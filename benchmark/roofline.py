"""The least time an NVIDIA H100 SXM could take for one call of each of
the program's hand-written kernels, from the call's own inputs: admissible
pairs or active slots, each state and slot row read once, each output
written once.  Counted from what the call asks for, never from how a
kernel does it, so any later kernel is held to the same work.

The peaks are NVIDIA's published H100 SXM figures, which assume the
card's full 700 W power limit."""
from __future__ import annotations

# HBM bytes/s, and f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations of detection per admissible (row, column) pair: 6
# differences, 6 squares, 4 adds, 1 min, 1 add, 1 square of the reach,
# 1 compare
DETECT_OPS_PER_PAIR = 20
# f32 operations of the forward friction sweep per active slot: d (6), the
# case split (sd 5, fN 3, fT 3, |fT|^2 5, sqrt 1, compares 3, t_hat 3, the
# slide force 7), k_red scaling 3, the row add 3
FRICTION_OPS_PER_SLOT = 45
# f32 operations of the backward sweep per active slot: d (9), the case
# split (sd 5, fN 3, fT 3, |fT|^2 5, sqrt 1, slide 2, compares 3), t_hat 3,
# the Jacobian^T product (n.w 5, t.w 5, sign 2, its factor 3, w - (n.w)n -
# (t.w)t 12, the slide scale 7, selects 6), the friction force for the
# k_red cotangent (9), u = k_red jt (3), the row and partner adds and their
# scales (12), the three slot cotangents (16)
FRICTION_BWD_OPS_PER_SLOT = 114


def least_s(nbytes: float, ops: float) -> float:
    """The larger of the byte time and the operation time, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def detect(B: int, n_pad: int, k_partners: int, admissible: int) -> tuple:
    """(bytes, operations) of one detection call: the (B, 8, n_pad) f32
    geometry and the (n_pad, n_pad) int8 admissibility table read, the
    (B, n_pad, K + 1) int32 partner table written; `admissible` the
    table's admissible pairs, each a distance per sample."""
    nbytes = B * 8 * n_pad * 4 + n_pad * n_pad + B * n_pad * (k_partners
                                                             + 1) * 4
    return nbytes, B * admissible * DETECT_OPS_PER_PAIR


def friction_fwd(B: int, n: int, TC: int, layers: int, active: int) -> tuple:
    """(bytes, operations) of one forward sweep: the (B, n, 3) f32 force in
    and out, the selects (B, 6, TC) written, the (B, layers) counts, and
    each active slot's indices (2), normal (3) and masses (3)."""
    nbytes = (2 * B * n * 3 * 4 + B * 6 * TC * 4 + B * layers * 4
              + active * 4 * (2 + 3 + 3))
    return nbytes, active * FRICTION_OPS_PER_SLOT


def friction_bwd(B: int, n: int, TC: int, layers: int, active: int) -> tuple:
    """(bytes, operations) of one backward sweep: the (B, n, 3) cotangent
    in and out, each active slot's indices, normal, masses and selects
    (6), the three slot cotangents (B, TC) written, the counts."""
    nbytes = (2 * B * n * 3 * 4 + active * 4 * (2 + 3 + 3 + 6)
              + 3 * B * TC * 4 + B * layers * 4)
    return nbytes, active * FRICTION_BWD_OPS_PER_SLOT
