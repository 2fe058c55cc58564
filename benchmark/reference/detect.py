"""Self-collision detection: the CUDA kernel, its plain PyTorch version, and
the per-step detection pipeline.

Counterpart of `diffcloth_tpu/core/selfcol_pallas.py`: `build_geom`,
`pack_allowed`, `detect_partners` in symmetric mode (the TPU `_kernel`,
here `csrc/selfcol_detect.cu`) and `detect_tables` (`detect_tables_pallas`,
:263-301).  `detect_partners` launches the kernel for a CUDA tensor and
runs `detect_partners_plain` for a CPU tensor; there is no fallback from
one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.selfcol import layer_tables_from_partners

SEGMENT = 512     # column segment of the TPU kernel; n_pad is a multiple
MAX_K = 127       # largest partner budget (the JAX kernel's: SLOT_COLS - 1)
MAX_BATCH = 65535  # largest batch: the kernel's grid has one y-block each


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_allowed(allowed: np.ndarray) -> np.ndarray:
    """(n,n) bool admissibility -> padded (n_pad, n_pad) int8 (host)."""
    n = allowed.shape[0]
    n_pad = round_up(n, SEGMENT)
    out = np.zeros((n_pad, n_pad), np.int8)
    out[:n, :n] = allowed.astype(np.int8)
    return out


def build_geom(x: torch.Tensor, v: torch.Tensor, radii: torch.Tensor,
               h: float, n_pad: int) -> torch.Tensor:
    """Pack positions, swept positions and radii into the (8, n_pad) (or
    batched (B, 8, n_pad)) f32 kernel input: rows x, x + h v, r, 0.
    Padding columns get x = 1e9 (never within reach) and r = 0."""
    single = x.dim() == 2
    if single:
        x, v = x[None], v[None]
    B, n, _ = x.shape
    geom = torch.zeros((B, 8, n_pad), dtype=torch.float32, device=x.device)
    geom[:, 0:3, :n] = x.to(torch.float32).transpose(1, 2)
    geom[:, 3:6, :n] = (x + h * v).to(torch.float32).transpose(1, 2)
    geom[:, 6, :n] = radii.to(torch.float32)
    geom[:, 0:6, n:] = 1e9
    return geom[0] if single else geom


def detect_partners_plain(geom: torch.Tensor, allowed: torch.Tensor,
                          k_partners: int) -> torch.Tensor:
    """Plain PyTorch version of the detection kernel (same semantics, see
    csrc/selfcol_detect.cu): geom (B, 8, n_pad) or (8, n_pad), allowed
    (n_pad, n_pad) int8 -> (B, n_pad, K+1) / (n_pad, K+1) int32."""
    single = geom.dim() == 2
    g = geom[None] if single else geom
    B, _, n_pad = g.shape
    k = k_partners
    dev = g.device
    slots = torch.full((B, n_pad, k + 1), -1, dtype=torch.int64, device=dev)
    count = torch.zeros((B, n_pad), dtype=torch.int64, device=dev)
    jk = torch.arange(k, device=dev)

    def pair_d2(gj, row0):
        d2 = None
        for c in range(3):
            diff = g[:, row0 + c, :, None] - gj[:, row0 + c, None, :]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        return d2

    for seg in range(0, n_pad, SEGMENT):
        gj = g[:, :, seg:seg + SEGMENT]
        d2 = torch.minimum(pair_d2(gj, 0), pair_d2(gj, 3))
        reach = g[:, 6, :, None] + gj[:, 6, None, :]
        hit = (d2 < reach * reach) & (allowed[None, :, seg:seg + SEGMENT] > 0)
        masked = torch.where(hit, d2, torch.full_like(d2, float("inf")))
        order = torch.sort(masked, dim=-1, stable=True).indices[..., :k]
        hits = hit.sum(dim=-1)
        take = torch.minimum(hits, (k - count).clamp(min=0))
        keep = jk < take[..., None]
        dest = torch.where(keep, count[..., None] + jk, k)   # k = scratch
        slots.scatter_(-1, dest, order + seg)
        count = count + take + (hits - k).clamp(min=0)
    slots[..., k] = count
    out = slots.to(torch.int32)
    return out[0] if single else out


def detect_partners(geom: torch.Tensor, allowed: torch.Tensor,
                    k_partners: int) -> torch.Tensor:
    """Symmetric-mode partner detection, by the plain version."""
    return detect_partners_plain(geom, allowed, k_partners)


def detect_table(allowed_sym: torch.Tensor, radii: torch.Tensor,
                 x: torch.Tensor, v: torch.Tensor, h: float,
                 k_partners: int):
    """Symmetric detection alone: x, v (n,3) or (B,n,3) -> (partners
    (..., n, K) int32, overflow () / (B,) bool: some row exceeded
    k_partners contacts)."""
    n = x.shape[-2]
    geom = build_geom(x, v, radii, h, allowed_sym.shape[0])
    table = detect_partners(geom, allowed_sym, k_partners)
    overflow = (table[..., :n, k_partners] > k_partners).any(dim=-1)
    return table[..., :n, :k_partners], overflow


def detect_tables(allowed_sym: torch.Tensor, radii: torch.Tensor,
                  x: torch.Tensor, v: torch.Tensor, h: float,
                  k_partners: int, max_layers: int):
    """Symmetric detection -> layered partner tables (detect_tables_pallas
    with with_normals=False).  x, v (n,3) or (B,n,3).  Returns
    (SelfContactTables, overflow) with overflow () / (B,) bool: some row
    exceeded k_partners contacts."""
    partners, overflow = detect_table(allowed_sym, radii, x, v, h,
                                      k_partners)
    return layer_tables_from_partners(partners, max_layers), overflow
