"""Dense constraint operators and closed-form projections.

Counterpart of `diffcloth_tpu/core/dense_ops.py:59-239`.  Every application
of the sparse constraint matrix A is a dense matmul:

    y   = A x        (R,n)@(n,3B)
    A^T d            (n,R)@(R,3B)
    C v = h^2 Sk v   per-type S_t matvecs, then the k contraction

and the constraint projections read y directly (no vertex gathers).  States
are (n,3) or batched (B,n,3); a batch is folded into the matmul's columns,
so each operator is read once per application whatever B is.  The plain
products stay `torch.matmul` (the JAX package leaves them to XLA); full f32
is kept by the TF32 switches `ClothSim` turns off, mirroring the JAX
package's Precision.HIGHEST.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.constraints import EPS, safe_norm
from benchmark.reference.device import resolve_device
from benchmark.reference import builder as gb


@dataclasses.dataclass
class DenseOps:
    """Dense constraint operators for one attachment stage."""
    A_s: torch.Tensor     # (2T, n) stretch rows (weightless), split order
    A_b: torch.Tensor     # (Bn, n) bending rows
    A_a: torch.Tensor     # (F, n) attachment rows
    A_sp: torch.Tensor    # (S, n) spring rows (+1/-1)
    sp_l0: torch.Tensor   # (S,) spring rest lengths
    S: torch.Tensor       # (4, n, n) per-type Gram
    #                       [spring, attach, stretch, bend] = k_pertype order
    tri_sw: torch.Tensor  # (T,) sqrt(rest area)
    b_scale: torch.Tensor  # (Bn,) n_rest * sqrt(3/(A0+A1)), 0 where flat


def _rows_to_dense(rows_idx: np.ndarray, rows_w: np.ndarray,
                   n: int) -> np.ndarray:
    R, K = rows_idx.shape
    A = np.zeros((R, n))
    if R:
        np.add.at(A, (np.repeat(np.arange(R), K), rows_idx.reshape(-1)),
                  rows_w.reshape(-1))
    return A


def build_dense_ops(scene_host, stage_host, dtype=torch.float32,
                    device=None) -> DenseOps:
    """Host-side densification of the per-type constraint rows, onto
    `device` (the card unless it says otherwise).

    The stretch rows are stored in SPLIT order — all column-0 rows (T),
    then all column-1 rows (T) — as in the JAX package (dense_ops.py:89-104),
    so the projection reads each block as one contiguous slice.  A^T A is
    permutation-invariant, and y_s and p_s share the order."""
    device = resolve_device(device)
    n = scene_host.n
    s_rows = gb.stretch_rows(scene_host.triangle)
    b_rows = gb.bend_rows(scene_host.bending)
    a_rows = gb.attach_rows(stage_host)
    sp_rows = gb.spring_rows(scene_host.springs)
    A_s = _rows_to_dense(s_rows.idx, s_rows.w, n)
    T2 = A_s.shape[0]
    perm = np.concatenate([np.arange(0, T2, 2), np.arange(1, T2, 2)])
    A_s = A_s[perm]
    A_b = _rows_to_dense(b_rows.idx, b_rows.w, n)
    A_a = _rows_to_dense(a_rows.idx, a_rows.w, n)
    A_sp = _rows_to_dense(sp_rows.idx, sp_rows.w, n)
    S = np.stack([A_sp.T @ A_sp, A_a.T @ A_a, A_s.T @ A_s, A_b.T @ A_b])
    n_rest = scene_host.bending.n_rest
    sw_b = np.sqrt(3.0 / np.maximum(scene_host.bending.area_sum, 1e-30))
    b_scale = np.where(n_rest <= 1e-6, 0.0, n_rest * sw_b)

    def f(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=dtype)

    return DenseOps(
        A_s=f(A_s), A_b=f(A_b), A_a=f(A_a), A_sp=f(A_sp),
        sp_l0=f(scene_host.springs.l0), S=f(S),
        tri_sw=f(np.sqrt(scene_host.triangle.area)), b_scale=f(b_scale))


# ---------------------------------------------------------------------------
# operator applications (plain matmuls, batch folded into the columns)

# the control's precision: when True every product's operands are rounded
# to TF32 (a 10-bit mantissa, to nearest even), as the tensor cores read
# f32 operands with TF32 on; the sums stay in the operands' dtype
TF32_OPERANDS = False


def tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 a rounded to TF32, to nearest even (finite values)."""
    bits = a.contiguous().view(torch.int32)
    bits = bits + (0x0FFF + ((bits >> 13) & 1))
    return (bits & ~0x1FFF).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """A @ x with both operands rounded to TF32, and so in its VJP."""

    @staticmethod
    def forward(ctx, A, x):
        ctx.save_for_backward(A, x)
        return tf32(A) @ tf32(x)

    @staticmethod
    def backward(ctx, g):
        A, x = ctx.saved_tensors
        g = tf32(g)
        gA = g @ tf32(x).t() if ctx.needs_input_grad[0] else None
        gx = tf32(A).t() @ g if ctx.needs_input_grad[1] else None
        return gA, gx


def _product(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _TF32Product.apply(A, x) if TF32_OPERANDS else A @ x


def mm(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (R,n) @ x for x (n,3) or batched (B,n,3) -> (R,3) / (B,R,3).
    The batch rides in the product's columns: one (R,n)@(n,3B) GEMM reads A
    once, where a broadcast batched matmul would re-read it B times."""
    if x.dim() == 2:
        return _product(A, x)
    B, n, c = x.shape
    y = _product(A, x.transpose(0, 1).reshape(n, B * c))
    return y.reshape(A.shape[0], B, c).transpose(0, 1)


def _k(k_pertype: torch.Tensor, t: int) -> torch.Tensor:
    """k_t broadcastable against (n,3) / (B,n,3) operands."""
    kt = k_pertype[..., t]
    return kt if kt.dim() == 0 else kt[:, None, None]


def apply_A(dense: DenseOps, x):
    """x -> (y_s (.., 2T,3), y_b (.., Bn,3), y_a (.., F,3), y_sp (.., S,3))."""
    return (mm(dense.A_s, x), mm(dense.A_b, x), mm(dense.A_a, x),
            mm(dense.A_sp, x))


def apply_At(dense: DenseOps, k_pertype, d_s, d_b, d_a, d_sp=None):
    """sum_t k_t A_t^T d_t -> (n,3) / (B,n,3).  k_pertype (4,) or (B,4)."""
    out = _k(k_pertype, 2) * mm(dense.A_s.t(), d_s)
    out = out + _k(k_pertype, 3) * mm(dense.A_b.t(), d_b)
    out = out + _k(k_pertype, 1) * mm(dense.A_a.t(), d_a)
    if d_sp is not None and dense.A_sp.shape[0] > 0:
        out = out + _k(k_pertype, 0) * mm(dense.A_sp.t(), d_sp)
    return out


def apply_S_pertype(S, k_pertype, v):
    """(sum_t k_t S_t) v as per-type matvecs then a weighted sum
    (dense_ops.py:160-168): the S_t are shared by the whole batch and the k
    contraction happens on the (4, n, 3B) matvec outputs, so no (B, n, n)
    matrix ever exists."""
    T, n, _ = S.shape
    if v.dim() == 2:
        u = _product(S.reshape(T * n, n), v).reshape(T, n, 3)
        return torch.tensordot(k_pertype, u, dims=1)
    B = v.shape[0]
    u = mm(S.reshape(T * n, n), v).reshape(B, T, n, 3)
    return torch.einsum("bt,btnc->bnc", k_pertype, u)


# ---------------------------------------------------------------------------
# projections from y = A x (gather-free)

def corot_project_cols(a, b):
    """Closed-form co-rotational projection of deformation-gradient columns
    a, b (any positive common scaling) — dense_ops.py:174-198: in the
    Gram-Schmidt frame of (a, b) the 2x2 polar factor is
    R = [[tr, dq], [-dq, tr]] / sqrt(tr^2 + dq^2), tr = |a| + |b_perp|."""
    na = safe_norm(a)
    q0 = a / na
    dq = torch.sum(b * q0, -1, keepdim=True)
    bperp = b - dq * q0
    nb = safe_norm(bperp)
    q1 = bperp / nb
    tr = na + nb
    rnorm = torch.sqrt(tr * tr + dq * dq + EPS)
    c0 = (q0 * tr - q1 * dq) / rnorm
    c1 = (q0 * dq + q1 * tr) / rnorm
    return c0, c1


def stretch_proj_from_y(y_s, tri_sw):
    """Rows [0,T) = sqrt(area) F[:,0], rows [T,2T) = sqrt(area) F[:,1]; the
    polar factor is invariant to the sqrt(area) scaling."""
    if y_s.shape[-2] == 0:
        return y_s
    T = y_s.shape[-2] // 2
    c0, c1 = corot_project_cols(y_s[..., :T, :], y_s[..., T:, :])
    sw = tri_sw.to(y_s.dtype)[:, None]
    return torch.cat([c0 * sw, c1 * sw], dim=-2)


def bend_proj_from_y(y_b, b_scale):
    """p = n_rest * sw * normalize(sum_i w_i x_i) (TriangleBending.cpp
    :138-151)."""
    if y_b.shape[-2] == 0:
        return y_b
    en = safe_norm(y_b)
    return b_scale.to(y_b.dtype)[:, None] * y_b / en


def spring_proj_from_y(y_sp, sp_l0):
    """p = l0 * normalize(x_i - x_j) (Spring.cpp:92-97)."""
    if y_sp.shape[-2] == 0:
        return y_sp
    en = safe_norm(y_sp)
    return sp_l0.to(y_sp.dtype)[:, None] * y_sp / en


def projections_from_y(dense: DenseOps, y_s, y_b, x_fixed, y_sp=None):
    """All weightless projections, computed from y = A x."""
    p_sp = (spring_proj_from_y(y_sp, dense.sp_l0) if y_sp is not None
            else y_s[..., :0, :])
    return (stretch_proj_from_y(y_s, dense.tri_sw),
            bend_proj_from_y(y_b, dense.b_scale),
            x_fixed, p_sp)
