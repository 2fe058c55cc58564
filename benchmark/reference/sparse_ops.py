"""Scatter-free sparse constraint operators for large meshes.

Counterpart of `diffcloth_tpu/core/sparse_ops.py:40-221`: `build_incidence`,
`make_row_ops`, `make_vertex_gather`, `SparseOps`, `build_sparse_ops`,
`apply_A`, `apply_At`, `apply_AtA` and `projections`.  The dense operators
(`dense_ops.py`) cost O(R n) memory; past 300 MB of them `ClothSim` takes
these instead, at O(n D) (D the largest vertex degree):

* A x gathers each row's vertices and sums them with the row's weights.
* A^T d is computed from each vertex's side: the vertex sums w * d over its
  incident (row, slot) pairs, an incidence table built once on the host and
  padded to the largest degree.  A gather and a weighted sum, no scatter.
* A and A^T are each other's backward (`torch.autograd.Function`s), and a
  vertex gather x[idx] used by the nonlinear projections is a row block of
  unit weights, so its backward is the incidence sum too.  Autograd's own
  backward of an index, an atomic `index_add_` whose order is neither the
  reference's nor fixed from run to run, is never used.

States are (n, 3) or batched (..., n, 3); the tables are shared by the
batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import dense_ops as dn
from benchmark.reference.constraints import safe_norm
from benchmark.reference.device import resolve_device
from benchmark.reference import builder as gb


def build_incidence(flat_idx: np.ndarray, weights: np.ndarray, n: int):
    """Host-side transpose of a flattened index map.

    flat_idx: (M,) vertex of each source slot; weights: (M,) what each slot
    contributes to its vertex.  Returns (inc_idx (n, D) int32, inc_w (n, D))
    padded with (slot 0, weight 0); a vertex lists its slots in slot order
    (the JAX package's stable sort)."""
    M = flat_idx.shape[0]
    if M == 0:
        return np.zeros((n, 1), np.int32), np.zeros((n, 1))
    order = np.argsort(flat_idx, kind="stable")
    sorted_v = flat_idx[order]
    counts = np.bincount(sorted_v, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(M) - starts[sorted_v]
    inc_idx = np.zeros((n, int(counts.max())), np.int64)
    inc_w = np.zeros(inc_idx.shape)
    inc_idx[sorted_v, pos] = order
    inc_w[sorted_v, pos] = weights[order]
    return inc_idx.astype(np.int32), inc_w


@dataclasses.dataclass(eq=False)
class RowOps:
    """One weightless row block as index data: A (R, n) with K nonzeros a
    row, and its transpose by incidence.  `A(x)` and `At(d)` are
    differentiable, each the other's backward."""
    idx: torch.Tensor        # (R, K) vertex of each row slot
    w: torch.Tensor          # (R, K) its weight
    inc_rows: torch.Tensor   # (n, D) row of each slot incident to a vertex
    inc_w: torch.Tensor      # (n, D) its weight, 0 in the padding
    n: int

    def __post_init__(self):
        # the flat index maps and (.., 1) weights the gathers take
        self.idx_flat = self.idx.reshape(-1)
        self.w3 = self.w[..., None]
        self.inc_flat = self.inc_rows.reshape(-1)
        self.inc_w3 = self.inc_w[..., None]

    @property
    def rows(self) -> int:
        return self.idx.shape[0]

    # without a graph to record (the PD loop, the CG solves) the plain
    # function runs: the same arithmetic without autograd's bookkeeping

    def A(self, x):
        if torch.is_grad_enabled() and x.requires_grad:
            return _ApplyA.apply(x, self)
        return _apply_a(self, x)

    def At(self, d):
        if torch.is_grad_enabled() and d.requires_grad:
            return _ApplyAt.apply(d, self)
        return _apply_at(self, d)


def _gather_sum(src, idx_flat, w3):
    """sum_k w[r, k] src[..., idx[r, k], :] for src (..., m, 3), the
    (rows, K) index map flattened, w3 its weights as (rows, K, 1)."""
    g = torch.index_select(src, -2, idx_flat)
    g = g.view(src.shape[:-2] + w3.shape[:2] + (3,))
    return (w3.to(src.dtype) * g).sum(dim=-2)


def _apply_a(op: RowOps, x):
    """(..., n, 3) -> (..., R, 3): each row's weighted sum of its
    vertices."""
    if op.rows == 0:
        return x.new_zeros(x.shape[:-2] + (0, 3))
    return _gather_sum(x, op.idx_flat, op.w3)


def _apply_at(op: RowOps, d):
    """(..., R, 3) -> (..., n, 3): each vertex's weighted sum over its
    incident rows."""
    if op.rows == 0:
        return d.new_zeros(d.shape[:-2] + (op.n, 3))
    return _gather_sum(d, op.inc_flat, op.inc_w3)


class _ApplyA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return _apply_a(op, x)

    @staticmethod
    def backward(ctx, g):
        return _ApplyAt.apply(g, ctx.op), None


class _ApplyAt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, op):
        ctx.op = op
        return _apply_at(op, d)

    @staticmethod
    def backward(ctx, g):
        return _ApplyA.apply(g, ctx.op), None


def make_row_ops(rows_idx: np.ndarray, rows_w: np.ndarray, n: int,
                 dtype=torch.float32, device=None) -> RowOps:
    """(A, A^T) of one row block, both scatter-free, their backwards
    included.  Slot m = (r, k) adds w[r, k] x[idx[r, k]] to row r; the
    transpose indexes rows, so the incidence of slot m is row m // K."""
    device = resolve_device(device)
    R, K = rows_idx.shape
    inc_idx, inc_w = build_incidence(rows_idx.reshape(-1),
                                     rows_w.reshape(-1), n)
    row_of_slot = inc_idx // K if R else inc_idx
    return RowOps(
        idx=torch.as_tensor(rows_idx.astype(np.int64), device=device),
        w=torch.as_tensor(np.asarray(rows_w)).to(device=device, dtype=dtype),
        inc_rows=torch.as_tensor(row_of_slot.astype(np.int64),
                                 device=device),
        inc_w=torch.as_tensor(inc_w).to(device=device, dtype=dtype), n=n)


def make_vertex_gather(idx: np.ndarray, n: int, dtype=torch.float32,
                       device=None):
    """x -> x[..., idx, :] with the unit-weight incidence as its backward:
    a row block of one unit weight per slot (the product with 1.0 is
    exact)."""
    shape = idx.shape
    op = make_row_ops(idx.reshape(-1, 1), np.ones((idx.size, 1)), n, dtype,
                      device)

    def gather(x):
        return op.A(x).reshape(x.shape[:-2] + shape + (3,))

    gather.op = op
    return gather


@dataclasses.dataclass(eq=False)
class SparseOps:
    """Scatter-free operators for one attachment stage (large-mesh path)."""
    s: RowOps                # stretch, 2T rows (interleaved, as built)
    b: RowOps                # bending
    a: RowOps                # attachment
    sp: RowOps               # springs
    gather_tri: object       # x -> x[tri_idx] (..., T, 3, 3)
    gather_bend: object      # x -> x[b_idx]   (..., Bn, 4, 3)

    @property
    def n_rows(self) -> tuple:
        """(2T, Bn, F, S) row counts."""
        return (self.s.rows, self.b.rows, self.a.rows, self.sp.rows)


def build_sparse_ops(scene_host, stage_host, dtype=torch.float32,
                     device=None) -> SparseOps:
    """The host scene's row blocks as incidence operators on `device` (the
    card unless it says otherwise)."""
    device = resolve_device(device)
    n = scene_host.n

    def ops(rows):
        return make_row_ops(rows.idx, rows.w, n, dtype, device)

    return SparseOps(
        s=ops(gb.stretch_rows(scene_host.triangle)),
        b=ops(gb.bend_rows(scene_host.bending)),
        a=ops(gb.attach_rows(stage_host)),
        sp=ops(gb.spring_rows(scene_host.springs)),
        gather_tri=make_vertex_gather(scene_host.triangle.idx, n, dtype,
                                      device),
        gather_bend=make_vertex_gather(scene_host.bending.idx, n, dtype,
                                       device))


# ---------------------------------------------------------------------------
# step.py's operator surface (the dense_ops one)

def apply_A(sp: SparseOps, x):
    """x -> (y_s, y_b, y_a, y_sp)."""
    return sp.s.A(x), sp.b.A(x), sp.a.A(x), sp.sp.A(x)


def apply_At(sp: SparseOps, k_pertype, d_s, d_b, d_a, d_sp=None):
    """sum_t k_t A_t^T d_t; k_pertype (4,) or (B, 4)."""
    out = dn._k(k_pertype, 2) * sp.s.At(d_s)
    out = out + dn._k(k_pertype, 3) * sp.b.At(d_b)
    out = out + dn._k(k_pertype, 1) * sp.a.At(d_a)
    if d_sp is not None and sp.sp.rows > 0:
        out = out + dn._k(k_pertype, 0) * sp.sp.At(d_sp)
    return out


def apply_AtA(sp: SparseOps, k_pertype, v):
    """sum_t k_t A_t^T (A_t v): gathers both ways, no scatter."""
    out = dn._k(k_pertype, 2) * sp.s.At(sp.s.A(v))
    out = out + dn._k(k_pertype, 3) * sp.b.At(sp.b.A(v))
    out = out + dn._k(k_pertype, 1) * sp.a.At(sp.a.A(v))
    if sp.sp.rows > 0:
        out = out + dn._k(k_pertype, 0) * sp.sp.At(sp.sp.A(v))
    return out


def projections(sp: SparseOps, scene, x, x_fixed):
    """All weightless projections at x, from gathered vertices (the same
    math as dense_ops.projections_from_y; reference Triangle.cpp:329-351,
    TriangleBending.cpp:138-151, Spring.cpp:92-97).  `scene` is the
    SceneDev; returns (p_s, p_b, p_a, p_sp) in apply_A's row order."""
    lead = x.shape[:-2]
    if sp.s.rows > 0:
        verts = sp.gather_tri(x)                       # (..., T, 3, 3)
        e1 = verts[..., 1, :] - verts[..., 0, :]
        e2 = verts[..., 2, :] - verts[..., 0, :]
        u = scene.tri_inv_duv.to(x.dtype)
        a = e1 * u[:, 0, 0][:, None] + e2 * u[:, 1, 0][:, None]
        b = e1 * u[:, 0, 1][:, None] + e2 * u[:, 1, 1][:, None]
        c0, c1 = dn.corot_project_cols(a, b)
        sw = torch.sqrt(scene.tri_area).to(x.dtype)[:, None]
        p_s = torch.stack([c0 * sw, c1 * sw], dim=-2).reshape(
            lead + (sp.s.rows, 3))
    else:
        p_s = x.new_zeros(lead + (0, 3))
    if sp.b.rows > 0:
        quad = sp.gather_bend(x)                       # (..., Bn, 4, 3)
        e = (scene.b_w_vert.to(x.dtype)[..., None] * quad).sum(dim=-2)
        en = safe_norm(e)
        flat = (scene.b_n_rest <= 1e-6)[:, None]
        p_b = torch.where(
            flat, 0.0,
            (scene.b_n_rest * scene.b_sw).to(x.dtype)[:, None] * e / en)
    else:
        p_b = x.new_zeros(lead + (0, 3))
    p_sp = dn.spring_proj_from_y(sp.sp.A(x), scene.sp_l0)
    return p_s, p_b, x_fixed, p_sp
