"""The pieces of `diffcloth_tpu/core/constraints.py` the port uses: the
norm guard and its epsilon (the step's operators), and the gather form of
the A0 operators and the projections (the energy diagnostics)."""
from __future__ import annotations

import torch

EPS = 1e-12


def safe_norm(v, dim=-1, keepdim=True, eps=EPS):
    """|v| with the JAX package's double-where guard (constraints.py:22-34):
    degenerate inputs (|v| <= eps) give exactly eps."""
    n2 = torch.sum(v * v, dim=dim, keepdim=keepdim)
    safe = n2 > eps * eps
    n = torch.sqrt(torch.where(safe, n2, torch.ones_like(n2)))
    return torch.where(safe, n, torch.full_like(n, eps))


# ---------------------------------------------------------------------------
# the gather form of the operators and projections (constraints.py:40-60,
# 187-196), for the energy diagnostics; the step uses dense_ops or
# sparse_ops instead

def apply_rows(rows_idx: torch.Tensor, rows_w: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """(A0 x): (R,K) indices, (R,K) weights, (n,3) x -> (R,3)."""
    if rows_idx.shape[0] == 0:
        return x.new_zeros((0, 3))
    return torch.einsum("rk,rkd->rd", rows_w.to(x.dtype), x[rows_idx])


def all_projections(scene, stage, x, x_fixed):
    """All weightless projections at configuration x (n,3): (p_stretch,
    p_bend, p_attach, p_spring) in the rows of the A0 operators (reference
    Triangle.cpp:329-351, TriangleBending.cpp:138-151, Spring.cpp:92-97,
    AttachmentSpring::project).  `scene` is the SceneDev; `stage` is not
    read (the attachment projection is the clip position), as in the JAX
    package."""
    from benchmark.reference import dense_ops as dn
    if scene.tri_idx.shape[0]:
        verts = x[scene.tri_idx]                      # (T,3,3)
        e1 = verts[:, 1] - verts[:, 0]
        e2 = verts[:, 2] - verts[:, 0]
        u = scene.tri_inv_duv.to(x.dtype)
        a = e1 * u[:, 0, 0][:, None] + e2 * u[:, 1, 0][:, None]
        b = e1 * u[:, 0, 1][:, None] + e2 * u[:, 1, 1][:, None]
        c0, c1 = dn.corot_project_cols(a, b)
        sw = torch.sqrt(scene.tri_area).to(x.dtype)[:, None]
        # rows interleave: triangle t gives rows 2t (column 0), 2t+1
        p_s = torch.stack([c0 * sw, c1 * sw], dim=1).reshape(-1, 3)
    else:
        p_s = x.new_zeros((0, 3))
    if scene.b_rows_idx.shape[0]:
        e = torch.einsum("bk,bkd->bd", scene.b_w_vert.to(x.dtype),
                         x[scene.b_rows_idx])
        flat = (scene.b_n_rest <= 1e-6)[:, None]
        p_b = torch.where(flat, 0.0, (scene.b_n_rest * scene.b_sw).to(
            x.dtype)[:, None] * e / safe_norm(e))
    else:
        p_b = x.new_zeros((0, 3))
    p_sp = dn.spring_proj_from_y(
        apply_rows(scene.sp_rows_idx, scene.sp_rows_w, x), scene.sp_l0)
    return p_s, p_b, x_fixed, p_sp
