"""PD system-matrix prefactorization as a host function of (k, density).

Counterpart of `diffcloth_tpu/core/solver.py:30-109`.  The per-type Gram
matrices S_t = A0_t^T A0_t are (n,n) constants on the vertex graph, so

    P(k, rho) = rho * diag(area) + h^2 * sum_t k_t S_t

and its explicit inverse turns every PD global solve into one (n,n)x(n,3B)
matmul.  The inverse is computed on the host in NumPy f64 through scipy's
Cholesky (as the JAX package does) and only then cast to the device
tensor, so both packages hold bit-equal P^{-1} for the same parameters.

Past n = 8000 the solve is matrix-free Jacobi-PCG (`step.py`), whose only
per-parameter data is 1/diag(P): `gram_diagonals` and
`make_host_p_diag_inv_fn` build it in O(n) host memory, with no (n,n)
matrix anywhere.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from diffcloth_tpu_torch.core.device import resolve_device
from diffcloth_tpu_torch.geometry import builder as gb


def dense_gram_matrices(scene: "gb.Scene") -> List[np.ndarray]:
    """Per-stage list of per-type Gram matrices [S_spring, S_attach,
    S_stretch, S_bend], each (n,n) float64 (host-side, built once)."""
    n = scene.n
    S_stretch = gb.rows_to_dense_ata(gb.stretch_rows(scene.triangle), n)
    S_bend = gb.rows_to_dense_ata(gb.bend_rows(scene.bending), n)
    S_spring = gb.rows_to_dense_ata(gb.spring_rows(scene.springs), n)
    out = []
    for stage in scene.stages:
        S_attach = gb.rows_to_dense_ata(gb.attach_rows(stage), n)
        out.append(np.stack([S_spring, S_attach, S_stretch, S_bend]))
    return out


def _host_f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def make_host_p_inv_fn(gram_stack: np.ndarray, area: np.ndarray, h: float,
                       dtype=torch.float32, device=None):
    """Returns host-side (k_pertype, density) -> P^{-1} (an (n,n) tensor of
    `dtype` on `device`, the card unless it says otherwise) for one stage.
    gram_stack: (4, n, n) float64."""
    import scipy.linalg

    device = resolve_device(device)
    h2 = h * h
    eye = np.eye(area.shape[0])

    def p_inv(k_pertype, density):
        k = _host_f64(k_pertype)
        P = h2 * np.tensordot(k, gram_stack, axes=1)
        P[np.diag_indices_from(P)] += float(_host_f64(density)) * area
        c, low = scipy.linalg.cho_factor(P)
        inv = scipy.linalg.cho_solve((c, low), eye)
        return torch.as_tensor(inv).to(device=device, dtype=dtype)

    return p_inv


def gram_diagonals(scene: "gb.Scene") -> List[np.ndarray]:
    """Per-stage (4, n) diag(S_t), in k_pertype order [spring, attach,
    stretch, bend]: the O(n) substitute for dense_gram_matrices on the CG
    solve path."""
    n = scene.n
    d_stretch = gb.rows_to_ata_diag(gb.stretch_rows(scene.triangle), n)
    d_bend = gb.rows_to_ata_diag(gb.bend_rows(scene.bending), n)
    d_spring = gb.rows_to_ata_diag(gb.spring_rows(scene.springs), n)
    return [np.stack([d_spring, gb.rows_to_ata_diag(gb.attach_rows(st), n),
                      d_stretch, d_bend])
            for st in scene.stages]


def make_host_p_diag_inv_fn(gram_diags: np.ndarray, area: np.ndarray,
                            h: float, dtype=torch.float32, device=None):
    """The Jacobi preconditioner of the CG solve path: host-side
    (k_pertype, density) -> 1/diag(P), an (n,) tensor of `dtype` on
    `device` (the card unless it says otherwise), computed in f64 from the
    (4, n) `gram_diags`."""
    device = resolve_device(device)
    h2 = h * h

    def p_diag_inv(k_pertype, density):
        k = _host_f64(k_pertype)
        d = float(_host_f64(density)) * area + h2 * (k @ gram_diags)
        return torch.as_tensor(1.0 / d).to(device=device, dtype=dtype)

    return p_diag_inv
