"""Energy diagnostics, explosion detection and central-difference
gradient checks (counterpart of `diffcloth_tpu/core/diagnostics.py`).

Reference: the PD system energy E = 1/2 (x-s_n)^T M (x-s_n) + h^2 sum_c
E_c (`evaluateEnergy` / `evaluateSystemEnergy`, Simulation.cpp:921-948),
the explosion freeze (:1415-1424) and the finite-difference oracle
(`finiteDifferenceBackward`, :3640-3786).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from benchmark.reference import constraints as cons
from benchmark.reference.types import SimParams


def constraint_energy(scene, stage, k_pertype, x, x_fixed):
    """sum_c E_c, E_c = 1/2 k_t |A0_t x - p0_t(x)|^2 per constraint type
    (the PD quadratic energy at the projection; reference per-constraint
    evaluateEnergy, Constraint.h:49-84).  One episode: x (n,3), x_fixed
    (F,3); `scene` the SceneDev, `stage` the StageDev."""
    p_s, p_b, p_a, p_sp = cons.all_projections(scene, stage, x, x_fixed)
    y_s = cons.apply_rows(scene.s_rows_idx, scene.s_rows_w, x)
    y_b = cons.apply_rows(scene.b_rows_idx, scene.b_rows_w, x)
    y_a = cons.apply_rows(stage.attach_idx, stage.attach_w, x)
    y_sp = cons.apply_rows(scene.sp_rows_idx, scene.sp_rows_w, x)
    return 0.5 * (k_pertype[2] * torch.sum((y_s - p_s) ** 2)
                  + k_pertype[3] * torch.sum((y_b - p_b) ** 2)
                  + k_pertype[1] * torch.sum((y_a - p_a) ** 2)
                  + k_pertype[0] * torch.sum((y_sp - p_sp) ** 2))


def system_energy(scene, stage, k_pertype, m, h, x, s_n, x_fixed):
    """E = 1/2 (x-s_n)^T M (x-s_n) + h^2 sum_c E_c (evaluateSystemEnergy,
    Simulation.cpp:939-948); m (n,) lumped masses."""
    d = x - s_n
    inertia = 0.5 * torch.sum(m[:, None] * d * d)
    return inertia + h * h * constraint_energy(scene, stage, k_pertype, x,
                                               x_fixed)


def is_exploded(x, v, threshold: float = 1e4):
    """Per-episode numerical-failure predicate used to freeze the remaining
    rollout (the reference freezes on E > 1e6, Simulation.cpp:1415-1424;
    here: non-finite state or runaway velocity).  x, v (n,3) -> () bool;
    batched (B,n,3) -> (B,) bool."""
    x, v = x.flatten(-2), v.flatten(-2)
    finite = torch.isfinite(x).all(-1) & torch.isfinite(v).all(-1)
    bounded = torch.amax(torch.abs(v), dim=-1) < threshold
    return ~(finite & bounded)


DEFAULT_FD_FIELDS = ("wind", "wind_freq", "wind_phase", "k_pertype",
                     "density", "mu", "spline", "x0", "v0")


def finite_difference_gradients(
        loss_of_params: Callable[[SimParams], float],
        params: SimParams,
        fields: Sequence[str] = DEFAULT_FD_FIELDS,
        delta: float = 1e-6,
        max_entries_per_field: Optional[int] = 12,
        rng: Optional[np.random.RandomState] = None) -> Dict[str, np.ndarray]:
    """Central-difference dL/dtheta per parameter field (the reference's
    oracle, `finiteDifferenceBackward`, Simulation.cpp:3640-3786).

    `loss_of_params` runs a full episode on a single SimParams and returns
    the scalar task loss (tighten the forward tolerance for agreement at
    small delta, as the reference does during FD checks,
    Simulation.cpp:3648).  For large fields a random subset of
    `max_entries_per_field` coordinates is probed; the returned array holds
    the FD value at probed coordinates and NaN elsewhere."""
    rng = rng or np.random.RandomState(0)
    out: Dict[str, np.ndarray] = {}
    for name in fields:
        leaf = getattr(params, name)
        base = leaf.detach().cpu().numpy().astype(np.float64)
        flat = base.reshape(-1)
        k = flat.shape[0]
        if k == 0:
            out[name] = base.copy()
            continue
        probe = np.arange(k)
        if max_entries_per_field is not None and k > max_entries_per_field:
            probe = np.sort(rng.choice(k, max_entries_per_field,
                                       replace=False))
        g = np.full((k,), np.nan)
        for i in probe:
            acc = 0.0
            for sgn in (+1.0, -1.0):
                pert = flat.copy()
                pert[i] += sgn * delta
                p2 = params.replace(**{name: torch.as_tensor(
                    pert.reshape(base.shape)).to(leaf.device, leaf.dtype)})
                acc += sgn * float(loss_of_params(p2))
            g[i] = acc / (2.0 * delta)
        out[name] = g.reshape(base.shape)
    return out


def compare_fd_adjoint(fd: Dict[str, np.ndarray], grads: SimParams,
                       rtol: float = 5e-2, atol: float = 1e-8):
    """Elementwise FD-vs-adjoint agreement over the probed entries:
    {field: (max_abs_err, max_rel_err, ok)}."""
    report = {}
    for name, g_fd in fd.items():
        g_ad = getattr(grads, name).detach().cpu().numpy().astype(np.float64)
        mask = np.isfinite(g_fd)
        if not mask.any():
            report[name] = (0.0, 0.0, True)
            continue
        diff = np.abs(g_fd[mask] - g_ad[mask])
        scale = np.maximum(np.abs(g_fd[mask]), np.abs(g_ad[mask]))
        rel = diff / np.maximum(scale, atol / rtol)
        report[name] = (float(diff.max()), float(rel.max()),
                        bool(np.all(diff <= atol + rtol * scale)))
    return report
