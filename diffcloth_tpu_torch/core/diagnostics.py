"""Explosion detection and central-difference gradient checks
(counterpart of `diffcloth_tpu/core/diagnostics.py` :52-109; the energy
diagnostics are not ported)."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from diffcloth_tpu_torch.core.types import SimParams


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
