"""Hand parameters between the JAX package and the port as plain numpy
arrays.

`sim_params_from_numpy` takes the JAX `SimParams` as a dict of numpy arrays
(`{k: np.asarray(v) for k, v in p._asdict().items()}`), with or without a
leading batch dim, and returns the port's `SimParams`, so that both
packages compute the same episode.  `sim_params_to_numpy` is its inverse,
for the port's parameters and its gradients alike (a dict that the JAX
`SimParams(**d)` takes).  Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from diffcloth_tpu_torch.core.device import resolve_device
from diffcloth_tpu_torch.core.types import SimParams


def sim_params_from_numpy(arrays: Mapping[str, np.ndarray], device=None,
                          dtype=torch.float32) -> SimParams:
    """On the card unless `device` says otherwise."""
    device = resolve_device(device)
    names = [f.name for f in dataclasses.fields(SimParams)]
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"SimParams fields missing: {sorted(missing)}")
    return SimParams(**{
        k: torch.as_tensor(np.array(arrays[k])).to(device=device,
                                                      dtype=dtype)
        for k in names})


def sim_params_to_numpy(params: SimParams) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
