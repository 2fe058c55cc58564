"""Hand parameters between the JAX package and the port as plain numpy
arrays.

`sim_params_from_numpy` takes the JAX `SimParams` as a dict of numpy arrays
(`{k: np.asarray(v) for k, v in p._asdict().items()}`), with or without a
leading batch dim, and returns the port's `SimParams`, so that both
packages compute the same episode.  `sim_params_to_numpy` is its inverse,
for the port's parameters and its gradients alike (a dict that the JAX
`SimParams(**d)` takes).  `primitive_set_from_numpy` carries a JAX
`PrimitiveSet` (`p._asdict()`, arrays as numpy) across the same way, so
that both packages simulate the same obstacles.  `controller_from_numpy`
and `controller_to_numpy` move the hat controller's weights the same way,
in the JAX app's `controller.pkl` format (a list of {"w": (in, out),
"b": (out,)} numpy dicts, one per layer).  Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import numpy as np
import torch

from diffcloth_tpu_torch.core.contact import PrimitiveSet
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


# PrimitiveSet fields that stay host numpy (they select code paths)
_HOST_PRIM_FIELDS = {"kind": np.int32, "rotates": bool, "enabled": bool,
                     "kinematic": bool}


def primitive_set_from_numpy(fields: Mapping[str, np.ndarray],
                             dtype=torch.float32, device=None
                             ) -> PrimitiveSet:
    """A JAX `PrimitiveSet` as a dict of numpy arrays -> the port's, on the
    card unless `device` says otherwise.  A missing or None `kinematic`
    means all static, as there."""
    device = resolve_device(device)
    out = {}
    for f in dataclasses.fields(PrimitiveSet):
        a = fields.get(f.name)
        if f.name in _HOST_PRIM_FIELDS:
            out[f.name] = (None if a is None else
                           np.asarray(a, _HOST_PRIM_FIELDS[f.name]))
        else:
            out[f.name] = torch.as_tensor(np.array(a)).to(device=device,
                                                          dtype=dtype)
    return PrimitiveSet(**out)


def controller_from_numpy(layers: List[Mapping[str, np.ndarray]],
                          device=None, dtype=torch.float32):
    """The JAX app's controller weights -> the port's `Controller`, on the
    card unless `device` says otherwise."""
    from diffcloth_tpu_torch.apps.hat_controller import Controller
    device = resolve_device(device)
    widths = [np.shape(layers[0]["w"])[0]] + [np.shape(d["w"])[1]
                                               for d in layers]
    ctrl = Controller(widths, dtype, device)
    with torch.no_grad():
        for p, a in zip(ctrl.layers(),
                        [a for d in layers for a in (d["w"], d["b"])]):
            p.copy_(torch.as_tensor(np.asarray(a)))
    return ctrl


def controller_to_numpy(ctrl) -> List[Dict[str, np.ndarray]]:
    ws = [p.detach().cpu().numpy() for p in ctrl.layers()]
    return [{"w": ws[i], "b": ws[i + 1]} for i in range(0, len(ws), 2)]
