"""Obstacle contact: the dry-friction projection and the (empty) obstacle
sets of this slice.

Counterpart of `diffcloth_tpu/core/contact.py`.  The port's first slice runs
obstacle-free scenes, so `PrimitiveSet` / `ContactSet` exist only in their
empty form; obstacle detection comes with a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffcloth_tpu_torch.core.constraints import safe_norm
from diffcloth_tpu_torch.core.device import resolve_device


@dataclasses.dataclass
class PrimitiveSet:
    """Array-of-structs for up to P primitives (static scene data).  Only
    `kind` (host numpy, selects code paths) and `mu` are carried so far."""
    kind: np.ndarray         # (P,) int32 (HOST)
    mu: torch.Tensor         # (P,) default friction coefficients


def empty_primitive_set(dtype=torch.float32, device=None) -> PrimitiveSet:
    """On the card unless `device` says otherwise."""
    return PrimitiveSet(kind=np.zeros((0,), np.int32),
                        mu=torch.zeros((0,), dtype=dtype,
                                       device=resolve_device(device)))


@dataclasses.dataclass
class ContactSet:
    """Frozen per-particle obstacle-contact data for one step."""
    mask: torch.Tensor      # (..., n) bool
    normal: torch.Tensor    # (..., n, 3)
    v_out: torch.Tensor     # (..., n, 3)
    prim_id: torch.Tensor   # (..., n) int64


def empty_contact_set(x: torch.Tensor) -> ContactSet:
    return ContactSet(mask=torch.zeros(x.shape[:-1], dtype=torch.bool,
                                       device=x.device),
                      normal=torch.zeros_like(x), v_out=torch.zeros_like(x),
                      prim_id=torch.zeros(x.shape[:-1], dtype=torch.int64,
                                          device=x.device))


def dry_friction_force(normal, d, mu):
    """r(n, d, mu) — take-off / stick / slide case split (reference:
    calcualteDryFrictionForce, Simulation.cpp:829-862; contact.py:223-239).
    Batched over leading dims."""
    sd = torch.sum(d * normal, dim=-1, keepdim=True)      # signed normal mag
    fN = normal * sd
    fT = d - fN
    tnorm = safe_norm(fT)
    t_hat = fT / tnorm
    in_contact = sd < 0.0
    stick = tnorm <= mu[..., None] * torch.abs(sd)
    r_stick = -fN - fT
    r_slide = -fN - mu[..., None] * torch.abs(sd) * t_hat
    r = torch.where(stick, r_stick, r_slide)
    return torch.where(in_contact, r, torch.zeros_like(r))
