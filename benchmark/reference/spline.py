"""Cubic-Hermite control-point trajectories.

Counterpart of `diffcloth_tpu/core/spline.py` (reference Spline.h: basis
:201-243, evaluate :322-330).  All demo splines are single-segment with
startFraction 0 and endFraction 1.
"""
from __future__ import annotations

import torch

from benchmark.reference.config import SplineType


def hermite_basis(t):
    """h00, h10, h01, h11 at t (reference: Spline.h:201-243)."""
    t2 = t * t
    t3 = t2 * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    return h00, h10, h01, h11


def tangents_from_endpoint(p0, p1, yup):
    """m0 = p1 - p0 + yup e_y;  m1 = p1 - p0 - yup e_y (Spline.h:42-45)."""
    d = p1 - p0
    z = torch.zeros_like(yup)
    up = torch.stack([z, yup, z], dim=-1)
    return d + up, d - up


def unpack_params(spline_type: SplineType, params, p0, yup):
    """params: (..., F, 9) [p1, m0, m1] slots; inactive slots ignored."""
    p1 = params[..., 0:3]
    if spline_type == SplineType.ENDPOINT:
        m0, m1 = tangents_from_endpoint(p0, p1, yup)
    elif spline_type == SplineType.ENDPOINT_AND_UP:
        m0, m1 = tangents_from_endpoint(p0, p1, params[..., 3])
    else:  # ENDPOINT_AND_TANGENTS
        m0 = params[..., 3:6]
        m1 = params[..., 6:9]
    return p1, m0, m1


def eval_splines(spline_type: SplineType, params, p0, yup, t_frac):
    """Evaluate the F splines at the fractions t_frac (L,).
    params (F,9) -> (L, F, 3); batched params (B,F,9) -> (B, L, F, 3)."""
    t = torch.clamp(t_frac, 0.0, 1.0)
    p1, m0, m1 = unpack_params(spline_type, params, p0, yup)
    h00, h10, h01, h11 = (h[:, None, None] for h in hermite_basis(t))
    if params.dim() == 3:
        p1, m0, m1 = (a[:, None] for a in (p1, m0, m1))
    return h00 * p0 + h10 * m0 + h01 * p1 + h11 * m1


def default_params_from_endpoints(p0, p1, yup):
    """Spline params equivalent to the reference ENDPOINT construction,
    in the 9-dof slot layout."""
    m0, m1 = tangents_from_endpoint(p0, p1, yup)
    return torch.cat([p1, m0, m1], dim=-1)
