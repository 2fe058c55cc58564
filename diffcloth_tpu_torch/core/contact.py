"""Obstacle contact: analytic primitive tests + dry-friction projection.

Counterpart of `diffcloth_tpu/core/contact.py` (reference
`Primitive::isInContact`, Primitive.cpp:67-130 plane, :221-261 sphere,
:360-379 bowl, :570-602 capsule; `calcualteDryFrictionForce`,
Simulation.cpp:829-862).  Every function takes positions with any leading
dims, so a batch of B episodes is a leading (B,) dim; the contact set is
detected once per PD step and FROZEN for the step's sweeps and its adjoint.
Plain PyTorch on tensors: the JAX package computes these outside any Pallas
kernel too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from diffcloth_tpu_torch.core.constraints import safe_norm
from diffcloth_tpu_torch.core.device import resolve_device

# primitive type codes
P_SPHERE = 0
P_PLANE = 1
P_CAPSULE = 2
P_BOWL = 3


@dataclasses.dataclass
class PrimitiveSet:
    """Array-of-structs for P primitives (static scene data).  `kind`,
    `rotates`, `enabled` and `kinematic` are host numpy: they select code
    paths, as in the JAX package."""
    kind: np.ndarray                # (P,) int32 (HOST)
    center: torch.Tensor            # (P,3) pose at t=0
    velocity: torch.Tensor          # (P,3)
    radius: torch.Tensor            # (P,) sphere/capsule/bowl radius
    length: torch.Tensor            # (P,) capsule length
    axis_rot: torch.Tensor          # (P,3,3) capsule local -> world
    plane_normal: torch.Tensor      # (P,3)
    plane_upper_left: torch.Tensor  # (P,3) relative to center
    plane_upper_right: torch.Tensor  # (P,3)
    rotates: np.ndarray             # (P,) bool (HOST) rotating sphere
    mu: torch.Tensor                # (P,) default friction coefficients
    enabled: np.ndarray             # (P,) bool (HOST)
    kinematic: Optional[np.ndarray] = None  # (P,) bool (HOST); None: static

    @property
    def n(self) -> int:
        return int(self.kind.shape[0])

    def replace(self, **kw) -> "PrimitiveSet":
        return dataclasses.replace(self, **kw)

    def to(self, device, dtype) -> "PrimitiveSet":
        """The device fields on `device` in `dtype`."""
        return self.replace(**{
            f.name: getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def empty_primitive_set(dtype=torch.float32, device=None) -> PrimitiveSet:
    """On the card unless `device` says otherwise."""
    kw = dict(dtype=dtype, device=resolve_device(device))

    def z(*s):
        return torch.zeros(s, **kw)

    return PrimitiveSet(
        kind=np.zeros((0,), np.int32), center=z(0, 3), velocity=z(0, 3),
        radius=z(0), length=z(0), axis_rot=z(0, 3, 3), plane_normal=z(0, 3),
        plane_upper_left=z(0, 3), plane_upper_right=z(0, 3),
        rotates=np.zeros((0,), bool), mu=z(0), enabled=np.zeros((0,), bool),
        kinematic=np.zeros((0,), bool))


def prims_at_time(prims: PrimitiveSet, t) -> PrimitiveSet:
    """center(t) = c0 + t v for the kinematic primitives (contact.py:61-77:
    the single-advance semantics); static sets are returned untouched."""
    if (prims.n == 0 or prims.kinematic is None
            or not bool(np.any(prims.kinematic))):
        return prims
    kin = torch.as_tensor(prims.kinematic,
                          device=prims.center.device)[:, None]
    center_t = prims.center + torch.where(kin, t * prims.velocity, 0.0)
    return prims.replace(center=center_t)


@dataclasses.dataclass
class ContactSet:
    """Frozen per-particle obstacle-contact data for one step."""
    mask: torch.Tensor      # (..., n) bool
    normal: torch.Tensor    # (..., n, 3)
    v_out: torch.Tensor     # (..., n, 3)
    prim_id: torch.Tensor   # (..., n) int64 (0 when no contact: masked)


def empty_contact_set(x: torch.Tensor) -> ContactSet:
    return ContactSet(mask=torch.zeros(x.shape[:-1], dtype=torch.bool,
                                       device=x.device),
                      normal=torch.zeros_like(x), v_out=torch.zeros_like(x),
                      prim_id=torch.zeros(x.shape[:-1], dtype=torch.int64,
                                          device=x.device))


def _safe_normalize(v, eps=1e-12):
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def _dot(a, b):
    """Contraction over the last dim (the JAX package's einsum / dot)."""
    return torch.sum(a * b, dim=-1)


def _sphere_test(prims: PrimitiveSet, j, pos):
    """Sphere::isInContact (contact.py:93-105): dist < 0.1; a rotating
    sphere adds (0,1,0) x n * 8 to v_out."""
    rel = pos - prims.center[j]
    dist = torch.linalg.norm(rel, dim=-1) - prims.radius[j]
    normal = _safe_normalize(rel)
    hit = dist < 0.1
    if bool(prims.rotates[j]):
        up = torch.tensor([0.0, 1.0, 0.0], dtype=pos.dtype,
                          device=pos.device).expand_as(normal)
        v_out = prims.velocity[j] + torch.cross(up, normal, dim=-1) * 8.0
    else:
        v_out = prims.velocity[j].expand(pos.shape)
    return hit, normal, dist, v_out


def _plane_test(prims: PrimitiveSet, j, pos):
    """Plane::isInContact (contact.py:108-129): a bounded rectangle,
    |d| <= 0.4, the normal flipped where d < -0.4."""
    rel = pos - prims.center[j]
    nrm = prims.plane_normal[j]
    d = _dot(rel, nrm)
    ul = prims.plane_upper_left[j]
    ur = prims.plane_upper_right[j]
    proj = rel - d[..., None] * nrm
    eu = _safe_normalize(ul + ur)
    ev = _safe_normalize(ur - ul)
    half_u = (torch.abs(_dot(ul + ur, eu)) / 2
              + torch.abs(_dot(ul - ur, eu)) / 2)
    half_v = (torch.abs(_dot(ur - ul, ev)) / 2
              + torch.abs(_dot(ur + ul, ev)) / 2)
    cu = _dot(proj, eu)
    cv = _dot(proj, ev)
    inside = (torch.abs(cu) <= half_u) & (torch.abs(cv) <= half_v)
    hit = inside & (torch.abs(d) <= 0.4)
    normal = torch.where((d < -0.4)[..., None], -nrm, nrm) \
        * torch.ones_like(pos)
    return hit, normal, d, prims.velocity[j].expand(pos.shape)


def _capsule_test(prims: PrimitiveSet, j, pos):
    """Capsule::isInContact (contact.py:132-157): the body and top cap at
    radius + 0.1, the bottom cap at the bare radius, an acceptance window
    r/L beyond both ends, contact at dist < 0.1."""
    L = prims.length[j]
    r = prims.radius[j]
    rot = prims.axis_rot[j]
    base = prims.center[j]
    tip = rot @ (torch.tensor([0.0, 1.0, 0.0], dtype=pos.dtype,
                              device=pos.device) * L)
    rel = pos - base
    t = _dot(rel, tip) / torch.clamp(torch.sum(tip * tip), min=1e-30)
    in_window = (t >= -r / L) & (t <= 1.0 + r / L)
    d_bot = torch.linalg.norm(rel, dim=-1) - r
    d_top = torch.linalg.norm(rel - tip, dim=-1) - (r + 0.1)
    proj = torch.clamp(t, 0.0, 1.0)[..., None] * tip
    d_body = torch.linalg.norm(rel - proj, dim=-1) - (r + 0.1)
    dist = torch.where(t < 0.0, d_bot, torch.where(t > 1.0, d_top, d_body))
    nvec = torch.where((t < 0.0)[..., None], rel,
                       torch.where((t > 1.0)[..., None], rel - tip,
                                   rel - proj))
    hit = in_window & (dist < 0.1)
    return hit, _safe_normalize(nvec), dist, prims.velocity[j].expand(
        pos.shape)


def _bowl_test(prims: PrimitiveSet, j, pos):
    """Bowl::isInContact (contact.py:160-174): a thin lower-hemisphere
    shell, eps 0.005, the normal pointing inward."""
    eps_bowl = 0.005
    rel = pos - prims.center[j]
    rn = torch.linalg.norm(rel, dim=-1)
    dist = rn - prims.radius[j]
    normal = -_safe_normalize(rel)
    lower = pos[..., 1] <= prims.center[j, 1]
    hit = (dist <= eps_bowl) & lower & (rn > prims.radius[j] - eps_bowl)
    return hit, normal, dist, prims.velocity[j].expand(pos.shape)


_TESTS = [_sphere_test, _plane_test, _capsule_test, _bowl_test]


def detect_obstacle_contacts(prims: PrimitiveSet, x: torch.Tensor,
                             v: torch.Tensor, h: float,
                             t=None) -> ContactSet:
    """Per-particle first-hit test against every primitive at x, x + v h/2
    and x + v h (contact.py:180-217; reference isInContactWithObstacle,
    Simulation.cpp:153-191): for one primitive the first sample that hits
    sets the normal and v_out; the earliest enabled primitive in index
    order wins.  `t` (time of the step being produced) advances kinematic
    primitives.  x, v (..., n, 3)."""
    cs = empty_contact_set(x)
    if prims.n == 0:
        return cs
    if t is not None:
        prims = prims_at_time(prims, t)
    mask, normal, v_out, prim_id = cs.mask, cs.normal, cs.v_out, cs.prim_id
    for j in range(prims.n):
        test = _TESTS[int(prims.kind[j])]
        hit_any = torch.zeros_like(mask)
        nrm_j = torch.zeros_like(x)
        vout_j = torch.zeros_like(x)
        for dt in (0.0, 0.5 * h, h):
            hit, nrm, _, vo = test(prims, j, x + v * dt)
            take = (hit & ~hit_any)[..., None]
            nrm_j = torch.where(take, nrm, nrm_j)
            vout_j = torch.where(take, vo, vout_j)
            hit_any = hit_any | hit
        if not bool(prims.enabled[j]):
            continue
        new = hit_any & ~mask
        mask = mask | new
        normal = torch.where(new[..., None], nrm_j, normal)
        v_out = torch.where(new[..., None], vout_j, v_out)
        prim_id = torch.where(new, j, prim_id)
    return ContactSet(mask, normal, v_out, prim_id)


# ---------------------------------------------------------------------------
# dry friction (Signorini-Coulomb projection)

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


def obstacle_friction(f, contact: ContactSet, mass, mu_prims):
    """Layer-0 obstacle friction r_i = friction(n_i, f_i - m_i v_out,
    mu[prim_i]) on the contact particles (contact.py:242-248; reference
    calculateDryFrictionVector, Simulation.cpp:639-651).  f (..., n, 3),
    mass (..., n), mu_prims (..., P): a batch gathers each episode's own
    coefficients, so dL/dmu stays per episode.  The coefficient is picked
    by a one-hot contraction, whose backward sums over the particles in a
    fixed order: a gather's backward scatters with atomic adds, whose
    order (and so dL/dmu's last bits) changes from run to run on the
    card."""
    d = f - mass[..., None] * contact.v_out
    pick = contact.prim_id[..., None] == torch.arange(
        mu_prims.shape[-1], device=mu_prims.device)
    mu = torch.sum(torch.where(pick, mu_prims[..., None, :], 0.0), dim=-1)
    r = dry_friction_force(contact.normal, d, mu)
    return torch.where(contact.mask[..., None], r, 0.0)
