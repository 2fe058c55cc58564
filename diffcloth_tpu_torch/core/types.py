"""Device-side state: static scene tensors, differentiable parameters,
per-step records.

Counterpart of `diffcloth_tpu/core/types.py`.  The JAX NamedTuples become
dataclasses of torch tensors; where JAX vmaps, every tensor here may carry
an explicit leading batch dim instead (see `SimParams.batch_size`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from diffcloth_tpu_torch.core.device import resolve_device

@dataclasses.dataclass
class StageDev:
    """One attachment stage's device tensors (one reference `sysMat`)."""
    attach_idx: torch.Tensor     # (F,1) int64 row indices (cloth vertex)
    attach_w: torch.Tensor       # (F,1)
    fixed_pos_rest: torch.Tensor  # (F,3)
    spline_p0: torch.Tensor      # (F,3)
    spline_yup: torch.Tensor     # (F,)


@dataclasses.dataclass
class SceneDev:
    """Static (non-differentiated) scene tensors."""
    tri_idx: torch.Tensor        # (T,3) int64
    tri_inv_duv: torch.Tensor    # (T,2,2)
    tri_area: torch.Tensor       # (T,)
    s_rows_idx: torch.Tensor     # (2T,3) int64
    s_rows_w: torch.Tensor       # (2T,3)
    sp_rows_idx: torch.Tensor    # (S,2) int64
    sp_rows_w: torch.Tensor      # (S,2)
    sp_l0: torch.Tensor          # (S,)
    b_rows_idx: torch.Tensor     # (Bn,4) int64
    b_rows_w: torch.Tensor       # (Bn,4)
    b_w_vert: torch.Tensor       # (Bn,4)
    b_n_rest: torch.Tensor       # (Bn,)
    b_sw: torch.Tensor           # (Bn,)
    area: torch.Tensor           # (n,) lumped areas
    radii: torch.Tensor          # (n,)
    x_rest: torch.Tensor         # (n,3)
    wind_falloff: torch.Tensor   # (n,3), ones unless WIND_SIN_AND_FALLOFF


# unbatched rank of every SimParams field
_PARAM_RANK = {"k_pertype": 1, "density": 0, "wind": 1, "wind_freq": 0,
               "wind_phase": 0, "x0": 2, "v0": 2, "spline": 2, "mu": 1,
               "force_field": 2, "wind_perstep": 1}


@dataclasses.dataclass
class SimParams:
    """All differentiable simulation parameters (reference `ParamInfo`,
    Simulation.h:120-133).  Unbatched shapes below; a batched SimParams
    carries a leading (B,) dim on EVERY field."""
    k_pertype: torch.Tensor      # (4,) [spring, attach, stretch, bend]
    density: torch.Tensor        # ()
    wind: torch.Tensor           # (3,) full wind vector (dir * norm)
    wind_freq: torch.Tensor      # ()
    wind_phase: torch.Tensor     # ()
    x0: torch.Tensor             # (n,3) initial positions
    v0: torch.Tensor             # (n,3) initial velocities
    spline: torch.Tensor         # (F,9) per-fixed-point [p1, m0, m1]
    mu: torch.Tensor             # (n_prims,) friction coefficients
    force_field: torch.Tensor    # (n,3) constant per-particle force
    wind_perstep: torch.Tensor   # (N+1,) per-step wind factor

    @property
    def batch_size(self) -> Optional[int]:
        """B for a batched SimParams, None for a single one."""
        return self.x0.shape[0] if self.x0.dim() == 3 else None

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)

    def items(self):
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)]

    def expand(self, batch: int) -> "SimParams":
        """Single -> batched: `batch` copies along a new leading dim."""
        assert self.batch_size is None, "already batched"
        return SimParams(**{k: v.unsqueeze(0).repeat(
            (batch,) + (1,) * v.dim()) for k, v in self.items()})

    def as_batched(self) -> "SimParams":
        """Batched view (B = 1 for a single SimParams)."""
        if self.batch_size is not None:
            return self
        return SimParams(**{k: v.unsqueeze(0) for k, v in self.items()})

    def sample(self, i: int) -> "SimParams":
        assert self.batch_size is not None, "not batched"
        return SimParams(**{k: v[i] for k, v in self.items()})


@dataclasses.dataclass
class StepRecord:
    """Per-step outputs stacked over the episode (reference
    `ForwardInformation`).  Single episode: (N, ...); batched: (B, N, ...)."""
    x: torch.Tensor               # (N,n,3)
    v: torch.Tensor               # (N,n,3)
    f: torch.Tensor               # (N,n,3) contact-solve force term
    r: torch.Tensor               # (N,n,3) friction force
    x_fixed: torch.Tensor         # (N,F,3)
    converged: torch.Tensor       # (N,) bool
    iters: torch.Tensor           # (N,) int32
    avg_deformation: torch.Tensor  # (N,)
    max_deformation: torch.Tensor  # (N,) max per-triangle area ratio
    selfcol_overflow: torch.Tensor  # (N,) bool — self-contact capacity
    #                                  exceeded this step
    selfcol_pairs: torch.Tensor   # (N,) int32 self-contact pairs detected
    #                               (port-only diagnostic)
    selfcol_slots: torch.Tensor   # (N,) int32 friction slots active after
    #                               the budget drop (port-only diagnostic)
    obstacle_contacts: torch.Tensor  # (N,) int64 particles in obstacle
    #                                  contact (port-only diagnostic)
    cg_iters: torch.Tensor        # (N,) int32 CG iterations over the
    #                               step's PD sweeps (0 with a dense solve;
    #                               port-only diagnostic)


@dataclasses.dataclass
class EpisodeRecords:
    """Full-episode output: the initial frame travels separately from the
    stacked steps (frame i is x0 for i = 0 and steps.x[i-1] otherwise),
    exactly as in the JAX package."""
    x0: torch.Tensor
    v0: torch.Tensor
    steps: StepRecord

    @property
    def batched(self) -> bool:
        return self.x0.dim() == 3

    def frame_x(self, i: int):
        if i == 0:
            return self.x0
        return self.steps.x[:, i - 1] if self.batched else self.steps.x[i - 1]

    @property
    def n_frames(self):
        return self.steps.x.shape[-3] + 1

    def full_x(self):
        """(N+1, n, 3) (batched: (B, N+1, n, 3)) stacked trajectory."""
        ax = 1 if self.batched else 0
        return torch.cat([self.x0.unsqueeze(ax), self.steps.x], dim=ax)

    def full_v(self):
        ax = 1 if self.batched else 0
        return torch.cat([self.v0.unsqueeze(ax), self.steps.v], dim=ax)


def make_sim_params(n: int, n_fixed: int, n_prims: int, n_steps: int,
                    dtype=torch.float32, device=None,
                    k_stretch: float = 100.0, k_bend: float = 0.0,
                    k_attach: float = 10000.0, k_spring: float = 0.0,
                    density: float = 0.054) -> SimParams:
    """Defaults: attachment stiffness is the reference AttachmentSpring::k_stiff
    default (diffcloth_tpu/core/types.py:111-130); the card unless `device`
    says otherwise."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    z3 = torch.zeros((n, 3), **kw)
    return SimParams(
        k_pertype=torch.tensor([k_spring, k_attach, k_stretch, k_bend], **kw),
        density=torch.tensor(density, **kw),
        wind=torch.zeros((3,), **kw),
        wind_freq=torch.tensor(14.0, **kw),
        wind_phase=torch.tensor(0.0, **kw),
        x0=z3, v0=z3.clone(),
        spline=torch.zeros((n_fixed, 9), **kw),
        mu=torch.zeros((max(n_prims, 1),), **kw),
        force_field=z3.clone(),
        wind_perstep=torch.ones((n_steps + 1,), **kw),
    )
