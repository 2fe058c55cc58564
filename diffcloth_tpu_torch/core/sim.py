"""Episode runner: device scene assembly, attachment trajectories, the
rollout and its gradient, single or batched.

Counterpart of `diffcloth_tpu/core/sim.py` for single-stage scenes, with
or without obstacles:
`scene_to_device`, `stage_to_device`, `ClothSim.default_params`, `p_inv`,
`x_fixed_seq`, `simulate` / `rollout` with the explosion freeze,
`rollout_chunked`, `episode_loss` and `episode_value_and_grad`.  The JAX
`lax.scan` over steps is a Python loop; `vmap` over a population of
episodes is a leading batch dim on the `SimParams` (one shared P^{-1}, as
the JAX package's batched paths share it).  Eager PyTorch runs no device
program longer than one kernel, so the JAX package's `_chunked` variants
(bounded device executions of `chunk` steps) fold into these single
functions.  Self-collision always runs the kernel pipeline that the JAX
package selects on a TPU (symmetric detection kernel -> layering -> slot
geometry -> friction sweep kernels, forward and backward).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from diffcloth_tpu_torch.config import (SimFlags, SplineType,
                                        TrajectoryConfig, WindConfig)
from diffcloth_tpu_torch.core import contact as ct
from diffcloth_tpu_torch.core import dense_ops as dn
from diffcloth_tpu_torch.core import diagnostics as diag
from diffcloth_tpu_torch.core import selfcol as sc
from diffcloth_tpu_torch.core import selfcol_cuda as scd
from diffcloth_tpu_torch.core import solver as slv
from diffcloth_tpu_torch.core import spline as spl
from diffcloth_tpu_torch.core import step as step_mod
from diffcloth_tpu_torch.core.device import resolve_device
from diffcloth_tpu_torch.core.types import (EpisodeRecords, SceneDev,
                                            SimParams, StageDev, StepRecord,
                                            make_sim_params)
from diffcloth_tpu_torch.geometry import builder as gb

# self-collision capacities, the JAX ClothSim's defaults: partner slots per
# row (detection), layering rounds, and layers given a friction budget
SELF_K_PARTNERS = 8
SELF_MAX_LAYERS = 16
SELF_COMPACT_LAYERS = 4


def set_full_f32_matmul() -> None:
    """Full-f32 products on the card (no TF32), the counterpart of the JAX
    package's Precision.HIGHEST (dense_ops.py:41, step.py:143-148)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _wind_falloff(scene: gb.Scene) -> np.ndarray:
    """Per-particle wind attenuation min(1/|focus - x|, 1) (reference
    sim2real setup, Simulation.cpp:3125-3131)."""
    focus = getattr(scene.cfg, "wind_falloff_focus", None)
    if focus is None:
        return np.ones((scene.n, 3))
    dist = np.linalg.norm(np.asarray(focus)[None, :] - scene.x_rest, axis=-1)
    fall = np.minimum(1.0 / np.maximum(dist, 1e-12), 1.0)
    return np.repeat(fall[:, None], 3, axis=1)


def scene_to_device(scene: gb.Scene, dtype=torch.float32,
                    device=None) -> SceneDev:
    device = resolve_device(device)
    s_rows = gb.stretch_rows(scene.triangle)
    b_rows = gb.bend_rows(scene.bending)
    sp_rows = gb.spring_rows(scene.springs)

    def f(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return SceneDev(
        tri_idx=i(scene.triangle.idx), tri_inv_duv=f(scene.triangle.inv_duv),
        tri_area=f(scene.triangle.area),
        s_rows_idx=i(s_rows.idx), s_rows_w=f(s_rows.w),
        sp_rows_idx=i(sp_rows.idx), sp_rows_w=f(sp_rows.w),
        sp_l0=f(scene.springs.l0),
        b_rows_idx=i(b_rows.idx), b_rows_w=f(b_rows.w),
        b_w_vert=f(scene.bending.w_vert), b_n_rest=f(scene.bending.n_rest),
        b_sw=f(np.sqrt(3.0 / np.maximum(scene.bending.area_sum, 1e-30))),
        area=f(scene.area), radii=f(scene.radii), x_rest=f(scene.x_rest),
        wind_falloff=f(_wind_falloff(scene)))


def stage_to_device(stage: gb.AttachmentStage, dtype=torch.float32,
                    device=None) -> StageDev:
    device = resolve_device(device)
    a_rows = gb.attach_rows(stage)

    def f(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    return StageDev(
        attach_idx=torch.as_tensor(a_rows.idx.astype(np.int64),
                                   device=device),
        attach_w=f(a_rows.w), fixed_pos_rest=f(stage.fixed_pos_rest),
        spline_p0=f(stage.spline_p0), spline_yup=f(stage.spline_yup))


class ClothSim:
    """A built scene with its forward step and episode functions (one
    instance per mesh topology, scene config, dtype and device).

    `device` defaults to "cuda" and raises when no card is present; pass
    device="cpu" to run the plain PyTorch versions of the kernels.  `prims`
    are the scene's obstacles (none by default; moved to the sim's device
    and dtype), `spline_type` the attachment splines' parametrization."""

    def __init__(self, scene: gb.Scene, *, flags: Optional[SimFlags] = None,
                 prims: Optional[ct.PrimitiveSet] = None,
                 spline_type: SplineType = SplineType.ENDPOINT,
                 device=None, dtype=torch.float32):
        self.device = resolve_device(device)
        set_full_f32_matmul()
        if len(scene.stages) != 1:
            raise NotImplementedError(
                "multi-stage attachment scenes are not ported yet")
        cfg = scene.cfg
        self.scene_host = scene
        self.cfg = cfg
        self.dtype = dtype
        self.spline_type = spline_type
        self.flags = flags or SimFlags(
            wind_enabled=cfg.wind_config != WindConfig.NO_WIND)
        self.h = cfg.time_step
        self.n = scene.n
        self.n_steps = cfg.step_num
        # f32 cannot resolve displacement deltas below ~1e-7 of |x|; floor
        # the forward tolerance (sim.py:141-147); f64 keeps the config's
        eps_f = cfg.forward_convergence_thresh
        if dtype == torch.float32:
            eps_f = max(eps_f, 1e-6)
        self.eps_forward = eps_f
        self.eps_backward = cfg.backward_convergence_thresh

        dev = self.device
        self.scene_dev = scene_to_device(scene, dtype, dev)
        self.stage_host = scene.stages[0]
        self.stage_dev = stage_to_device(self.stage_host, dtype, dev)
        self.prims = (ct.empty_primitive_set(dtype, dev) if prims is None
                      else prims.to(dev, dtype))
        self.n_prims = self.prims.n
        area64 = np.asarray(scene.area, np.float64)
        self._p_inv_fn = slv.make_host_p_inv_fn(
            slv.dense_gram_matrices(scene)[0], area64, self.h, dtype, dev)
        self.dense = dn.build_dense_ops(scene, self.stage_host, dtype, dev)

        self.self_cfg = None
        if (self.flags.contact_enabled and self.flags.self_collision_enabled
                and scene.n > 1):
            # the reference enables self-collision for every demo
            # (OptimizationTaskSetup.cpp:154-224); the SYMMETRIC table makes
            # each row's partner slots its complete contact incidence
            allowed = ~scene.conn_table & ~np.eye(scene.n, dtype=bool)
            budgets = sc.compact_slot_budgets(SELF_COMPACT_LAYERS)
            self.self_cfg = step_mod.SelfColConfig(
                allowed=torch.as_tensor(scd.pack_allowed(allowed),
                                        device=dev),
                k_partners=SELF_K_PARTNERS, max_layers=SELF_MAX_LAYERS,
                budgets=tuple(min(c, scene.n) for c in budgets))

        self.step, self.residual = step_mod.make_step(
            self.scene_dev, self.dense, self.prims, h=self.h,
            wind_config=cfg.wind_config, flags=self.flags,
            eps_forward=self.eps_forward, eps_backward=self.eps_backward,
            self_cfg=self.self_cfg)
        self.bwd_stats = self.step.bwd_stats

    # ------------------------------------------------------------------ params

    def default_params(self) -> SimParams:
        fab = self.cfg.fabric
        p = make_sim_params(
            self.n, n_fixed=len(self.stage_host.particle_idx),
            n_prims=max(self.n_prims, 1), n_steps=self.n_steps,
            dtype=self.dtype, device=self.device,
            k_stretch=fab.k_stiff_stretching, k_bend=fab.k_stiff_bending,
            density=fab.density)
        if self.n_prims > 0:
            p = p.replace(mu=self.prims.mu.clone())
        sd = self.stage_dev
        return p.replace(
            x0=self.scene_dev.x_rest.clone(),
            v0=torch.as_tensor(self.scene_host.v_init).to(self.device,
                                                          self.dtype),
            spline=spl.default_params_from_endpoints(
                sd.spline_p0,
                torch.as_tensor(self.stage_host.spline_p1).to(self.device,
                                                              self.dtype),
                sd.spline_yup))

    def p_inv(self, params: SimParams) -> torch.Tensor:
        """Refactorize the PD system for a parameter guess (the analogue of
        resetSystemWithParams).  A batched SimParams shares sample 0's
        P^{-1}: k_pertype and density must agree across the batch."""
        p = params.sample(0) if params.batch_size is not None else params
        return self._p_inv_fn(p.k_pertype, p.density)

    # -------------------------------------------------------- fixed trajectory

    def x_fixed_seq(self, params: SimParams) -> torch.Tensor:
        """(N, F, 3) clip positions for steps 1..N (stepFixPoints,
        Simulation.cpp:964-1018); batched params -> (B, N, F, 3)."""
        N = self.n_steps
        fracs = torch.arange(1, N + 1, dtype=self.dtype,
                             device=self.device) / N
        sd = self.stage_dev
        F = len(self.stage_host.particle_idx)
        traj = self.cfg.trajectory
        B = params.batch_size
        lead = (N, F, 3) if B is None else (B, N, F, 3)
        if F == 0 or traj == TrajectoryConfig.NO_TRAJECTORY:
            return sd.fixed_pos_rest.expand(lead).clone()
        if traj in (TrajectoryConfig.CORNERS_2_UP,
                    TrajectoryConfig.CORNERS_2_WEARHAT,
                    TrajectoryConfig.CORNERS_1_WEARHAT,
                    TrajectoryConfig.CORNERS_2_WEARSOCK):
            return spl.eval_splines(self.spline_type, params.spline,
                                    sd.spline_p0, sd.spline_yup, fracs)
        raise NotImplementedError(f"trajectory {traj} is not ported yet")

    # ---------------------------------------------------------------- episode

    def simulate(self, params: SimParams, p_inv: torch.Tensor,
                 x_fixed_seq: torch.Tensor,
                 record_forces: bool = True) -> EpisodeRecords:
        """Full rollout: frame 0 (the initial state) plus the stacked records
        of steps 1..N.  Single or batched params (then x_fixed_seq is
        (B, N, F, 3) and every record carries a leading B).  Once an episode
        explodes its remaining steps pass the state through unchanged
        (Simulation.cpp:1415-1424)."""
        batched = params.batch_size is not None
        pb = params.as_batched()
        xfs = x_fixed_seq if batched else x_fixed_seq[None]
        B = pb.x0.shape[0]
        x, v = pb.x0, pb.v0
        frozen = torch.zeros(B, dtype=torch.bool, device=x.device)
        diag_keys = ("converged", "iters", "avg_deformation",
                     "max_deformation", "selfcol_overflow", "selfcol_pairs",
                     "selfcol_slots", "obstacle_contacts")
        cols = {k: [] for k in ("x", "v", "f", "r") + diag_keys}
        for i in range(1, self.n_steps + 1):
            t = torch.tensor(float(i), dtype=self.dtype,
                             device=self.device) * self.h
            x2, v2, aux = self.step(x, v, pb, xfs[:, i - 1], p_inv, t, i)
            frozen = frozen | diag.is_exploded(x2, v2)
            fz = frozen[:, None, None]
            x2 = torch.where(fz, x, x2)
            v2 = torch.where(fz, v, v2)
            cols["x"].append(x2)
            cols["v"].append(v2)
            if record_forces:
                cols["f"].append(aux.f)
                cols["r"].append(aux.r)
            for k in diag_keys:
                cols[k].append(getattr(aux, k))
            x, v = x2, v2
        st = {k: torch.stack(c, dim=1) for k, c in cols.items() if c}
        if not record_forces:   # a stride-0 view: no (B, N, n, 3) storage
            st["f"] = st["r"] = st["x"].new_zeros(()).expand(st["x"].shape)
        st["x_fixed"] = xfs
        steps = StepRecord(**st)
        if not batched:
            steps = StepRecord(**{k: getattr(steps, k)[0]
                                  for k in st})
        return EpisodeRecords(x0=params.x0, v0=params.v0, steps=steps)

    def rollout(self, params: SimParams) -> EpisodeRecords:
        """Refactorize + trajectory + simulate; params single or batched."""
        return self.simulate(params, self.p_inv(params),
                             self.x_fixed_seq(params))

    def rollout_chunked(self, params: SimParams) -> EpisodeRecords:
        """`rollout` whose records leave f / r zero-filled, as the JAX
        package's chunked rollout does (no consumer outside the viewer
        overlays reads them), saving their (N, n, 3) storage.  It takes no
        chunk length: eager PyTorch runs no device program longer than one
        kernel, so there is nothing to split."""
        return self.simulate(params, self.p_inv(params),
                             self.x_fixed_seq(params), record_forces=False)

    def episode_loss(self, loss_fn):
        """Forward-only loss: params (single or batched) -> loss (a scalar,
        or (B,) for batched params, with one shared P^{-1}).  `loss_fn`
        maps records to losses (see losses.py)."""
        def value(params: SimParams):
            with torch.no_grad():
                return loss_fn(self.rollout_chunked(params))
        return value

    def episode_value_and_grad(self, loss_fn):
        """params -> (loss, dparams), single or batched (batched: (B,)
        losses and a batched SimParams of gradients, every episode's
        gradient its own; one P^{-1}, from sample 0, serves the batch, so
        k_pertype and density must agree across it).

        P^{-1} enters as data: gradients to k and density flow through the
        step's operator-form residual, not through P^{-1}, which only
        preconditions (sim.py:777-800).  The gradient chains through
        `x_fixed_seq` into the spline params, through the explosion freeze
        (a select, so a frozen episode passes zero cotangents) and into x0
        and v0.  `value_and_grad.split` holds the forward and backward wall
        seconds of the last call."""
        def value_and_grad(params: SimParams):
            p_inv = self.p_inv(params)
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in params.items()}
            p = SimParams(**leaves)
            t0 = time.perf_counter()
            with torch.enable_grad():
                recs = self.simulate(p, p_inv, self.x_fixed_seq(p),
                                     record_forces=False)
                loss = loss_fn(recs)
                _sync(self.device)
                t1 = time.perf_counter()
                grads = torch.autograd.grad(loss.sum(),
                                            list(leaves.values()),
                                            allow_unused=True)
            _sync(self.device)
            value_and_grad.split = {"forward_s": t1 - t0,
                                    "backward_s": time.perf_counter() - t1}
            return loss.detach(), SimParams(**{
                k: torch.zeros_like(v) if g is None else g
                for (k, v), g in zip(leaves.items(), grads)})

        value_and_grad.split = None
        return value_and_grad


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
