"""Episode runner: device scene assembly, attachment trajectories, the
rollout and its gradient, single or batched.

Counterpart of `diffcloth_tpu/core/sim.py`, with or without obstacles,
with one attachment stage or several:
`scene_to_device`, `stage_to_device`, `ClothSim.default_params`, `p_inv`,
`x_fixed_seq` (the splines and the dress twirl), `simulate` / `rollout`
with the explosion freeze, `episode_loss` and `episode_value_and_grad`,
and their chunked variants `rollout_chunked`, `episode_loss_chunked` and
`episode_value_and_grad_chunked` (sim.py:475-775): the horizon in chunks
of `chunk` steps, the backward recomputing each chunk's forward from its
saved start, so a gradient holds one chunk's step residuals.  The JAX
`lax.scan` over steps is a Python loop; `vmap` over a population of
episodes is a leading batch dim on the `SimParams` (one shared P^{-1}, as
the JAX package's batched paths share it).  On the card a step is one
launch of its captured device programs (`core/graphs.py`), whose loops end
on the device: inside a chunk the host waits on nothing.

A scene of several attachment stages (reference: one `sysMat` per stage,
switched by frame, Simulation.h:361-405, Simulation.cpp:1053-1068) gets
one step, operator set and P^{-1} per stage, as the JAX ClothSim does
(sim.py:152-201, 281-318); the loop picks the stage of each frame and the
adjoint follows through autograd across the switch.  Like the JAX
package's batched routes, which have no multi-stage form, a batched
episode of such a scene raises.

`ClothSim` picks its algorithms by mesh size at the JAX package's
thresholds (sim.py:183-300): the dense P^{-1} up to n = 8000 and
Jacobi-PCG past it; dense operators while they take at most 300 MB and
the scatter-free sparse operators past that; self-collision detection by
the kernel up to n = 10000 and by the sort-based sweep past it.  Either
detection feeds the same layering, slot geometry and friction sweep
kernels, forward and backward.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from diffcloth_tpu_torch.config import (SimFlags, SplineType,
                                        TrajectoryConfig, WindConfig,
                                        pd_total_iters)
from diffcloth_tpu_torch.core import contact as ct
from diffcloth_tpu_torch.core import dense_ops as dn
from diffcloth_tpu_torch.core import diagnostics as diag
from diffcloth_tpu_torch.core import graphs as gr
from diffcloth_tpu_torch.core import selfcol as sc
from diffcloth_tpu_torch.core import selfcol_cuda as scd
from diffcloth_tpu_torch.core import solver as slv
from diffcloth_tpu_torch.core import sparse_ops as spo
from diffcloth_tpu_torch.core import spline as spl
from diffcloth_tpu_torch.core import step as step_mod
from diffcloth_tpu_torch.core.device import resolve_device
from diffcloth_tpu_torch.core.types import (EpisodeRecords, SceneDev,
                                            SimParams, StageDev, StepRecord,
                                            make_sim_params)
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.utils import timing as tm

# self-collision capacities, the JAX ClothSim's defaults: partner slots per
# row (detection on its kernel route), layering rounds, and layers given a
# friction budget
SELF_K_PARTNERS = 8
SELF_MAX_LAYERS = 16
SELF_COMPACT_LAYERS = 4
# the JAX ClothSim's size switches: the CG solve past DENSE_SOLVE_MAX_N
# vertices, the sweep past SWEEP_MIN_N (and always past KERNEL_MAX_N,
# where int32 canonical pair ids overflow in the JAX package), sparse
# operators past DENSE_OPS_MAX_BYTES of dense ones
DENSE_SOLVE_MAX_N = 8000
SWEEP_MIN_N = 10000
KERNEL_MAX_N = 46340
DENSE_OPS_MAX_BYTES = 300 * 1024 * 1024


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


def dense_ops_bytes(scene: gb.Scene) -> int:
    """The JAX package's estimate of the dense operators' f32 bytes for one
    stage (sim.py:283-285), the gate of the sparse operators."""
    T2 = 2 * len(scene.triangle.area)
    Bn = len(scene.bending.n_rest)
    return 4 * (2 * T2 * scene.n + 2 * Bn * scene.n + 3 * scene.n * scene.n)


def self_budgets(n: int, max_layers: int, compact_layers: int,
                 budgets: Optional[tuple]) -> tuple:
    """The per-layer friction slot budgets, as the JAX step's
    `_compact_budgets` (step.py:440-443): `budgets` or
    `compact_slot_budgets(min(compact_layers, max_layers))`, each capped at
    n.  Raises ValueError where the JAX package would fail: max_layers
    below 1, a budget that is not a non-negative int, or more budgets than
    layering rounds (the slot geometry reads a layer per budget)."""
    if not (isinstance(max_layers, int) and max_layers >= 1):
        raise ValueError(f"self_max_layers {max_layers!r}: at least 1")
    if not isinstance(compact_layers, int):
        raise ValueError(f"self_compact_layers {compact_layers!r}: an int")
    budgets = budgets or sc.compact_slot_budgets(min(compact_layers,
                                                     max_layers))
    if not all(isinstance(c, (int, np.integer)) and c >= 0
               for c in budgets):
        raise ValueError(f"self_compact_budgets {budgets!r}: non-negative "
                         f"ints")
    if len(budgets) > max_layers:
        raise ValueError(f"self_compact_budgets: {len(budgets)} budgets for "
                         f"{max_layers} layering rounds")
    return tuple(min(int(c), n) for c in budgets)


class ClothSim:
    """A built scene with its forward step and episode functions (one
    instance per mesh topology, scene config, dtype and device).

    `device` defaults to "cuda" and raises when no card is present; pass
    device="cpu" to run the plain PyTorch versions of the kernels.  `prims`
    are the scene's obstacles (none by default; moved to the sim's device
    and dtype), `spline_type` the attachment splines' parametrization.

    The JAX ClothSim's size switches, with its defaults and thresholds:
    `solve_mode` ("dense" up to n = 8000, else "cg", with `cg_max_iters`
    and `cg_rtol`), `dense_ops` / `sparse_ops` (dense while the dense
    operators take at most 300 MB; sparse_ops=True forces the sparse ones)
    and `self_method` ("kernel" up to n = 10000, else "sweep", with
    `self_window` and `self_cap_pairs`; the JAX package's "pallas" and
    "matrix" are "kernel" here and raise).  The choices are recorded as
    `solve_mode`, `dense`, `sparse` and `self_cfg.method`; with several
    attachment stages `dense` / `sparse` / `step` are stage 0's and
    `dense_list` / `sparse_list` / `steps` hold every stage's.

    The JAX ClothSim's solver arguments: `eps_forward` / `eps_backward`
    (None: the scene's thresholds; in f32 the forward one is floored at
    1e-6, an override too), `max_forward_iters` (None: the flags', else
    -log10(eps_forward) * 150), `plateau_window` and `solve_fn` (see
    core/step.make_step; the tensor-parallel solve of parallel/mesh.py).

    `cuda_graphs`, the counterpart of the JAX package's jit: None runs each
    step's forward and adjoint as captured device programs whose loops end
    on the device (`core/graphs.py`) on a CUDA device, and uncaptured on
    the CPU or with a `solve_fn` other than the tensor-parallel one; True
    raises on the CPU or with such a `solve_fn`; False runs the same
    segments uncaptured on the card
    (`jax.disable_jit()`).  The choice is `self.cuda_graphs`; each stage's
    step keeps its programs (`self.graphs`), dropped with the sim.

    Self-collision capacity, the JAX ClothSim's options with its defaults
    and meanings (sim.py:102-108, step.py:440-451): `self_k_partners`
    partner slots per row (None: 8; 1-127 with the detection kernel),
    `self_max_layers` layering rounds, `self_compact_layers` the layers
    given a friction slot budget and `self_compact_budgets` the budgets
    (None: `selfcol.compact_slot_budgets(min(compact_layers,
    max_layers))`, 256, 128, 64, 64 for four), each capped at n; a layer
    past its budget, or a layer past the last budget, drops contacts and
    raises `StepAux.selfcol_overflow`.  `(n,) * 16` with 16 compact
    layers drops none (the sweeps then stream their slot rows from global
    memory, `friction_cuda.sweep_operands`).  `self_ablate` ("nofric" or
    "detect_only", see `step.SelfColConfig`) is a profiling knob whose
    steps are not physical.  The choices are `self_cfg`.
    Not ported, and raising: the gather/scatter operator path
    (dense_ops=False with sparse_ops=False); the JAX ClothSim's options
    that choose between TPU implementations of one function
    (`self_friction_unroll`, `self_friction_impl`) are not arguments
    here."""

    def __init__(self, scene: gb.Scene, *, flags: Optional[SimFlags] = None,
                 prims: Optional[ct.PrimitiveSet] = None,
                 spline_type: SplineType = SplineType.ENDPOINT,
                 device=None, dtype=torch.float32,
                 solve_mode: Optional[str] = None, cg_max_iters: int = 64,
                 cg_rtol: float = 1e-6, dense_ops: Optional[bool] = None,
                 sparse_ops: Optional[bool] = None,
                 self_method: Optional[str] = None, self_window: int = 48,
                 self_cap_pairs: Optional[int] = None,
                 self_k_partners: Optional[int] = None,
                 self_max_layers: int = SELF_MAX_LAYERS,
                 self_compact_layers: int = SELF_COMPACT_LAYERS,
                 self_compact_budgets: Optional[tuple] = None,
                 self_ablate: str = "",
                 eps_forward: Optional[float] = None,
                 eps_backward: Optional[float] = None,
                 max_forward_iters: Optional[int] = None,
                 plateau_window: int = step_mod.PLATEAU_WINDOW,
                 solve_fn=None, cuda_graphs: Optional[bool] = None):
        self.device = resolve_device(device)
        self.cuda_graphs = gr.resolve(cuda_graphs, self.device, solve_fn)
        set_full_f32_matmul()
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
        # the forward tolerance (sim.py:141-150); f64 keeps the config's
        eps_f = (cfg.forward_convergence_thresh if eps_forward is None
                 else eps_forward)
        if dtype == torch.float32:
            eps_f = max(eps_f, 1e-6)
        self.eps_forward = eps_f
        self.eps_backward = (cfg.backward_convergence_thresh
                             if eps_backward is None else eps_backward)
        self.max_forward_iters = (max_forward_iters
                                  or self.flags.max_forward_iters
                                  or pd_total_iters(eps_f))

        dev = self.device
        self.scene_dev = scene_to_device(scene, dtype, dev)
        self.stages_host = list(scene.stages)
        self.stage_devs = [stage_to_device(st, dtype, dev)
                           for st in self.stages_host]
        self.stage_host, self.stage_dev = self.stages_host[0], \
            self.stage_devs[0]
        self.n_stages = len(self.stages_host)
        self.max_fixed = max(len(st.particle_idx) for st in self.stages_host)
        # frames k in 1..N run stage s on [lo, hi): stage i is active from
        # its start_frame on, the last one wins (Simulation.cpp:1053-1056;
        # JAX sim.py:166-179)
        starts = [st.start_frame for st in self.stages_host]
        if starts != sorted(starts):
            raise ValueError("attachment stages must be ordered by "
                             "start_frame")
        self.segments = []
        for st in range(self.n_stages):
            lo = max(starts[st], 1)
            hi = (starts[st + 1] if st + 1 < self.n_stages
                  else cfg.step_num + 1)
            hi = max(min(hi, cfg.step_num + 1), lo)
            if hi > lo:
                self.segments.append((st, lo, hi))
        self._stage_of_frame = [st for st, lo, hi in self.segments
                                for _ in range(lo, hi)]
        self.prims = (ct.empty_primitive_set(dtype, dev) if prims is None
                      else prims.to(dev, dtype))
        self.n_prims = self.prims.n

        # global solve: the explicit dense P^{-1} up to dress scale, then
        # matrix-free Jacobi-PCG whose per-parameter data is 1/diag(P)
        if solve_mode is None:
            solve_mode = "dense" if scene.n <= DENSE_SOLVE_MAX_N else "cg"
        if solve_mode not in ("dense", "cg"):
            raise ValueError(f"solve_mode {solve_mode!r}: 'dense' or 'cg'")
        self.solve_mode = solve_mode
        self.cg_max_iters, self.cg_rtol = cg_max_iters, cg_rtol
        area64 = np.asarray(scene.area, np.float64)
        # one prefactorization per stage (Simulation.cpp:2969-3059)
        if solve_mode == "dense":
            self._p_inv_fns = [
                slv.make_host_p_inv_fn(g, area64, self.h, dtype, dev)
                for g in slv.dense_gram_matrices(scene)]
        else:
            self._p_inv_fns = [
                slv.make_host_p_diag_inv_fn(d, area64, self.h, dtype, dev)
                for d in slv.gram_diagonals(scene)]

        # constraint operators: dense matmuls while they stay small, the
        # scatter-free incidence operators past that
        if sparse_ops:
            dense_ops = False
        if dense_ops is None:
            dense_ops = (dense_ops_bytes(scene) * self.n_stages
                         <= DENSE_OPS_MAX_BYTES)
        if sparse_ops is None:
            sparse_ops = not dense_ops
        if not (dense_ops or sparse_ops):
            raise NotImplementedError(
                "the gather/scatter operator path is not ported: keep "
                "dense_ops or sparse_ops")
        self.dense_list = [None] * self.n_stages
        self.sparse_list = [None] * self.n_stages
        if dense_ops:
            self.dense_list = [dn.build_dense_ops(scene, st, dtype, dev)
                               for st in self.stages_host]
        else:
            self.sparse_list = [spo.build_sparse_ops(scene, st, dtype, dev)
                                for st in self.stages_host]
        self.dense, self.sparse = self.dense_list[0], self.sparse_list[0]

        self.self_cfg = None
        if (self.flags.contact_enabled and self.flags.self_collision_enabled
                and scene.n > 1):
            # the reference enables self-collision for every demo
            # (OptimizationTaskSetup.cpp:154-224)
            if self_method is None:
                self_method = "sweep" if scene.n > SWEEP_MIN_N else "kernel"
            if self_method == "kernel" and scene.n > KERNEL_MAX_N:
                self_method = "sweep"
            # the SYMMETRIC non-adjacency table: for the kernel it makes
            # each row's partner slots its complete contact incidence
            allowed = ~scene.conn_table
            np.fill_diagonal(allowed, False)
            if self_method == "kernel":
                allowed_t = torch.as_tensor(scd.pack_allowed(allowed),
                                            device=dev)
            else:
                allowed_t = torch.as_tensor(allowed, device=dev)
            del allowed
            k_partners = (SELF_K_PARTNERS if self_k_partners is None
                          else self_k_partners)
            self.self_cfg = step_mod.SelfColConfig(
                allowed=allowed_t, k_partners=k_partners,
                max_layers=self_max_layers,
                budgets=self_budgets(scene.n, self_max_layers,
                                     self_compact_layers,
                                     self_compact_budgets),
                method=self_method, window=min(self_window, scene.n - 1),
                cap_pairs=self_cap_pairs or max(128, scene.n // 2),
                ablate=self_ablate)
            if self_method == "kernel" and not (
                    isinstance(k_partners, (int, np.integer))
                    and 1 <= k_partners <= scd.MAX_K):
                raise ValueError(f"self_k_partners {k_partners!r}: the "
                                 f"detection kernel takes 1-{scd.MAX_K} "
                                 f"(the JAX package's bound)")

        # one step per stage; the stages count their adjoint's work together
        self.bwd_stats = step_mod.BackwardStats()
        self.steps, self.residuals = [], []
        for dn_s, sp_s in zip(self.dense_list, self.sparse_list):
            st, res = step_mod.make_step(
                self.scene_dev, dn_s, self.prims, h=self.h,
                wind_config=cfg.wind_config, flags=self.flags,
                eps_forward=self.eps_forward,
                eps_backward=self.eps_backward, self_cfg=self.self_cfg,
                sparse=sp_s, solve_mode=solve_mode,
                cg_max_iters=cg_max_iters, cg_rtol=cg_rtol,
                max_forward_iters=self.max_forward_iters,
                plateau_window=plateau_window, solve_fn=solve_fn,
                stats=self.bwd_stats, cuda_graphs=self.cuda_graphs)
            self.steps.append(st)
            self.residuals.append(res)
        self.step, self.residual = self.steps[0], self.residuals[0]
        self.graphs = [st.graphs for st in self.steps]

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
        return p.replace(
            x0=self.scene_dev.x_rest.clone(),
            v0=torch.as_tensor(self.scene_host.v_init).to(self.device,
                                                          self.dtype),
            spline=self._default_spline())

    def _default_spline(self) -> torch.Tensor:
        """(F,9) for one stage; (S, F_max, 9), zero-padded, for several
        (one spline set per sysMat, Simulation.h:372; JAX sim.py:322-335)."""
        per_stage = []
        for sh, sd in zip(self.stages_host, self.stage_devs):
            sp = spl.default_params_from_endpoints(
                sd.spline_p0,
                torch.as_tensor(sh.spline_p1).to(self.device, self.dtype),
                sd.spline_yup)
            per_stage.append(torch.nn.functional.pad(
                sp, (0, 0, 0, self.max_fixed - sp.shape[0])))
        return per_stage[0] if self.n_stages == 1 else torch.stack(per_stage)

    def p_inv(self, params: SimParams):
        """Refactorize the PD system for a parameter guess (the analogue of
        resetSystemWithParams): the (n,n) P^{-1} with solve_mode "dense",
        the (n,) Jacobi diagonal 1/diag(P) with "cg"; a tuple of one per
        stage for a scene of several.  A batched SimParams shares sample
        0's: k_pertype and density must agree across the batch."""
        p = params.sample(0) if params.batch_size is not None else params
        out = tuple(f(p.k_pertype, p.density) for f in self._p_inv_fns)
        return out[0] if self.n_stages == 1 else out

    # -------------------------------------------------------- fixed trajectory

    def _xf_for_stage(self, s: int, params: SimParams,
                      fracs: torch.Tensor) -> torch.Tensor:
        """(L, F_s, 3) clip positions of stage s at the given fractions of
        the episode, (B, L, F_s, 3) for batched params (stepFixPoints
        evaluates the splines at the whole episode's fraction whatever the
        stage, Simulation.cpp:1004-1011; JAX sim.py:364-400)."""
        sh, sd = self.stages_host[s], self.stage_devs[s]
        F = len(sh.particle_idx)
        traj = self.cfg.trajectory
        B = params.batch_size
        lead = (fracs.shape[0], F, 3) if B is None else \
            (B, fracs.shape[0], F, 3)
        if F == 0 or traj == TrajectoryConfig.NO_TRAJECTORY:
            return sd.fixed_pos_rest.expand(lead).clone()
        if traj in (TrajectoryConfig.CORNERS_2_UP,
                    TrajectoryConfig.CORNERS_2_WEARHAT,
                    TrajectoryConfig.CORNERS_1_WEARHAT,
                    TrajectoryConfig.CORNERS_2_WEARSOCK):
            spline = (params.spline if self.n_stages == 1
                      else params.spline[..., s, :F, :])
            return spl.eval_splines(self.spline_type, spline, sd.spline_p0,
                                    sd.spline_yup, fracs)
        if traj == TrajectoryConfig.TRAJECTORY_DRESS_TWIRL:
            # 0.02 rad per step about the vertical axis through
            # restShapeMidPoint (Simulation.cpp:980-994), in closed form:
            # the rotation keeps y
            mid = torch.as_tensor(self.scene_host.rest_mid).to(self.device,
                                                               self.dtype)
            ang = 0.02 * fracs * self.n_steps
            rest = sd.fixed_pos_rest
            rel_x, rel_z = rest[:, 0] - mid[0], rest[:, 2] - mid[2]
            c, sn = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
            out = torch.stack(
                [c * rel_x + sn * rel_z + mid[0],
                 rest[:, 1].expand(fracs.shape[0], F),
                 -sn * rel_x + c * rel_z + mid[2]], dim=-1)
            return out.expand(lead).clone()
        raise NotImplementedError(f"trajectory {traj}")

    def x_fixed_seq(self, params: SimParams) -> torch.Tensor:
        """(N, F, 3) clip positions for steps 1..N (stepFixPoints,
        Simulation.cpp:964-1018); batched params -> (B, N, F, 3).  Several
        stages pad F to the largest stage's (F_max); frame k's stage reads
        the leading F_s rows (JAX sim.py:402-416)."""
        N = self.n_steps
        fracs = torch.arange(1, N + 1, dtype=self.dtype,
                             device=self.device) / N
        if self.n_stages == 1:
            return self._xf_for_stage(0, params, fracs)
        if params.batch_size is not None:
            raise ValueError(_BATCHED_MULTISTAGE)
        parts = []
        for s, lo, hi in self.segments:
            xf = self._xf_for_stage(s, params, fracs[lo - 1:hi - 1])
            parts.append(torch.nn.functional.pad(
                xf, (0, 0, 0, self.max_fixed - xf.shape[-2])))
        return torch.cat(parts, dim=0)

    # ---------------------------------------------------------------- episode

    def _times(self):
        """(N,) step times i h and (N,) int64 step indices i, i = 1..N, on
        the device: a step reads its time and index from device scalars,
        so one captured step serves every step of an episode."""
        if getattr(self, "_ts", None) is None:
            N = self.n_steps
            self._ts = torch.arange(1, N + 1, dtype=self.dtype,
                                    device=self.device) * self.h
            self._idxs = torch.arange(1, N + 1, dtype=torch.int64,
                                      device=self.device)
        return self._ts, self._idxs

    def _run_steps(self, x, v, frozen, pb: SimParams, p_invs, xfs, lo: int,
                   hi: int, record_forces: bool):
        """Frames lo..hi-1 (1-based) of a batched episode from (x, v), with
        xfs (B, hi - lo, F, 3) their clip positions and `frozen` (B,) the
        explosion freeze so far: once an episode explodes its remaining
        steps pass the state through unchanged (Simulation.cpp:1415-1424).
        Returns (x, v, frozen, the stacked (B, hi - lo, ...) records)."""
        ts, idxs = self._times()
        cols = {k: [] for k in ("x", "v", "f", "r") + DIAG_KEYS}
        for i in range(lo, hi):
            s = self._stage_of_frame[i - 1]
            F_s = len(self.stages_host[s].particle_idx)
            x2, v2, aux = self.steps[s](x, v, pb, xfs[:, i - lo, :F_s],
                                        p_invs[s], ts[i - 1], idxs[i - 1])
            frozen = frozen | diag.is_exploded(x2, v2)
            fz = frozen[:, None, None]
            x2 = torch.where(fz, x, x2)
            v2 = torch.where(fz, v, v2)
            cols["x"].append(x2)
            cols["v"].append(v2)
            if record_forces:
                cols["f"].append(aux.f)
                cols["r"].append(aux.r)
            for k in DIAG_KEYS:
                cols[k].append(getattr(aux, k))
            x, v = x2, v2
        return x, v, frozen, {k: torch.stack(c, dim=1)
                              for k, c in cols.items() if c}

    def _records(self, params: SimParams, xfs, cols: dict) -> EpisodeRecords:
        """Records of single or batched params from batched columns and
        clip positions xfs (B, N, F, 3) (f / r zero-filled, as a stride-0
        view, where they were not recorded)."""
        st = dict(cols)
        if "f" not in st:   # a stride-0 view: no (B, N, n, 3) storage
            st["f"] = st["r"] = st["x"].new_zeros(()).expand(st["x"].shape)
        st["x_fixed"] = xfs
        steps = StepRecord(**st)
        if params.batch_size is None:
            steps = StepRecord(**{k: getattr(steps, k)[0] for k in st})
        return EpisodeRecords(x0=params.x0, v0=params.v0, steps=steps)

    def simulate(self, params: SimParams, p_inv,
                 x_fixed_seq: torch.Tensor,
                 record_forces: bool = True) -> EpisodeRecords:
        """Full rollout: frame 0 (the initial state) plus the stacked records
        of steps 1..N.  Single or batched params (then x_fixed_seq is
        (B, N, F, 3) and every record carries a leading B); a scene of
        several stages takes single params only, and `p_inv` is then
        `p_inv(params)`'s tuple.  Once an episode explodes its remaining
        steps pass the state through unchanged (Simulation.cpp:1415-1424)."""
        batched = params.batch_size is not None
        if batched and self.n_stages > 1:
            raise ValueError(_BATCHED_MULTISTAGE)
        pb = params.as_batched()
        xfs = x_fixed_seq if batched else x_fixed_seq[None]
        p_invs = p_inv if self.n_stages > 1 else (p_inv,)
        frozen = torch.zeros(pb.x0.shape[0], dtype=torch.bool,
                             device=pb.x0.device)
        _, _, _, cols = self._run_steps(pb.x0, pb.v0, frozen, pb, p_invs,
                                        xfs, 1, self.n_steps + 1,
                                        record_forces)
        return self._records(params, xfs, cols)

    def rollout(self, params: SimParams) -> EpisodeRecords:
        """Refactorize + trajectory + simulate; params single or batched."""
        return self.simulate(params, self.p_inv(params),
                             self.x_fixed_seq(params))

    # --------------------------------------------------------- chunked episode

    def _chunk_size(self, chunk: int) -> int:
        """The largest divisor of the episode length that is at most
        `chunk`: every chunk of a pass has one length (JAX sim.py:475-480)."""
        N = self.n_steps
        return next(c for c in range(min(chunk, N), 0, -1) if N % c == 0)

    def _chunk_forward(self, pb: SimParams, p_inv, xfs, chunk: int):
        """The horizon of batched params as chunks of `chunk` steps, without
        gradient: (the stacked (B, N, ...) records but f / r, each chunk's
        start (x, v, frozen)).  Inside a chunk the host waits on nothing:
        on the card each step is one launch of its captured programs, whose
        loops end on the device.  Each chunk is a `chunk` span of the
        tracer."""
        x, v = pb.x0, pb.v0
        frozen = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        starts, parts = [], []
        with torch.no_grad():
            for lo in range(1, self.n_steps + 1, chunk):
                starts.append((x, v, frozen))
                with tm.span("chunk"):
                    x, v, frozen, cols = self._run_steps(
                        x, v, frozen, pb, (p_inv,),
                        xfs[:, lo - 1:lo - 1 + chunk], lo, lo + chunk,
                        record_forces=False)
                parts.append(cols)
        return ({k: torch.cat([c[k] for c in parts], dim=1)
                 for k in parts[0]}, starts)

    def rollout_chunked(self, params: SimParams,
                        chunk: int = 50) -> EpisodeRecords:
        """`rollout` as chunks of `chunk` steps (the largest divisor of the
        episode length at most `chunk`), the counterpart of the JAX
        package's bounded device executions (sim.py:583-597).  Records
        match `rollout`'s bit for bit except f / r (the pre-friction and the
        friction force), which are zero-filled, as there (no consumer
        outside the viewer overlays reads them).  Single or batched params;
        a scene of several stages runs `rollout`."""
        if self.n_stages > 1:
            return self.rollout(params)
        xfs = self.x_fixed_seq(params)
        if params.batch_size is None:
            xfs = xfs[None]
        cols, _ = self._chunk_forward(params.as_batched(), self.p_inv(params),
                                      xfs, self._chunk_size(chunk))
        return self._records(params, xfs, cols)

    def episode_loss(self, loss_fn):
        """Forward-only loss: params (single or batched) -> loss (a scalar,
        or (B,) for batched params, with one shared P^{-1}).  `loss_fn`
        maps records to losses (see losses.py)."""
        def value(params: SimParams):
            with torch.no_grad():
                return loss_fn(self.simulate(params, self.p_inv(params),
                                             self.x_fixed_seq(params),
                                             record_forces=False))
        return value

    def episode_loss_chunked(self, loss_fn, chunk: int = 50,
                             batched: bool = False):
        """Forward-only chunked loss (JAX sim.py:599-672): params -> loss
        through `rollout_chunked`, so it agrees with
        `episode_value_and_grad_chunked` bit for bit, freeze included.
        batched=True evaluates a population: params with a leading batch
        dim -> (B,) losses (one P^{-1}, from sample 0, shared: k_pertype and
        density must agree across the batch).  A scene of several stages
        evaluates the whole episode."""
        if self.n_stages > 1:
            def value_multistage(params: SimParams):
                with torch.no_grad():
                    return loss_fn(self.rollout(params))
            return value_multistage

        def value(params: SimParams):
            _check_batched(params, batched)
            with torch.no_grad():
                return loss_fn(self.rollout_chunked(params, chunk))
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
        seconds of the last call.  `p_inv` given: that in place of
        `p_inv(params)` (a tensor-parallel rank's row block of it)."""
        def value_and_grad(params: SimParams, p_inv=None):
            if p_inv is None:
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

    def episode_value_and_grad_chunked(self, loss_fn, chunk: int = 50,
                                       batched: bool = False):
        """`episode_value_and_grad` with both passes in chunks of `chunk`
        steps (JAX sim.py:674-775): the forward runs chunk after chunk
        without gradient, keeping only each chunk's start; the loss gives
        the cotangents of every frame; the backward runs the chunks in
        reverse, each recomputing its forward under autograd from its saved
        start and taking its VJP, the cotangents of its end state passed
        from the chunk after it.  So a value-and-grad holds one chunk's
        step residuals, not the whole horizon's.  The result equals the
        whole-episode gradient up to the order of its sums.  batched=True:
        params with a leading batch dim ((B,) losses, per-episode
        gradients, one shared P^{-1}).  A scene of several stages runs
        `episode_value_and_grad`.  `.split` holds the forward (with the
        loss) and backward wall seconds of the last call.  `p_inv` given:
        that in place of `p_inv(params)` (a tensor-parallel rank's row block
        of it).  The tracer's spans (`utils/timing.py`): `p_inv` (the host
        prefactorization), `forward` (its `chunk`s), `loss`, `backward`
        (per chunk in reverse, `recompute` then `vjp`) and
        `spline_grads`."""
        if self.n_stages > 1:
            return self.episode_value_and_grad(loss_fn)
        chunk = self._chunk_size(chunk)

        def value_and_grad(params: SimParams, p_inv=None):
            _check_batched(params, batched)
            if p_inv is None:
                with tm.span("p_inv"):
                    p_inv = self.p_inv(params)
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in params.items()}
            p = SimParams(**leaves)
            t0 = time.perf_counter()
            with torch.enable_grad():
                xfs = self.x_fixed_seq(p)
                xfs_b = xfs if batched else xfs[None]
                pb = p.as_batched()
            pb_const = SimParams(**{k: v.detach() for k, v in pb.items()})
            with tm.span("forward"):
                cols, starts = self._chunk_forward(pb_const, p_inv,
                                                   xfs_b.detach(), chunk)
            with tm.span("loss"), torch.enable_grad():
                X = cols["x"].requires_grad_(True)
                V = cols["v"].requires_grad_(True)
                recs = self._records(p, xfs_b.detach(), dict(cols, x=X, v=V))
                loss = loss_fn(recs)
                g = torch.autograd.grad(loss.sum(), [X, V] + list(
                    leaves.values()), allow_unused=True)
                _sync(self.device)
            t1 = time.perf_counter()
            # a loss of the positions alone gives the velocities no
            # cotangent (and the reverse)
            dX = torch.zeros_like(X) if g[0] is None else g[0]
            dV = torch.zeros_like(V) if g[1] is None else g[1]
            grads = dict(zip(leaves, g[2:]))
            cot_x = torch.zeros_like(starts[-1][0])
            cot_v = torch.zeros_like(cot_x)
            g_xfs = torch.zeros_like(xfs_b)
            with tm.span("backward"):
                for c in reversed(range(len(starts))):
                    x_in, v_in, frozen_in = starts[c]
                    sl = slice(c * chunk, (c + 1) * chunk)
                    with torch.enable_grad():
                        xi = x_in.detach().requires_grad_(True)
                        vi = v_in.detach().requires_grad_(True)
                        xf_c = xfs_b[:, sl].detach().requires_grad_(True)
                        with tm.span("recompute"):
                            xN, vN, _, cc = self._run_steps(
                                xi, vi, frozen_in, pb, (p_inv,), xf_c,
                                c * chunk + 1, (c + 1) * chunk + 1,
                                record_forces=False)
                        with tm.span("vjp"):
                            gc = torch.autograd.grad(
                                [xN, vN, cc["x"], cc["v"]],
                                [xi, vi, xf_c] + list(leaves.values()),
                                [cot_x, cot_v, dX[:, sl], dV[:, sl]],
                                allow_unused=True)
                    cot_x, cot_v = gc[0], gc[1]
                    if gc[2] is not None:
                        g_xfs[:, sl] += gc[2]
                    for k, gk in zip(leaves, gc[3:]):
                        if gk is not None:
                            grads[k] = (gk if grads[k] is None
                                        else grads[k] + gk)
            with tm.span("spline_grads"):
                if xfs.requires_grad:     # the clips follow the splines
                    with torch.enable_grad():
                        gx = torch.autograd.grad(
                            xfs, list(leaves.values()),
                            g_xfs if batched else g_xfs[0],
                            allow_unused=True)
                    for k, gk in zip(leaves, gx):
                        if gk is not None:
                            grads[k] = (gk if grads[k] is None
                                        else grads[k] + gk)
            for k, cot in (("x0", cot_x), ("v0", cot_v)):
                cot = cot if batched else cot[0]
                grads[k] = cot if grads[k] is None else grads[k] + cot
            _sync(self.device)
            value_and_grad.split = {"forward_s": t1 - t0,
                                    "backward_s": time.perf_counter() - t1}
            return loss.detach(), SimParams(**{
                k: torch.zeros_like(leaves[k]) if gk is None else gk
                for k, gk in grads.items()})

        value_and_grad.split = None
        return value_and_grad


DIAG_KEYS = ("converged", "iters", "avg_deformation", "max_deformation",
             "selfcol_overflow", "selfcol_pairs", "selfcol_slots",
             "obstacle_contacts", "cg_iters")


def _check_batched(params: SimParams, batched: bool) -> None:
    """The chunked functions take batched params exactly when built with
    batched=True, as the JAX package's vmapped and plain executables do."""
    if (params.batch_size is not None) != batched:
        raise ValueError(
            f"built with batched={batched}: params "
            f"{'with' if params.batch_size is not None else 'without'} a "
            f"leading batch dim")


_BATCHED_MULTISTAGE = (
    "a scene of several attachment stages runs one episode at a time (the "
    "JAX package's batched routes have no multi-stage form either)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
