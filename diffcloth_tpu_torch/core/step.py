"""The differentiable PD step: forward local-global loop with
self-collision friction, and the implicit adjoint.

Counterpart of `diffcloth_tpu/core/step.py` `make_step`: `pd_forward`
(:216-642), `residual` (:406-419), the K map (:683-692), `_gmres_cycle`
(:97-140), `_pcg` and `solver_for` (:151-175, :425-436) and `step_bwd` in
its default `fp` mode (:659-830).  Options, as the JAX package's:
  * operators: `dense` (dense_ops.py, matmuls) or `sparse` (sparse_ops.py,
    scatter-free incidence operators); the JAX package's plain
    gather/scatter fallback, used only when both are None, is not ported
    and raises;
  * global solve `solve_mode`: "dense" (one P^{-1} matmul) or "cg"
    (matrix-free Jacobi-PCG, `cg_max_iters`, `cg_rtol`; p_inv is then
    1/diag(P));
  * self-collision `SelfColConfig.method`: "kernel" (the detection kernel,
    the JAX package's "pallas" and "matrix") or "sweep" (sort-based
    sweep-and-prune, selfcol.py);
  * `solve_fn` (p_inv, rhs) -> P^{-1} rhs in place of the dense product or
    the CG solve, in the PD loop and in every P^{-1} of the adjoint (the
    tensor-parallel solve of parallel/mesh.py plugs in here; like P^{-1}
    it is a constant to autograd);
  * `max_forward_iters` and `plateau_window` (the PD loop's cap and its
    plateau exit);
  * `flags.adjoint_mode`: "fp" (the reference's fixed point with a GMRES
    fallback) or "gmres" (restarted preconditioned GMRES as the primary
    solver, step.py:704-757).
  * self-collision capacity (`SelfColConfig`): partner slots per row
    `k_partners`, layering rounds `max_layers`, per-layer friction slot
    budgets `budgets`, and the profiling ablation `ablate` ("nofric",
    "detect_only"; step.py:365, :459-460, :491-545).  The JAX package's
    TPU tuning options that choose between implementations of one
    function (`friction_unroll`, `friction_impl`) are not ported.

Forward: velocity-based projective dynamics with dry frictional contact
(Simulation::step, Simulation.cpp:1043-1428):

    s_n   = x_n + h v_n + h^2 M^{-1} f_ext
    loop: b~ = h sum_t k_t A_t^T (p_t(x_now) - A_t x_n) + M v_n + h f_ext
          f  = b~ - h^2 Sk v_now
          r  = friction(f)        [contacts frozen at the step's start]
          v_new = P^{-1}(b~ + r);  x_new = x_n + h v_new

with the strict-eps exit, the plateau exit after PLATEAU_WINDOW sweeps
without a new best, and the best-iterate revert.  friction(f) is the
obstacle friction (layer 0, contact.obstacle_friction) followed by the
self-friction sweep on f + r_obstacle (step.py:349-385).  Obstacle contacts
are detected once per step at the step's time t (plain PyTorch, as in the
JAX package); self-collision runs its pipeline once per step (detection
kernel, or the sweep, -> layering -> slot geometry) and the friction sweep
kernel once per PD iteration.  With solve_mode "cg" every P^{-1} product,
in the PD loop and in the adjoint, is a Jacobi-PCG solve, masked per
episode as the loops are.

Backward (Simulation::stepBackward, Simulation.cpp:1455-1780): implicit
differentiation of the residual R(v_new; x_n, v_n, theta, x_fixed) =
P v_new - b~(x_new) - r(f) = 0.  The adjoint lambda solves
(dR/dv)^T lambda = w, w = v_bar + h x_bar, in mode "fp" by the reference's
fixed point lambda <- P^{-1}(w + (dK/dv)^T lambda) with K(v) =
b~(x_n + h v) + r(f(v)), capped at max_backward_iters, with a GMRES(16)
fallback of up to 3 cycles; in mode "gmres" by restarted GMRES(m) on the
preconditioned system, each cycle judged by its true residual.  One VJP of
R then gives every gradient.  K is linearized once per adjoint program, at
its start, at the step's v_new (`adjoint_linear.py`): the per-row Jacobians
of the projections, the obstacle friction's per-particle 3 x 3 and the
`vals` of one forward friction sweep.  Each (dK/dv)^T product then applies
that linearization's transpose: the backward sweep kernel, a kernel that
folds the friction into [z | g], a GEMM by the constraint operators, a
per-row kernel, and the transposed GEMM (`kdv`).  `StepFn` (a
`torch.autograd.Function`) is the counterpart of the step's
`jax.custom_vjp`.

Everything is batched over a leading dim B: where the JAX package vmaps a
`while_loop`, here every update is masked per episode (the PD loop's state,
the adjoint's lambda, the GMRES iterate), so an episode that is done stops
changing exactly as a finished vmapped lane does, and a batched result
equals the per-episode ones.  Each of the three while_loops (the PD loop,
the fixed point, Jacobi-PCG) is written once, as a block of CHECK_EVERY
masked iterations over a dict of tensors (`pd_block`, `trip_block`,
`_cg_block`; the last block of a cap that CHECK_EVERY does not divide is
shorter), and the host reads whether any episode is still active between
blocks; the masked extra iterations are no-ops.  On a CUDA device the
blocks run as CUDA graphs, captured once and replayed (`graphs.py`, which
also lists what stays uncaptured); on the CPU, with `cuda_graphs=False` or
with a `solve_fn` other than the tensor-parallel one, the same block
functions are called directly.  A CG
solve inside a captured PD sweep or fixed-point trip runs to its cap
(`cg_max_iters`) without host reads, its extra iterations masked; the
iterates are the same.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Optional

import torch

from diffcloth_tpu_torch.config import (GRAVITY, SimFlags, WindConfig,
                                        pd_total_iters)
from diffcloth_tpu_torch.core import adjoint_linear as al
from diffcloth_tpu_torch.core import contact as ct
from diffcloth_tpu_torch.core import dense_ops as dn
from diffcloth_tpu_torch.core import friction_cuda as fc
from diffcloth_tpu_torch.core import graphs as gr
from diffcloth_tpu_torch.core import lstsq_cuda as lq
from diffcloth_tpu_torch.core import selfcol as sc
from diffcloth_tpu_torch.core import selfcol_cuda as scd
from diffcloth_tpu_torch.core import sparse_ops as spo
from diffcloth_tpu_torch.core.types import SceneDev, SimParams

# sweeps without a new best iterate before the plateau exit (the JAX
# package's default)
PLATEAU_WINDOW = 12
# PD sweeps (and adjoint trips) between the host's reads of "is any
# episode still active"
CHECK_EVERY = 4
# Krylov vectors and cycles of the adjoint's GMRES fallback (step.py:782-798)
GMRES_M = 16
GMRES_CYCLES = 3
PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(SimParams))


# the profiling ablations of the self-collision pipeline ("" = none)
ABLATIONS = ("", "nofric", "detect_only")


@dataclasses.dataclass
class SelfColConfig:
    """Static self-collision configuration.  method "kernel": `allowed` is
    the (n_pad, n_pad) int8 symmetric admissibility table the detection
    kernel reads and `k_partners` its partner slots per row.  method
    "sweep": `allowed` is the (n, n) bool symmetric non-adjacency table,
    `window` the sorted-order window and `cap_pairs` the pair capacity of a
    step (None: max(128, n // 2)).  The JAX package's "matrix" and
    "pallas" methods are both the kernel here (its CPU route is the
    kernel's plain version) and raise.

    `ablate`, the JAX package's build-time profiling knob: "" the full
    pipeline; "nofric" detection, layering and slot geometry every step
    but self-friction never applied; "detect_only" detection every step
    (kept live through the overflow flag), nothing after it.  Ablated
    steps are not physical: profiling only."""
    allowed: torch.Tensor
    k_partners: int         # partner slots per row (detection kernel)
    max_layers: int         # layering rounds
    budgets: tuple          # per-layer friction slot budgets
    method: str = "kernel"
    window: int = 48
    cap_pairs: Optional[int] = None
    ablate: str = ""

    def __post_init__(self):
        if self.method not in ("kernel", "sweep"):
            raise ValueError(
                f"self-collision method {self.method!r}: the port has "
                f"'kernel' (the JAX package's 'pallas' and 'matrix'; on the "
                f"CPU it runs the kernel's plain version) and 'sweep'")
        if self.ablate not in ABLATIONS:
            raise ValueError(f"self-collision ablate {self.ablate!r}: one "
                             f"of {ABLATIONS}")


@dataclasses.dataclass
class StepAux:
    """Per-step diagnostics, each with a leading (B,) dim."""
    f: torch.Tensor
    r: torch.Tensor
    converged: torch.Tensor
    iters: torch.Tensor
    avg_deformation: torch.Tensor
    max_deformation: torch.Tensor
    selfcol_overflow: torch.Tensor   # capacity exceeded this step
    selfcol_pairs: torch.Tensor      # self-contact pairs layered this step
    selfcol_slots: torch.Tensor      # friction slots each sweep works on
    obstacle_contacts: torch.Tensor  # particles in obstacle contact
    cg_iters: torch.Tensor           # CG iterations over the step's sweeps


def deformation(scene: SceneDev, x):
    """(total current area / total rest area, max per-triangle area ratio)
    per episode (Simulation.cpp:34-53); x (B,n,3) -> two (B,) tensors."""
    if scene.tri_idx.shape[0] == 0:
        one = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
        return one, one
    p0 = x[:, scene.tri_idx[:, 0]]
    p1 = x[:, scene.tri_idx[:, 1]]
    p2 = x[:, scene.tri_idx[:, 2]]
    c = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    area = 0.5 * torch.sqrt(torch.sum(c * c, dim=-1))
    rest = scene.tri_area.to(x.dtype)
    return (area.sum(-1) / rest.sum(),
            (area / torch.clamp(rest, min=1e-30)).amax(-1))


def _frob(a):
    """Per-episode Frobenius norm of (B, n, 3)."""
    return torch.sqrt(torch.sum(a * a, dim=(-2, -1)))


STAT_FIELDS = (
    "trips",            # fixed-point sweeps over the batch, masked included
    "gmres_matvecs",    # (dK/dv)^T products of GMRES (either mode)
    "gmres_cycles",     # GMRES cycles over the batch (mode "gmres")
    "residual_vjps",    # VJPs of the residual
    "lane_steps",       # (episode, step) pairs with a nonzero cotangent
    "lane_trips",       # their fixed-point trips (GMRES cycles)
    "fallback_lanes",   # of them that fell to the GMRES fallback
    "slot_launches",    # active friction slots over the backward sweep's
#                         launches (one per product and per residual VJP)
    "cg_solves",        # CG solves over the batch (solve_mode "cg")
    "cg_iters",         # their iterations, summed over the episodes (a
#                         trip's only where the episode is active)
    "linear_products")  # (dK/dv)^T products taken through the step's
#                         linearization (trips and GMRES matvecs)
_STAT = {k: i for i, k in enumerate(STAT_FIELDS)}


class BackwardStats:
    """Counters of the adjoint (STAT_FIELDS), summed over `step_bwd` calls
    since the last `reset()`.  They are counted on the device, by the
    adjoint's own segments, so that a captured adjoint counts what it ran
    (a loop's iterations are known only there).  With self-friction on,
    every (dK/dv)^T product (a fixed-point trip or a GMRES matvec) launches
    the backward friction sweep once for the whole batch, at the `vals`
    of the one forward sweep the adjoint's start makes to linearize K; the
    residual VJP launches both sweeps once.  `trips` counts the trips the
    blocks ran, masked ones included."""

    def __init__(self):
        self.vec = None     # (len(STAT_FIELDS),) f64 on the sim's device

    def vector(self, device) -> torch.Tensor:
        if self.vec is None:
            self.vec = torch.zeros(len(STAT_FIELDS), dtype=torch.float64,
                                   device=device)
        return self.vec

    def reset(self):
        if self.vec is not None:
            self.vec.zero_()

    def summary(self) -> dict:
        """Host numbers (one device read)."""
        vals = (self.vec.tolist() if self.vec is not None
                else [0.0] * len(STAT_FIELDS))
        out = dict(zip(STAT_FIELDS, vals))
        out["launches"] = (out["trips"] + out["gmres_matvecs"]
                           + out["residual_vjps"])
        return out


def _count(st: dict, name: str, value) -> None:
    """Add `value` to the adjoint counter `name` (st["stats"], the step's
    BackwardStats vector)."""
    st["stats"][_STAT[name]] += value


def _gmres_cycle(op, b, x0, m: int):
    """One GMRES(m) cycle on op(u) = b from x0, for each episode of the batch
    (step.py:97-140): Arnoldi with modified Gram-Schmidt, then the
    (m+1, m) Hessenberg least squares (`lstsq_cuda.hessenberg_lstsq`, with
    the cutoff rcond = eps * (m+1) that jnp.linalg.lstsq applies in the
    simulation dtype).  b, x0 (B, n, 3)."""
    B = x0.shape[0]
    shape = x0.shape
    r0 = (b - op(x0)).reshape(B, -1)
    beta = torch.linalg.vector_norm(r0, dim=1)
    V = torch.zeros((B, m + 1, r0.shape[1]), dtype=r0.dtype,
                    device=r0.device)
    H = torch.zeros((B, m + 1, m), dtype=r0.dtype, device=r0.device)
    V[:, 0] = r0 / torch.clamp(beta, min=1e-30)[:, None]
    for j in range(m):
        w = op(V[:, j].reshape(shape)).reshape(B, -1)
        for i in range(j + 1):
            hij = torch.sum(V[:, i] * w, dim=1)
            w = w - hij[:, None] * V[:, i]
            H[:, i, j] = hij
        hnext = torch.linalg.vector_norm(w, dim=1)
        H[:, j + 1, j] = hnext
        V[:, j + 1] = w / torch.clamp(hnext, min=1e-30)[:, None]
    e1 = torch.zeros((B, m + 1), dtype=r0.dtype, device=r0.device)
    e1[:, 0] = beta
    y = lq.hessenberg_lstsq(H, e1, torch.finfo(r0.dtype).eps * (m + 1))
    return x0 + torch.einsum("bm,bmn->bn", y, V[:, :m]).reshape(shape)


def _cg_start(op, b, diag_inv, rtol: float) -> dict:
    """The Jacobi-PCG carry before its first iteration (step.py:151-175)."""
    x = diag_inv[:, None] * b     # Jacobi initial guess
    r = b - op(x)
    p = diag_inv[:, None] * r
    stop2 = (rtol * _frob(b)) ** 2
    return dict(d=diag_inv, x=x, r=r, p=p,
                rz=torch.sum(r * p, dim=(-2, -1)), stop2=stop2,
                it=torch.zeros(b.shape[0], dtype=torch.int32,
                               device=b.device),
                active=torch.sum(r * r, dim=(-2, -1)) > stop2)


def _cg_block(op, st: dict, k: int, max_iters: int) -> None:
    """k masked Jacobi-PCG iterations on the carry in `st`, written back in
    place (the body of step.py:185's while_loop, per episode)."""
    D = st["d"][:, None]
    x, r, p, rz, it, active = (st[name] for name in
                               ("x", "r", "p", "rz", "it", "active"))
    for _ in range(k):
        Ap = op(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap, dim=(-2, -1)), min=1e-30)
        a3 = active[:, None, None]
        x = torch.where(a3, x + alpha[:, None, None] * p, x)
        r_new = r - alpha[:, None, None] * Ap
        z = D * r_new
        rz_new = torch.sum(r_new * z, dim=(-2, -1))
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = torch.where(a3, z + beta[:, None, None] * p, p)
        r = torch.where(a3, r_new, r)
        rz = torch.where(active, rz_new, rz)
        it = it + active.to(torch.int32)
        active = (active & (it < max_iters)
                  & (torch.sum(r * r, dim=(-2, -1)) > st["stop2"]))
    for name, val in zip(("x", "r", "p", "rz", "it", "active"),
                         (x, r, p, rz, it, active)):
        st[name].copy_(val)


def pcg(op, b, diag_inv, max_iters: int, rtol: float, checked: bool = True):
    """Jacobi-preconditioned conjugate gradients on the SPD operator `op`
    for each episode of the batch (step.py:151-175): b (B, n, 3), the three
    right-hand sides of an episode solved jointly (P x I_3 is SPD on the
    product space, so inner products run over all entries), diag_inv (n,)
    = 1/diag(P).  An episode iterates while it is under `max_iters`
    iterations and its |r| is above rtol |b|, as its lane of the JAX
    package's vmapped while_loop does; a finished episode is frozen.  The
    iterations run in blocks of CHECK_EVERY; checked=False (inside a
    captured block) skips the host's check between them.  Returns (x,
    iterations (B,) int32)."""
    st = _cg_start(op, b, diag_inv, rtol)
    gr.run_blocks(max_iters, CHECK_EVERY,
                  lambda k: _cg_block(op, st, k, max_iters),
                  (lambda: st["active"]) if checked else None)
    return st["x"], st["it"]


@dataclasses.dataclass
class Frozen:
    """What a step detects once and holds fixed for its sweeps and its
    adjoint: the obstacle contact set and the self-contact slot geometry
    (either None when its kind of contact is off).  Constants of the
    backward: no cotangent reaches the normals or v_out, as in the JAX
    package, where both are fixed arguments of the residual."""
    contact: Optional[object]   # contact.ContactSet
    geom: Optional[object]      # friction_cuda.KernelGeom


class StepFn(torch.autograd.Function):
    """One PD step as a differentiable function of (x_n, v_n, x_fixed, the
    SimParams fields): the counterpart of the step's `jax.custom_vjp`
    (step.py:646-832).  The forward runs the PD loop; the backward the
    implicit adjoint.  P^{-1}, t and the step index are constants (P^{-1}
    only preconditions; gradients to k and density flow through the
    operator-form residual), as are the step's diagnostics and its
    `Frozen` contacts (kept only when a backward may follow)."""

    @staticmethod
    def forward(ctx, step_def, keep, p_inv, t, step_idx, x_n, v_n, x_fixed,
                *param_tensors):
        params = SimParams(**dict(zip(PARAM_FIELDS, param_tensors)))
        x_new, v_new, aux, frozen = step_def.forward(
            x_n, v_n, params, x_fixed, p_inv, t, step_idx, keep)
        ctx.save_for_backward(x_n, v_n, v_new, x_fixed, *param_tensors)
        ctx.step_def, ctx.frozen = step_def, frozen
        ctx.p_inv, ctx.t, ctx.step_idx = p_inv, t, step_idx
        aux_t = tuple(getattr(aux, f.name) for f in dataclasses.fields(aux))
        ctx.mark_non_differentiable(*aux_t)
        return (x_new, v_new) + aux_t

    @staticmethod
    def backward(ctx, x_bar, v_bar, *_aux_bar):
        x_n, v_n, v_new, x_fixed, *param_tensors = ctx.saved_tensors
        params = SimParams(**dict(zip(PARAM_FIELDS, param_tensors)))
        wanted = tuple(k for k, need in zip(PARAM_FIELDS,
                                            ctx.needs_input_grad[8:]) if need)
        gx, gv, gxf, gp = ctx.step_def.backward(
            x_n, v_n, v_new, params, x_fixed, ctx.frozen, ctx.p_inv, ctx.t,
            ctx.step_idx, x_bar, v_bar, wanted)
        return (None, None, None, None, None, gx, gv, gxf) + tuple(
            gp.get(k) for k in PARAM_FIELDS)


# the loops' carries, written back in place by their blocks
PD_CARRY = ("x_now", "v_now", "best_x", "best_v", "min_xd", "it", "cg_it",
            "done", "strict", "since", "f", "r")
# the SimParams fields a step reads (x0, v0 and the splines it does not)
STEP_PARAMS = ("k_pertype", "density", "mu", "wind", "wind_freq",
               "wind_phase", "wind_perstep", "force_field")
# the frozen contacts' entries (contact set, slot geometry)
CONTACT_ENTRIES = ("c_mask", "c_normal", "c_v_out", "c_prim")
GEOM_ENTRIES = ("idx_row", "idx_part", "normalT", "counts", "area_row",
                "area_part")
AUX_ENTRIES = tuple("aux_" + f.name for f in dataclasses.fields(StepAux))


def make_step(scene: SceneDev, dense: Optional[dn.DenseOps],
              prims: ct.PrimitiveSet, *, h: float, wind_config: WindConfig,
              flags: SimFlags, eps_forward: float, eps_backward: float,
              self_cfg: Optional[SelfColConfig] = None,
              sparse: Optional[spo.SparseOps] = None,
              solve_mode: str = "dense", cg_max_iters: int = 64,
              cg_rtol: float = 1e-6, max_forward_iters: Optional[int] = None,
              plateau_window: int = PLATEAU_WINDOW, solve_fn=None,
              stats: Optional[BackwardStats] = None, cuda_graphs=None):
    """Build the batched differentiable PD step for one attachment stage:

        step(x (B,n,3), v, params (batched SimParams), x_fixed (B,F,3),
             p_inv, t (0-dim tensor), step_idx (int or 0-dim int tensor))
          -> (x_new, v_new, StepAux)

    and the residual R(v_new, x_n, v_n, params, x_fixed, frozen, t,
    step_idx) it differentiates (`frozen`: the step's `Frozen` contacts).
    The constraint operators are `dense` or, when it is None, `sparse`.
    p_inv is the (n,n) P^{-1} with solve_mode "dense" and the (n,)
    1/diag(P) with "cg"; `solve_fn(p_inv, rhs)`, when given, replaces
    either solve (p_inv is then whatever it takes, e.g. a row block of
    P^{-1}).  `prims` are the scene's obstacles (an empty set for none).
    `step.bwd_stats` counts the adjoint's work (into `stats` when given,
    shared by the steps of a scene's stages).  `cuda_graphs`
    (`graphs.resolve`): None runs the step's forward and its adjoint as
    captured device programs on a CUDA scene without `solve_fn` or with
    the tensor-parallel one and uncaptured otherwise, True insists on
    them, False runs the same segments uncaptured; `step.graphs` holds
    the step's programs.

    The forward is the program [prologue, the PD loop, epilogue]: the
    prologue detects the step's contacts (obstacles at the step's time t,
    a device scalar, and self-collision: detection, layering, slot
    geometry and masses) and starts the loop's carry; the epilogue reverts
    to the best iterate and makes the diagnostics.  The adjoint is [its
    start (w, the first solve), the fixed-point trips, the fallback's
    start, the GMRES fallback's cycles, the residual VJP] in mode "fp", or
    [its start, the GMRES cycles, the residual VJP] in mode "gmres"."""
    if flags.adjoint_mode not in ("fp", "gmres"):
        raise NotImplementedError(
            f"adjoint_mode {flags.adjoint_mode!r}: the port has 'fp' (the "
            f"reference's fixed point with its GMRES fallback) and 'gmres'")
    if dense is None and sparse is None:
        raise NotImplementedError(
            "the gather/scatter operator path is not ported: pass dense or "
            "sparse operators")
    if solve_mode not in ("dense", "cg"):
        raise ValueError(f"solve_mode {solve_mode!r}: 'dense' or 'cg'")
    n = int(scene.area.shape[0])
    dev = scene.area.device
    max_iter = (max_forward_iters or flags.max_forward_iters
                or pd_total_iters(eps_forward))
    max_back = flags.max_backward_iters
    h2 = h * h
    nh = n * h
    use_obstacles = flags.contact_enabled and prims.n > 0
    use_self = (flags.contact_enabled and flags.self_collision_enabled
                and self_cfg is not None)
    # the friction sweeps run but with either ablation (step.py:365); the
    # prologue builds the slot geometry but with ablate "detect_only"
    self_fric = use_self and self_cfg.ablate == ""
    # friction runs in every sweep (step.py:294-297)
    has_contact = use_obstacles or use_self
    uses_cg = solve_mode == "cg" and solve_fn is None
    cap_pairs = None
    if use_self:
        cap_pairs = self_cfg.cap_pairs or max(128, n // 2)
    stats = stats if stats is not None else BackwardStats()
    graphs = gr.BlockGraphs(gr.resolve(cuda_graphs, dev, solve_fn))
    # a captured segment holds no host read: a CG inside it runs to its
    # cap (its extra iterations masked no-ops)
    block_checks = not graphs.enabled
    gravity = torch.as_tensor(GRAVITY, dtype=scene.area.dtype, device=dev)

    def wind_factor(params: SimParams, t, step_idx):
        """(sin(freq t + phase) + 1)/2 and friends (fillForces,
        Simulation.cpp:62-85), (B,); step_idx a 0-dim int64 tensor."""
        if wind_config in (WindConfig.WIND_SIN,
                           WindConfig.WIND_SIN_AND_FALLOFF):
            return (torch.sin(params.wind_freq * t + params.wind_phase)
                    + 1.0) / 2.0
        if wind_config == WindConfig.NO_WIND:
            return torch.zeros_like(params.wind_freq)
        if wind_config == WindConfig.WIND_FACTOR_PER_STEP:
            return params.wind_perstep.index_select(
                1, step_idx.reshape(1))[:, 0]
        return torch.ones_like(params.wind_freq)   # WIND_CONSTANT

    def external_force(params: SimParams, mass, t, step_idx):
        """f_ext per particle (fillForces, Simulation.cpp:55-116)."""
        f = torch.zeros(mass.shape + (3,), dtype=mass.dtype,
                        device=mass.device)
        if flags.gravity_enabled:
            f = f + gravity.to(mass.dtype) * mass[..., None]
        if flags.wind_enabled and wind_config != WindConfig.NO_WIND:
            wind_f = params.wind * wind_factor(params, t, step_idx)[:, None]
            if wind_config in (WindConfig.WIND_SIN_AND_FALLOFF,
                               WindConfig.WIND_FACTOR_PER_STEP):
                f = f + wind_f[:, None, :] * scene.wind_falloff
            else:
                f = f + wind_f[:, None, :]
        if flags.constant_forcefield_enabled:
            f = f + params.force_field
        return f

    def masses(params: SimParams):
        return params.density[:, None] * scene.area        # M = rho Area

    # -- constraint operators: dense matmuls or scatter-free incidence

    def apply_A(x):
        """y_t = A0_t x for t in (stretch, bend, attach, spring)."""
        if dense is not None:
            return dn.apply_A(dense, x)
        return spo.apply_A(sparse, x)

    def projections(x_eval, x_fixed):
        """Weightless projections at x_eval (the dense path reads them off
        y = A x_eval, the sparse one gathers vertices)."""
        if dense is not None:
            y = dn.apply_A(dense, x_eval)
            return dn.projections_from_y(dense, y[0], y[1], x_fixed,
                                         y_sp=y[3])
        return spo.projections(sparse, scene, x_eval, x_fixed)

    def apply_At(k_pertype, d_s, d_b, d_a, d_sp):
        if dense is not None:
            return dn.apply_At(dense, k_pertype, d_s, d_b, d_a, d_sp)
        return spo.apply_At(sparse, k_pertype, d_s, d_b, d_a, d_sp)

    def btilde_of(k, m, f_ext, v_n, x_eval, x_fixed, y_n):
        """b~ in residual form (step.py:387-404), k the (B, 4) stiffness:
        h sum_t k_t A0_t^T (p0_t - A0_t x_n) + m v_n + h f_ext."""
        p_s, p_b, p_a, p_sp = projections(x_eval, x_fixed)
        At_d = apply_At(k, p_s - y_n[0], p_b - y_n[1], p_a - y_n[2],
                        p_sp - y_n[3])
        return h * At_d + m[..., None] * v_n + h * f_ext

    def apply_C(k, v):
        """C v = h^2 (sum_t k_t S_t) v."""
        if dense is not None:
            return h2 * dn.apply_S_pertype(dense.S, k, v)
        return h2 * spo.apply_AtA(sparse, k, v)

    def cg_op(st):
        """u -> P u = m u + C u with st's masses and stiffness."""
        return lambda q: st["m"][..., None] * q + apply_C(st["k_pertype"], q)

    def solve(st, rhs, checked: bool):
        """The global solve P^{-1} rhs -> (u, CG iterations (B,) or None)
        with st's p_inv (step.py:425-436): one matmul by the explicit P^{-1}
        ("dense"), or Jacobi-PCG on P u = m u + C u with p_inv = 1/diag(P)
        ("cg", host checks between its blocks when `checked`), or the
        caller's solve_fn."""
        if solve_fn is not None:
            return solve_fn(st["p_inv"], rhs), None
        if solve_mode == "dense":
            return dn.mm(st["p_inv"], rhs), None
        return pcg(cg_op(st), rhs, st["p_inv"], cg_max_iters, cg_rtol,
                   checked)

    def friction(f, contact, ops, mu, m):
        """Obstacle friction first (layer 0), then the layered self-contact
        sweep on f + r_obstacle (step.py:349-385); ops: the step's sweep
        operands."""
        if use_obstacles:
            r = ct.obstacle_friction(f, contact, m, mu)
        else:
            r = torch.zeros_like(f)
        if self_fric:
            r = fc.self_friction(f, ops, r)
        return r

    def params_of(st) -> SimParams:
        """The step's SimParams fields out of st (the rest unused)."""
        return SimParams(**{k: st.get(k) for k in PARAM_FIELDS})

    def bind_inputs(name, x_n, v_n, x_fixed, p_inv, t, step_idx, params,
                    **more) -> dict:
        """Bind a program's inputs: the parameters and P^{-1} copied only
        when they change (a chunk's steps share them)."""
        t = torch.as_tensor(t, dtype=x_n.dtype, device=x_n.device)
        step_idx = torch.as_tensor(step_idx, dtype=torch.int64,
                                   device=x_n.device)
        st = graphs.bind(name, dict(
            x_n=x_n, v_n=v_n, x_fixed=x_fixed, t=t, step_idx=step_idx,
            **more))
        graphs.bind(name, dict(p_inv=p_inv, **{
            k: getattr(params, k) for k in STEP_PARAMS}),
            once=("p_inv",) + STEP_PARAMS)
        st["stats"] = stats.vector(x_n.device)
        return st

    def contact_of(st):
        if not use_obstacles:
            return None
        return ct.ContactSet(*(st[k] for k in CONTACT_ENTRIES))

    def geom_of(st):
        if not self_fric:
            return None
        return fc.KernelGeom(**{k: st[k] for k in GEOM_ENTRIES},
                             overflow=None)

    def bind_ops(st) -> None:
        """st["ops"]: the sweep operands over st's slot geometry and masses,
        validated once per dict when captured (their kernel argument struct
        points at the static buffers), once per call uncaptured."""
        if self_fric and (not graphs.enabled or "ops" not in st):
            st["ops"] = fc.sweep_operands(geom_of(st), (st["kred"], st["imr"],
                                                        st["imp"]),
                                          self_cfg.budgets, n)

    def start_entries(st, params: SimParams) -> dict:
        """What the forward's and the adjoint's loops read besides their
        carry: masses, f_ext, A x_n and the slot masses."""
        m = masses(params)
        out = dict(m=m, f_ext=external_force(params, m, st["t"],
                                             st["step_idx"]))
        out.update({f"y{i}": y for i, y in enumerate(apply_A(st["x_n"]))})
        if self_fric:
            out.update(zip(("kred", "imr", "imp"),
                           fc.slot_masses(geom_of(st), params.density)))
        return out

    def y_of(st) -> tuple:
        return tuple(st[f"y{i}"] for i in range(4))

    # -- forward: prologue, PD loop, epilogue ------------------------------

    def pd_prologue(st) -> None:
        """Contacts once per step and the loop's start (step.py:468-557)."""
        x_n, v_n, params = st["x_n"], st["v_n"], params_of(st)
        B = x_n.shape[0]
        m = masses(params)
        f_ext = external_force(params, m, st["t"], st["step_idx"])
        s_n = x_n + h * v_n + h2 * f_ext / m[..., None]
        v_iter0 = (s_n - x_n) / h
        out = {}
        n_contacts = torch.zeros(B, dtype=torch.int64, device=x_n.device)
        if use_obstacles:
            # once per step, at the time of the step being produced
            # (step.py:472-479)
            contact = ct.detect_obstacle_contacts(prims, x_n, v_iter0, h,
                                                  t=st["t"])
            out.update(zip(CONTACT_ENTRIES, (contact.mask, contact.normal,
                                             contact.v_out, contact.prim_id)))
            n_contacts = contact.mask.sum(dim=1)
        overflow = torch.zeros(B, dtype=torch.bool, device=x_n.device)
        pairs = torch.zeros(B, dtype=torch.int64, device=x_n.device)
        slots = torch.zeros(B, dtype=torch.int32, device=x_n.device)
        if use_self and self_cfg.ablate == "detect_only":
            # ablate "detect_only": detection alone, its overflow flag the
            # step's (step.py:515-520, :540-543)
            if self_cfg.method == "sweep":
                overflow = sc.detect_self_collisions_sweep(
                    self_cfg.allowed, scene.radii, x_n, v_iter0, h,
                    self_cfg.window, cap_pairs).overflow
            else:
                overflow = scd.detect_table(
                    self_cfg.allowed, scene.radii, x_n, v_iter0, h,
                    self_cfg.k_partners)[1]
        elif use_self:
            if self_cfg.method == "sweep":
                cs = sc.detect_self_collisions_sweep(
                    self_cfg.allowed, scene.radii, x_n, v_iter0, h,
                    self_cfg.window, cap_pairs)
                cs = sc.assign_layers(cs, n, self_cfg.max_layers)
                tables = sc.build_layer_tables(cs, n, self_cfg.max_layers)
                overflow = cs.overflow
            else:
                tables, overflow = scd.detect_tables(
                    self_cfg.allowed, scene.radii, x_n, v_iter0, h,
                    self_cfg.k_partners, self_cfg.max_layers)
            geom = fc.build_kernel_geom(tables, scene.area, n,
                                        self_cfg.budgets, x=x_n)
            overflow = (overflow | geom.overflow
                        | (tables.n_layers > len(self_cfg.budgets)))
            pairs = (tables.partner >= 0).sum(dim=(1, 2)) // 2
            slots = geom.counts.sum(dim=1, dtype=torch.int32)
            out.update({k: getattr(geom, k) for k in GEOM_ENTRIES})
            if self_fric:
                out.update(zip(("kred", "imr", "imp"),
                               fc.slot_masses(geom, params.density)))
        zeros = lambda dt: torch.zeros(B, dtype=dt, device=x_n.device)  # noqa
        out.update(
            m=m, f_ext=f_ext,
            **{f"y{i}": y for i, y in enumerate(apply_A(x_n))},
            # the carry: the loop starts from the inertia target
            # (Simulation.cpp:1154-1160)
            x_now=s_n, v_now=v_iter0, best_x=x_n.clone(), best_v=v_n.clone(),
            min_xd=_frob(s_n - x_n) / n, it=zeros(torch.int32),
            cg_it=zeros(torch.int32), done=zeros(torch.bool),
            strict=zeros(torch.bool), since=zeros(torch.int32),
            f=torch.zeros_like(x_n), r=torch.zeros_like(x_n),
            go=~zeros(torch.bool), aux_selfcol_overflow=overflow,
            aux_selfcol_pairs=pairs, aux_selfcol_slots=slots,
            aux_obstacle_contacts=n_contacts)
        graphs.store(st, out)
        bind_ops(st)

    def pd_block(st, k: int) -> None:
        """k masked PD sweeps (the body of step.py:626's while_loop, per
        episode) on the loop's carry in st, written back in place."""
        x_n, v_n, m, kp = st["x_n"], st["v_n"], st["m"], st["k_pertype"]
        y_n = y_of(st)
        c = {name: st[name] for name in PD_CARRY}
        for _ in range(k):
            x_now, v_now = c["x_now"], c["v_now"]
            btilde = btilde_of(kp, m, st["f_ext"], v_n, x_now, st["x_fixed"],
                               y_n)
            if has_contact:
                f_k = btilde - apply_C(kp, v_now)
                r_k = friction(f_k, contact_of(st), st.get("ops"), st["mu"],
                               m)
            else:
                f_k = r_k = torch.zeros_like(x_n)
            v_new, cg_k = solve(st, btilde + r_k, block_checks)
            x_new = x_n + h * v_new
            xd = _frob(x_new - x_now) / n
            better = xd < c["min_xd"]
            since_k = torch.where(better, 0, c["since"] + 1)
            strict_k = xd < eps_forward
            act = ~c["done"]
            a3 = act[:, None, None]
            b3 = (act & better)[:, None, None]
            c["best_x"] = torch.where(b3, x_new, c["best_x"])
            c["best_v"] = torch.where(b3, v_new, c["best_v"])
            c["x_now"] = torch.where(a3, x_new, x_now)
            c["v_now"] = torch.where(a3, v_new, v_now)
            c["f"] = torch.where(a3, f_k, c["f"])
            c["r"] = torch.where(a3, r_k, c["r"])
            c["it"] = c["it"] + act.to(torch.int32)
            if cg_k is not None:
                c["cg_it"] = c["cg_it"] + torch.where(act, cg_k, 0)
            c["min_xd"] = torch.where(act, torch.minimum(xd, c["min_xd"]),
                                      c["min_xd"])
            c["since"] = torch.where(act, since_k, c["since"])
            c["strict"] = torch.where(act, strict_k, c["strict"])
            c["done"] = torch.where(
                act, strict_k | (since_k >= plateau_window), c["done"])
        for name in PD_CARRY:
            st[name].copy_(c[name])
        st["go"].copy_(~c["done"])

    def pd_epilogue(st) -> None:
        """Strict convergence keeps the last iterate; a plateau or cap exit
        reverts to the best iterate (Simulation.cpp:1357-1367); the step's
        diagnostics."""
        s3 = st["strict"][:, None, None]
        x_new = torch.where(s3, st["x_now"], st["best_x"])
        v_new = torch.where(s3, st["v_now"], st["best_v"])
        f = st["f"]
        if not has_contact:
            # the pre-friction force record, reconstructed once post-loop
            kp = st["k_pertype"]
            f = (btilde_of(kp, st["m"], st["f_ext"], st["v_n"], x_new,
                           st["x_fixed"], y_of(st)) - apply_C(kp, v_new))
        avg_def, max_def = deformation(scene, x_new)
        graphs.store(st, dict(
            x_new=x_new, v_new=v_new, aux_f=f, aux_r=st["r"],
            aux_converged=st["done"], aux_iters=st["it"],
            aux_avg_deformation=avg_def, aux_max_deformation=max_def,
            aux_cg_iters=st["cg_it"]))

    def pd_forward(x_n, v_n, params: SimParams, x_fixed, p_inv, t,
                   step_idx, keep_frozen: bool = True):
        """The forward program; returns (x_new, v_new, StepAux, the Frozen
        contacts or None when not `keep_frozen`)."""
        key = ("pd", x_n.shape[0], x_n.dtype)
        st = bind_inputs(key, x_n, v_n, x_fixed, p_inv, t, step_idx, params)
        graphs.program(key, (pd_prologue, gr.Loop(pd_block, max_iter,
                                                  CHECK_EVERY, "pd"),
                             pd_epilogue), st)
        take = graphs.take
        aux = StepAux(*(take(st[k]) for k in AUX_ENTRIES))
        frozen = None
        if keep_frozen:
            frozen = Frozen(
                contact=(ct.ContactSet(*(take(st[k]) for k in
                                         CONTACT_ENTRIES))
                         if use_obstacles else None),
                geom=(fc.KernelGeom(**{k: take(st[k]) for k in GEOM_ENTRIES},
                                    overflow=None) if self_fric else None))
        return take(st["x_new"]), take(st["v_new"]), aux, frozen

    # -- the residual and the K map ------------------------------------------

    def residual(v_new, x_n, v_n, params: SimParams, x_fixed,
                 frozen: Frozen, t, step_idx):
        """R(v_new) = P v_new - b~ - r with every parameter dependence
        explicit (operator form), so one VJP gives every gradient the
        reference hand-derives in stepBackward (:1622-1764).  The masses
        (slot masses included) are recomputed from params.density here, so
        dL/drho flows through them, and mu[prim_id] from params.mu; the
        frozen contacts (normals, v_out, slot geometry) are constants."""
        step_idx = torch.as_tensor(step_idx, dtype=torch.int64,
                                   device=x_n.device)
        m = masses(params)
        f_ext = external_force(params, m, t, step_idx)
        kp = params.k_pertype
        btilde = btilde_of(kp, m, f_ext, v_n, x_n + h * v_new, x_fixed,
                           apply_A(x_n))
        Cv = apply_C(kp, v_new)
        R = m[..., None] * v_new + Cv - btilde
        if has_contact:
            ops = None
            if self_fric:
                ops = fc.sweep_operands(
                    frozen.geom, fc.slot_masses(frozen.geom, params.density),
                    self_cfg.budgets, n)
            R = R - friction(btilde - Cv, frozen.contact, ops, params.mu, m)
        return R

    def k_map(vn, st):
        """K(v) = b~(x_n + h v) + r(f(v)), so that P - dR/dv = dK/dv
        (step.py:683-692): the fixed point needs only K's VJP."""
        kp, m = st["k_pertype"], st["m"]
        btilde = btilde_of(kp, m, st["f_ext"], st["v_n"], st["x_n"] + h * vn,
                           st["x_fixed"], y_of(st))
        if not has_contact:
            return btilde
        return btilde + friction(btilde - apply_C(kp, vn), contact_of(st),
                                 st.get("ops"), st["mu"], m)

    def vjp_k(st, u):
        """(dK/dv)^T u at the step's v_new by autograd: K recomputed (its
        dense products, projections and a forward friction sweep) and
        `torch.autograd.grad` taken of it.  Not on the adjoint's path, which
        applies the linearization (`kdv`): the plain product the tests hold
        `kdv` to (`step.vjp_k` and `step.kdv` on an uncaptured adjoint's
        entries)."""
        with torch.enable_grad():
            vn = st["v_new"].detach().requires_grad_(True)
            return torch.autograd.grad(k_map(vn, st), vn, u)[0]

    # -- the linearized K map (adjoint_linear.py) ----------------------------

    # K's friction part: obstacle friction or self-friction (with neither,
    # K = b~ and a product reads z = u alone)
    lin_fric = use_obstacles or self_fric
    if dense is not None:
        # the four row blocks stacked (stretch rows split), so that one GEMM
        # applies A, and one its transpose, to a product's [z | g]: a copy
        # of the operators (10 MB on the sphere), where one GEMM per block
        # costs two launches more a trip (on an H100, 77 against 66 us a
        # trip of the sphere)
        A_all = torch.cat([dense.A_s, dense.A_b, dense.A_a, dense.A_sp])
        lin_counts = (dense.A_s.shape[0] // 2, dense.A_b.shape[0],
                      dense.A_a.shape[0], dense.A_sp.shape[0])
        lin_consts = (dense.tri_sw, dense.b_scale, dense.sp_l0)
    else:
        # the sparse route's projections are those of its own rows (y = A x
        # is sqrt(area) F for stretch, sqrt(3 / area) e for bending, the
        # polar factor and the normalization invariant to either scale);
        # stretch rows interleaved
        A_all = None
        two_t, n_b, n_f, n_s = sparse.n_rows
        lin_counts = (two_t // 2, n_b, n_f, n_s)
        lin_consts = (torch.sqrt(scene.tri_area),
                      torch.where(scene.b_n_rest <= 1e-6, 0.0,
                                  scene.b_n_rest * scene.b_sw),
                      scene.sp_l0)
    lin_rows = 2 * lin_counts[0] + sum(lin_counts[1:])

    def rows_at(x):
        """A x for every row block: the logical (..., R, 3) rows."""
        if A_all is None:
            return torch.cat(spo.apply_A(sparse, x), dim=-2)
        B = x.shape[0]
        y = A_all @ x.transpose(0, 1).reshape(n, 3 * B)
        return y.view(lin_rows, B, 3).transpose(0, 1)

    def linearize(st) -> None:
        """K's transposed linearization at v_new, once per adjoint program,
        into the adjoint's own entries: "kdv_jac" the per-row Jacobians of
        the projections at x_n + h v_new, "kdv_jobs" the obstacle
        friction's per-particle 3 x 3 at the step's frozen contacts, and
        "kdv_vals" the selects of the one forward friction sweep, at f =
        b~ - C v_new plus the obstacle friction (what K's own sweep reads)."""
        kp, m, v_new = st["k_pertype"], st["m"], st["v_new"]
        x_eval = st["x_n"] + h * v_new
        out, obstacles = {}, None
        if lin_fric:
            f = (btilde_of(kp, m, st["f_ext"], st["v_n"], x_eval,
                           st["x_fixed"], y_of(st)) - apply_C(kp, v_new))
            if use_obstacles:
                obstacles = (f, m, st["c_normal"], st["c_v_out"],
                             st["c_mask"], st["c_prim"], st["mu"])
            if self_fric:
                r0 = (ct.obstacle_friction(f, contact_of(st), m, st["mu"])
                      if use_obstacles else torch.zeros_like(f))
                out["kdv_vals"] = fc.friction_sweep(
                    (f + r0).to(torch.float32).contiguous(), st["ops"])[1]
        jac, jobs = al.linearize(rows_at(x_eval), *lin_consts, lin_counts,
                                 A_all is not None, obstacles)
        out["kdv_jac"] = jac
        if jobs is not None:
            out["kdv_jobs"] = jobs
        graphs.store(st, out)

    def kdv(st, u, add=None):
        """(dK/dv)^T u at v_new through the linearization (`linearize`):
        with g = J_r^T u the friction's transposed Jacobian (the backward
        sweep at "kdv_vals", then J_obs) and z = u + g,

            (dK/dv)^T u = h^2 sum_t k_t A_t^T (J_t^T A_t z - A_t g),

        `kdv_pre`, one GEMM by the stacked rows, `kdv_rows` and the
        transposed GEMM (the sparse route: its gathers).  u (B, n, 3);
        `add` (n, 3 B) node-major, added in the last GEMM.  Returns the
        logical (B, n, 3) (node-major in memory on the dense route)."""
        B = u.shape[0]
        s = None
        if self_fric:
            s = fc.friction_sweep_bwd(u.to(torch.float32).contiguous(),
                                      st["kdv_vals"], st["ops"])[0]
        H = 2 if lin_fric else 1
        zg = al.kdv_pre(u, s, st.get("kdv_jobs"), H, A_all is not None)
        if A_all is None:
            q = al.kdv_rows(torch.cat(spo.apply_A(sparse, zg), dim=-2),
                            st["kdv_jac"], st["k_pertype"], h2, lin_counts,
                            False, False)
            out = sum(op.At(part) for op, part in zip(
                (sparse.s, sparse.b, sparse.a, sparse.sp),
                torch.split(q, list(sparse.n_rows), dim=1)))
            if add is not None:
                out = out + add.view(n, B, 3).transpose(0, 1)
            return out
        # zg is node-major: (n, H B 3) for the GEMM without a copy
        y = A_all @ zg.permute(2, 0, 1, 3).reshape(n, H * B * 3)
        q = al.kdv_rows(y.view(lin_rows, H, B, 3).permute(1, 2, 0, 3),
                        st["kdv_jac"], st["k_pertype"], h2, lin_counts, True,
                        True)
        q = q.transpose(0, 1).reshape(lin_rows, 3 * B)
        out = (A_all.t() @ q if add is None
               else torch.addmm(add, A_all.t(), q))
        return out.view(n, B, 3).transpose(0, 1)

    # -- the implicit adjoint ------------------------------------------------

    def adjoint_ops(st):
        """(P^{-1}, (dR/dv)^T, P^{-1} (dR/dv)^T) on st, and a list whose
        length counts the (dK/dv)^T products made (by each segment run)."""
        made = []

        def P_inv(rhs):
            u, cg_k = solve(st, rhs, block_checks)
            if cg_k is not None:
                _count(st, "cg_solves", 1)
                _count(st, "cg_iters", cg_k.sum())
            return u

        def vjp_v(u):
            """(dR/dv)^T u = P u - (dK/dv)^T u."""
            made.append(1)
            return (st["m"][..., None] * u + apply_C(st["k_pertype"], u)
                    - kdv(st, u))

        return P_inv, vjp_v, (lambda u: P_inv(vjp_v(u))), made

    def count_matvecs(st, made) -> None:
        if made:
            _count(st, "gmres_matvecs", len(made))
            _count(st, "linear_products", len(made))
            st["n_kdv"] += len(made)

    def adj_start(st) -> None:
        """w, the loops' inputs, b_pre = P^{-1} w and the start of the fixed
        point (mode "fp") or of the GMRES cycles (mode "gmres")."""
        params = params_of(st)
        # total cotangent on v_new: x_new = x_n + h v_new
        w = st["v_bar"] + h * st["x_bar"]
        if flags.gradient_clipping:
            # the reference clips the folded gradient dL_dx = w/h at
            # threshold * n_particles (Simulation.cpp:1460-1466)
            norm = _frob(w) / h
            cap = flags.gradient_clipping_threshold * n
            scale = torch.where(norm > cap,
                                cap / torch.clamp(norm, min=1e-30), 1.0)
            w = w * scale[:, None, None]
        w_norm = _frob(w)
        # zero-cotangent lanes: a frozen (exploded) step receives zero
        # cotangents through the episode's freeze select; lambda = 0 is
        # exact there, and the residual at the exploded state would turn
        # 0 * NaN into NaN, so their outputs are selected away
        live = w_norm > 0
        B = w.shape[0]
        graphs.store(st, dict(start_entries(st, params), w=w,
                              w_norm=w_norm, live=live))
        bind_ops(st)
        linearize(st)
        P_inv, vjp_v, op_pre, made = adjoint_ops(st)
        b_pre = P_inv(w)
        out = dict(b_pre=b_pre, n_kdv=torch.zeros((), dtype=torch.int64,
                                                   device=w.device))
        if flags.adjoint_mode == "gmres":
            r0 = _frob(P_inv(w - vjp_v(b_pre)))
            best_res = torch.where(torch.isfinite(r0), r0, float("inf"))
            stop = (best_res / nh < eps_backward) | ~live
            out.update(lam=b_pre.clone(), best_res=best_res, stop=stop,
                       go=~stop,
                       cycles=torch.zeros(B, dtype=torch.int32,
                                          device=w.device))
        else:
            # lam contiguous (the trips update it in place), w node-major
            # (the trips add it in their last GEMM)
            out.update(lam=b_pre.clone(memory_format=torch.contiguous_format),
                       kdv_w=w.transpose(0, 1).reshape(n, 3 * B),
                       it=torch.ones(B, dtype=torch.int32, device=w.device),
                       done=~live, bad=torch.zeros_like(live),
                       go=live.clone(),
                       cg_sum=torch.zeros(B, dtype=torch.int32,
                                          device=w.device))
        graphs.store(st, out)
        count_matvecs(st, made)

    def trip_block(st, k: int) -> None:
        """k masked fixed-point trips (the body of step.py:774's
        while_loop, per episode) on the adjoint's carry in st, in place:
        each the linearized product with w added (`kdv`), the solve, and
        the masked convergence update (`adjoint_linear.trip_update`)."""
        lam, it, done, bad, go = (st[name] for name in
                                  ("lam", "it", "done", "bad", "go"))
        for _ in range(k):
            lam_next, cg_k = solve(st, kdv(st, lam, st["kdv_w"]),
                                   block_checks)
            if cg_k is not None:
                st["cg_sum"].add_(torch.where(done | bad, 0, cg_k))
            al.trip_update(lam, lam_next, st["w_norm"], it, done, bad, go,
                           eps_backward, nh)
        st["n_kdv"].add_(k)
        _count(st, "trips", k)
        _count(st, "linear_products", k)
        if uses_cg:
            _count(st, "cg_solves", k)

    def fallback_start(st) -> None:
        """The fixed point's counts; the episodes it left unconverged go to
        the GMRES fallback (step.py:782-798)."""
        live, it, done, bad = st["live"], st["it"], st["done"], st["bad"]
        if uses_cg:
            _count(st, "cg_iters", st["cg_sum"].sum())
        _count(st, "lane_steps", live.sum())
        _count(st, "lane_trips", torch.where(live, it - 1, 0).sum())
        need = ~(done & ~bad) & live
        _count(st, "fallback_lanes", need.sum())
        graphs.store(st, dict(need=need, go=need.clone()))

    def fallback_block(st, k: int) -> None:
        """k GMRES(16) fallback cycles for the episodes in need."""
        _, _, op_pre, made = adjoint_ops(st)
        lam, need = st["lam"], st["need"]
        for _ in range(k):
            x0 = torch.where(torch.isfinite(lam), lam, 0.0)
            sol = _gmres_cycle(op_pre, st["b_pre"], x0, GMRES_M)
            sol = torch.where(torch.isfinite(sol), sol, 0.0)
            res = _frob(st["b_pre"] - op_pre(sol)) / nh
            lam = torch.where(need[:, None, None], sol, lam)
            need = need & ((res >= eps_backward) | ~torch.isfinite(res))
        st["lam"].copy_(lam)
        st["need"].copy_(need)
        st["go"].copy_(need)
        count_matvecs(st, made)

    def gmres_block(st, k: int) -> None:
        """k cycles of restarted preconditioned GMRES as the primary solver
        (step.py:704-757): a cycle budget of max_back // (M + 2), each
        cycle judged by its TRUE preconditioned residual (the free
        Hessenberg estimate is not trusted), restarted from the best
        iterate; an episode stops on convergence, on a cycle that does not
        improve, or on one that gains under 10 %."""
        P_inv, vjp_v, op_pre, made = adjoint_ops(st)
        lam, best_res, stop, cycles = (st[name] for name in (
            "lam", "best_res", "stop", "cycles"))
        for _ in range(k):
            act = ~stop
            sol = _gmres_cycle(op_pre, st["b_pre"], lam,
                               flags.adjoint_gmres_m)
            res = _frob(P_inv(st["w"] - vjp_v(sol)))
            better = (torch.isfinite(res)
                      & torch.isfinite(sol).all(dim=(-2, -1))
                      & (res < best_res))
            new_res = torch.where(better, res, best_res)
            stop_k = ((new_res / nh < eps_backward) | ~better
                      | (res > 0.9 * best_res))
            lam = torch.where((act & better)[:, None, None], sol, lam)
            best_res = torch.where(act, new_res, best_res)
            stop = torch.where(act, stop_k, stop)
            cycles = cycles + act.to(torch.int32)
        for name, val in zip(("lam", "best_res", "stop", "cycles"),
                             (lam, best_res, stop, cycles)):
            st[name].copy_(val)
        st["go"].copy_(~stop)
        _count(st, "gmres_cycles", k)
        count_matvecs(st, made)

    def adj_finish(wanted):
        def finish(st) -> None:
            """One VJP of the residual for x_n, v_n, x_fixed and the wanted
            params, lambda zero on the lanes without a cotangent."""
            live = st["live"]
            if flags.adjoint_mode == "gmres":
                _count(st, "lane_steps", live.sum())
                _count(st, "lane_trips", st["cycles"].sum())
            lam = torch.where(live[:, None, None], st["lam"], 0.0)
            params = params_of(st)
            with torch.enable_grad():
                leaves = {"x_n": st["x_n"], "v_n": st["v_n"],
                          "x_fixed": st["x_fixed"]}
                leaves.update({k: getattr(params, k) for k in wanted})
                leaves = {k: v.detach().clone().requires_grad_(True)
                          for k, v in leaves.items()}
                pr = params.replace(**{k: leaves[k] for k in wanted})
                R = residual(st["v_new"], leaves["x_n"], leaves["v_n"], pr,
                             leaves["x_fixed"], Frozen(contact_of(st),
                                                       geom_of(st)),
                             st["t"], st["step_idx"])
                grads = torch.autograd.grad(R, list(leaves.values()), lam,
                                            allow_unused=True)
            _count(st, "residual_vjps", 1)
            if self_fric:
                # every (dK/dv)^T product and the residual VJP sweep once
                _count(st, "slot_launches",
                       st["counts"].sum() * (st["n_kdv"] + 1))
            g = {}
            for k, gr_, leaf in zip(leaves, grads, leaves.values()):
                gr_ = torch.zeros_like(leaf) if gr_ is None else gr_
                g[k] = torch.where(live.view((-1,) + (1,) * (gr_.dim() - 1)),
                                   gr_, 0.0)
            graphs.store(st, dict(
                g_x=st["x_bar"] - g.pop("x_n"), g_v=-g.pop("v_n"),
                g_xf=-g.pop("x_fixed"), **{"g_" + k: -v
                                           for k, v in g.items()}))
        return finish

    def step_bwd(x_n, v_n, v_new, params: SimParams, x_fixed,
                 frozen: Frozen, p_inv, t, step_idx, x_bar, v_bar, wanted):
        """Cotangents of (x_new, v_new) -> those of x_n, v_n and x_fixed,
        and a dict of those of the SimParams fields named in `wanted` that
        the step reads (the others get none): the adjoint program."""
        wanted = tuple(k for k in wanted if k in STEP_PARAMS)
        key = ("adj", x_n.shape[0], x_n.dtype, wanted)
        more = dict(v_new=v_new, x_bar=x_bar, v_bar=v_bar)
        if use_obstacles:
            more.update(zip(CONTACT_ENTRIES, (
                frozen.contact.mask, frozen.contact.normal,
                frozen.contact.v_out, frozen.contact.prim_id)))
        if self_fric:
            more.update({k: getattr(frozen.geom, k) for k in GEOM_ENTRIES})
        st = bind_inputs(key, *(a.detach() for a in (x_n, v_n, x_fixed)),
                         p_inv, t, step_idx,
                         SimParams(**{k: v.detach()
                                      for k, v in params.items()}),
                         **{k: v.detach() for k, v in more.items()})
        if flags.adjoint_mode == "gmres":
            cycles = max(1, max_back // (flags.adjoint_gmres_m + 2))
            segments = (adj_start, gr.Loop(gmres_block, cycles, 1, "gmres"),
                        adj_finish(wanted))
        else:
            segments = (adj_start,
                        gr.Loop(trip_block, max_back - 1, CHECK_EVERY,
                                "trips"),
                        fallback_start,
                        gr.Loop(fallback_block, GMRES_CYCLES, 1, "fallback"),
                        adj_finish(wanted))
        graphs.program(key, segments, st)
        take = graphs.take
        return (take(st["g_x"]), take(st["g_v"]), take(st["g_xf"]),
                {k: take(st["g_" + k]) for k in wanted})

    step_def = types.SimpleNamespace(forward=pd_forward, backward=step_bwd)

    def step(x_n, v_n, params: SimParams, x_fixed, p_inv, t, step_idx):
        tensors = (x_n, v_n, x_fixed) + tuple(getattr(params, k)
                                              for k in PARAM_FIELDS)
        # the frozen contacts are kept only for a backward that may follow
        keep = torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in tensors)
        out = StepFn.apply(step_def, keep, p_inv, t, step_idx, x_n, v_n,
                           x_fixed, *(getattr(params, k)
                                      for k in PARAM_FIELDS))
        return out[0], out[1], StepAux(*out[2:])

    step.bwd_stats = stats
    step.graphs = graphs
    # the product the trips take, the autograd one the tests hold it to, and
    # the operands of its linearization, for checks of its kernels
    step.kdv, step.vjp_k = kdv, vjp_k
    step.lin = types.SimpleNamespace(rows_at=rows_at, counts=lin_counts,
                                     split=A_all is not None,
                                     consts=lin_consts)
    return step, residual
