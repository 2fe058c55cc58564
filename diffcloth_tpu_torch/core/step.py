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
  The JAX package's self-collision profiling and TPU tuning options
  (`ablate`, `friction_unroll`, `friction_impl`, `compact_*`) are not
  ported.

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
R then gives every gradient.  Each (dK/dv)^T product recomputes K at v_new
and takes one `torch.autograd.grad` of it, its friction part the forward
and the backward sweep kernel (`friction_cuda.FrictionSweep`).  `StepFn`
(a `torch.autograd.Function`) is the counterpart of the step's
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
with a `solve_fn`, the same block functions are called directly.  A CG
solve inside a captured PD sweep or fixed-point trip runs to its cap
(`cg_max_iters`) without host reads, its extra iterations masked; the
iterates are the same.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Optional

import numpy as np
import torch

from diffcloth_tpu_torch.config import (GRAVITY, SimFlags, WindConfig,
                                        pd_total_iters)
from diffcloth_tpu_torch.core import contact as ct
from diffcloth_tpu_torch.core import dense_ops as dn
from diffcloth_tpu_torch.core import friction_cuda as fc
from diffcloth_tpu_torch.core import graphs as gr
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


@dataclasses.dataclass
class SelfColConfig:
    """Static self-collision configuration.  method "kernel": `allowed` is
    the (n_pad, n_pad) int8 symmetric admissibility table the detection
    kernel reads and `k_partners` its partner slots per row.  method
    "sweep": `allowed` is the (n, n) bool symmetric non-adjacency table,
    `window` the sorted-order window and `cap_pairs` the pair capacity of a
    step (None: max(128, n // 2)).  The JAX package's "matrix" and
    "pallas" methods are both the kernel here (its CPU route is the
    kernel's plain version) and raise."""
    allowed: torch.Tensor
    k_partners: int         # partner slots per row (detection kernel)
    max_layers: int         # layering rounds
    budgets: tuple          # per-layer friction slot budgets
    method: str = "kernel"
    window: int = 48
    cap_pairs: Optional[int] = None

    def __post_init__(self):
        if self.method not in ("kernel", "sweep"):
            raise ValueError(
                f"self-collision method {self.method!r}: the port has "
                f"'kernel' (the JAX package's 'pallas' and 'matrix'; on the "
                f"CPU it runs the kernel's plain version) and 'sweep'")


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


@dataclasses.dataclass
class BackwardStats:
    """Counters of the adjoint, summed over `step_bwd` calls since the last
    `reset()`.  Every (dK/dv)^T product (a fixed-point trip or a GMRES
    matvec) and every residual VJP launches the forward and the backward
    friction sweep once each for the whole batch when self-collision is
    on.  `trips` counts the trips the blocks ran, masked ones included."""
    trips: int = 0           # fixed-point sweeps over the batch
    gmres_matvecs: int = 0   # (dK/dv)^T products of GMRES (either mode)
    gmres_cycles: int = 0    # GMRES cycles over the batch (mode "gmres")
    residual_vjps: int = 0   # VJPs of the residual
    lane_steps: object = 0   # (episode, step) pairs with a nonzero cotangent
    lane_trips: object = 0   # their fixed-point trips (GMRES cycles)
    fallback_lanes: object = 0   # of them that fell to the GMRES fallback
    slot_launches: object = 0    # active friction slots over all launches
    cg_solves: int = 0       # CG solves over the batch (solve_mode "cg")
    cg_iters: object = 0     # their iterations, summed over the episodes
    #                          (a trip's only where the episode is active)

    def reset(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def summary(self) -> dict:
        """Host numbers (one device read)."""
        out = {f.name: float(getattr(self, f.name))
               for f in dataclasses.fields(self)}
        out["launches"] = (out["trips"] + out["gmres_matvecs"]
                           + out["residual_vjps"])
        return out


def _lstsq_host(H: torch.Tensor, e1: torch.Tensor, eps: float):
    """Least squares min |e1 - H y| per episode, on the host in f64 by SVD
    (numpy's gelsd), with the cutoff rcond = eps * max(H.shape) that
    jnp.linalg.lstsq applies in the simulation dtype.  A rank-deficient H
    (a happy breakdown) is fine; an episode with non-finite H or e1 gets a
    NaN y, which the caller replaces by zeros as the JAX package does."""
    Hn = H.detach().cpu().double().numpy()
    en = e1.detach().cpu().double().numpy()
    y = np.full((Hn.shape[0], Hn.shape[2]), np.nan)
    rcond = eps * max(Hn.shape[1:])
    for b in range(Hn.shape[0]):
        if np.isfinite(Hn[b]).all() and np.isfinite(en[b]).all():
            y[b] = np.linalg.lstsq(Hn[b], en[b], rcond=rcond)[0]
    return torch.as_tensor(y).to(device=H.device, dtype=H.dtype)


def _gmres_cycle(op, b, x0, m: int):
    """One GMRES(m) cycle on op(u) = b from x0, for each episode of the batch
    (step.py:97-140): Arnoldi with modified Gram-Schmidt, then the
    (m+1, m) Hessenberg least squares on the host.  b, x0 (B, n, 3)."""
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
    y = _lstsq_host(H, e1, torch.finfo(r0.dtype).eps)
    return x0 + torch.einsum("bm,bmn->bn", y, V[:, :m]).reshape(shape)


def _run_blocks(total: int, run_block, active=None) -> int:
    """Run `total` masked iterations as blocks of CHECK_EVERY (the last one
    shorter when CHECK_EVERY does not divide `total`): run_block(k) runs k
    of them.  Between blocks the host reads active() (a (B,) bool tensor)
    and stops when no episode is active; active None (inside a captured
    block, where no host read may sit) runs every block.  The extra
    iterations of a finished episode are masked no-ops, so either way the
    iterates and counts are those of the JAX package's while_loop.  Returns
    the iterations run, masked ones included."""
    for k in range(0, total, CHECK_EVERY):
        if k and active is not None and not bool(active().any()):
            return k
        run_block(min(CHECK_EVERY, total - k))
    return total


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
    _run_blocks(max_iters, lambda k: _cg_block(op, st, k, max_iters),
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
    `Frozen` contacts."""

    @staticmethod
    def forward(ctx, step_def, p_inv, t, step_idx, x_n, v_n, x_fixed,
                *param_tensors):
        params = SimParams(**dict(zip(PARAM_FIELDS, param_tensors)))
        x_new, v_new, aux, frozen = step_def.forward(
            x_n, v_n, params, x_fixed, p_inv, t, step_idx)
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
                                            ctx.needs_input_grad[7:]) if need)
        gx, gv, gxf, gp = ctx.step_def.backward(
            x_n, v_n, v_new, params, x_fixed, ctx.frozen, ctx.p_inv, ctx.t,
            ctx.step_idx, x_bar, v_bar, wanted)
        return (None, None, None, None, gx, gv, gxf) + tuple(
            gp.get(k) for k in PARAM_FIELDS)


# the loops' carries, written back in place by their blocks
PD_CARRY = ("x_now", "v_now", "best_x", "best_v", "min_xd", "it", "cg_it",
            "done", "strict", "since", "f", "r")
TRIP_CARRY = ("lam", "it", "done", "bad", "cg_sum")


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
             p_inv, t (0-dim tensor), step_idx (int))
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
    (`graphs.resolve`): None runs the loops' blocks as CUDA graphs on a
    CUDA scene without `solve_fn` and uncaptured otherwise, True insists
    on graphs, False runs the same blocks uncaptured; `step.graphs` holds
    the step's blocks and graphs."""
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
    max_iter = (max_forward_iters or flags.max_forward_iters
                or pd_total_iters(eps_forward))
    max_back = flags.max_backward_iters
    h2 = h * h
    nh = n * h
    use_obstacles = flags.contact_enabled and prims.n > 0
    use_self = (flags.contact_enabled and flags.self_collision_enabled
                and self_cfg is not None)
    # friction runs in every sweep (step.py:294-297)
    has_contact = use_obstacles or use_self
    uses_cg = solve_mode == "cg" and solve_fn is None
    cap_pairs = None
    if use_self:
        cap_pairs = self_cfg.cap_pairs or max(128, n // 2)
    stats = stats if stats is not None else BackwardStats()
    graphs = gr.BlockGraphs(gr.resolve(cuda_graphs, scene.area.device,
                                       solve_fn))
    # a captured block holds no host read: a CG inside it runs to its cap
    # (its extra iterations masked no-ops)
    block_checks = not graphs.enabled

    def wind_factor(params: SimParams, t, step_idx):
        """(sin(freq t + phase) + 1)/2 and friends (fillForces,
        Simulation.cpp:62-85), (B,)."""
        if wind_config in (WindConfig.WIND_SIN,
                           WindConfig.WIND_SIN_AND_FALLOFF):
            return (torch.sin(params.wind_freq * t + params.wind_phase)
                    + 1.0) / 2.0
        if wind_config == WindConfig.NO_WIND:
            return torch.zeros_like(params.wind_freq)
        if wind_config == WindConfig.WIND_FACTOR_PER_STEP:
            return params.wind_perstep[:, int(step_idx)]
        return torch.ones_like(params.wind_freq)   # WIND_CONSTANT

    def external_force(params: SimParams, mass, t, step_idx):
        """f_ext per particle (fillForces, Simulation.cpp:55-116), computed
        before the blocks (`wind_factor` indexes by the step)."""
        f = torch.zeros(mass.shape + (3,), dtype=mass.dtype,
                        device=mass.device)
        if flags.gravity_enabled:
            g = torch.as_tensor(GRAVITY, dtype=mass.dtype, device=mass.device)
            f = f + g * mass[..., None]
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
        return lambda q: st["m"][..., None] * q + apply_C(st["k"], q)

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

    def solve_alone(st, rhs):
        """`solve` outside the loops' blocks (the adjoint's first solve and
        its GMRES): with graphs and solve_mode "cg", the CG iterations run
        as replayed CG blocks."""
        if not (graphs.enabled and uses_cg):
            return solve(st, rhs, True)
        name = ("cg", rhs.shape[0], rhs.dtype)
        cst = graphs.bind(name, dict(_cg_start(cg_op(st), rhs, st["p_inv"],
                                               cg_rtol),
                                     m=st["m"], k=st["k"]))
        _run_blocks(cg_max_iters,
                    lambda k: graphs.run(name + (k,), lambda s: _cg_block(
                        cg_op(s), s, k, cg_max_iters), cst),
                    lambda: cst["active"])
        return cst["x"].clone(), cst["it"].clone()

    def sweep_ops(geom, params: SimParams):
        """The step's slot operands, validated once for all its sweeps."""
        return fc.sweep_operands(geom, fc.slot_masses(geom, params.density),
                                 self_cfg.budgets, n)

    def friction(f, contact, ops, mu, m):
        """Obstacle friction first (layer 0), then the layered self-contact
        sweep on f + r_obstacle (step.py:349-385); ops: the step's sweep
        operands."""
        if use_obstacles:
            r = ct.obstacle_friction(f, contact, m, mu)
        else:
            r = torch.zeros_like(f)
        if use_self:
            r = fc.self_friction(f, ops, r)
        return r

    def frozen_entries(contact, ops) -> dict:
        """The frozen contacts' tensors, as entries of a block's dict."""
        d = {}
        if use_obstacles:
            d.update(c_mask=contact.mask, c_normal=contact.normal,
                     c_v_out=contact.v_out, c_prim=contact.prim_id)
        if use_self:
            kred, imr, imp = ops.masses
            d.update(idx_row=ops.geom.idx_row, idx_part=ops.geom.idx_part,
                     normalT=ops.geom.normalT, counts=ops.geom.counts,
                     kred=kred, imr=imr, imp=imp)
        return d

    def bind_frozen(st, ops) -> None:
        """st["contact"] and st["ops"] over st's frozen entries: the step's
        own sweep operands uncaptured; captured, operands over the slot
        buffers, whose kernel argument struct points at them (validated
        once per dict)."""
        if use_obstacles:
            st["contact"] = ct.ContactSet(st["c_mask"], st["c_normal"],
                                          st["c_v_out"], st["c_prim"])
        if not use_self:
            return
        if not graphs.enabled:
            st["ops"] = ops
        elif "ops" not in st:
            geom = fc.KernelGeom(
                idx_row=st["idx_row"], idx_part=st["idx_part"],
                normalT=st["normalT"], area_row=None, area_part=None,
                counts=st["counts"], overflow=None)
            st["ops"] = fc.sweep_operands(geom, (st["kred"], st["imr"],
                                                 st["imp"]),
                                          self_cfg.budgets, n)

    def y_entries(x_n) -> dict:
        return {f"y{i}": y for i, y in enumerate(apply_A(x_n))}

    def y_of(st) -> tuple:
        return tuple(st[f"y{i}"] for i in range(4))

    # -- forward PD loop ----------------------------------------------------

    def pd_block(st, k: int) -> None:
        """k masked PD sweeps (the body of step.py:626's while_loop, per
        episode) on the loop's carry in st, written back in place."""
        x_n, v_n, m, kp = st["x_n"], st["v_n"], st["m"], st["k"]
        y_n = y_of(st)
        c = {name: st[name] for name in PD_CARRY}
        for _ in range(k):
            x_now, v_now = c["x_now"], c["v_now"]
            btilde = btilde_of(kp, m, st["f_ext"], v_n, x_now, st["x_fixed"],
                               y_n)
            if has_contact:
                f_k = btilde - apply_C(kp, v_now)
                r_k = friction(f_k, st.get("contact"), st.get("ops"),
                               st["mu"], m)
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

    def pd_forward(x_n, v_n, params: SimParams, x_fixed, p_inv, t,
                   step_idx):
        B = x_n.shape[0]
        dev = x_n.device
        m = masses(params)
        f_ext = external_force(params, m, t, step_idx)
        s_n = x_n + h * v_n + h2 * f_ext / m[..., None]
        v_iter0 = (s_n - x_n) / h
        contact = None
        n_contacts = torch.zeros(B, dtype=torch.int64, device=dev)
        if use_obstacles:
            # once per step, at the time of the step being produced
            # (step.py:472-479)
            contact = ct.detect_obstacle_contacts(prims, x_n, v_iter0, h,
                                                  t=t)
            n_contacts = contact.mask.sum(dim=1)

        overflow = torch.zeros(B, dtype=torch.bool, device=dev)
        pairs = torch.zeros(B, dtype=torch.int64, device=dev)
        slots = torch.zeros(B, dtype=torch.int32, device=dev)
        geom = ops = None
        if use_self:
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
            ops = sweep_ops(geom, params)
        frozen = Frozen(contact=contact, geom=geom)

        name = ("pd", B, x_n.dtype, ops.route if use_self else None)
        zeros = lambda dt: torch.zeros(B, dtype=dt, device=dev)  # noqa: E731
        st = graphs.bind(name, dict(
            x_n=x_n, v_n=v_n, x_fixed=x_fixed, f_ext=f_ext, m=m,
            k=params.k_pertype, mu=params.mu, p_inv=p_inv,
            **y_entries(x_n), **frozen_entries(contact, ops),
            # the carry: the loop starts from the inertia target
            # (Simulation.cpp:1154-1160)
            x_now=s_n, v_now=v_iter0, best_x=x_n.clone(),
            best_v=v_n.clone(), min_xd=_frob(s_n - x_n) / n,
            it=zeros(torch.int32), cg_it=zeros(torch.int32),
            done=zeros(torch.bool), strict=zeros(torch.bool),
            since=zeros(torch.int32), f=torch.zeros_like(x_n),
            r=torch.zeros_like(x_n)), once=("p_inv",))
        bind_frozen(st, ops)
        _run_blocks(max_iter,
                    lambda k: graphs.run(name + (k,),
                                         lambda s: pd_block(s, k), st),
                    lambda: ~st["done"])
        # strict convergence keeps the last iterate; plateau / cap exit
        # reverts to the best iterate (Simulation.cpp:1357-1367)
        s3 = st["strict"][:, None, None]
        x_new = torch.where(s3, st["x_now"], st["best_x"])
        v_new = torch.where(s3, st["v_now"], st["best_v"])
        r = st["r"].clone()
        if has_contact:
            f = st["f"].clone()
        else:
            # the pre-friction force record, reconstructed once post-loop
            kp = params.k_pertype
            f = (btilde_of(kp, m, f_ext, v_n, x_new, x_fixed, y_of(st))
                 - apply_C(kp, v_new))
        avg_def, max_def = deformation(scene, x_new)
        aux = StepAux(f=f, r=r, converged=st["done"].clone(),
                      iters=st["it"].clone(), avg_deformation=avg_def,
                      max_deformation=max_def, selfcol_overflow=overflow,
                      selfcol_pairs=pairs, selfcol_slots=slots,
                      obstacle_contacts=n_contacts,
                      cg_iters=st["cg_it"].clone())
        return x_new, v_new, aux, frozen

    # -- the residual and the K map ------------------------------------------

    def residual(v_new, x_n, v_n, params: SimParams, x_fixed,
                 frozen: Frozen, t, step_idx):
        """R(v_new) = P v_new - b~ - r with every parameter dependence
        explicit (operator form), so one VJP gives every gradient the
        reference hand-derives in stepBackward (:1622-1764).  The masses
        (slot masses included) are recomputed from params.density here, so
        dL/drho flows through them, and mu[prim_id] from params.mu; the
        frozen contacts (normals, v_out, slot geometry) are constants."""
        m = masses(params)
        f_ext = external_force(params, m, t, step_idx)
        kp = params.k_pertype
        btilde = btilde_of(kp, m, f_ext, v_n, x_n + h * v_new, x_fixed,
                           apply_A(x_n))
        Cv = apply_C(kp, v_new)
        R = m[..., None] * v_new + Cv - btilde
        if has_contact:
            ops = sweep_ops(frozen.geom, params) if use_self else None
            R = R - friction(btilde - Cv, frozen.contact, ops, params.mu, m)
        return R

    def k_map(vn, st):
        """K(v) = b~(x_n + h v) + r(f(v)), so that P - dR/dv = dK/dv
        (step.py:683-692): the fixed point needs only K's VJP."""
        kp, m = st["k"], st["m"]
        btilde = btilde_of(kp, m, st["f_ext"], st["v_n"], st["x_n"] + h * vn,
                           st["x_fixed"], y_of(st))
        if not has_contact:
            return btilde
        return btilde + friction(btilde - apply_C(kp, vn), st.get("contact"),
                                 st.get("ops"), st["mu"], m)

    def vjp_k(st, u):
        """(dK/dv)^T u at the step's v_new.  K's forward is recomputed for
        each product (one forward friction sweep beside the backward one),
        so that a captured block holds both: autograd cannot replay inside
        a graph the backward of a forward recorded outside it."""
        with torch.enable_grad():
            vn = st["v_new"].detach().requires_grad_(True)
            return torch.autograd.grad(k_map(vn, st), vn, u)[0]

    # -- the implicit adjoint ------------------------------------------------

    def trip_block(st, k: int) -> None:
        """k masked fixed-point trips (the body of step.py:774's
        while_loop, per episode) on the adjoint's carry in st, written back
        in place."""
        lam, it, done, bad, cg_sum = (st[name] for name in TRIP_CARRY)
        for _ in range(k):
            act = ~(done | bad)
            lam_next, cg_k = solve(st, st["w"] + vjp_k(st, lam),
                                   block_checks)
            delta = _frob(lam_next - lam) / nh
            bad_k = ~torch.isfinite(delta) | (
                _frob(lam_next) > 1e8 * (st["w_norm"] + 1e-30))
            lam = torch.where(act[:, None, None], lam_next, lam)
            it = it + act.to(torch.int32)
            done = torch.where(act, delta < eps_backward, done)
            bad = torch.where(act, bad_k, bad)
            if cg_k is not None:
                cg_sum = cg_sum + torch.where(act, cg_k, 0)
        for name, val in zip(TRIP_CARRY, (lam, it, done, bad, cg_sum)):
            st[name].copy_(val)

    def step_bwd(x_n, v_n, v_new, params: SimParams, x_fixed,
                 frozen: Frozen, p_inv, t, step_idx, x_bar, v_bar, wanted):
        """Cotangents of (x_new, v_new) -> those of x_n, v_n and x_fixed,
        and a dict of those of the SimParams fields named in `wanted`."""
        B = x_n.shape[0]
        params = SimParams(**{k: v.detach() for k, v in params.items()})
        x_n, v_n, v_new, x_fixed = (a.detach()
                                    for a in (x_n, v_n, v_new, x_fixed))
        # total cotangent on v_new: x_new = x_n + h v_new
        w = v_bar + h * x_bar
        if flags.gradient_clipping:
            # the reference clips the folded gradient dL_dx = w/h at
            # threshold * n_particles (Simulation.cpp:1460-1466)
            norm = _frob(w) / h
            cap = flags.gradient_clipping_threshold * n
            scale = torch.where(norm > cap,
                                cap / torch.clamp(norm, min=1e-30), 1.0)
            w = w * scale[:, None, None]
        w_norm = _frob(w)
        # zero-cotangent short-circuit: a frozen (exploded) step receives
        # zero cotangents through the episode's freeze select; lambda = 0
        # is exact there, and evaluating the residual at the exploded state
        # would turn 0 * NaN into NaN, so its outputs are selected away
        live = w_norm > 0
        if not bool(live.any()):
            return (x_bar, torch.zeros_like(v_n), torch.zeros_like(x_fixed),
                    {k: torch.zeros_like(getattr(params, k))
                     for k in wanted})

        m = masses(params)
        ops = sweep_ops(frozen.geom, params) if use_self else None
        name = ("adj", B, x_n.dtype, ops.route if use_self else None)
        st = graphs.bind(name, dict(
            x_n=x_n, v_n=v_n, v_new=v_new, x_fixed=x_fixed,
            f_ext=external_force(params, m, t, step_idx), m=m,
            k=params.k_pertype, mu=params.mu, p_inv=p_inv, w=w,
            w_norm=w_norm, **y_entries(x_n),
            **frozen_entries(frozen.contact, ops)), once=("p_inv",))
        bind_frozen(st, ops)
        matvecs = 0     # (dK/dv)^T products outside the trip blocks

        def P_inv(rhs):
            u, cg_k = solve_alone(st, rhs)
            if cg_k is not None:
                stats.cg_solves += 1
                stats.cg_iters = stats.cg_iters + cg_k.sum()
            return u

        def vjp_v(u):
            """(dR/dv)^T u = P u - (dK/dv)^T u."""
            nonlocal matvecs
            matvecs += 1
            return m[..., None] * u + apply_C(params.k_pertype, u) - vjp_k(
                st, u)

        def op_pre(u):
            """P^{-1} (dR/dv)^T u, the GMRES operator."""
            return P_inv(vjp_v(u))

        b_pre = P_inv(w)
        trips = 0
        if flags.adjoint_mode == "gmres":
            # ---- restarted preconditioned GMRES as the primary solver
            # (step.py:704-757): a cycle budget of max_back // (M + 2),
            # each cycle judged by its TRUE preconditioned residual (the
            # free Hessenberg estimate is not trusted), restarted from the
            # best iterate; an episode stops on convergence, on a cycle
            # that does not improve, or on one that gains under 10 %
            M = flags.adjoint_gmres_m

            def true_res(u):
                return _frob(P_inv(w - vjp_v(u)))

            r0 = true_res(b_pre)
            best_res = torch.where(torch.isfinite(r0), r0, float("inf"))
            lam = b_pre
            stop = (best_res / nh < eps_backward) | ~live
            cycles = torch.zeros(B, dtype=torch.int32, device=w.device)
            for _ in range(max(1, max_back // (M + 2))):
                act = ~stop
                if not bool(act.any()):
                    break
                sol = _gmres_cycle(op_pre, b_pre, lam, M)
                res = true_res(sol)
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
                stats.gmres_cycles += 1
            stats.lane_steps = stats.lane_steps + live.sum()
            stats.lane_trips = stats.lane_trips + cycles.sum()
        else:
            # ---- the reference's fixed point (Simulation.cpp:1569-1599)
            graphs.bind(name, dict(
                lam=b_pre.clone(),
                it=torch.ones(B, dtype=torch.int32, device=w.device),
                done=~live, bad=torch.zeros_like(live),
                cg_sum=torch.zeros(B, dtype=torch.int32, device=w.device)))
            trips = _run_blocks(
                max_back - 1,
                lambda k: graphs.run(name + (k,),
                                     lambda s: trip_block(s, k), st),
                lambda: ~(st["done"] | st["bad"]))
            lam, it, done, bad = (st[k].clone()
                                  for k in ("lam", "it", "done", "bad"))
            stats.trips += trips
            if uses_cg:
                stats.cg_solves += trips
                stats.cg_iters = stats.cg_iters + st["cg_sum"].sum()
            stats.lane_steps = stats.lane_steps + live.sum()
            stats.lane_trips = stats.lane_trips + torch.where(live, it - 1,
                                                              0).sum()

            # ---- GMRES(16) fallback, up to 3 cycles, for the episodes
            # whose fixed point did not converge (step.py:782-798)
            need = ~(done & ~bad) & live
            stats.fallback_lanes = stats.fallback_lanes + need.sum()
            for _ in range(GMRES_CYCLES):
                if not bool(need.any()):
                    break
                x0 = torch.where(torch.isfinite(lam), lam, 0.0)
                sol = _gmres_cycle(op_pre, b_pre, x0, GMRES_M)
                sol = torch.where(torch.isfinite(sol), sol, 0.0)
                res = _frob(b_pre - op_pre(sol)) / nh
                lam = torch.where(need[:, None, None], sol, lam)
                need = need & ((res >= eps_backward) | ~torch.isfinite(res))
        stats.gmres_matvecs += matvecs
        lam = torch.where(live[:, None, None], lam, 0.0)

        # ---- one VJP of the residual for x_n, v_n, x_fixed and params
        with torch.enable_grad():
            leaves = {"x_n": x_n, "v_n": v_n, "x_fixed": x_fixed}
            leaves.update({k: getattr(params, k) for k in wanted})
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in leaves.items()}
            pr = params.replace(**{k: leaves[k] for k in wanted})
            R = residual(v_new, leaves["x_n"], leaves["v_n"], pr,
                         leaves["x_fixed"], frozen, t, step_idx)
            grads = torch.autograd.grad(R, list(leaves.values()), lam,
                                        allow_unused=True)
        stats.residual_vjps += 1
        if use_self:
            # every (dK/dv)^T product and the residual VJP sweep once
            stats.slot_launches = (stats.slot_launches
                                   + frozen.geom.counts.sum()
                                   * (trips + matvecs + 1))
        g = {}
        for k, gr_, leaf in zip(leaves, grads, leaves.values()):
            gr_ = torch.zeros_like(leaf) if gr_ is None else gr_
            g[k] = torch.where(live.view((-1,) + (1,) * (gr_.dim() - 1)),
                               gr_, 0.0)
        return (x_bar - g.pop("x_n"), -g.pop("v_n"), -g.pop("x_fixed"),
                {k: -v for k, v in g.items()})

    step_def = types.SimpleNamespace(forward=pd_forward, backward=step_bwd)

    def step(x_n, v_n, params: SimParams, x_fixed, p_inv, t, step_idx):
        out = StepFn.apply(step_def, p_inv, t, step_idx, x_n, v_n, x_fixed,
                           *(getattr(params, k) for k in PARAM_FIELDS))
        return out[0], out[1], StepAux(*out[2:])

    step.bwd_stats = stats
    step.graphs = graphs
    return step, residual
