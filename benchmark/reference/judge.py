"""What the reference works out to judge a run: each step again from the
program's own state before it, and each step's adjoint again at the
program's own cotangents on the state after it.

In f32 a self-contact amplifies rounding from step to step, and the
adjoint's fixed point stops at an absolute tolerance, so a whole episode
of the reference, or a whole backward chain, drifts from any f32 run by
far more than the run's own error.  The reference therefore follows the
program step by step.  Forward: step k of the reference starts from the
program's state after step k - 1 (the benchmark's start for step 1) and is
compared with the program's state after step k.  Backward: the
reference's VJP of step k, at the program's cotangents on the state after
it, gives the cotangent on the state before it, compared with the
program's there, and the step's share of the parameters' gradient; the
gradient is the sum of those shares."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import losses
from benchmark.reference.config import LossType
from benchmark.reference.types import EpisodeRecords, SimParams, StepRecord

# (episode, step) pairs of one batched call of `adjoint_steps`
ADJOINT_BLOCK = 200


def batched_params(sim, base: dict, fields: dict, x0: np.ndarray
                   ) -> SimParams:
    """The reference's batched SimParams: its defaults, then `base` (field
    -> value for every episode), then `fields` (field -> (B, ...) numpy,
    one row an episode) and the starts x0 (B, n, 3)."""
    B = x0.shape[0]
    dev, dt = sim.device, sim.dtype

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dt,
                               device=dev)

    p = sim.default_params().replace(**{k: t(v) for k, v in base.items()})
    p = p.expand(B)
    return p.replace(x0=t(x0), **{k: t(v) for k, v in fields.items()})


def _rel(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per episode |a - ref| / |ref| over all but the leading dim."""
    dims = tuple(range(1, ref.dim()))
    num = torch.sqrt(((a - ref) ** 2).sum(dims))
    return num / torch.sqrt((ref ** 2).sum(dims)).clamp_min(1e-30)


def step_at(sim, params: SimParams, k: int, x, v):
    """Step k (1-based: the step that produces frame k) of every episode
    from its state (x, v) after step k - 1."""
    ts, idxs = sim._times()
    xfs = sim.x_fixed_seq(params)
    return sim.step(x, v, params, xfs[:, k - 1], sim.p_inv(params),
                    ts[k - 1], idxs[k - 1])


def follow(sim, params: SimParams, k: int, x_prev, v_prev, x_next, v_next):
    """Step k again from the program's state before it: (B,) the relative
    gap of the program's velocity after it.  Arrays as numpy or
    tensors."""
    dev, dt = sim.device, sim.dtype
    x_prev, v_prev, x_next, v_next = (
        torch.as_tensor(np.asarray(a), device=dev).to(dt)
        for a in (x_prev, v_prev, x_next, v_next))
    with torch.no_grad():
        _, v_ref, _ = step_at(sim, params, k, x_prev, v_prev)
    return _rel(v_next, v_ref).cpu().numpy()


def loss_cotangents(X, x0, target):
    """MATCH_TRAJECTORY's loss (E,) of the program's frames X (E, N, n, 3)
    after the starts x0 (E, n, 3), and its cotangents dL/dX."""
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    Xl = X.clone().requires_grad_(True)
    st = StepRecord(x=Xl, v=zero, f=zero, r=zero, x_fixed=zero,
                    converged=zero, iters=zero, avg_deformation=zero,
                    max_deformation=zero, selfcol_overflow=zero,
                    selfcol_pairs=zero, selfcol_slots=zero,
                    obstacle_contacts=zero, cg_iters=zero)
    loss_fn = losses.make_loss_fn(LossType.MATCH_TRAJECTORY,
                                  losses.LossInfo(target_x=target))
    with torch.enable_grad():
        loss = loss_fn(EpisodeRecords(x0=x0, v0=zero, steps=st))
        dX, = torch.autograd.grad(loss.sum(), [Xl])
    return loss.detach(), dX


def adjoint_steps(sim, params: SimParams, X, V, LX, LV, target, vector,
                  block: int = ADJOINT_BLOCK):
    """Every step of each episode of `params` again, from the program's
    state before it, with its VJP at the program's cotangents on the state
    after it.  X, V (E, N, n, 3) the program's states after steps 1..N;
    LX, LV the cotangents its adjoint gave those states; target
    (E, N + 1, n, 3); `vector` the [field, index or None] of each entry of
    the gradient vector.  The steps are independent given the program's
    states and cotangents, so they run batched, `block` (episode, step)
    pairs a call, each with its own time.

    Returns (loss (E,) of the reference's own states after each step,
    gradient (E, D): the sum of every step's parameter VJP (the loss reads
    no parameter), the (E, N) relative velocity gap of
    each step, the (E, N - 1) gap |lambda_ref - lambda| of the cotangent
    each step passes back (with the loss's own on that state) to the
    program's cotangent lambda there, and (E, N) the program's |lambda| on
    each state)."""
    dev, dt = sim.device, sim.dtype
    if sim.cfg.wind_config.name == "WIND_FACTOR_PER_STEP":
        raise NotImplementedError("per-step wind factors index by step")

    def t_(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt)

    X, V, LX, LV, target = map(t_, (X, V, LX, LV, target))
    E, N = X.shape[:2]
    _, dX = loss_cotangents(X, params.x0, target)
    xfs, p_inv = sim.x_fixed_seq(params), sim.p_inv(params)
    ts, idxs = sim._times()
    fields = sorted({f for f, _ in vector})
    grads = {f: torch.zeros_like(getattr(params, f)) for f in fields}
    gaps = torch.zeros((E, N), dtype=dt, device=dev)
    back_x = torch.zeros_like(X)
    back_v = torch.zeros_like(V)
    x_ref = torch.zeros_like(X)
    pairs = [(e, k) for e in range(E) for k in range(1, N + 1)]
    for lo in range(0, len(pairs), block):
        e = torch.tensor([q[0] for q in pairs[lo:lo + block]], device=dev)
        k = torch.tensor([q[1] for q in pairs[lo:lo + block]], device=dev)
        first = k == 1
        km = (k - 2).clamp(min=0)
        x_prev = torch.where(first[:, None, None], params.x0[e], X[e, km])
        v_prev = torch.where(first[:, None, None], params.v0[e], V[e, km])
        leaves = {f: getattr(params, f)[e].detach().clone()
                  .requires_grad_(True) for f in fields}
        p = SimParams(**{f: a[e] for f, a in params.items()}).replace(
            **leaves)
        with torch.enable_grad():
            xp = x_prev.detach().clone().requires_grad_(True)
            vp = v_prev.detach().clone().requires_grad_(True)
            x_new, v_new, _ = sim.step(xp, vp, p, xfs[e, k - 1], p_inv,
                                       ts[k - 1], idxs[k[0] - 1])
            g = torch.autograd.grad([x_new, v_new], [xp, vp]
                                    + list(leaves.values()),
                                    [LX[e, k - 1], LV[e, k - 1]],
                                    allow_unused=True)
        gaps[e, k - 1] = _rel(V[e, k - 1], v_new.detach())
        x_ref[e, k - 1] = x_new.detach()
        back_x[e, k - 1], back_v[e, k - 1] = g[0], g[1]
        for f, gf in zip(fields, g[2:]):
            if gf is not None:
                grads[f].index_add_(0, e, gf)
    # the cotangent on the state after step k - 1: the loss's own plus
    # what step k passes back
    pred_x = dX[:, :-1] + back_x[:, 1:]
    pred_v = back_v[:, 1:]
    lam = torch.sqrt((LX ** 2).sum((-2, -1)) + (LV ** 2).sum((-2, -1)))
    num = torch.sqrt(((pred_x - LX[:, :-1]) ** 2).sum((-2, -1))
                     + ((pred_v - LV[:, :-1]) ** 2).sum((-2, -1)))

    G = torch.stack([grads[f][:, i] if i is not None else grads[f]
                     for f, i in vector], dim=1)
    loss, _ = loss_cotangents(x_ref, params.x0, target)
    return (loss.cpu().numpy(), G.cpu().numpy(), gaps.cpu().numpy(),
            num.cpu().numpy(), lam.cpu().numpy())
