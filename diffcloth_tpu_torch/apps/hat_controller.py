"""Closed-loop NN hat-dressing controller on the port.

Counterpart of the repository's `apps/hat_controller.py` (reference:
src/python_code/hatController.py, clothNN/controller.py, common.py:61-78):
a tanh MLP reads the cloth's state every step and moves the two clips by
a bounded delta; it is trained through the simulator's implicit-adjoint
steps to put the hat on the bust.  Same command line and defaults:

    python -m diffcloth_tpu_torch.apps.hat_controller [--epochs N]
        [--train-samples K] [--steps N] [--eval] [--resume] [--cpu]
        [--standin]

`--standin` runs the hat's 25 x 25 grid stand-in
(`registry.hat_grid_standin`; the hat mesh is not in the repository, and
`build_task("hat")` raises without it).

The pieces are importable: `featurize`, `Controller` (widths [feat, 64,
64, 3F], orthogonal init with gains 5/3 and 5/3 * 0.001 from a seeded
`torch.Generator`), `control_action`, `closed_loop_rollout`, `chunk_roll`,
`vjp_chunk`, `rollout_chunked`, `traj_loss`, `loss_and_grad`,
`sample_pose`, `train` and `evaluate`; `main` is the command line.

The episode runs as the JAX app's chunks of CHUNK = 50 steps (the largest
divisor of the horizon at most `chunk`): `chunk_roll` runs a chunk's
closed loop without gradient, `vjp_chunk` recomputes a chunk's forward
from its saved start under autograd and takes its VJP, so `loss_and_grad`
holds one chunk's step residuals, not the horizon's; `episode_loss` and
`evaluate` run the no-gradient chunks.  Inside a chunk the host waits on
nothing: on the card each step is two launches of captured device
programs, the controller's (featurize, the MLP, the clip, the action
update; `HatProblem.graphs`) and the step's forward.
`loss_and_grad(..., chunk=None)` runs the whole episode as one autograd
graph (`closed_loop_rollout`, with the controller inline), the route the
chunks are held to.

What differs from the JAX app, with the same arithmetic:
  * per-sample policy gradients come from per-episode copies of the
    weights, (B, ...) leaves applied with `torch.bmm`, so each chunk's VJP
    yields all B of them (the JAX app vmaps a VJP);
  * the action-cotangent clamp is an autograd.Function that clamps each
    episode's cotangent norm, as the JAX custom_vjp does under vmap;
  * `torch.optim.Adam` after optax's global-norm clip (g / |g| when
    |g| >= 1, not `clip_grad_norm_`, which adds 1e-6 to the norm), its
    rate set every epoch to optax's `cosine_decay_schedule(lr, epochs,
    alpha=0.1)` in closed form (the formula of `CosineAnnealingLR(T_max=
    epochs, eta_min=0.1 lr)`, without its recursive update's rounding);
  * checkpoints are the port's npz ones (weights, Adam moments and step,
    the whole numpy RNG state, the best validation loss), so a resumed run
    equals an unbroken one; `controller.pkl` keeps the JAX app's format (a
    list of {"w", "b"} numpy dicts), so controllers move between the
    packages (`convert.controller_from_numpy` / `controller_to_numpy`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pickle
import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from diffcloth_tpu_torch.convert import (controller_from_numpy,
                                         controller_to_numpy)
from diffcloth_tpu_torch.core import graphs as gr
from diffcloth_tpu_torch.core.device import resolve_device
from diffcloth_tpu_torch.tasks import registry
from diffcloth_tpu_torch.tasks.setup import TaskSetup, build_task
from diffcloth_tpu_torch.utils import checkpoint as ckpt

V_MIN, V_MAX = -0.1, 0.1     # action-delta clamp (common.py:63)
DIR_PAIRS = ((394, 562), (32, 108))   # CLIP_DIR_VERTEX_PAIR (:211)
HIDDEN = (64, 64)            # hatController.py:232
CHUNK = 50                   # steps per chunk (apps/hat_controller.py:134)


@dataclasses.dataclass
class HatProblem:
    """What the controller's pieces read from the hat task: the sim, its
    parameters and P^{-1}, the head sphere, the clips, the target (the hat
    translated onto the bust) and the horizon."""
    sim: object
    params: object            # single SimParams
    p_inv: torch.Tensor
    head_center: torch.Tensor  # (3,)
    head_radius: float
    attach_idx: torch.Tensor   # (F,) long
    x0: torch.Tensor           # (n, 3)
    clip0: torch.Tensor        # (F, 3)
    target: torch.Tensor       # (n, 3)
    dir_pairs: torch.Tensor    # (2, 2) long
    clip_rest_dist: float
    n_steps: int
    times: tuple               # (N,) step times i h, (N,) int64 indices i
    graphs: gr.BlockGraphs     # the controller's device programs
    _batched: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False)

    def batched_params(self, B: int):
        """The task's parameters for B episodes, made once per B (a step
        program binds them again only when they change)."""
        if B not in self._batched:
            self._batched[B] = self.params.expand(B)
        return self._batched[B]


def make_problem(task: TaskSetup, steps: Optional[int] = None
                 ) -> HatProblem:
    """The hat task's pieces; `steps` cuts the horizon (None: the scene's
    400).  The step times and indices are device vectors, as
    `ClothSim._times()`'s, so no step makes a host tensor."""
    sim = task.sim
    params = task.param_base
    dev = sim.device
    clip0 = sim.stage_dev.fixed_pos_rest.to(sim.dtype)
    n_steps = steps or sim.n_steps
    return HatProblem(
        sim=sim, params=params, p_inv=sim.p_inv(params),
        head_center=sim.prims.center[0].to(sim.dtype),
        head_radius=float(sim.prims.radius[0]),
        attach_idx=torch.as_tensor(np.asarray(sim.stage_host.particle_idx),
                                   dtype=torch.long, device=dev),
        x0=params.x0, clip0=clip0,
        target=task.loss_info.x_init + task.loss_info.target_translation,
        dir_pairs=torch.as_tensor(DIR_PAIRS, dtype=torch.long, device=dev),
        clip_rest_dist=float(torch.linalg.vector_norm(clip0[1] - clip0[0])),
        n_steps=n_steps,
        times=(torch.arange(1, n_steps + 1, dtype=sim.dtype, device=dev)
               * sim.h,
               torch.arange(1, n_steps + 1, dtype=torch.int64, device=dev)),
        graphs=gr.BlockGraphs(sim.cuda_graphs))


def featurize(prob: HatProblem, x, v):
    """The controller's input per episode (reference getState,
    hatController.py:137-154): [x - target, the head's projection of the
    cloth's mean, the elevation vector, the mean velocity, the two
    direction vectors]; x, v (B, n, 3) -> (B, 3n + 15)."""
    B = x.shape[0]
    x_mean, v_mean = x.mean(dim=1), v.mean(dim=1)
    d = x_mean - prob.head_center
    elev = prob.head_radius * d / torch.clamp(
        torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9)
    proj = elev + prob.head_center
    dp = prob.dir_pairs
    dirs = (x[:, dp[:, 0]] - x[:, dp[:, 1]]).reshape(B, -1)
    return torch.cat([(x - prob.target).reshape(B, -1), proj, elev, v_mean,
                      dirs], dim=1)


class Controller(nn.Module):
    """tanh MLP h <- tanh(h @ w + b), the last layer linear
    (clothNN/controller.py); weights stored (in, out) as in the JAX app.
    `generator` given: orthogonal init with gain 5/3, the last layer's
    5/3 * 0.001, zero biases; otherwise zeros (to be filled).  On the
    card unless `device` says otherwise."""

    def __init__(self, widths, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        ps = []
        for i in range(len(widths) - 1):
            w = torch.zeros(widths[i], widths[i + 1], dtype=dtype)
            if generator is not None:
                gain = 5.0 / 3.0 if i < len(widths) - 2 else \
                    (5.0 / 3.0) * 0.001
                nn.init.orthogonal_(w, gain, generator=generator)
            ps += [w, torch.zeros(widths[i + 1], dtype=dtype)]
        self.weights = nn.ParameterList(
            [nn.Parameter(p.to(device)) for p in ps])

    def layers(self):
        return list(self.weights)

    def forward(self, s):
        return net(self.layers(), s)


def net(ws: List[torch.Tensor], s):
    """The MLP on s (B, feat) with weights [w0, b0, w1, b1, ...], each
    shared ((in, out), (out,)) or one per episode ((B, in, out), (B, out))."""
    h = s
    n_layers = len(ws) // 2
    for i in range(n_layers):
        w, b = ws[2 * i], ws[2 * i + 1]
        h = (torch.bmm(h[:, None, :], w)[:, 0] if w.dim() == 3
             else h @ w) + b
        if i < n_layers - 1:
            h = torch.tanh(h)
    return h


class _CotangentClamp(torch.autograd.Function):
    """Identity forward; the backward scales each episode's cotangent
    (B, F, 3) to norm max_norm where it is larger (the bridge's dL/da
    clamp, pySim/functional.py:89-99, as the JAX app's custom_vjp under
    vmap)."""

    @staticmethod
    def forward(ctx, a, max_norm):
        ctx.max_norm = max_norm
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        nrm = torch.sqrt(torch.sum(g * g, dim=(1, 2), keepdim=True))
        scale = torch.where(nrm > ctx.max_norm,
                            ctx.max_norm / torch.clamp(nrm, min=1e-30), 1.0)
        return g * scale, None


class Rollout(NamedTuple):
    x: torch.Tensor           # (B, n, 3) final state
    v: torch.Tensor
    a: torch.Tensor           # (B, F, 3) final clip targets
    clip_traj: torch.Tensor   # (B, N, F, 3) clipped vertices per step
    iters: torch.Tensor       # (B, N) PD sweeps per step
    states: Optional[torch.Tensor]   # (B, N, n, 3) with record=True


def control_action(prob: HatProblem, ws, x, v, a):
    """The controller's work for one step: the MLP on the features of
    (x, v), clipped to [-1, 1] and mapped to a bounded delta of the clip
    targets a (B, F, 3) -> the step's clip targets."""
    out = torch.clamp(net(ws, featurize(prob, x, v)), -1.0, 1.0)
    return a + ((out + 1.0) / 2.0 * (V_MAX - V_MIN) + V_MIN).reshape(
        a.shape)


def _captured_action(prob: HatProblem, ws, x, v, a):
    """`control_action` without gradient as a device program: on the card
    its captured graph, bound to the weights once per call (copied only
    when they change) and to x, v, a per step; elsewhere the same segment,
    called directly."""
    g = prob.graphs
    names = tuple(f"w{i}" for i in range(len(ws)))
    key = ("control", x.shape[0], x.dtype, tuple(w.shape for w in ws))
    st = g.bind(key, dict(x=x, v=v, a=a))
    g.bind(key, dict(zip(names, ws)), once=names)

    def segment(s):
        g.store(s, {"a_new": control_action(prob, [s[k] for k in names],
                                            s["x"], s["v"], s["a"])})

    g.program(key, (segment,), st)
    return g.take(st["a_new"])


def _closed_loop(prob: HatProblem, ws, x, v, a, lo: int, hi: int, act,
                 action_grad_clamp: float = 0.0,
                 record: bool = False) -> Rollout:
    """Closed-loop steps lo..hi-1 (1-based) from (x, v, a): act(prob, ws,
    x, v, a) -> the step's clip targets, then the simulator's step at its
    time and index, both read from `prob.times`."""
    sim = prob.sim
    pb = prob.batched_params(x.shape[0])
    ts, idxs = prob.times
    clips, iters, states = [], [], []
    for i in range(lo, hi):
        a = act(prob, ws, x, v, a)
        a_in = (_CotangentClamp.apply(a, action_grad_clamp)
                if action_grad_clamp > 0 else a)
        x, v, aux = sim.step(x, v, pb, a_in, prob.p_inv, ts[i - 1],
                             idxs[i - 1])
        clips.append(x[:, prob.attach_idx])
        iters.append(aux.iters)
        if record:
            states.append(x.detach())
    return Rollout(x=x, v=v, a=a, clip_traj=torch.stack(clips, dim=1),
                   iters=torch.stack(iters, dim=1),
                   states=torch.stack(states, dim=1) if record else None)


def closed_loop_rollout(prob: HatProblem, ws, x, v, a,
                        action_grad_clamp: float = 0.0,
                        record: bool = False) -> Rollout:
    """`prob.n_steps` closed-loop steps (controller, then simulator) of a
    batch of episodes from (x, v, a) (B, n/n/F, 3), with weights `ws` (see
    `net`), the controller inline: the whole episode as one autograd
    graph, differentiable in ws and the start through every step's
    implicit adjoint.  action_grad_clamp > 0 clamps the cotangent reaching
    each step's clip targets to that norm per episode."""
    return _closed_loop(prob, ws, x, v, a, 1, prob.n_steps + 1,
                        control_action, action_grad_clamp, record)


def chunk_size(n_steps: int, chunk: int) -> int:
    """The largest divisor of the horizon at most `chunk`, so every chunk
    has one length (apps/hat_controller.py:222-225)."""
    return next(c for c in range(min(chunk, n_steps), 0, -1)
                if n_steps % c == 0)


def chunk_roll(prob: HatProblem, ws, x, v, a, lo: int, chunk: int,
               record: bool = False) -> Rollout:
    """The JAX app's `chunk_roll` (apps/hat_controller.py:161-182): `chunk`
    closed-loop steps lo..lo+chunk-1 from (x, v, a), without gradient; on
    the card each step launches the controller's program and the step's
    forward program, and the host waits on neither.  Returns the chunk's
    final (x, v, a), its clipped vertices (B, chunk, F, 3) and, with
    `record`, its states."""
    with torch.no_grad():
        return _closed_loop(prob, ws, x, v, a, lo, lo + chunk,
                            _captured_action, record=record)


def rollout_chunked(prob: HatProblem, ws, x, v, a, chunk: int = CHUNK,
                    record: bool = False):
    """The horizon as no-gradient chunks of `chunk_size(N, chunk)` steps:
    (its Rollout, equal to `closed_loop_rollout`'s bit for bit, and each
    chunk's start (x, v, a))."""
    c = chunk_size(prob.n_steps, chunk)
    starts, parts = [], []
    for lo in range(1, prob.n_steps + 1, c):
        starts.append((x, v, a))
        r = chunk_roll(prob, ws, x, v, a, lo, c, record)
        x, v, a = r.x, r.v, r.a
        parts.append(r)

    def cat(k):
        return torch.cat([getattr(r, k) for r in parts], dim=1)

    return Rollout(x=x, v=v, a=a, clip_traj=cat("clip_traj"),
                   iters=cat("iters"),
                   states=cat("states") if record else None), starts


def vjp_chunk(prob: HatProblem, ws, x, v, a, lo: int, chunk: int, cots,
              action_grad_clamp: float = 0.0) -> list:
    """The JAX app's `vjp_chunk` (apps/hat_controller.py:186-192): the
    chunk's forward recomputed under autograd from its start (x, v, a),
    then its VJP for cots (cot_x, cot_v, cot_a, dclip) of its final
    (x, v, a) and clipped vertices -> the cotangents of ws (per episode,
    as ws is) and of x, v, a."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (*ws, x, v, a)]
        r = _closed_loop(prob, leaves[:len(ws)], *leaves[len(ws):], lo,
                         lo + chunk, control_action, action_grad_clamp)
        g = torch.autograd.grad([r.x, r.v, r.a, r.clip_traj], leaves, cots,
                                allow_unused=True)
    return [torch.zeros_like(t) if gi is None else gi
            for t, gi in zip(leaves, g)]


def _smooth_l1(d):
    ad = torch.abs(d)
    return torch.mean(torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5), dim=-1)


def traj_loss(prob: HatProblem, clip_traj, xN):
    """The composite loss per episode (hatController.py:54-76): the clips'
    stretch beyond 1 of their rest distance, the direction vectors'
    misalignment with the target's, and smooth-L1 to the target;
    clip_traj (B, N, F, 3), xN (B, n, 3) -> (B,)."""
    B = xN.shape[0]
    clip_dist = torch.linalg.vector_norm(
        clip_traj[:, :, 1] - clip_traj[:, :, 0], dim=-1)
    stretch = torch.sum(torch.clamp(
        torch.abs(clip_dist - prob.clip_rest_dist) - 1.0, min=0.0),
        dim=1) * 0.2
    dp = prob.dir_pairs
    dirs = xN[:, dp[:, 0]] - xN[:, dp[:, 1]]
    goal = prob.target[dp[:, 0]] - prob.target[dp[:, 1]]
    cos = torch.sum(
        dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        * goal / torch.linalg.vector_norm(goal, dim=-1, keepdim=True),
        dim=-1)
    direction = torch.sum((0.5 - torch.clamp(cos, max=0.5)) * 3.0, dim=-1)
    target_l = _smooth_l1(xN.reshape(B, -1) - prob.target.reshape(-1))
    return stretch + direction + target_l


class PolicyGradient(NamedTuple):
    loss: torch.Tensor            # () mean episode loss over the batch
    grads: List[torch.Tensor]     # the kept samples' summed gradient
    sample_gnorms: np.ndarray     # (B,) per-sample gradient norms
    dropped: np.ndarray           # (B,) bool
    iters: torch.Tensor           # (B, N) PD sweeps per step
    forward_s: float
    backward_s: float


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def loss_and_grad(prob: HatProblem, ctrl: Controller, xs, aas,
                  action_grad_clamp: float = 4.0,
                  sample_gnorm_max: float = 1e3,
                  chunk: Optional[int] = CHUNK) -> PolicyGradient:
    """The mean episode loss over a batch of start poses (xs (B, n, 3),
    clip targets aas (B, F, 3), at rest) and its policy gradient.  Each
    episode runs its own copy of the weights, so the backward pass gives
    every per-sample gradient (of the mean: each carries 1/B); a sample
    whose gradient norm exceeds `sample_gnorm_max` (> 0) is dropped, unless
    all would be (contact-stiff outlier rejection, hatController.py
    :254-272), and the kept ones are summed.

    The JAX app's scheme (apps/hat_controller.py:227-272): the forward
    chunk by chunk without gradient, keeping each chunk's start; the
    loss's cotangents of the clip trajectory and of x_N; the chunks in
    reverse (`vjp_chunk`), the per-episode weight gradients summed over
    them.  chunk=None: the whole episode as one autograd graph
    (`closed_loop_rollout`); the two agree up to the order of the
    gradient's sums."""
    B = xs.shape[0]
    dev = prob.sim.device
    ws = [p.detach().expand((B,) + p.shape).clone() for p in ctrl.layers()]
    v0 = torch.zeros_like(xs)
    t0 = time.perf_counter()
    if not chunk:
        ws = [w.requires_grad_(True) for w in ws]
        with torch.enable_grad():
            roll = closed_loop_rollout(prob, ws, xs, v0, aas,
                                       action_grad_clamp=action_grad_clamp)
            L = torch.mean(traj_loss(prob, roll.clip_traj, roll.x))
            _sync(dev)
            t1 = time.perf_counter()
            gs = torch.autograd.grad(L, ws)
    else:
        roll, starts = rollout_chunked(prob, ws, xs, v0, aas, chunk)
        with torch.enable_grad():
            clip = roll.clip_traj.requires_grad_(True)
            xN = roll.x.detach().requires_grad_(True)
            L = torch.mean(traj_loss(prob, clip, xN))
            dclip, dxN = torch.autograd.grad(L, [clip, xN])
        _sync(dev)
        t1 = time.perf_counter()
        c = chunk_size(prob.n_steps, chunk)
        cot = [dxN, torch.zeros_like(roll.v), torch.zeros_like(roll.a)]
        gs = None
        for k in reversed(range(len(starts))):
            g = vjp_chunk(prob, ws, *starts[k], 1 + k * c, c,
                          cot + [dclip[:, k * c:(k + 1) * c]],
                          action_grad_clamp)
            cot = g[len(ws):]
            gs = g[:len(ws)] if gs is None else [
                a + b for a, b in zip(gs, g[:len(ws)])]
    _sync(dev)
    t2 = time.perf_counter()
    gn = torch.sqrt(sum(torch.sum(g.reshape(B, -1) ** 2, dim=1)
                        for g in gs))
    keep = (gn <= sample_gnorm_max if sample_gnorm_max > 0
            else torch.ones_like(gn, dtype=torch.bool))
    keep = torch.where(keep.any(), keep, torch.ones_like(keep))
    grads = [torch.sum(torch.where(keep.view((-1,) + (1,) * (g.dim() - 1)),
                                   g, 0.0), dim=0) for g in gs]
    return PolicyGradient(loss=L.detach(), grads=grads,
                          sample_gnorms=gn.cpu().numpy(),
                          dropped=(~keep).cpu().numpy(), iters=roll.iters,
                          forward_s=t1 - t0, backward_s=t2 - t1)


def sample_pose(prob: HatProblem, rng: np.random.RandomState):
    """A start pose on a sphere around the head (hatController.py:18-28):
    the cloth and its clips translated, (n, 3) and (F, 3)."""
    x0 = prob.x0.detach().cpu().numpy()
    clip0 = prob.clip0.detach().cpu().numpy()
    head = prob.head_center.detach().cpu().numpy()
    cloth_center = x0.mean(axis=0)
    diff = head - cloth_center
    dist = float(np.linalg.norm([diff[0], diff[2]])) + 3.0
    xz = rng.uniform(0, 2 * math.pi)
    y = math.radians(rng.uniform(0, 90))
    point = np.array([dist * math.cos(y) * math.cos(xz), 0.0,
                      dist * math.cos(y) * math.sin(xz)])
    point[1] = dist * math.sin(y)
    center = head.copy()
    center[1] = cloth_center[1]
    translation = (point + center) - cloth_center

    def t(a):
        return torch.as_tensor(a).to(device=prob.sim.device,
                                     dtype=prob.sim.dtype)

    return t(x0 + translation), t(clip0 + translation)


def stack_poses(prob: HatProblem, rng, count: int):
    poses = [sample_pose(prob, rng) for _ in range(count)]
    return (torch.stack([p[0] for p in poses]),
            torch.stack([p[1] for p in poses]))


def episode_loss(prob: HatProblem, ctrl: Controller, xs, aas,
                 chunk: int = CHUNK) -> float:
    """The mean forward-only loss of a batch of start poses (the JAX app's
    `val_loss`, apps/hat_controller.py:312-322), in chunks of `chunk`
    steps."""
    roll, _ = rollout_chunked(prob, ctrl.layers(), xs, torch.zeros_like(xs),
                              aas, chunk)
    return float(torch.mean(traj_loss(prob, roll.clip_traj, roll.x)))


def cosine_lr(lr: float, epoch: int, epochs: int,
              alpha: float = 0.1) -> float:
    """optax.cosine_decay_schedule(lr, epochs, alpha) at `epoch`."""
    count = float(min(epoch, epochs))
    decay = 0.5 * (1 + math.cos(math.pi * count / float(epochs)))
    return lr * ((1 - alpha) * decay + alpha)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm in place: g / |g| * max_norm when the
    global norm |g| is not below max_norm.  Returns |g|."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    trigger = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g, (g / g_norm) * max_norm))
    return g_norm


def adam_step(opt: torch.optim.Adam, params, grads, lr: float) -> float:
    """One update of optax.chain(clip_by_global_norm(1.0), adam(lr)), as
    the JAX app builds it: the gradient clipped to global norm 1.0, then
    the Adam step at rate lr.  Returns the norm before the clip."""
    for p, g in zip(params, grads):
        p.grad = g.detach().clone()
    gnorm = clip_by_global_norm_([p.grad for p in params], 1.0)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    opt.zero_grad(set_to_none=True)
    return float(gnorm)


@dataclasses.dataclass
class TrainConfig:
    """The command line's training options, with its defaults."""
    epochs: int = 40
    train_samples: int = 8
    seed: int = 0
    lr: float = 2e-4                 # hatController.py:233
    lr_decay: str = "cosine"         # or "none"
    action_grad_clamp: float = 4.0
    sample_gnorm_max: float = 1e3
    val_samples: int = 4
    resume: bool = False
    out: str = "output/hat_controller"


def _adam_state(opt, params):
    return [{k: opt.state[p][k] for k in ("step", "exp_avg", "exp_avg_sq")}
            for p in params]


def _rng_state(rng: np.random.RandomState):
    _, keys, pos, has_gauss, gauss = rng.get_state()
    return {"keys": keys, "pos": np.asarray(pos),
            "has_gauss": np.asarray(has_gauss), "gauss": np.asarray(gauss)}


def train(prob: HatProblem, cfg: TrainConfig, log=print,
          on_epoch=None) -> dict:
    """Train the controller (reference training loop,
    hatController.py:156-250): per epoch, `train_samples` poses from the
    seeded stream, one `loss_and_grad`, optax's global-norm clip at 1.0,
    an Adam step at the epoch's rate, the validation loss of a fixed pose
    set; the best-validation controller goes to `out/controller.pkl`, the
    epoch's state to an npz checkpoint under `out/ckpts`, the log to
    `out/log.json`.  `on_epoch(epoch, PolicyGradient)`, if given, sees each
    epoch's gradient.  Returns {"log", "best", "controller"}."""
    sim = prob.sim
    rng = np.random.RandomState(cfg.seed)
    gen = torch.Generator().manual_seed(cfg.seed)
    feat = featurize(prob, prob.x0[None], torch.zeros_like(prob.x0)[None])
    widths = [feat.shape[1], *HIDDEN, 3 * prob.clip0.shape[0]]
    ctrl = Controller(widths, sim.dtype, sim.device, generator=gen)
    params = ctrl.layers()
    opt = torch.optim.Adam(params, lr=cfg.lr)

    def lr_at(epoch):
        return (cosine_lr(cfg.lr, epoch, max(cfg.epochs, 1))
                if cfg.lr_decay == "cosine" else cfg.lr)

    # a fixed validation set from a held-out stream
    xs_val, aas_val = stack_poses(prob, np.random.RandomState(
        cfg.seed + 10007), cfg.val_samples)
    os.makedirs(cfg.out, exist_ok=True)
    ckpt_dir = os.path.join(cfg.out, "ckpts")
    log_path = os.path.join(cfg.out, "log.json")
    history, start, best = [], 0, float("inf")
    if cfg.resume and ckpt.latest_step(ckpt_dir) is not None:
        start, state = ckpt.restore_checkpoint(ckpt_dir)
        with torch.no_grad():
            for p, layer in zip(params, [a for d in state["ws"]
                                         for a in (d["w"], d["b"])]):
                p.copy_(torch.as_tensor(layer))
        for p, st in zip(params, state["adam"]):
            opt.state[p] = {
                "step": torch.as_tensor(st["step"]),
                "exp_avg": torch.as_tensor(st["exp_avg"]).to(p),
                "exp_avg_sq": torch.as_tensor(st["exp_avg_sq"]).to(p)}
        r = state["rng"]
        rng.set_state(("MT19937", np.asarray(r["keys"], np.uint32),
                       int(r["pos"]), int(r["has_gauss"]), float(r["gauss"])))
        best = float(state["best"])
        if os.path.exists(log_path):
            with open(log_path) as fh:
                history = json.load(fh)[:start]
        log(f"resumed from epoch {start} (best {best:.5f})")

    for epoch in range(start, cfg.epochs):
        t0 = time.time()
        xs, aas = stack_poses(prob, rng, cfg.train_samples)
        pg = loss_and_grad(prob, ctrl, xs, aas, cfg.action_grad_clamp,
                           cfg.sample_gnorm_max)
        if on_epoch is not None:
            on_epoch(epoch, pg)
        lr_now = lr_at(epoch)
        gnorm = adam_step(opt, params, pg.grads, lr_now)
        vl = episode_loss(prob, ctrl, xs_val, aas_val)
        loss = float(pg.loss)
        n_drop = int(pg.dropped.sum())
        history.append({"epoch": epoch, "train": loss, "val": vl,
                        "gnorm": round(gnorm, 4), "lr": lr_now,
                        "sample_gnorms": [round(float(g), 3)
                                          for g in pg.sample_gnorms],
                        "dropped": n_drop})
        log(f"epoch {epoch}: train {loss:.5f} val {vl:.5f} gnorm "
            f"{gnorm:.3f} sample gnorms "
            f"{np.array2string(pg.sample_gnorms, precision=3)} lr "
            f"{lr_now:.2e} dropped {n_drop} ({time.time() - t0:.1f}s)")
        with open(log_path, "w") as fh:
            json.dump(history, fh)
        if vl < best:   # the best-VAL controller (hatController.py:156-185)
            best = vl
            with open(os.path.join(cfg.out, "controller.pkl"), "wb") as fh:
                pickle.dump(controller_to_numpy(ctrl), fh)
        ckpt.save_checkpoint(
            ckpt_dir, epoch + 1,
            {"ws": controller_to_numpy(ctrl),
             "adam": _adam_state(opt, params), "rng": _rng_state(rng),
             "best": np.asarray(best)},
            metadata={"loss": loss, "val": vl})
    log(f"done; best val loss {best if history else None}")
    return {"log": history, "best": best, "controller": ctrl}


def evaluate(prob: HatProblem, controller_path: str, seed: int = 0,
             gif: Optional[str] = None, log=print,
             chunk: int = CHUNK) -> dict:
    """The trained controller on one pose (reference eval mode,
    hatController.py:253-273; the JAX app's chunked eval rollout,
    apps/hat_controller.py:332-358): a closed-loop episode from the pose of
    RandomState(seed + 1) in chunks of `chunk` steps, its loss, and with
    `gif` its frames rendered there (io/viewer.py, every 8th).  Returns
    {"loss", "frames"}."""
    with open(controller_path, "rb") as fh:
        ctrl = controller_from_numpy(pickle.load(fh), prob.sim.device,
                                     prob.sim.dtype)
    x, a = sample_pose(prob, np.random.RandomState(seed + 1))
    roll, _ = rollout_chunked(prob, ctrl.layers(), x[None],
                              torch.zeros_like(x)[None], a[None], chunk,
                              record=True)
    L = float(traj_loss(prob, roll.clip_traj, roll.x)[0])
    frames = torch.cat([x[None], roll.states[0]]).cpu().numpy()
    log(f"eval loss {L:.5f}")
    if gif:
        from diffcloth_tpu_torch.io import viewer
        viewer.render_episode(frames, prob.sim.scene_host.tris, gif,
                              stride=8)
        log(f"wrote {gif}")
    return {"loss": L, "frames": frames}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--train-samples", type=int, default=8)
    ap.add_argument("--steps", type=int, default=None,
                    help="override horizon (default: scene's 400)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--lr-decay", default="cosine",
                    choices=["cosine", "none"],
                    help="cosine-decay the LR to 10%% over the run")
    ap.add_argument("--action-grad-clamp", type=float, default=4.0,
                    help="per-step norm clamp on the action cotangent "
                         "(pySim/functional.py:89-99); 0 disables")
    ap.add_argument("--sample-gnorm-max", type=float, default=1e3,
                    help="drop a sampled pose's policy gradient when its "
                         "norm exceeds this; 0 disables")
    ap.add_argument("--val-samples", type=int, default=4,
                    help="fixed held-out poses evaluated every epoch; the "
                         "shipped controller is the best-validation one")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --out")
    ap.add_argument("--out", default="output/hat_controller")
    ap.add_argument("--standin", action="store_true",
                    help="the hat's 25 x 25 grid stand-in "
                         "(registry.hat_grid_standin) in place of its mesh")
    args = ap.parse_args(argv)

    task = build_task("hat", dtype=torch.float32,
                      device="cpu" if args.cpu else None,
                      scene=registry.hat_grid_standin() if args.standin
                      else None)
    prob = make_problem(task, args.steps)
    if args.eval:
        evaluate(prob, os.path.join(args.out, "controller.pkl"), args.seed,
                 gif=os.path.join(args.out, "eval.gif"))
        return 0
    train(prob, TrainConfig(
        epochs=args.epochs, train_samples=args.train_samples,
        seed=args.seed, lr=args.lr, lr_decay=args.lr_decay,
        action_grad_clamp=args.action_grad_clamp,
        sample_gnorm_max=args.sample_gnorm_max,
        val_samples=args.val_samples, resume=args.resume, out=args.out),
        log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
