"""The system under test, driven as its users drive it: the cell's
population evaluations through the program's own entry, with the answers
the reference checks kept on the host as they are produced.

Only this module and `replay.py` import the program (diffcloth_tpu_torch).
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from benchmark import traffic as tr
from benchmark.reference import scene as rscene


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    """One configuration under one gradient traffic mix on the program.
    `setup()` builds the sim, the population's base, the target and the
    helper, and warms up with one whole evaluation; `evaluate(i)` runs
    evaluation i of the window and keeps what the reference checks."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device="cuda",
                 trace: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.trace = trace
        if traffic["entry"] != "batched_loss_and_grad":
            raise ValueError(f"entry {traffic['entry']!r}")
        self.keep = True        # keep the checked answers (off: timing only)
        self.kept = []          # per evaluation: what the reference checks
        self.stats = []         # per evaluation (trace): device reductions
        self.phase = None       # (trace) the CUDA event ending a forward

    # -- set-up -----------------------------------------------------------

    def setup(self):
        from diffcloth_tpu_torch import config as pc
        from diffcloth_tpu_torch import losses
        from diffcloth_tpu_torch.core.sim import ClothSim
        from diffcloth_tpu_torch.geometry import builder as gb
        from diffcloth_tpu_torch.optim.helper import GradMask, OptimizeHelper
        from diffcloth_tpu_torch.tasks.setup import build_task

        cfg, dev = self.cfg, self.device
        dtype = getattr(torch, cfg["dtype"])
        scene_cfg = rscene.scene_config(pc, cfg["scene"])
        flags = rscene.sim_flags(pc, cfg["flags"])
        if cfg["task"]:
            task = build_task(cfg["task"], dtype=dtype, device=dev,
                              scene=scene_cfg, **cfg["sim"])
            sim, base = task.sim, task.param_base
            if sim.flags != flags:
                raise ValueError(f"the task's flags {sim.flags} are not the "
                                 f"configuration's {flags}")
        else:
            sim = ClothSim(gb.build_scene(scene_cfg), flags=flags,
                           device=dev, dtype=dtype, **cfg["sim"])
            base = sim.default_params()
        self.sim = sim
        # the starts come from the reference's own builder, handed to both
        ref_scene = rscene.build_scene(cfg)
        if not np.array_equal(ref_scene.x_rest, sim.scene_host.x_rest):
            raise AssertionError("the reference's scene is not the program's")
        P = cfg["population"]
        self.x0 = rscene.starts(ref_scene, cfg["starts"], P)

        def t(a):
            return torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                                   device=dev)

        base = base.replace(**{k: t(v) for k, v in cfg["base"].items()})
        self.pbase = base.expand(P).replace(x0=t(self.x0))
        truth = self.pbase.replace(**{
            k: t(np.broadcast_to(v, getattr(self.pbase, k).shape))
            for k, v in cfg["truth"].items()})
        if cfg["task"]:
            truth = task.param_gt
        recs = sim.rollout_chunked(truth, self.traffic["chunk"])
        self.target_x = recs.full_x()
        if cfg["task"] and not torch.equal(
                self.target_x, torch.as_tensor(task.loss_info.target_x)):
            raise AssertionError("the task's target is not its ground "
                                 "truth's rollout")
        self.target_v = torch.cat([recs.v0[..., None, :, :], recs.steps.v],
                                  dim=-3)
        inner = losses.make_loss_fn(pc.LossType.MATCH_TRAJECTORY,
                                    losses.LossInfo(target_x=self.target_x))

        def loss_fn(recs):
            L = inner(recs)
            self._keep_forward(recs)
            return L
        mask = GradMask(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in cfg["mask"].items()})
        self.helper = OptimizeHelper(sim, mask, loss_fn,
                                     param_base=self.pbase,
                                     chunk=self.traffic["chunk"])
        if self.helper.n_params != len(cfg["vector"]):
            raise ValueError("the configuration's vector is not the mask's")
        defaults = {k: v.detach().cpu().numpy()
                    for k, v in base.items()}
        self.base_vec = tr.base_vector(cfg, defaults)
        self.watch = CotangentWatch(
            sim, self.traffic["check"]["episodes_per_evaluation"])
        self._warm_up()
        _sync(dev)

    def _warm_up(self):
        """One whole evaluation at the base, through the window's own
        entry at the cell's batch and chunk, with the answers kept as the
        window keeps them, then dropped: every program the window runs is
        captured and every first call made before it opens."""
        self._index = 0
        self.helper.batched_loss_and_grad(
            np.repeat(self.base_vec[None], self.cfg["population"], 0))
        self.watch.take()
        self.kept, self.stats, self.phase = [], [], None

    # -- the window ---------------------------------------------------------

    def evaluate(self, index: int) -> dict:
        """Evaluation `index`: its candidates from (seed, index), one call
        of the helper's batched value-and-grad, its answers read back;
        returns its record (wall seconds, its forward / backward split)."""
        X = tr.candidates(self.cfg, self.seed, index, self.base_vec)
        P, N = X.shape[0], self.sim.n_steps
        self._index = index
        ev = None
        if self.trace:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        L, G = self.helper.batched_loss_and_grad(X)
        split = dict(self.helper.last_split)
        wall = time.perf_counter() - t0
        if ev is not None:
            ev[1].record()
        if self.keep:
            lx, lv = self.watch.take()
            self.kept[-1].update(loss=L, grad=G, lx=lx, lv=lv, index=index,
                                 X=X)
        return dict(wall=wall, split=split, sample_steps=P * N, events=ev,
                    fwd_end=self.phase, loss=L, grad=G)

    def _keep_forward(self, recs):
        """Inside an evaluation's loss: the checked episodes' whole
        trajectories, from the records the loss reads."""
        st = recs.steps
        if self.trace:
            self.phase = torch.cuda.Event(enable_timing=True)
            self.phase.record()
            self._stats(st)
        if not self.keep:
            self.watch.episodes = None
            return
        eps = tr.checked_episodes(self.traffic, self.seed, self._index,
                                  st.x.shape[0])
        self.watch.episodes = torch.as_tensor(eps, device=self.device)
        kept = dict(episodes=eps,
                    x=st.x.detach()[eps].cpu().numpy(),
                    v=st.v.detach()[eps].cpu().numpy())
        if self.trace and not self.kept:
            k = tr.checked_steps(1, self.seed, 7, st.x.shape[1] - 1,
                                 False)[0]
            kept["replay"] = (k + 1, st.x.detach()[:, k - 1].cpu(),
                              st.v.detach()[:, k - 1].cpu())
        self.kept.append(kept)

    def _stats(self, st):
        """(trace) Sums over the evaluation's sample-steps, on the device."""
        self.stats.append(torch.stack([
            st.iters.double().sum(), st.selfcol_overflow.double().sum(),
            st.obstacle_contacts.double().sum(),
            torch.tensor(float(st.iters.numel()), dtype=torch.float64,
                         device=st.iters.device)]))

    # -- what the reference needs -------------------------------------------

    def target_checks(self) -> list:
        """(k, x before, v before, x after, v after) of the target's checked
        steps, every episode of it."""
        n_t = self.traffic["check"].get("target_steps", 0)
        if n_t == 0:
            return []
        X, V = self.target_x, self.target_v
        if X.dim() == 3:
            X, V = X[None], V[None]
        steps = tr.checked_steps(n_t, self.seed, 5, X.shape[1] - 1, True)
        return [(k,) + tuple(a.cpu().numpy() for a in
                             (X[:, k - 1], V[:, k - 1], X[:, k], V[:, k]))
                for k in steps]

    def free(self):
        """Drop the program's state: the reference runs after it."""
        for k in ("sim", "helper", "pbase", "target_v", "watch"):
            self.__dict__.pop(k, None)
        self.target_x = self.target_x.cpu()


class CotangentWatch:
    """The cotangents an episode's adjoint gives each of its states.  The
    program has no hook for them, so the sim's step (`sim.steps[0]`, the
    function each chunk's autograd recompute calls) is wrapped: where it
    runs under autograd, a hook on the step's (x, v) copies the rows of
    `episodes` (a device index tensor; None: no hook) of their cotangents
    into device buffers at the step's index.  `take()` reads the buffers
    back after a value-and-grad, and raises where no hook ran: the
    program then no longer takes its adjoint through that step, and the
    harness has to follow it."""

    def __init__(self, sim, episodes: int):
        shape = (episodes, sim.n_steps, sim.n, 3)
        self.buffers = [torch.zeros(shape, dtype=sim.dtype,
                                    device=sim.device) for _ in range(2)]
        self.episodes = None
        self.fired = [0]
        self.inner = inner = sim.steps[0]

        def step(x, v, params, x_fixed, p_inv, t, step_idx):
            out = inner(x, v, params, x_fixed, p_inv, t, step_idx)
            if out[0].requires_grad and self.episodes is not None:
                idx = (torch.as_tensor(step_idx, device=x.device)
                       - 1).reshape(1)
                for y, buf in zip(out[:2], self.buffers):
                    y.register_hook(functools.partial(
                        _keep_cotangent, buf, idx, self.episodes,
                        self.fired))
            return out
        sim.steps[0] = step

    def take(self) -> list:
        if not self.fired[0]:
            raise RuntimeError(
                "no cotangent reached the watched step: the program's "
                "value-and-grad no longer calls sim.steps[0] under autograd")
        self.fired[0] = 0
        return [b.to("cpu", copy=True).numpy() for b in self.buffers]


def _keep_cotangent(buf, idx, eps, fired, grad):
    """A hook: the watched episodes' rows of a state's cotangent into
    buf[:, step]."""
    fired[0] += 1
    buf.index_copy_(1, idx, grad.index_select(0, eps).unsqueeze(1))
