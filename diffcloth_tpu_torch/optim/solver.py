"""Demo orchestration: task setup -> (optional random restarts) ->
L-BFGS-B, single or as a lockstep population, with checkpoints, the
export of results and the keypoint tau ladder.

Counterpart of `diffcloth_tpu/optim/solver.py` (reference
BackwardTaskSolver::solveDemo / optimizeLBFGS, BackwardTaskSolver.cpp:11-66;
exportStatistics / exportOptimizationRecords, Simulation.cpp:3963-4129).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from diffcloth_tpu_torch import losses as losses_mod
from diffcloth_tpu_torch.io import export as ioexp
from diffcloth_tpu_torch.optim.helper import OptimizeHelper
from diffcloth_tpu_torch.optim.lbfgsb import (LbfgsResult, minimize_lbfgsb,
                                              minimize_lbfgsb_population)
from diffcloth_tpu_torch.tasks.setup import TaskSetup, build_task
from diffcloth_tpu_torch.utils import checkpoint as ckpt
from diffcloth_tpu_torch.utils.timing import EpisodeStats


def _filter_restarts(helper: OptimizeHelper, x0: np.ndarray,
                     n_restarts: int, base_seed: int) -> np.ndarray:
    """Evaluate the default guess + n_restarts bounded random candidates
    and return the lowest-loss valid one: one batched forward when the
    candidates share the prefactorization (can_batch), one episode each
    otherwise (reference OptimizeHelper.cpp:316-359)."""
    cands = [x0] + [helper.random_param(base_seed + 1 + i)
                    for i in range(n_restarts)]
    if helper.can_batch and len(cands) > 1:
        losses = helper.batched_loss(np.stack(cands))
    else:
        losses = np.array([helper.loss(c) for c in cands])
    losses = np.where(np.isfinite(losses), losses, np.inf)
    return cands[int(np.argmin(losses))]


def default_guess_vec(task: TaskSetup, helper: OptimizeHelper) -> np.ndarray:
    """The reference's default initial guess as a packed vector: spline
    endpoints translated by (-1,1,0) for the first two splines and (1,1,0)
    for the rest (OptimizeHelper.cpp:21-38); out-of-bounds entries snapped
    to mid-bounds."""
    start = task.param_base
    if task.mask.control_points:
        sp = start.spline.detach().cpu().numpy().astype(np.float64)
        for f in range(sp.shape[0]):
            d = (np.array([-1.0, 1.0, 0.0]) if f < 2
                 else np.array([1.0, 1.0, 0.0]))
            sp[f, 0:3] += d   # p1
            sp[f, 3:6] += d   # m0 = p1 - p0 (+yUp e_y): shifts with p1
            sp[f, 6:9] += d
        start = start.replace(spline=torch.as_tensor(sp).to(
            task.sim.device, task.sim.dtype))
    x0 = helper.params_to_vec(start)
    lb, ub = helper.lower_bound, helper.upper_bound
    return np.where((x0 < lb) | (x0 > ub), 0.5 * (lb + ub), x0)


@dataclasses.dataclass
class DemoResult:
    task: TaskSetup
    helper: OptimizeHelper
    result: LbfgsResult
    x_init: np.ndarray
    wallclock_s: float
    rungs: Optional[list] = None     # solve_demo_tau_ladder's, per rung


def solve_demo(demo: str, *, seed: Optional[int] = None, maxiter: int = 100,
               dtype=torch.float32, device=None, n_restarts: int = 0,
               population: int = 0, max_backward_iters: Optional[int] = None,
               keypoint_tau: float = 0.0, callback=None,
               export_dir: Optional[str] = None,
               checkpoint_dir: Optional[str] = None, resume: bool = False,
               export_iters: bool = False, **sim_kwargs) -> DemoResult:
    """Run one parameter optimization demo end to end, on the card unless
    device="cpu".

    seed=None starts from the reference's default guess; an integer seed
    draws a bounded random restart (reference `-seed N`, main.cpp:115-150).
    n_restarts > 0 evaluates that many random candidates besides and starts
    from the lowest-loss valid one.  population > 0 instead runs that many
    L-BFGS-B instances in lockstep from (the default guess + population - 1
    random candidates), every evaluation one batched episode
    (minimize_lbfgsb_population); the best endpoint is reported.
    `callback(iteration, x, losses)` fires after every population iteration
    (x (P, D), losses (P,)), or `callback(iteration, x)` after every single
    L-BFGS iteration.  `keypoint_tau` and `sim_kwargs` go to build_task.

    export_dir: `export_optimization`'s files there (and population.json
    for a population).  export_iters: also every accepted iterate's
    episode, iter{k}/.  checkpoint_dir: the solver's whole state after
    every accepted iteration (utils.checkpoint, ckpt_{iteration});
    resume=True continues from the newest one there, so that a resumed fit
    ends where an unbroken one would (the JAX package restarts L-BFGS from
    the saved x instead).  Checkpoints and export_iters cover the single
    L-BFGS-B run, and raise with a population."""
    if population > 0 and (checkpoint_dir or export_iters):
        raise ValueError("checkpoints and export_iters cover the single "
                         "L-BFGS-B run, not a population")
    task = build_task(demo, dtype=dtype, device=device,
                      keypoint_tau=keypoint_tau,
                      max_backward_iters=max_backward_iters, **sim_kwargs)
    helper = OptimizeHelper(task.sim, task.mask, task.loss_fn(),
                            param_base=task.param_base)
    x0 = (helper.random_param(seed) if seed is not None
          else default_guess_vec(task, helper))
    base_seed = 0 if seed is None else seed

    if population > 0:
        if not helper.can_batch:
            raise ValueError("population mode needs batchable parameters "
                             "(stiffness/density change the "
                             "prefactorization)")
        X0 = np.stack([x0] + [helper.random_param(base_seed + 1 + i)
                              for i in range(population - 1)])
        t0 = time.time()
        pop = minimize_lbfgsb_population(
            helper.batched_loss_and_grad, X0, helper.lower_bound,
            helper.upper_bound, maxiter=maxiter, callback=callback)
        wall = time.time() - t0
        if export_dir:
            export_optimization(export_dir, demo, helper, pop.best)
            with open(os.path.join(export_dir, "population.json"),
                      "w") as fh:
                json.dump({"P": population,
                           "losses": pop.losses.tolist(),
                           "messages": pop.messages,
                           "n_iters": pop.n_iters.tolist(),
                           "n_outer": pop.n_outer,
                           "n_batched_evals": pop.n_batched_evals,
                           "wallclock_s": wall}, fh, indent=1)
        return DemoResult(task=task, helper=helper, result=pop.best,
                          x_init=X0[0], wallclock_s=wall)

    if n_restarts > 0:
        x0 = _filter_restarts(helper, x0, n_restarts, base_seed)

    state = None
    if checkpoint_dir and resume and ckpt.latest_step(checkpoint_dir) \
            is not None:
        _, saved = ckpt.restore_checkpoint(checkpoint_dir)
        state = saved["lbfgs"]
    on_state = None
    if checkpoint_dir:
        def on_state(st):
            ckpt.save_checkpoint(checkpoint_dir, int(st["n_iters"]),
                                 {"x": st["x"], "lbfgs": st},
                                 metadata={"demo": demo})

    iterates: list = []

    def cb(it, xk):
        if export_iters:
            iterates.append(np.array(xk))
        if callback is not None:
            callback(it, xk)

    t0 = time.time()
    res = minimize_lbfgsb(helper.loss_and_grad, x0, helper.lower_bound,
                          helper.upper_bound, maxiter=maxiter, callback=cb,
                          state=state, on_state=on_state)
    wall = time.time() - t0
    if export_dir:
        export_optimization(export_dir, demo, helper, res,
                            iterates=iterates if export_iters else None)
    return DemoResult(task=task, helper=helper, result=res, x_init=x0,
                      wallclock_s=wall)


def solve_demo_tau_ladder(demo: str, *, taus=(2.0, 0.5, 0.1, 0.0),
                          maxiter_per_rung: int = 12,
                          final_maxiter: int = 25,
                          seed: Optional[int] = None,
                          n_restarts: int = 0, population: int = 0,
                          dtype=torch.float32, device=None,
                          export_dir: Optional[str] = None,
                          callback=None) -> DemoResult:
    """Graduated smoothing for the keypoint loss's max (the sock demo):
    anneal the softmax temperature tau to 0, each rung warm-started from the
    previous optimum, and report the reference's hard-max loss at every
    rung (Simulation.cpp:3440-3475 is the hard max; the smoothed rungs
    give every candidate vertex gradient mass, the final tau = 0 rung
    polishes on the reference loss).  All rungs share one ClothSim.

    population > 0 carries the whole candidate set across the rungs (every
    evaluation one batched episode), and after each rung candidate b, the
    one with the lowest hard-max loss, is the result: its own x, smoothed
    loss, iterations, convergence and message (the JAX package reports
    b's x and loss with the iterations and message of the candidate with
    the lowest smoothed loss).  The rungs' losses go to
    `export_dir/tau_ladder.json` with export_optimization's files.
    `callback(rung, tau, iteration, x, losses)` fires after every
    population iteration."""
    taus = list(taus)
    if taus[-1] != 0.0:
        taus.append(0.0)
    task = build_task(demo, dtype=dtype, device=device,
                      keypoint_tau=taus[0])
    hard_fn = losses_mod.make_loss_fn(
        task.loss_type, dataclasses.replace(task.loss_info, keypoint_tau=0.0))
    # the rungs' hard-loss reports through the chunked episode
    # (solver.py:214-217, :245)
    hard_eval = task.sim.episode_loss_chunked(hard_fn)

    def rung_helper(tau):
        loss_fn = losses_mod.make_loss_fn(
            task.loss_type,
            dataclasses.replace(task.loss_info, keypoint_tau=tau))
        return OptimizeHelper(task.sim, task.mask, loss_fn,
                              param_base=task.param_base)

    helper = rung_helper(taus[0])
    x = (helper.random_param(seed) if seed is not None
         else default_guess_vec(task, helper))
    base_seed = 0 if seed is None else seed
    if n_restarts > 0 and population == 0:
        x = _filter_restarts(helper, x, n_restarts, base_seed)
    x_init = np.array(x)
    if population > 0:
        X = np.stack([x] + [helper.random_param(base_seed + 1 + i)
                            for i in range(population - 1)])
        hard_eval_b = task.sim.episode_loss_chunked(hard_fn, batched=True)

    t0 = time.time()
    rungs = []
    res = None
    for r, tau in enumerate(taus):
        if r > 0:
            helper = rung_helper(tau)
        it = final_maxiter if tau == 0.0 else maxiter_per_rung
        if population > 0:
            cb = None
            if callback is not None:
                def cb(k, Xk, Fk, _r=r, _tau=tau):
                    callback(_r, _tau, k, Xk, Fk)
            pop = minimize_lbfgsb_population(
                helper.batched_loss_and_grad, X, helper.lower_bound,
                helper.upper_bound, maxiter=it, callback=cb)
            X = pop.X
            hards = np.asarray(hard_eval_b(helper.stack_vecs(X)).detach()
                               .cpu().numpy(), np.float64)
            b = int(np.argmin(np.where(np.isfinite(hards), hards, np.inf)))
            res = LbfgsResult(
                x=X[b], loss=float(pop.losses[b]),
                n_iters=int(pop.n_iters[b]), n_evals=pop.n_batched_evals,
                converged=bool(pop.converged[b]), message=pop.messages[b],
                loss_history=[float(pop.losses[b])])
            rungs.append({"tau": tau, "smoothed_loss": res.loss,
                          "hard_max_loss": float(hards[b]),
                          "hard_all": hards.tolist(), "winner": b,
                          "n_batched_evals": pop.n_batched_evals})
            continue
        res = minimize_lbfgsb(helper.loss_and_grad, x, helper.lower_bound,
                              helper.upper_bound, maxiter=it)
        x = res.x
        rungs.append({"tau": tau, "smoothed_loss": res.loss,
                      "hard_max_loss": float(hard_eval(
                          helper.vec_to_params(x))),
                      "n_evals": res.n_evals, "n_iters": res.n_iters})
    wall = time.time() - t0

    if export_dir:
        export_optimization(export_dir, demo, helper, res)
        with open(os.path.join(export_dir, "tau_ladder.json"), "w") as fh:
            json.dump({"taus": taus, "rungs": rungs, "wallclock_s": wall},
                      fh, indent=1)
    return DemoResult(task=task, helper=helper, result=res, x_init=x_init,
                      wallclock_s=wall, rungs=rungs)


def export_optimization(folder: str, demo: str, helper: OptimizeHelper,
                        res: LbfgsResult, iterates=None) -> None:
    """Persist the fit (optimization.json: losses, iterations, the final x)
    and the final episode's OBJ frames with its solver statistics
    (final/), and with `iterates` (solve_demo(export_iters=True)) every
    accepted iterate's episode (iter{k}/) — the reference's exportStatistics
    / exportOptimizationRecords (Simulation.cpp:3963-4129)."""
    os.makedirs(folder, exist_ok=True)
    log = {
        "demo": demo,
        "final_loss": res.loss,
        "n_iters": res.n_iters,
        "n_evals": res.n_evals,
        "converged": res.converged,
        "message": res.message,
        "loss_history": res.loss_history,
        "x_final": res.x.tolist(),
    }
    with open(os.path.join(folder, "optimization.json"), "w") as fh:
        json.dump(log, fh, indent=1)
    sim = helper.sim
    t0 = time.time()
    recs = sim.rollout_chunked(helper.vec_to_params(res.x))
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    stats = EpisodeStats.from_records(recs, forward_s=time.time() - t0)
    ioexp.export_episode(os.path.join(folder, "final"), recs,
                         sim.scene_host.tris,
                         stats={"episode_report": stats.report()})
    for k, xk in enumerate(iterates or ()):
        ioexp.export_episode(os.path.join(folder, f"iter{k}"),
                             sim.rollout_chunked(helper.vec_to_params(xk)),
                             sim.scene_host.tris)
