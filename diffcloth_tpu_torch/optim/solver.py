"""Demo orchestration: task setup -> (optional random restarts) ->
L-BFGS-B, single or as a lockstep population.

Counterpart of `diffcloth_tpu/optim/solver.py:22-180` (reference
BackwardTaskSolver::solveDemo / optimizeLBFGS, BackwardTaskSolver.cpp:11-66).
The export of results, checkpoints and the tau ladder are not ported yet:
asking for them raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from diffcloth_tpu_torch.optim.helper import OptimizeHelper
from diffcloth_tpu_torch.optim.lbfgsb import (LbfgsResult, minimize_lbfgsb,
                                              minimize_lbfgsb_population)
from diffcloth_tpu_torch.tasks.setup import TaskSetup, build_task


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


def solve_demo(demo: str, *, seed: Optional[int] = None, maxiter: int = 100,
               dtype=torch.float32, device=None, n_restarts: int = 0,
               population: int = 0, max_backward_iters: Optional[int] = None,
               callback=None, export_dir: Optional[str] = None,
               checkpoint_dir: Optional[str] = None,
               export_iters: bool = False) -> DemoResult:
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
    L-BFGS iteration."""
    if export_dir or checkpoint_dir or export_iters:
        raise NotImplementedError("export and checkpoints are not ported "
                                  "yet")
    task = build_task(demo, dtype=dtype, device=device,
                      max_backward_iters=max_backward_iters)
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
        return DemoResult(task=task, helper=helper, result=pop.best,
                          x_init=X0[0], wallclock_s=time.time() - t0)

    if n_restarts > 0:
        x0 = _filter_restarts(helper, x0, n_restarts, base_seed)
    t0 = time.time()
    res = minimize_lbfgsb(helper.loss_and_grad, x0, helper.lower_bound,
                          helper.upper_bound, maxiter=maxiter,
                          callback=callback)
    return DemoResult(task=task, helper=helper, result=res, x_init=x0,
                      wallclock_s=time.time() - t0)
