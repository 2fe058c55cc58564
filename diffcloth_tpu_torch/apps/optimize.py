"""Command line of the port, mirroring `apps/optimize.py` (reference
binary: src/code/main.cpp:115-150).

    python -m diffcloth_tpu_torch.apps.optimize --demo wind --mode optimize \
        [--seed N] [--restarts R] [--maxiter M] [--max-backward-iters K] \
        [--population P] [--cpu] [--x64]
    python -m diffcloth_tpu_torch.apps.optimize --demo wind --mode simulate

Runs on the card unless --cpu is given.  Demos: wind, wind_sim2real and
sphere build from grids; tshirt, slope, hat and sock need their mesh or
position assets; dress is not ported yet, nor are the modes and options of
the JAX CLI not listed here (visualize, export, the tau ladder).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from diffcloth_tpu_torch.tasks import registry


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--demo", required=True, choices=sorted(registry.DEMOS))
    ap.add_argument("--mode", default="optimize",
                    choices=["optimize", "simulate", "visualize"])
    ap.add_argument("--seed", type=int, default=None,
                    help="random-restart seed (omit for the default guess)")
    ap.add_argument("--restarts", type=int, default=0,
                    help="validity-filtered random restarts (reference "
                         "OptimizeHelper.cpp:316-359)")
    ap.add_argument("--maxiter", type=int, default=100)
    ap.add_argument("--max-backward-iters", type=int, default=None,
                    help="adjoint fixed-point cap (default 64)")
    ap.add_argument("--population", type=int, default=0,
                    help="lockstep multi-start: this many L-BFGS-B "
                         "instances, every evaluation one batched episode")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    ap.add_argument("--x64", action="store_true", help="simulate in f64")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "visualize":
        raise NotImplementedError("--mode visualize is not ported yet")
    device = "cpu" if args.cpu else None
    dtype = torch.float64 if args.x64 else torch.float32

    if args.mode == "simulate":
        from diffcloth_tpu_torch.tasks.setup import build_task
        task = build_task(args.demo, dtype=dtype, device=device)
        sim = task.sim
        t0 = time.perf_counter()
        recs = sim.rollout_chunked(task.param_base)
        x_last = recs.steps.x[-1].cpu()
        wall = time.perf_counter() - t0
        print(f"demo={args.demo} on {sim.device}: {sim.n_steps} steps in "
              f"{wall:.2f} s ({sim.n_steps / wall:.1f} steps/s), converged "
              f"{float(recs.steps.converged.float().mean()):.4f}, final "
              f"centroid {np.round(x_last.mean(0).numpy(), 4).tolist()}")
        return

    from diffcloth_tpu_torch.optim.solver import solve_demo
    res = solve_demo(args.demo, seed=args.seed, maxiter=args.maxiter,
                     dtype=dtype, device=device, n_restarts=args.restarts,
                     population=args.population,
                     max_backward_iters=args.max_backward_iters)
    r = res.result
    first = res.helper.history[0][0] if res.helper.history else r.loss
    print(f"demo={args.demo} evals={r.n_evals} iters={r.n_iters} loss "
          f"{first:.6f} -> {r.loss:.6f} ({res.wallclock_s:.0f}s)")
    print("x* =", np.array2string(r.x, precision=5))


if __name__ == "__main__":
    main()
