"""Command line of the port, mirroring `apps/optimize.py` (reference
binary: src/code/main.cpp:115-150).

    python -m diffcloth_tpu_torch.apps.optimize --demo wind --mode optimize \
        [--seed N] [--restarts R] [--maxiter M] [--max-backward-iters K] \
        [--population P] [--tau T | --tau-ladder] [--export-iters] \
        [--exp NAME] [--cpu] [--x64]
    python -m diffcloth_tpu_torch.apps.optimize --demo wind --mode simulate \
        [--exp NAME]
    python -m diffcloth_tpu_torch.apps.optimize --mode visualize \
        --exp NAME [--gif]

Runs on the card unless --cpu is given.  Results go to output/NAME/ under
the working directory (NAME defaults to the demo and the time): the fit's
optimization.json and final episode, the simulated episode, or the
rendered frames of an exported one (--mode visualize reads output/NAME/,
or its final/ episode, and needs matplotlib).  Demos: wind,
wind_sim2real and sphere build from grids; tshirt, slope, hat, sock and
dress need their mesh or position assets.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from diffcloth_tpu_torch.tasks import registry


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--demo", choices=sorted(registry.DEMOS),
                    help="required unless --mode visualize")
    ap.add_argument("--mode", default="optimize",
                    choices=["optimize", "simulate", "visualize"])
    ap.add_argument("--seed", type=int, default=None,
                    help="random-restart seed (omit for the default guess)")
    ap.add_argument("--restarts", type=int, default=0,
                    help="validity-filtered random restarts (reference "
                         "OptimizeHelper.cpp:316-359)")
    ap.add_argument("--maxiter", type=int, default=100)
    ap.add_argument("--tau", type=float, default=0.0,
                    help="softmax temperature of the keypoint loss (sock); "
                         "0 = the reference's hard max")
    ap.add_argument("--tau-ladder", action="store_true",
                    help="anneal the keypoint tau over (2, 0.5, 0.1, 0), "
                         "each rung warm-started from the previous optimum")
    ap.add_argument("--max-backward-iters", type=int, default=None,
                    help="adjoint fixed-point cap (default 64)")
    ap.add_argument("--population", type=int, default=0,
                    help="lockstep multi-start: this many L-BFGS-B "
                         "instances, every evaluation one batched episode")
    ap.add_argument("--export-iters", action="store_true",
                    help="export every accepted L-BFGS iterate's episode "
                         "(reference exportOptimizationRecords)")
    ap.add_argument("--exp", default=None,
                    help="experiment name: results in output/NAME/")
    ap.add_argument("--gif", action="store_true",
                    help="with --mode visualize: write episode.gif, not "
                         "PNG frames")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    ap.add_argument("--x64", action="store_true", help="simulate in f64")
    args = ap.parse_args(argv)
    if args.mode != "visualize" and args.demo is None:
        ap.error("--demo is required")
    if args.tau_ladder and args.tau > 0:
        ap.error("--tau is the fixed-temperature mode; --tau-ladder anneals "
                 "its own schedule: pass one or the other")
    return args


def visualize(args) -> str:
    """Render an exported episode (reference main.cpp:33-45,
    renderFromFolder -> Viewer) to output/NAME/pngs/ or episode.gif."""
    from diffcloth_tpu_torch.io import export as ioexp
    from diffcloth_tpu_torch.io import viewer
    folder = os.path.join("output", args.exp) if args.exp else None
    if not folder or not os.path.isdir(folder):
        raise SystemExit("--mode visualize needs --exp naming an exported "
                         "folder under output/")
    sub = os.path.join(folder, "final")
    xs, tris, _ = ioexp.import_episode(sub if os.path.isdir(sub) else folder)
    out = os.path.join(folder, "episode.gif" if args.gif else "pngs")
    viewer.render_episode(xs, tris, out)
    print(f"rendered {xs.shape[0]} frames -> {out}")
    return out


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "visualize":
        visualize(args)
        return
    device = "cpu" if args.cpu else None
    dtype = torch.float64 if args.x64 else torch.float32
    exp = args.exp or f"{args.demo}-{time.strftime('%Y%m%d-%H%M%S')}"
    out_dir = os.path.join("output", exp)

    if args.mode == "simulate":
        from diffcloth_tpu_torch.io import export as ioexp
        from diffcloth_tpu_torch.tasks.setup import build_task
        from diffcloth_tpu_torch.utils.timing import EpisodeStats
        task = build_task(args.demo, dtype=dtype, device=device)
        sim = task.sim
        t0 = time.perf_counter()
        recs = sim.rollout_chunked(task.param_base)
        x_last = recs.steps.x[-1].cpu()
        stats = EpisodeStats.from_records(
            recs, forward_s=time.perf_counter() - t0)
        print(f"demo={args.demo} on {sim.device}: {stats.report()}; final "
              f"centroid {np.round(x_last.mean(0).numpy(), 4).tolist()}")
        ioexp.export_episode(out_dir, recs, sim.scene_host.tris,
                             stats={"episode_report": stats.report()})
        print("exported episode to", out_dir)
        return

    from diffcloth_tpu_torch.optim.solver import (solve_demo,
                                                  solve_demo_tau_ladder)
    if args.tau_ladder:
        res = solve_demo_tau_ladder(
            args.demo, seed=args.seed, dtype=dtype, device=device,
            export_dir=out_dir, final_maxiter=args.maxiter // 4,
            maxiter_per_rung=max(args.maxiter // 8, 4),
            n_restarts=args.restarts, population=args.population)
        r = res.result
        print(f"demo={args.demo} (tau ladder) evals={r.n_evals} final "
              f"hard-max loss {res.rungs[-1]['hard_max_loss']:.6f} "
              f"({res.wallclock_s:.0f}s)")
        print("exported to", out_dir)
        return
    res = solve_demo(args.demo, seed=args.seed, maxiter=args.maxiter,
                     dtype=dtype, device=device, n_restarts=args.restarts,
                     population=args.population,
                     max_backward_iters=args.max_backward_iters,
                     keypoint_tau=args.tau, export_dir=out_dir,
                     export_iters=args.export_iters)
    r = res.result
    if args.tau > 0:
        # the reference's hard-max loss at the smoothed optimum
        from diffcloth_tpu_torch import losses
        hard = losses.make_loss_fn(res.task.loss_type, dataclasses.replace(
            res.task.loss_info, keypoint_tau=0.0))
        recs = res.task.sim.rollout_chunked(res.helper.vec_to_params(r.x))
        print(f"hard-max loss at the smoothed optimum: "
              f"{float(hard(recs)):.6f}")
    first = res.helper.history[0][0] if res.helper.history else r.loss
    print(f"demo={args.demo} evals={r.n_evals} iters={r.n_iters} loss "
          f"{first:.6f} -> {r.loss:.6f} ({res.wallclock_s:.0f}s)")
    print("x* =", np.array2string(r.x, precision=5))
    print("exported to", out_dir)


if __name__ == "__main__":
    main()
