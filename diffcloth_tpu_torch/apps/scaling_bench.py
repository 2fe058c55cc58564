"""Scaling harness of the port: batched rollouts and training steps over a
(dp, tp) grid of ranks on torch.distributed, one process per rank.

Counterpart of the repository's `apps/scaling_bench.py` (a JAX device
mesh).  It reports aggregate PD steps/s of a batch of forward episodes at
one rank and at all ranks (dp), and of the distributed training step
(each rank's batched episode value-and-grad, the gradient averaged over
dp, P^{-1} row-sharded over tp when --tp > 1: parallel/mesh.py), with
the scaling efficiencies:

    python -m diffcloth_tpu_torch.apps.scaling_bench --ranks 4 --tp 2
    python -m diffcloth_tpu_torch.apps.scaling_bench --cpu --ranks 4

With --ranks it spawns one process per rank (rank r on card r, NCCL; or
on the CPU, gloo, with --cpu) joined over tcp://localhost; started by
torchrun (RANK / WORLD_SIZE in the environment) it is one rank of
torchrun's group.  The scene is the flagship stand-in's physics (tshirt
wind system-ID, two corners) on a --grid x --grid cloth, self-collision
on.  Rank 0 prints one JSON line (and writes it to --out).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from diffcloth_tpu_torch import losses
from diffcloth_tpu_torch.config import LossType
from diffcloth_tpu_torch.core import cuda_build
from diffcloth_tpu_torch.core.device import resolve_device
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.parallel import mesh as pmesh
from diffcloth_tpu_torch.tasks.registry import TSHIRT_GRID_STANDIN

BASE_WIND = np.array([0.04, 0.004, 0.04])


def build_sim(grid: int, steps: int, device, solve_fn=None) -> ClothSim:
    cfg = TSHIRT_GRID_STANDIN
    cfg = dataclasses.replace(cfg, step_num=steps, fabric=dataclasses.replace(
        cfg.fabric, grid_num_x=grid, grid_num_y=grid))
    return ClothSim(gb.build_scene(cfg), device=device, solve_fn=solve_fn)


def population(sim: ClothSim, batch: int, seed: int):
    base = sim.default_params()
    winds = np.random.RandomState(seed).randn(batch, 3) * 0.02 + BASE_WIND
    return base, base.expand(batch).replace(wind=torch.as_tensor(
        winds, dtype=sim.dtype, device=sim.device))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_wall(fn, device, repeats: int, group=None) -> float:
    """Best of `repeats` wall times of fn() (after a warm-up call), each
    the slowest rank's where `group` is given."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        if group is not None:
            dist.barrier(group=group)
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                          device=device)
        if group is not None:
            dist.all_reduce(dt, op=dist.ReduceOp.MAX, group=group)
        best = min(best, float(dt))
    return best


def run_rank(rank: int, world: int, args, init_method: str) -> None:
    if args.cpu:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    pmesh.initialize_distributed(None, init_method, world, rank,
                                 device=device)
    world_group = dist.new_group(list(range(world)))
    steps, bpr = args.steps, args.batch_per_rank
    sim = build_sim(args.grid, steps, device)

    def rollout(batch, seed):
        _, params = population(sim, batch, seed)
        return lambda: sim.rollout(params)

    # forward: rank 0 alone, then every rank on its own batch at once
    dist.barrier()
    one = (_best_wall(rollout(bpr, 0), device, args.repeats)
           if rank == 0 else 0.0)
    dist.barrier()
    all_ = _best_wall(rollout(bpr, rank), device, args.repeats, world_group)

    # training step: rank 0 alone, then the dp x tp objective
    target = torch.zeros((steps + 1, sim.n, 3), dtype=sim.dtype,
                         device=device)
    loss_fn = losses.make_loss_fn(LossType.MATCH_TRAJECTORY,
                                  losses.LossInfo(target_x=target))
    dist.barrier()
    if rank == 0:
        base, params = population(sim, bpr, 1)
        vg = sim.episode_value_and_grad(loss_fn)
        tr_one = _best_wall(lambda: vg(params), device, args.repeats)
    mesh = pmesh.make_mesh(tp=args.tp)
    sim_tp = build_sim(args.grid, steps, device,
                       pmesh.make_tp_solve(mesh.tp_group)
                       if args.tp > 1 else None)
    base, params = population(sim_tp, bpr * mesh.dp, 1)
    fn = pmesh.batched_value_and_grad(sim_tp, loss_fn, mesh,
                                      p_inv_spec="tp" if args.tp > 1
                                      else None)
    p_inv = sim_tp.p_inv(base)
    L, g = fn(params, p_inv)
    if not (bool(torch.isfinite(L).all())
            and bool(torch.isfinite(g.wind).all())):
        raise AssertionError("non-finite loss or gradient")
    dist.barrier()
    tr_all = _best_wall(lambda: fn(params, p_inv), device, args.repeats,
                        world_group)
    if rank == 0:
        fwd_1, fwd_n = bpr * steps / one, bpr * world * steps / all_
        tr_1, tr_n = bpr * steps / tr_one, bpr * mesh.dp * steps / tr_all
        result = {
            "metric": "scaling_efficiency", "ranks": world, "tp": args.tp,
            "batch_per_rank": bpr, "steps": steps, "n": sim.n,
            "device": ("cpu" if args.cpu else
                       f"{torch.cuda.get_device_name(device)} x "
                       f"{torch.cuda.device_count()}"),
            "forward_steps_per_sec_1rank": fwd_1,
            "forward_steps_per_sec_nrank": fwd_n,
            "forward_efficiency": fwd_n / (fwd_1 * world),
            "train_steps_per_sec_1rank": tr_1,
            "train_steps_per_sec_nrank": tr_n,
            "train_efficiency": tr_n * args.tp / (tr_1 * world)}
        line = json.dumps(result)
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(line + "\n")
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes to spawn (default: all cards, or 2 "
                         "with --cpu); ignored under torchrun")
    ap.add_argument("--cpu", action="store_true",
                    help="ranks on the CPU with gloo (default: one card "
                         "per rank, NCCL)")
    ap.add_argument("--batch-per-rank", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree of the training step")
    ap.add_argument("--grid", type=int, default=32,
                    help="grid x grid cloth (default 32: the flagship "
                         "stand-in's n = 1024)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed repetitions per row (best of)")
    ap.add_argument("--out", default="",
                    help="write the JSON line to this file as well")
    args = ap.parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        run_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                 args, "env://")
        return 0
    if not args.cpu:
        resolve_device(None)     # raises without a card
        cuda_build.build_all()   # once, before the ranks load the kernels
    ranks = args.ranks or (2 if args.cpu else torch.cuda.device_count())
    import torch.multiprocessing as mp
    mp.spawn(run_rank, args=(ranks, args, f"tcp://localhost:{_free_port()}"),
             nprocs=ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
