#!/usr/bin/env python3
"""The readings that set each cell's limits (`limits/<cell>.json`).

    python3 benchmark/control.py --workload CELL --seeds 1,2,... \
        [--control-seeds 7,8,9] [--evals E] [--out FILE] [--overhead K] \
        [--fault friction_bwd]

Program seeds: one set-up of the cell, then for each seed its first E
evaluations through the program's own entry, judged as a run judges them
(`check.judge_run`).  Control seeds: the plain reference put in the
program's place, in f32 with its products' operands in TF32 (the nearest
precision below the configuration's f32 with TF32 off), makes the same
answers of the same checked episodes, judged alike.  Each seed's numbers
are a JSON line on standard output and in FILE.  --fault friction_bwd
reads the program's seeds with its backward self-friction sweep broken;
--overhead K times K evaluations with the checked answers kept and again
without.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def load_cell(cell: str, overrides: dict = None):
    from benchmark import run
    from benchmark import traffic as tr
    w = next(c for c in run.load_benchmark()["workloads"]
             if c["name"] == cell)
    cfg = run._merge(tr.load("configs", w["config"]),
                     (overrides or {}).get("config", {}))
    tf = run._merge(tr.load("traffic", w["traffic"]),
                    (overrides or {}).get("traffic", {}))
    return cfg, tf


def program_readings(cell: str, seeds, evals: int, device="cuda",
                     overrides: dict = None, out=None) -> list:
    """The judged numbers of the program's first `evals` evaluations on
    each seed, after one set-up."""
    from benchmark import check, program
    cfg, tf = load_cell(cell, overrides)
    c = program.Cell(cfg, tf, seeds[0], device=device)
    c.setup()
    rows = []
    for s in seeds:
        c.seed, c.kept = s, []
        for i in range(evals):
            c.evaluate(i)
        t0 = time.perf_counter()
        numbers, raw = check.judge_run(
            cfg, check.trim(c.kept, tf, s), c.x0, c.target_checks(),
            c.target_x.cpu(), device=device)
        rows.append(_emit(dict(cell=cell, side="program", seed=s,
                               judge_s=time.perf_counter() - t0,
                               **numbers), raw, out))
    return rows


def control_answers(cfg: dict, tf: dict, seed: int, evals: int, device):
    """The control's answers, in the form `program.Cell` keeps them: the
    reference in f32 with TF32 operands runs the checked episodes of
    `evals` evaluations.  Returns (kept, x0, target_x)."""
    from benchmark import check, program
    from benchmark import traffic as tr
    from benchmark.reference import dense_ops, judge, losses
    from benchmark.reference import scene as rscene
    from benchmark.reference.config import LossType
    sim, scene = rscene.reference_sim(cfg, dtype=torch.float32,
                                      device=device)
    P = cfg["population"]
    x0 = rscene.starts(scene, cfg["starts"], P)
    defaults = {k: v.detach().cpu().numpy()
                for k, v in sim.default_params().items()}
    base = tr.base_vector(cfg, defaults)
    kept = []
    dense_ops.TF32_OPERANDS = True
    try:
        truth = dict(cfg["base"], **cfg["truth"])
        pt = judge.batched_params(sim, truth, {}, x0)
        target_x = sim.rollout_chunked(pt, tf["chunk"]).full_x()
        for i in range(evals):
            X = tr.candidates(cfg, seed, i, base)
            eps = tr.checked_episodes(tf, seed, i, P)
            p = judge.batched_params(
                sim, cfg["base"], check.fields_of(cfg, X[eps], defaults),
                x0[eps])
            loss_fn = losses.make_loss_fn(
                LossType.MATCH_TRAJECTORY,
                losses.LossInfo(target_x=target_x[eps]))
            keep = {}
            watch = program.CotangentWatch(sim, len(eps))
            watch.episodes = torch.arange(len(eps), device=sim.device)

            def keeping(recs, inner=loss_fn, keep=keep):
                keep["x"] = recs.steps.x.detach().cpu().numpy()
                keep["v"] = recs.steps.v.detach().cpu().numpy()
                return inner(recs)
            vg = sim.episode_value_and_grad_chunked(keeping, tf["chunk"],
                                                    batched=True)
            L, g = vg(p)
            keep["lx"], keep["lv"] = watch.take()
            sim.steps[0] = watch.inner
            G = np.stack([
                (getattr(g, f)[:, j] if j is not None
                 else getattr(g, f)).detach().cpu().numpy()
                for f, j in cfg["vector"]], 1)
            kept.append(dict(index=i, episodes=np.arange(len(eps)),
                             loss=L.cpu().numpy(), grad=G, X=X[eps],
                             x0_rows=eps, **keep))
    finally:
        dense_ops.TF32_OPERANDS = False
    return kept, x0, target_x.cpu()


def control_readings(cell: str, seeds, evals: int, device="cuda",
                     overrides: dict = None, out=None) -> list:
    """The judged numbers of the control on each seed."""
    from benchmark import check
    cfg, tf = load_cell(cell, overrides)
    rows = []
    for s in seeds:
        kept, x0, target_x = control_answers(cfg, tf, s, evals, device)
        # each evaluation's checked episodes, renumbered in one batch
        rows_x0 = np.concatenate([ev.pop("x0_rows") for ev in kept])
        off = 0
        for ev in kept:
            n = len(ev["episodes"])
            ev["episodes"] = np.arange(off, off + n)
            for k in ("loss", "grad", "X"):
                ev[k] = _spread(ev[k], off, len(rows_x0))
            off += n
        numbers, raw = check.judge_run(cfg, kept, x0[rows_x0], [],
                                       np.asarray(target_x)[rows_x0],
                                       device=device)
        rows.append(_emit(dict(cell=cell, side="control", seed=s,
                               **numbers), raw, out))
    return rows


def overhead(cell: str, seed: int, pairs: int, device="cuda",
             overrides: dict = None) -> list:
    """What keeping the checked answers adds to an evaluation: `pairs`
    times the same evaluation with the harness's hooks and copies, then
    without them, after one set-up; (kept s, bare s) a pair."""
    from benchmark import program
    from benchmark import traffic as tr
    cfg, tf = load_cell(cell, overrides)
    c = program.Cell(cfg, tf, seed, device=device)
    c.setup()
    rows = []
    for i in range(pairs):
        walls = []
        for keep in (True, False):
            c.keep = keep
            walls.append(c.evaluate(i)["wall"])
        rows.append(walls)
        print(json.dumps(dict(cell=cell, side="overhead", seed=seed,
                              X=tr.candidates(cfg, seed, i,
                                              c.base_vec)[:, 0].tolist(),
                              kept_s=walls[0], bare_s=walls[1])),
              flush=True)
    return rows


def plant_friction_bwd_fault():
    """The program's backward self-friction sweep with its slot
    contributions doubled: wrong only at the steps with self-contact."""
    from diffcloth_tpu_torch.core import friction_cuda as fc
    inner = fc.friction_sweep_bwd

    def doubled(g, vals, ops):
        out, *slots = inner(g, vals, ops)
        return (g + 2.0 * (out - g), *slots)
    fc.friction_sweep_bwd = doubled


def _spread(a, off, total):
    out = np.full((total,) + a.shape[1:], np.nan)
    out[off:off + len(a)] = a
    return out


def _emit(row: dict, raw: dict, out) -> dict:
    """A reading's line on standard output and in `out`, its per-episode
    and per-step gaps beside it."""
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")
        np.savez(f"{out}.{row['side']}.{row['seed']}.npz", **raw)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--evals", type=int, default=1)
    ap.add_argument("--out")
    ap.add_argument("--fault", choices=("friction_bwd",),
                    help="plant a fault in the program before its seeds")
    ap.add_argument("--overhead", type=int, default=0,
                    help="pairs of evaluations timed with and without "
                    "the kept answers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if args.fault:
        plant_friction_bwd_fault()
    if seeds:
        program_readings(args.workload, seeds, args.evals, out=args.out)
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    if cseeds:
        control_readings(args.workload, cseeds, args.evals, out=args.out)
    if args.overhead:
        overhead(args.workload, seeds[0] if seeds else 1, args.overhead)
    return 0


if __name__ == "__main__":
    sys.exit(main())
