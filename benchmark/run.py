#!/usr/bin/env python3
"""The benchmark of diffcloth_tpu_torch: one cell, one run.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

CELL is a `workloads` entry of BENCHMARK.json, the pair of a configuration
(`configs/<config>.json`) and a traffic mix (`traffic/<traffic>.json`).
Set-up builds the cell's sim, population, target and helper through the
program's own entries and warms up with one whole evaluation; the window
then runs whole evaluations back to back while it is open, each started
one counted with its whole time.  After the window the plain
reference (`reference/`, `check.py`) judges the answers the window kept,
and with --trace 1 the per-layer metrics (`metrics/<name>.py`) are read
from the traced window and an uncaptured replay (`replay.py`).  The last
line of standard output is the result's JSON object; the compared numbers
and their limits are the last lines of standard error.  Needs one CUDA
card; imports nothing of JAX or of the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# the program's caches live in the checkout, at fixed paths (its own
# kernels build into build/torch_kernels there)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

import numpy as np  # noqa: E402
import torch  # noqa: E402

# whole top-level module names the process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "diffcloth_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = (_merge(a[k], v) if isinstance(v, dict)
                  and isinstance(a.get(k), dict) else v)
    return out


def cell_metrics(bench: dict, cell: str, rate_metric: str) -> tuple:
    """(end-to-end names, per-layer entries) this cell reports."""
    def here(m):
        return cell in m.get("workloads", [cell])
    e2e = [m["name"] for m in bench["end_to_end"] if here(m)]
    moves = set(e2e)
    per_layer = [m for m in bench["per_layer"]
                 if here(m) and ("workloads" in m or m["moves"] in moves)]
    if rate_metric not in e2e or "setup_s" not in e2e:
        raise ValueError(f"{cell}: BENCHMARK.json lists {e2e}")
    return e2e, per_layer


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict = None) -> dict:
    """One run of `cell`; returns the result's JSON object.  `overrides`
    ({"config": {...}, "traffic": {...}}) are merged into the cell's files
    (the tests' small sizes)."""
    from benchmark import check, program
    from benchmark import traffic as tr

    bench = load_benchmark()
    w = next(c for c in bench["workloads"] if c["name"] == cell)
    cfg = _merge(tr.load("configs", w["config"]),
                 (overrides or {}).get("config", {}))
    tf = _merge(tr.load("traffic", w["traffic"]),
                (overrides or {}).get("traffic", {}))
    e2e, per_layer = cell_metrics(bench, cell, tf["rate_metric"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    trace = trace and cuda

    c = program.Cell(cfg, tf, seed, device=dev, trace=trace)
    c.setup()
    setup_s = time.perf_counter() - T_START

    graphs = None
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    if trace:
        from diffcloth_tpu_torch.core import graphs
        c.sim.bwd_stats.reset()
        graphs.TIMING = []
    evals, failed = [], 0
    w0 = time.perf_counter()
    try:
        while time.perf_counter() - w0 < seconds:
            rec = c.evaluate(len(evals))
            failed += not all(np.isfinite(rec.pop(k)).all()
                              for k in ("loss", "grad"))
            evals.append(rec)
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - w0
    finally:
        timing = graphs.TIMING if graphs else None
        if graphs:
            graphs.TIMING = None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rate = sum(e["sample_steps"] for e in evals) / window_s
    metrics = {tf["rate_metric"]: {"value": rate, "unit": "steps/s"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    result = dict(correct=False, attempted=len(evals), failed=failed)

    target_checks = c.target_checks()
    traced = {}
    if trace:
        from benchmark import replay
        traced = dict(
            window_s=window_s,
            evals=[dict(wall=e["wall"], split=e["split"]) for e in evals],
            window_peak_bytes=peak - before,
            sums=torch.stack(c.stats).sum(0).tolist(),
            adjoint=c.sim.bwd_stats.summary(),
            **replay.device_spans(timing, evals))
        traced.update(replay.kernels(c, cfg))
        traced["replay_s"] = time.perf_counter() - w0 - window_s
    x0, kept = c.x0, c.kept
    c.free()
    target_x = c.target_x
    del c
    check.free_device()
    j0 = time.perf_counter()
    numbers, _ = check.judge_run(cfg, check.trim(kept, tf, seed), x0,
                                 target_checks, target_x, device=dev)
    judge_s = time.perf_counter() - j0
    lim = check.limits(cell)
    result["correct"] = bool(check.verdict(numbers, lim) and failed == 0
                             and evals)
    result["metrics"] = {k: metrics[k] for k in e2e if k in metrics}
    if trace:
        result["metrics"] = {}
        for m in per_layer:
            value = read_metric(m["name"], traced)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
    result["device"] = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        count=1, memory_peak_bytes=int(peak))
    if trace:
        result["device"].update(busy_s=traced["busy_s"], window_s=window_s)
        result["breakdown"] = dict(device_ops=traced["device_ops"],
                                   idle_gaps=traced["idle_gaps"])
    result["seconds"] = dict(setup=setup_s, window=window_s, judge=judge_s,
                             **({"replay": traced["replay_s"]} if trace
                                else {}))
    result["checks"] = {k: {"value": numbers.get(k), "limit": v}
                        for k, v in lim.items()}
    return result


def read_metric(name: str, traced: dict):
    """The per-layer metric `name` from metrics/<name>.py, else from
    metrics/<name up to its last dot>.py (one reader for its suffixes);
    None where the reader finds nothing."""
    import importlib.util
    for stem in (name, name.rsplit(".", 1)[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "benchmark_metric_" + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read(traced)
    raise FileNotFoundError(f"no reader for the metric {name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    chips = next((c["chips"] for c in bench["workloads"]
                  if c["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); {have} "
              f"available", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the process holds {found}: the benchmark may not load JAX "
              f"or the JAX package", file=sys.stderr)
        return 3
    print("seconds " + json.dumps(result["seconds"]), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
