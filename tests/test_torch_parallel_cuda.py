"""The tensor-parallel step on the card: `parallel/mesh.make_tp_solve`'s
solve, whose all-gather is `parallel/exchange.py`'s kernel pair, inside
the step's captured device programs.

Each case runs its ranks as processes of their own
(tests/torch_parallel_cuda_worker.py, one card each unless named), under a
time limit: every rank arms faulthandler to print its stacks and end
before the limit, and the parent kills what is left.  The cases:

  * one rank (a world-size-1 NCCL group): the tp step captured by
    default, equal bit for bit to `cuda_graphs=False` and, losses and
    gradients, to the plain step (its row block is the whole P^{-1}), its
    programs and the exchange launched, its wind gradient nonzero;
    `cuda_graphs=True` with another `solve_fn` raises;
  * two ranks (dp 1 x tp 2) and four (dp 2 x tp 2, skips below four
    cards) on the flagship stand-in, and two on the dress stand-in's
    chunked value-and-grad: captured equal to uncaptured bit for bit on
    each rank, the tp ranks of a group equal to each other bit for bit,
    with equal body runs in every loop, a gradient nonzero, and on the
    flagship the losses and the gradients within F32_RTOL (GRAD_RTOL
    where it names the class) of the plain one-card step's
    (`torch_parallel_cuda_worker.check_tp_step`, which says why: the
    row-block product rounds otherwise than the dense one, and the loops'
    exits follow the rounding);
  * the tp step's f32 distance from the plain step, traced (two
    processes on one card): on the flagship stand-in and on
    tests/test_torch_parallel.py's folded contact scene the tp objective
    equals the plain step given the same row-block products in one
    process bit for bit; the distance per class is printed;
  * the exchange's kernels against NCCL's all-gather on two cards, bit
    for bit, and both timed;
  * the staged probe of the tp all-gather (skips below two cards): NCCL's
    `all_gather_into_tensor` eager, in a plain CUDA graph and in a WHILE
    body of a device program, each with communicators made lazily and
    eagerly; the exchange's kernels in a WHILE body; the flagship's tp
    step captured with NCCL's gather and with the exchange.  It records
    each stage's outcome (passed, the error, or the time-out with every
    rank's stacks and progress lines), `nvidia-smi topo -m`, the cards,
    their peer access and the transport NCCL picked, prints them as one
    JSON line and writes them to $TP_PROBE_OUT/tp_probe.json when that is
    set.

These tests need NVIDIA GPUs and skip without them; run them there with

    python -m pytest --noconftest -q tests/test_torch_parallel_cuda.py
"""
import glob
import json
import os
import pathlib
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torch_parallel_cuda_worker import check_tp_step, passed, run_ranks

pytestmark = pytest.mark.cuda
PROBE_STAGE_S = 60          # each probe stage's time limit
PROBE_STEP_S = 180          # the probe's tp-step stages'


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL and the CUDA kernels have no "
                    "CPU mode)")
    from diffcloth_tpu_torch.core import cuda_build
    cuda_build.build_all()      # once, before the ranks load the kernels
    return torch.device("cuda")


def cards(k):
    if torch.cuda.device_count() < k:
        pytest.skip(f"needs {k} cards")
    return list(range(k))


def test_tp_step_captured_world_one(card, tmp_path):
    """One rank: the tp step runs captured by default, bit for bit equal
    to `cuda_graphs=False` and to the plain step's losses and gradients;
    another `solve_fn` with `cuda_graphs=True` raises."""
    from diffcloth_tpu_torch.core.sim import ClothSim
    from diffcloth_tpu_torch.geometry import builder as gb
    from diffcloth_tpu_torch.tasks.registry import TSHIRT_GRID_STANDIN
    with pytest.raises(ValueError, match="solve_fn"):
        ClothSim(gb.build_scene(TSHIRT_GRID_STANDIN), device="cuda",
                 solve_fn=lambda p_inv, rhs: p_inv @ rhs, cuda_graphs=True)
    res = run_ranks("tp_step", tmp_path, [0], 300)
    check_tp_step(res, 1, "world one")
    a = res["arrays"][0]
    np.testing.assert_array_equal(a["captured_losses"], a["plain_losses"])


def test_tp_step_of_two_ranks_captured(card, tmp_path):
    """dp 1 x tp 2 on two cards, the flagship stand-in."""
    res = run_ranks("tp_step", tmp_path, cards(2), 300)
    check_tp_step(res, 2, "dp 1 x tp 2")


def test_dp2_tp2_step_captured_four_ranks(card, tmp_path):
    """dp 2 x tp 2 on four cards, the flagship stand-in."""
    res = run_ranks("tp_step", tmp_path, cards(4), 300, tp=2)
    check_tp_step(res, 2, "dp 2 x tp 2")


def test_dress_tp2_chunked_captured(card, tmp_path):
    """dp 1 x tp 2 on two cards, the dress stand-in (n = 7056)."""
    res = run_ranks("dress", tmp_path, cards(2), 900)
    check_tp_step(res, 2, "dress tp 2", grad="x0")


def gaps(a, scene, route, rows=slice(None)):
    """{class: max |route - plain| / max |plain|} over the episodes `rows`
    of `scene` (the `tp_gap` case's arrays), and of their means (`_mean`,
    as tests/tp_f32_gap.py measures), for the nonzero classes."""
    out = {}
    for k in sorted(k[len(f"{scene}_plain_"):] for k in a
                    if k.startswith(f"{scene}_plain_")):
        got = a[f"{scene}_{route}_{k}"][rows]
        ref = a[f"{scene}_plain_{k}"][rows]
        if not np.abs(ref).max() > 0:
            continue
        out[k] = float(np.abs(got - ref).max() / np.abs(ref).max())
        if k != "losses":
            out[k + "_mean"] = float(np.abs(got.mean(0) - ref.mean(0)).max()
                                     / np.abs(ref.mean(0)).max())
    return out


def test_tp_gap_is_the_row_block_rounding(card, tmp_path):
    """dp 1 x tp 2 as two gloo processes on one card, f32, on the
    flagship stand-in and on tests/test_torch_parallel.py's folded contact
    scene: the tp objective equals, bit for bit, the plain step given the
    same row-block products in one process (`split_solve`), so its
    distance from the plain step is the row-block product's rounding
    carried through the episode.  Prints that distance per class, for
    the flagship's folded and flat episodes apart, beside the distance
    that another rounding of the same product (`f64_solve`) makes."""
    res = passed(run_ranks("tp_gap", tmp_path, [0, 0], 600, tp=2,
                           backend="gloo"))
    a0, a1 = res["arrays"]
    for k in a0:
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
        assert np.isfinite(a0[k]).all(), k
    for k in [k for k in a0 if "_tp_" in k]:
        np.testing.assert_array_equal(a0[k], a0[k.replace("_tp_", "_split_")],
                                      err_msg=k)
    report = {f"{route}_{name}": gaps(a0, scene, route, rows)
              for route in ("tp", "f64")
              for name, scene, rows in (
                  ("flagship_folded", "flagship", slice(0, None, 2)),
                  ("flagship_flat", "flagship", slice(1, None, 2)),
                  ("contact", "contact", slice(None)))}
    print("[tp-gap] max |tp - plain| / max |plain|, f32, "
          + torch.cuda.get_device_name(0) + ": " + json.dumps(report),
          flush=True)


def test_exchange_matches_nccl_two_ranks(card, tmp_path):
    """The exchange's kernels on two cards equal NCCL's all-gather bit for
    bit at the flagship's and the dress's blocks; prints both times."""
    res = passed(run_ranks("exchange_time", tmp_path, cards(2), 300))
    for r in res["ranks"]:
        assert r["flagship"]["equal"] and r["dress"]["equal"], r
    print("[exchange-time] " + json.dumps({
        "cards": nvidia_smi("--query-gpu=name,power.limit",
                            "--format=csv,noheader"),
        "ranks": [{k: r[k] for k in ("flagship", "dress")}
                  for r in res["ranks"]]}), flush=True)


def nvidia_smi(*args) -> str:
    try:
        return subprocess.run(["nvidia-smi", *args], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def nccl_transports(out) -> list:
    """NCCL's version and the transports it chose, from its INFO logs."""
    seen = set()
    for path in glob.glob(str(pathlib.Path(out) / "nccl.*.log")):
        for line in open(path, errors="replace"):
            m = re.search(r"(NCCL version \S+|via \S+|NVLS \S+ \S+)", line)
            if m:
                seen.add(m.group(1))
    return sorted(seen)


# (stage, case, init, limit); the stages that may hang run last
PROBE = [("1 eager all-gather", "gather_eager", "lazy", PROBE_STAGE_S),
         ("1 eager all-gather", "gather_eager", "eager", PROBE_STAGE_S),
         ("2 plain graph", "gather_graph", "lazy", PROBE_STAGE_S),
         ("2 plain graph", "gather_graph", "eager", PROBE_STAGE_S),
         ("3B WHILE body, exchange kernels", "exchange_while", "eager",
          PROBE_STAGE_S),
         ("4B tp step captured, exchange kernels", "tp_step", "eager",
          PROBE_STEP_S),
         ("3 WHILE body", "gather_while", "lazy", PROBE_STAGE_S),
         ("3 WHILE body", "gather_while", "eager", PROBE_STAGE_S),
         ("4 tp step captured, NCCL gather", "tp_step_nccl", "eager",
          PROBE_STEP_S)]


def test_tp_staged_probe(card, tmp_path):
    """The staged probe (see the docstring): stages 1, 2, 3B and 4B pass;
    every other stage ends with a result, the time-outs with stacks."""
    cards(2)
    pairs = [[i, i + 1] for i in range(0, torch.cuda.device_count() - 1, 2)]

    def stage(i):
        name, case, init, limit = PROBE[i]
        pair = pairs[i % len(pairs)]
        res = run_ranks(case, tmp_path / f"s{i}", pair, limit, init=init)
        row = {"stage": name, "case": case, "init": init, "cards": pair,
               "outcome": res["outcome"],
               "seconds": round(res["seconds"], 1),
               "nccl": nccl_transports(tmp_path / f"s{i}")}
        if res["outcome"] == "passed":
            row["ranks"] = [{k: v for k, v in r.items()
                             if k in ("equal", "launches", "body_runs",
                                      "seconds")} for r in res["ranks"]]
            if case.startswith("tp_step"):
                try:
                    check_tp_step(res, 2, name, case == "tp_step")
                    row["check"] = "ok"
                except AssertionError as e:
                    row["check"] = str(e)[-2000:]
                row["ranks"] = [{"walls": r[t]["walls"], "route": t}
                                for r in res["ranks"]
                                for t in ("captured", "uncaptured")]
        else:
            row["logs"] = res["logs"]
        return row

    # a pair of cards per stage; the stages of one round run at once
    rows = []
    with ThreadPoolExecutor(len(pairs)) as pool:
        for at in range(0, len(PROBE), len(pairs)):
            rows += list(pool.map(stage, range(at, min(at + len(pairs),
                                                       len(PROBE)))))
    n = torch.cuda.device_count()
    report = {"cards": nvidia_smi("--query-gpu=name,power.limit",
                                  "--format=csv,noheader"),
              "topology": nvidia_smi("topo", "-m"),
              "p2p": [[int(i == j or torch.cuda.can_device_access_peer(i, j))
                       for j in range(n)] for i in range(n)],
              "nvlink": nvidia_smi("nvlink", "-s"), "stages": rows}
    print("[tp-probe] " + json.dumps(report), flush=True)
    if os.environ.get("TP_PROBE_OUT"):
        path = pathlib.Path(os.environ["TP_PROBE_OUT"]) / "tp_probe.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=1))
    for row in rows:
        if row["case"] in ("gather_eager", "gather_graph", "exchange_while",
                           "tp_step"):
            assert row["outcome"] == "passed", row
        if row["case"] == "tp_step":
            assert row["check"] == "ok", row
        if row["outcome"] == "passed" and "equal" in row["ranks"][0]:
            assert all(r["equal"] for r in row["ranks"]), row
        if row["outcome"] == "timeout":
            assert all(row["logs"].values()), row
