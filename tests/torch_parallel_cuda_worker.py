"""The ranks of the tp step's multi-process cases on the card (a helper,
not collected; imports no JAX): `run_ranks` spawns a case's ranks under a
time limit and `check_tp_step` holds a tp step's results, for
tests/test_torch_parallel_cuda.py and chip_smoke.py's phase 17f.  Run by
`run_ranks`, one process per rank:

    python -X faulthandler tests/torch_parallel_cuda_worker.py CASE \\
        --rank R --world W --port P --device D --out DIR [--tp T] \\
        [--init lazy|eager] [--backend nccl|gloo] [--dump-after S]

It joins an NCCL group of W ranks over tcp://localhost:P (--backend gloo:
a gloo group, for ranks that share one card, which NCCL refuses: 17f's
pair; the exchange's kernels need the group only to trade their handles,
and a tp step with dp = 1 makes no other collective), runs CASE and
writes DIR/rank{R}.json (and DIR/rank{R}.npz for arrays).  After
--dump-after seconds faulthandler prints every thread's stack and ends the
process, so a rank that stops names where.

Cases (the staged probe of the tp all-gather, at the dress solve's shape
(B, n / 2, 3) = (2, 3528, 3) f32, ROUNDS rounds each adding one to the
block before its gather):
  gather_eager      dist.all_gather_into_tensor on the tp group, eager;
  gather_graph      the same captured in a plain torch.cuda.graph, replayed;
  gather_while      the same as the body of a WHILE node of a device
                    program (core/graphs.py, csrc/graph_program.cu), cap
                    ROUNDS;
  exchange_while    the same with parallel/exchange.py's kernels in place
                    of NCCL;
  tp_step_nccl      the flagship stand-in's tp value-and-grad captured with
                    NCCL's all-gather as its solve's gather;
the exchange's kernels against NCCL:
  exchange_time     equal bit for bit, and both timed, at the flagship's
                    block (B = 32, n = 1024) and the dress's;
the tp training step, captured against uncaptured:
  tp_step           the flagship stand-in (n = 1024), dp x tp = W / --tp x
                    --tp, make_tp_solve's solve;
  dress             the dress stand-in (n = 7056), dp 1 x tp W,
                    `batched_value_and_grad` in chunks (`chunk`).
--init eager joins with `device_id` and runs one all_reduce on every
group before anything is captured; lazy leaves NCCL to make each group's
communicator at its first collective.
"""
import argparse
import dataclasses
import faulthandler
import json
import os
import pathlib
import socket
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from diffcloth_tpu_torch import losses
from diffcloth_tpu_torch.config import LossType
from diffcloth_tpu_torch.core import dense_ops as dn
from diffcloth_tpu_torch.core import graphs as gr
from diffcloth_tpu_torch.core import launch_count as lc
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.geometry import states
from diffcloth_tpu_torch.parallel import exchange
from diffcloth_tpu_torch.parallel import mesh as pmesh
from diffcloth_tpu_torch.tasks.registry import (TSHIRT_GRID_STANDIN,
                                                dress_grid_standin)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the tp step against the plain step, f32 (the row-block product rounds
# otherwise than the dense one, and the loops' exits follow the rounding):
# the losses elementwise, each gradient class within F32_RTOL (GRAD_RTOL
# where it names the class) of the class's largest entry.  dL/dk_pertype:
# the adjoint stops at its tolerance and the k gradient is a small sum of
# cancelling terms (on an H100 the plain step's own moved by 2.4e-3 of its
# largest entry between a batch of 2 and of 4 of the same episodes, the
# tp step's from the plain step's by 6.3e-3).  The start state's
# per-vertex gradients get 0.25, over three times what the rounding moved
# them by: on an H100 116 of 6144 entries of dL/dx0 moved by more
# than 2e-2 of its largest entry, the most by 7.1e-2 (dL/dv0 4.6e-2),
# with the losses within 7.5e-8 and dL/dwind within 1.8e-7 (the cause not
# traced); they are held bit for bit between the routes, between the tp
# ranks and, on one rank, to the plain step.
F32_RTOL = 1e-4
GRAD_RTOL = {"k_pertype": 2e-2, "x0": 0.25, "v0": 0.25}
GRACE_S = 30                # the peers' time to fail after a rank failed
ROUNDS = 100
PROBE_B, PROBE_N = 2, 7056
FLAGSHIP_STEPS = 4
EPISODES_PER_DP = 2
DRESS_STEPS = 125        # chip_smoke.py's dress depth (the scene's own)
DRESS_CHUNK = 25


def join(rank, world, port, device, init, tp, backend):
    torch.cuda.set_device(device)
    kw = {"device_id": torch.device("cuda", device)} \
        if init == "eager" and backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, **kw)
    mesh = pmesh.make_mesh(world // tp, tp)
    if init == "eager" and backend == "nccl":
        for g in (None, mesh.dp_group, mesh.tp_group):
            dist.all_reduce(torch.ones(1, device="cuda"), group=g)
        torch.cuda.synchronize()
    return mesh


# -- the parent: spawning the ranks, checking their results ---------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(case, out, devices, limit, tp=None, init="eager",
              backend="nccl") -> dict:
    """Run `case` on len(devices) ranks (rank r on card devices[r]) under
    `limit` seconds: {"outcome": "passed" | "error" | "timeout", "seconds",
    "ranks": [each rank's JSON], "arrays": [each rank's npz], "logs":
    {rank: its output's tail}}."""
    out = pathlib.Path(out)
    out.mkdir(parents=True, exist_ok=True)
    world, port = len(devices), free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), NCCL_DEBUG="INFO",
               NCCL_DEBUG_FILE=str(out / "nccl.%p.log"))
    procs, logs = [], []
    t0 = time.monotonic()
    for r, d in enumerate(devices):
        log = open(out / f"rank{r}.log", "w")
        logs.append(log)
        cmd = [sys.executable, "-X", "faulthandler", __file__, case,
               "--rank", str(r), "--world", str(world), "--port", str(port),
               "--device", str(d), "--out", str(out), "--init", init,
               "--backend", backend, "--dump-after", str(limit - 15)]
        if tp:
            cmd += ["--tp", str(tp)]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    ended = {}                  # rank -> (exit code, seconds)
    while len(ended) < world and time.monotonic() - t0 < limit:
        for r, p in enumerate(procs):
            if r not in ended and p.poll() is not None:
                ended[r] = (p.returncode, time.monotonic() - t0)
        failed = [t for rc, t in ended.values() if rc != 0]
        # a rank that failed leaves its peers waiting: a grace, then stop
        if failed and time.monotonic() - t0 > min(failed) + GRACE_S:
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for log in logs:
        log.close()
    res = {"seconds": time.monotonic() - t0,
           "logs": {r: (out / f"rank{r}.log").read_text()[-4000:]
                    for r in range(world)}}
    # faulthandler ends a rank with exit code 1 after its dump, near the
    # limit: a failure before that is an error, at it a time-out
    early = [t for rc, t in ended.values() if rc != 0 and t < limit - 16]
    if early:
        res["outcome"] = "error"
        return res
    if len(ended) < world or any(rc != 0 for rc, _ in ended.values()):
        res["outcome"] = "timeout"
        return res
    res["outcome"] = "passed"
    res["ranks"] = [json.loads((out / f"rank{r}.json").read_text())
                    for r in range(world)]
    res["arrays"] = [dict(np.load(out / f"rank{r}.npz"))
                     for r in range(world)]
    return res


def passed(res) -> dict:
    assert res["outcome"] == "passed", json.dumps(res["logs"], indent=1)
    return res


def check_tp_step(res, tp, name, exchange=True, grad="wind"):
    """A tp step's ranks (`train`'s results): captured against uncaptured
    on each rank bit for bit, the programs and (unless the gather is
    NCCL's) the exchange launched, the gradient `grad` nonzero; against the
    plain step where the case ran it, bit for bit on one rank (its row
    block is all of P^{-1}) and on more the losses and the gradients
    within F32_RTOL (GRAD_RTOL where given); the tp ranks of a
    group equal to each other bit for bit, with equal body runs in every
    loop.  Prints the calls' walls and each output's distance from the
    plain step's."""
    passed(res)
    one = len(res["ranks"]) == 1
    for info, a in zip(res["ranks"], res["arrays"]):
        cap, unc = info["captured"], info["uncaptured"]
        assert cap["captured"] and not unc["captured"], name
        assert cap["launches"] > 0 and unc["launches"] == 0, name
        assert (cap["kernels"]["peer_exchange"] > 0) == exchange, \
            cap["kernels"]
        for k in [k[len("captured_"):] for k in a if
                  k.startswith("captured_")]:
            np.testing.assert_array_equal(a["captured_" + k],
                                          a["uncaptured_" + k],
                                          err_msg=f"{name}: {k}")
        assert np.isfinite(a["captured_losses"]).all(), name
        assert np.abs(a["captured_" + grad]).max() > 0, (name, grad)
        plain = {k[len("plain_"):]: (a["captured_" + k[len("plain_"):]],
                                     a[k]) for k in a if k.startswith("plain_")}
        if plain:
            print(f"[tp-plain] {name}, rank {info['rank']}: max |tp - "
                  f"plain| / max |plain| " + json.dumps({
                      k: float(np.abs(g - r).max() / max(np.abs(r).max(),
                                                         1e-30))
                      for k, (g, r) in plain.items()}), flush=True)
        for k, (got, ref) in plain.items():
            if one:
                np.testing.assert_array_equal(got, ref,
                                              err_msg=f"{name}: {k}")
            elif k == "losses":
                np.testing.assert_allclose(got, ref, rtol=F32_RTOL)
            else:
                np.testing.assert_allclose(
                    got, ref, rtol=0, atol=GRAD_RTOL.get(k, F32_RTOL)
                    * float(np.abs(ref).max()), err_msg=f"{name}: {k}")
    info = res["ranks"][0]
    print(f"[tp-rates] {name}: walls of the calls, captured (warm-up, "
          f"capture, launch) {info['captured']['walls']}, uncaptured "
          f"(cold, warm) {info['uncaptured']['walls']}; program launches "
          f"{info['captured']['launches']}, kernels "
          f"{info['captured']['kernels']}", flush=True)
    for g0 in range(0, len(res["ranks"]), tp):
        group = list(zip(res["ranks"], res["arrays"]))[g0:g0 + tp]
        (i0, a0), rest = group[0], group[1:]
        for info, a in rest:
            for k in a0:
                np.testing.assert_array_equal(a0[k], a[k],
                                              err_msg=f"{name}: {k}")
            for tag in ("captured", "uncaptured"):
                assert info[tag]["body_runs"] == i0[tag]["body_runs"], name


# -- the staged probe ------------------------------------------------------

def probe_blocks(tp):
    """Every rank's starting block (m, B, 3), the layout the tp solve
    gathers, from seeds 0 .. tp-1 (so each rank knows its peers')."""
    m = PROBE_N // tp
    return [torch.randn((m, PROBE_B, 3), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(r))
            for r in range(tp)]


def probe_expected(blocks, rounds):
    out = []
    for b in blocks:
        b = b.clone()
        for _ in range(rounds):
            b.add_(1.0)
        out.append(b)
    return torch.cat(out)


def mark(what):
    """A progress line: where a stage that stops stopped."""
    print(f"[{time.strftime('%H:%M:%S')}] {what}", flush=True)


def probe(case, mesh):
    tp, me = mesh.tp, mesh.tp_rank
    blocks = probe_blocks(tp)
    local = blocks[me].clone()
    out = torch.empty((PROBE_N, PROBE_B, 3), device="cuda")
    group = mesh.tp_group
    gather = exchange.RowGather(group) if case == "exchange_while" else None

    def one():
        local.add_(1.0)
        if gather is None:
            dist.all_gather_into_tensor(out, local, group=group)
        else:   # the exchange takes (B, m, 3) blocks
            out.copy_(gather(local.transpose(0, 1)).transpose(0, 1))

    res = {}
    if case == "gather_eager":
        for _ in range(ROUNDS):
            one()
    elif case == "gather_graph":
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            for _ in range(3):
                one()
        torch.cuda.current_stream().wait_stream(s)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            one()
        mark("captured")
        local.copy_(blocks[me])
        for _ in range(ROUNDS):
            g.replay()
    else:   # gather_while, exchange_while
        bg = gr.BlockGraphs(True)
        st = {"go": torch.ones(1, dtype=torch.bool, device="cuda")}

        def block(st, k):
            for _ in range(k):
                one()

        prog = [gr.Loop(block, ROUNDS, 1, "gather")]
        bg.program("probe", prog, st)          # the warm-up, uncaptured
        torch.cuda.synchronize()
        mark("warm-up done")
        local.copy_(blocks[me])
        bg.reset()
        bg.program("probe", prog, st)          # captured, built, launched
        mark("captured, built and launched")
        torch.cuda.synchronize()
        mark("the launch ended")
        summ = bg.summary()["probe"]
        res["launches"] = summ["launches"]
        res["body_runs"] = summ["loops"][0]["runs"]
    torch.cuda.synchronize()
    res["equal"] = bool(torch.equal(out, probe_expected(blocks, ROUNDS)))
    return res


def time_ms(fn, reps=200, warmup=20):
    """Mean ms of fn() over `reps` back-to-back calls (CUDA events), the
    ranks starting together: the host's launch rate where it is slower
    than the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=100):
    """Mean device ms of fn() from one replay of a CUDA graph of `reps`
    calls (CUDA events), the ranks replaying together; None where fn
    cannot be captured (the error logged)."""
    try:
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
    except RuntimeError as e:
        print(f"graph_ms: {e}", flush=True)
        return None
    for _ in range(2):
        torch.cuda.synchronize()
        dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def exchange_time(mesh):
    """The exchange kernels against their plain version (NCCL's all-gather
    in the tp solve's layout), bit for bit, and the times of both and of
    one all_gather_into_tensor over the same bytes (back-to-back calls and
    a captured graph's replay), at the flagship's block (B = 32, n = 1024)
    and the dress's (B = 2, n = 7056)."""
    gather = exchange.RowGather(mesh.tp_group)
    group = mesh.tp_group
    res = {}
    for tag, B, n in (("flagship", 32, 1024), ("dress", 2, 7056)):
        # the solve's block: the transpose of a contiguous (n / tp, B, 3)
        x = torch.randn((n // mesh.tp, B, 3), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(
                            mesh.tp_rank))
        flat, x = x.reshape(-1), x.transpose(0, 1)
        buf = flat.new_empty(mesh.tp * flat.numel())
        fns = {"": lambda: gather(x),
               "plain_": lambda: exchange.all_gather_rows_plain(x, group),
               "nccl_": lambda: dist.all_gather_into_tensor(buf, flat,
                                                            group=group)}
        res[tag] = {"equal": bool(torch.equal(
                        gather(x), exchange.all_gather_rows_plain(x, group))),
                    "block_bytes": x.numel() * x.element_size()}
        for k, fn in fns.items():
            res[tag][k + "calls_ms"] = time_ms(fn)
            res[tag][k + "graph_ms"] = graph_ms(fn)
    return res


# -- the tp training step ----------------------------------------------------

def nccl_solve(group):
    """The tp solve with NCCL's all-gather in place of the exchange's
    kernels, marked capturable for the probe's stage 4."""
    def solve(p_inv_block, rhs):
        return exchange.all_gather_rows_plain(dn.mm(p_inv_block, rhs), group)

    solve.capturable = True
    return solve


def flagship_case(mesh, solve_fn, cuda_graphs):
    """(sim, the objective fn(params, p_inv), params, the full P^{-1}): the
    flagship stand-in cut to FLAGSHIP_STEPS steps, EPISODES_PER_DP
    perturbed winds per dp rank, even episodes starting folded."""
    scene = gb.build_scene(dataclasses.replace(TSHIRT_GRID_STANDIN,
                                               step_num=FLAGSHIP_STEPS))
    sim = ClothSim(scene, device="cuda", dtype=torch.float32,
                   solve_fn=solve_fn, cuda_graphs=cuda_graphs)
    B = EPISODES_PER_DP * mesh.dp
    folded = states.folded_grid(scene, 16, -1.5 * float(scene.radii.mean()))
    x0 = np.stack([folded if i % 2 == 0 else scene.x_rest for i in range(B)])
    winds = np.random.RandomState(0).randn(B, 3) * 0.02 + [0.04, 0.004,
                                                           0.04]
    base = sim.default_params()
    params = base.expand(B).replace(
        x0=torch.as_tensor(x0, dtype=sim.dtype, device=sim.device),
        wind=torch.as_tensor(winds, dtype=sim.dtype, device=sim.device))
    target = torch.zeros((FLAGSHIP_STEPS + 1, sim.n, 3), dtype=sim.dtype,
                         device=sim.device)
    loss_fn = losses.make_loss_fn(LossType.MATCH_TRAJECTORY,
                                  losses.LossInfo(target_x=target))
    fn = pmesh.batched_value_and_grad(
        sim, loss_fn, mesh, reduce_grads=False,
        p_inv_spec="tp" if solve_fn is not None else None)
    fn.loss_fn = loss_fn
    return sim, fn, params, sim.p_inv(base)


def dress_case(mesh, solve_fn, cuda_graphs):
    """The dress stand-in (84 x 84, n = 7056) at DRESS_STEPS steps, two
    episodes (the rest state and it displaced by a seeded 1e-3), the tp
    objective in chunks of DRESS_CHUNK steps."""
    from diffcloth_tpu_torch.tasks.setup import build_task
    scene = dataclasses.replace(dress_grid_standin(84), step_num=DRESS_STEPS)
    task = build_task("dress", scene=scene, solve_fn=solve_fn,
                      cuda_graphs=cuda_graphs)
    sim = task.sim
    base = task.param_base
    x0 = base.x0.cpu().numpy()
    x0 = np.stack([x0, x0 + 1e-3 * np.random.RandomState(1).randn(
        *x0.shape)])
    params = base.expand(2).replace(
        x0=torch.as_tensor(x0, dtype=sim.dtype, device=sim.device))
    fn = pmesh.batched_value_and_grad(sim, task.loss_fn(), mesh,
                                      reduce_grads=False, p_inv_spec="tp",
                                      chunk=DRESS_CHUNK)
    return sim, fn, params, sim.p_inv(base)


def body_runs(sim) -> dict:
    """{program key / loop / block length: body runs} since the last reset."""
    out = {}
    for i, g in enumerate(sim.graphs):
        for key, p in g.summary().items():
            for lp in p["loops"]:
                out[f"{i}/{key}/{lp['name']}/{lp['every']}"] = lp["runs"]
    return out


def run_objective(make, mesh, solve_fn, cuda_graphs, calls):
    """`calls` calls of the objective on fresh programs; the last call's
    losses and gradients, its program launches, body runs and kernel
    launches, the calls' wall seconds."""
    sim, fn, params, p_inv = make(mesh, solve_fn, cuda_graphs)
    walls = []
    for i in range(calls):
        for g in sim.graphs:
            g.reset()
        torch.cuda.synchronize()
        lc.zero()
        t0 = time.perf_counter()
        L, grads = fn(params, p_inv)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        mark(f"cuda_graphs={cuda_graphs}: call {i} ended")
    arrays = {"losses": L.cpu().numpy()}
    arrays.update({k: v.cpu().numpy() for k, v in grads.items()})
    info = {"captured": bool(sim.cuda_graphs),
            "launches": sum(p["launches"] for g in sim.graphs
                            for p in g.summary().values()),
            "body_runs": body_runs(sim), "kernels": lc.read_all(),
            "walls": walls}
    return arrays, info


def train(case, mesh, cuda_graphs_calls):
    make = dress_case if case == "dress" else flagship_case
    solve = (nccl_solve(mesh.tp_group) if case == "tp_step_nccl"
             else pmesh.make_tp_solve(mesh.tp_group))
    arrays, res = {}, {}
    for tag, g, calls in cuda_graphs_calls:
        a, info = run_objective(make, mesh, solve, g, calls)
        arrays.update({f"{tag}_{k}": v for k, v in a.items()})
        res[tag] = info
    if case == "tp_step":
        # the plain step on this rank's card: the whole batch, no tp
        sim, fn, params, _ = flagship_case(mesh, None, None)
        L, grads = sim.episode_value_and_grad(fn.loss_fn)(params)
        arrays["plain_losses"] = L.cpu().numpy()
        arrays.update({f"plain_{k}": v.cpu().numpy()
                       for k, v in grads.items()})
    return arrays, res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("case")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--init", default="eager", choices=("lazy", "eager"))
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--dump-after", type=float, default=0)
    args = ap.parse_args()
    if args.dump_after:
        faulthandler.dump_traceback_later(args.dump_after, exit=True)
    t0 = time.perf_counter()
    mesh = join(args.rank, args.world, args.port, args.device, args.init,
                args.tp or args.world, args.backend)
    res = {"case": args.case, "rank": args.rank, "tp_rank": mesh.tp_rank,
           "dp_rank": mesh.dp_rank, "init": args.init,
           "card": torch.cuda.get_device_name(args.device)}
    arrays = {}
    try:
        if args.case in ("gather_eager", "gather_graph", "gather_while",
                         "exchange_while"):
            res.update(probe(args.case, mesh))
        elif args.case == "exchange_time":
            res.update(exchange_time(mesh))
        else:
            # cuda_graphs None: warm-up, capture, launch; False: a cold
            # call and a warm one
            arrays, info = train(args.case, mesh,
                                 (("captured", None, 3),
                                  ("uncaptured", False, 2)))
            res.update(info)
        dist.barrier()
    except BaseException:
        # a collective left in flight makes destroy_process_group wait for
        # it: report and end here
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    np.savez(f"{args.out}/rank{args.rank}.npz", **arrays)
    with open(f"{args.out}/rank{args.rank}.json", "w") as fh:
        json.dump(res, fh)
    print(f"rank {args.rank}: {args.case} done in {res['seconds']:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
