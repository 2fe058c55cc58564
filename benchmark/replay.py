"""What a traced run reads besides its window's counters.

`device_spans`: the device time of the step's programs in the window,
from the CUDA events the program records around each program launch
(`core/graphs.TIMING`; torch.profiler sees few or none of the kernels
inside a program's WHILE bodies), and the device's idle time by what the
host was doing around it.

`kernels`: each hand-written kernel's device time per call, from
torch.profiler on an uncaptured replay (cuda_graphs=False) of a few of the
cell's own recorded steps, beside the least time its inputs allow
(`roofline.py`); and the replay's operators with the most device time.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import roofline

# steps of the uncaptured replay
REPLAY_STEPS = 2
# the kernels' symbols, as the profiler names them
SYMBOLS = {"selfcol_detect": "detect_kernel",
           "friction_fwd": "friction_kernel",
           "friction_bwd": "friction_bwd_kernel"}


def _overlap(spans, a, b) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in spans)


def device_spans(timing: list, evals: list) -> dict:
    """busy_s: the programs' device seconds in the window; idle_gaps: the
    device's idle seconds by phase (the forward's chunk loop, the
    backward's recompute and adjoint, between evaluations)."""
    torch.cuda.synchronize()
    busy_s = sum(a.elapsed_time(b) for a, b in timing) / 1e3
    origin = evals[0]["events"][0]
    spans = [(origin.elapsed_time(a) / 1e3, origin.elapsed_time(b) / 1e3)
             for a, b in timing]
    idle = {"forward: the host between step programs": 0.0,
            "backward: autograd, the chunks' recompute and their glue": 0.0,
            "between evaluations: the harness and the helper's packing": 0.0}
    keys = list(idle)
    last_end = None
    for e in evals:
        s = origin.elapsed_time(e["events"][0]) / 1e3
        end = origin.elapsed_time(e["events"][1]) / 1e3
        mid = (origin.elapsed_time(e["fwd_end"]) / 1e3 if e.get("fwd_end")
               is not None else end)
        idle[keys[0]] += (mid - s) - _overlap(spans, s, mid)
        idle[keys[1]] += (end - mid) - _overlap(spans, mid, end)
        if last_end is not None:
            idle[keys[2]] += (s - last_end) - _overlap(spans, last_end, s)
        last_end = end
    gaps = [[k, v] for k, v in idle.items() if v > 0]
    return dict(busy_s=busy_s, idle_gaps=sorted(gaps, key=lambda g: -g[1]))


def kernels(cell, cfg: dict) -> dict:
    """The replay: an uncaptured sim of the cell's scene takes
    REPLAY_STEPS steps from a state of the window's first evaluation (and,
    in a gradient cell, their adjoints at the loss's cotangents) under
    torch.profiler, each kernel call counted by a wrapper that reads its
    inputs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffcloth_tpu_torch.core import friction_cuda as fc
    from diffcloth_tpu_torch.core import selfcol_cuda as scd
    from diffcloth_tpu_torch.core.sim import ClothSim

    sim = cell.sim
    rsim = ClothSim(sim.scene_host, flags=sim.flags,
                    prims=sim.prims if sim.n_prims else None,
                    spline_type=sim.spline_type, device=sim.device,
                    dtype=sim.dtype, cuda_graphs=False, **cfg["sim"])
    k, x, v = cell.kept[0]["replay"]
    p = cell.helper.stack_vecs(cell.kept[0]["X"])
    x, v = x.to(sim.device), v.to(sim.device)
    xfs, p_inv = rsim.x_fixed_seq(p), rsim.p_inv(p)
    N = rsim.n_steps
    least = {name: [] for name in SYMBOLS}
    admissible = {}
    orig = (scd.detect_partners, fc.friction_sweep, fc.friction_sweep_bwd)

    def detect(geom, allowed, K):
        if "n" not in admissible:
            admissible["n"] = int((allowed > 0).sum())
        B, _, n_pad = geom.shape
        least["selfcol_detect"].append(roofline.least_s(
            *roofline.detect(B, n_pad, K, admissible["n"])))
        return orig[0](geom, allowed, K)

    def sweep_args(t, ops):
        B, n, _ = t.shape
        return (B, n, ops.vals_shape[2], ops.geom.counts.shape[1],
                int(ops.geom.counts.sum()))

    def fwd(fr, ops):
        least["friction_fwd"].append(roofline.least_s(
            *roofline.friction_fwd(*sweep_args(fr, ops))))
        return orig[1](fr, ops)

    def bwd(g, vals, ops):
        least["friction_bwd"].append(roofline.least_s(
            *roofline.friction_bwd(*sweep_args(g, ops))))
        return orig[2](g, vals, ops)

    scd.detect_partners, fc.friction_sweep, fc.friction_sweep_bwd = (
        detect, fwd, bwd)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for j in range(REPLAY_STEPS):
                kk = min(k + j, N)
                t = torch.tensor(kk * sim.h, dtype=sim.dtype,
                                 device=sim.device)
                i = torch.tensor(kk, dtype=torch.int64, device=sim.device)
                xl = x.detach().clone().requires_grad_(True)
                vl = v.detach().clone().requires_grad_(True)
                leaves = {f: a.detach().clone().requires_grad_(True)
                          for f, a in p.items()}
                with torch.enable_grad():
                    xn, vn, _ = rsim.step(xl, vl, type(p)(**leaves),
                                          xfs[:, kk - 1], p_inv, t, i)
                    tgt = cell.target_x[..., kk, :, :].to(sim.device)
                    cot = 2.0 * (xn.detach() - tgt) / ((N + 1) * sim.n)
                    torch.autograd.grad([xn], [xl, vl]
                                        + list(leaves.values()), [cot],
                                        allow_unused=True)
                x, v = xn.detach(), vn.detach()
            torch.cuda.synchronize()
    finally:
        scd.detect_partners, fc.friction_sweep, fc.friction_sweep_bwd = orig
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    out = {}
    for name, sym in SYMBOLS.items():
        hits = [e for e in events if sym in e.key]
        count = sum(e.count for e in hits)
        if not least[name] or not count:
            continue
        dev_per_call = sum(e.self_device_time_total for e in hits) / count
        out[name] = dict(calls=len(least[name]), events=count,
                         device_s_per_call=dev_per_call / 1e6,
                         least_s_per_call=float(np.mean(least[name])))
    ops = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    return dict(kernels=out, device_ops=[
        ["uncaptured replay: " + e.key[:100], e.self_device_time_total / 1e6]
        for e in ops])
