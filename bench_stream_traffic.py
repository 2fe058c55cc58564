#!/usr/bin/env python3
"""The friction sweeps' streamed-slot route on the slot traffic of a
drop-free flagship episode, on one NVIDIA GPU.

    python3 bench_stream_traffic.py [--tree DIR] [--states FILE] [--out FILE]

The traffic: chip_smoke.py phase 20's flagship stand-in (B = 32 winds,
half starting folded, 100 steps) at drop-free capacity (K = 8, budgets
(1024,) * 16, every sweep on the streamed-slot route), run uncaptured so
that each step's detection inputs (its positions and velocities) can be
kept; they are saved to FILE and read from it when it exists, so that
runs of other checkouts see the same steps.  Of each step's slot geometry
(detection, layer tables, `friction_cuda.sweep_operands`, as the step
builds it) the script reports the per-layer slot counts: how many
sample-steps hold narrow layers (32 slots or fewer) and runs of them,
how many wide ones, and the layers of each step's busiest sample.  Then
both sweeps run on every step's operands, held to their plain versions
exactly, and are timed: device ms per call over the episode's 100 steps
(torch.profiler), and the same on chip_smoke.py 20a's input.  Last, the
global-state streamed route at n = 19 500 (chip_smoke.py 20a's scene)
and at n = 18 500, B = 2.  The JSON line holds every number.

--tree DIR imports the port from another checkout's root (its kernels
built there), so that two trees can be compared on one card on the
same steps; chip_smoke.py's helpers come from this checkout.
"""
import argparse
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NARROW = 32         # the widest layer that counts as narrow
N_GLOBAL = (19500, 18500)


def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record(cs, sim, path):
    """Run the drop-free episode uncaptured, keeping each step's detection
    inputs; save them (x, v: (N, B, n, 3) f32) to path."""
    from diffcloth_tpu_torch.core import selfcol_cuda as scd
    kept, detect = [], scd.detect_tables

    def keep(allowed, radii, x, v, *rest):
        kept.append((x.float().cpu().numpy(), v.float().cpu().numpy()))
        return detect(allowed, radii, x, v, *rest)

    scd.detect_tables = keep
    try:
        st = sim.rollout(cs.episode_params(sim, cs.BATCH)).steps
    finally:
        scd.detect_tables = detect
    if bool(st.selfcol_overflow.any()) or len(kept) != sim.n_steps:
        raise AssertionError(f"{len(kept)} steps recorded, overflow "
                             f"{int(st.selfcol_overflow.sum())}")
    np.savez(path, x=np.stack([k[0] for k in kept]),
             v=np.stack([k[1] for k in kept]))


def step_operands(sim, x, v):
    """One step's slot geometry, masses and operands, as the step builds
    them from its detection inputs."""
    import torch
    from diffcloth_tpu_torch.core import friction_cuda as fc
    from diffcloth_tpu_torch.core import selfcol_cuda as scd
    cfg, dev = sim.self_cfg, sim.device
    x = torch.as_tensor(x, device=dev)
    v = torch.as_tensor(v, device=dev)
    tables, _ = scd.detect_tables(cfg.allowed, sim.scene_dev.radii, x, v,
                                  sim.h, cfg.k_partners, cfg.max_layers)
    kg = fc.build_kernel_geom(tables, sim.scene_dev.area, sim.n,
                              cfg.budgets, x=x)
    density = torch.full((x.shape[0],), sim.cfg.fabric.density,
                         dtype=torch.float32, device=dev)
    masses = fc.slot_masses(kg, density)
    return kg, masses, fc.sweep_operands(kg, masses, cfg.budgets, sim.n)


def traffic(counts):
    """Summary of (steps, B, L) per-layer slot counts."""
    on = counts > 0
    narrow = on & (counts <= NARROW)
    runs = (narrow[..., 1:] & narrow[..., :-1]).any(-1)
    layers = on.sum(-1)
    busiest = [counts[t, int(np.argmax(layers[t]))].tolist()
               for t in range(0, len(counts), 10)]
    return dict(
        sample_steps=int(on.any(-1).sum()),
        with_narrow=int(narrow.any(-1).sum()),
        with_narrow_run=int(runs.sum()),
        narrow_layers=int(narrow.sum()),
        wide_layers=int((counts > NARROW).sum()),
        layers_max=int(layers.max()),
        layers_mean=float(layers[on.any(-1)].mean()),
        slots_mean=float(counts.sum(-1).mean()),
        busiest_every_10th_step=busiest)


def sweep_ms(steps, f, g, reps=5):
    """Device ms per call of each sweep over every step's operands, held to
    the plain versions exactly first."""
    import torch
    from diffcloth_tpu_torch.core import friction_cuda as fc
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    vals = []
    for kg, masses, ops in steps:
        out_k, vals_k = fc.friction_sweep(f, ops)
        out_p, vals_p = fc.friction_sweep_plain(f, kg, *masses, ops.budgets)
        bwd_k = fc.friction_sweep_bwd(g, vals_k, ops)
        bwd_p = fc.friction_sweep_bwd_plain(g, kg, *masses, vals_k,
                                            ops.budgets)
        if not (torch.equal(out_k, out_p) and torch.equal(vals_k, vals_p)
                and all(torch.equal(a, b) for a, b in zip(bwd_k, bwd_p))):
            raise AssertionError("a sweep kernel != plain")
        vals.append(vals_k)
    calls = {"fwd": lambda i: fc.friction_sweep(f, steps[i][2]),
             "bwd": lambda i: fc.friction_sweep_bwd(g, vals[i], steps[i][2])}
    keys = {"fwd": "friction_kernel", "bwd": "friction_bwd_kernel"}
    out = {}
    for k, call in calls.items():
        for i in range(len(steps)):
            call(i)
        torch.cuda.synchronize()
        for _ in range(5):   # a session may lose device events: retake it
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    for i in range(len(steps)):
                        call(i)
                torch.cuda.synchronize()
            hits = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and keys[k] in e.key]
            if sum(e.count for e in hits) == reps * len(steps):
                out[k] = (sum(e.self_device_time_total for e in hits) / 1e3
                          / (reps * len(steps)))
                break
        else:
            raise AssertionError(f"the profiler lost {k} sweep events")
    return out


def global_scene(n, rng):
    """chip_smoke.py 20a's global-state streamed scene at n: B = 2,
    budgets (n,) * 16, random matchings in four layers."""
    import torch
    from diffcloth_tpu_torch.core import friction_cuda as fc
    from diffcloth_tpu_torch.core.selfcol import SelfContactTables
    B, pairs, budgets = 2, (400, 300, 150, 70), (n,) * 16
    partner = np.full((B, 16, n), -1, np.int64)
    for b in range(B):
        for lay, count in enumerate(pairs):
            perm = rng.permutation(n)[:2 * count]
            partner[b, lay, perm[:count]] = perm[count:]
            partner[b, lay, perm[count:]] = perm[:count]
    dev = torch.device("cuda")
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                    device=dev)
    tables = SelfContactTables(
        partner=torch.as_tensor(partner, device=dev),
        n_layers=torch.full((B,), len(pairs), device=dev))
    kg = fc.build_kernel_geom(tables, f32(rng.rand(n) + 0.2), n, budgets,
                              x=f32(rng.randn(B, n, 3)))
    masses = fc.slot_masses(kg, torch.full((B,), 0.3, device=dev))
    return (kg, masses, fc.sweep_operands(kg, masses, budgets, n)), \
        f32(rng.randn(B, n, 3) * 0.1), f32(rng.randn(B, n, 3))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--states", default=os.path.join(
        HERE, "build", "stream_traffic.npz"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("bench_stream_traffic: no CUDA device available",
              file=sys.stderr)
        return 1
    cs = smoke()
    from diffcloth_tpu_torch.core import cuda_build
    cuda_build.build_all(["selfcol_detect", "friction_fwd", "friction_bwd",
                          "graph_program"])
    print(cs.nvidia_smi_line(), flush=True)
    n = 1024
    sim = cs.flagship(torch.float32, "cuda", cs.FLAGSHIP_STEPS,
                      cuda_graphs=False, **cs.drop_free(n))
    if not os.path.exists(args.states):
        os.makedirs(os.path.dirname(args.states), exist_ok=True)
        record(cs, sim, args.states)
    data = np.load(args.states)
    steps = [step_operands(sim, x, v) for x, v in zip(data["x"], data["v"])]
    if any(ops.slots != "stream" for _, _, ops in steps):
        raise AssertionError("a step's sweeps left the streamed route")
    counts = np.stack([kg.counts.cpu().numpy() for kg, _, _ in steps])
    rng = np.random.RandomState(20)
    f = torch.as_tensor(rng.randn(cs.BATCH, n, 3) * 0.05,
                        dtype=torch.float32, device="cuda")
    g = torch.as_tensor(rng.randn(cs.BATCH, n, 3), dtype=torch.float32,
                        device="cuda")
    res = {"tree": os.path.abspath(args.tree), "traffic": traffic(counts),
           "episode": sweep_ms(steps, f, g)}
    # chip_smoke.py 20a's input: its perturbed states at K = 32
    sim32 = cs.flagship(torch.float32, "cuda", 10, **cs.drop_free(n, 32))
    x, v = cs.kernel_states(sim32, cs.initial_states(sim32, cs.BATCH), rng)
    kg, masses, f20, g20 = cs.capacity_sweep_inputs(sim32, x, v, rng)
    from diffcloth_tpu_torch.core import friction_cuda as fc
    ops = fc.sweep_operands(kg, masses, sim32.self_cfg.budgets, n)
    res["20a"] = sweep_ms([(kg, masses, ops)], f20, g20, reps=20)
    res["20a_counts_sample_1"] = kg.counts[1].tolist()
    for ng in N_GLOBAL:
        step, fg, gg = global_scene(ng, np.random.RandomState(ng))
        res[f"n{ng}"] = dict(route=[step[2].route, step[2].slots],
                             **sweep_ms([step], fg, gg, reps=20))
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
