#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full check, as the acceptance run
    python3 chip_smoke.py --steps 20 # shorter episode while iterating

Phases (any failure raises and exits non-zero), each printing its wall time:
  1. device: the card's name and power limit (nvidia-smi); build every
     CUDA kernel of the port from `diffcloth_tpu_torch/csrc/` with nvcc, one
     process per source, all at once.
  2. kernels: each kernel's wrapper on card tensors at the main paths'
     shapes (flagship stand-in, n = 1024, B = 32; folded and random states,
     overflow rows among them, for detection also a two-layer lattice
     whose hits tie exactly, friction at full layer-0 budget, and the
     same slot geometry with every count zero, as most sweeps of an
     episode see it) against its plain PyTorch version on the same inputs,
     exactly (max error 0), timed beside the plain version and the least
     time the card could take: device time per call from torch.profiler
     (the JSON line's `ms` and `plain_ms`, at full budget) and wall time of
     back-to-back calls from CUDA events; and the launch floor, the device
     time of a one-element `zero_()`.  Detection prints beside its bound
     the floor of its unfused f32 instructions.
  3. forward path: `ClothSim(...).rollout` of a batch of 32 perturbed-wind
     episodes of the flagship stand-in (half of them starting folded half
     over half) for the full 250 steps on the card.  Launch counters are
     zeroed just before and read just after: detection runs once per step,
     friction once per PD sweep.
  4. profile: the first 10 steps of the same batch under torch.profiler.
  5. reference: a small folded episode on the card against the same
     episode through the plain versions on the CPU.
  6. gradient path: one batched value-and-grad through
     `OptimizeHelper.batched_loss_and_grad` (GradMask(f_wind=True)) of the
     same 32 episodes, 250 steps, MATCH_TRAJECTORY against the base wind's
     rollout.  Counters zeroed just before and read just after: the
     backward friction kernel launches once per adjoint trip, GMRES matvec
     and residual VJP; the forward one once per PD sweep of the forward
     (as in phase 3) and twice per step whose cotangent is nonzero (the K
     map and the residual).  Prints episode-gradient steps/s, the forward and
     backward shares, adjoint trips per step, fallback steps and active
     slots per backward launch.
  7. gradient profile: a 10-step value-and-grad of the batch under
     torch.profiler.
  8. trainer: `solve_demo("wind", seed=1, population=4, maxiter=1)` on the
     card, the loss per iteration; the final loss must be below the
     initial one.
  9. gradient reference: the f64 value-and-grad of a small folded episode
     batch on the card against the same call on the CPU.
 10. sphere (the obstacle path): `build_task("sphere")` on the card at full
     width (25 x 25, n = 625, 350 steps, h = 1/180, a sphere of radius 2,
     self-collision on), then
     a. forward: a batched rollout of 16 friction coefficients,
        mu = linspace(0.05, 0.9); counters zeroed just before and read just
        after (detection once per step, the forward sweep once per PD
        sweep); converged fraction 1.0 and obstacle contact in most
        episode-steps;
     a'. kernels: phase 2's checks at this path's shapes (n = 625, which
        the sweeps stage by 4-byte copies, B = 16), on the sphere scene's
        folded and flat states perturbed as in phase 2 (the folds fill
        layer 0 and sink into the sphere's contact band), the sweeps'
        input f plus the obstacle friction of those states' contacts;
     b. gradient: the batched value-and-grad of mu through
        `OptimizeHelper.batched_loss_and_grad` at the same candidates
        against the demo's ground truth (mu = 0.3); finite, the loss
        smallest at the candidate nearest 0.3, the backward sweep once per
        adjoint trip, GMRES matvec and residual VJP;
     c. profile: phases 4 and 7 on 20 steps of the batch, and the
        obstacle detection and obstacle friction's device launches per
        call;
     d. reference: the scene cut to 60 steps (the cloth on the sphere),
        B = 2, f64, card against CPU (episode within 1e-6; every dL/dmu
        above 1e-6 in size, and within 1e-6 of the largest entry);
     e. fit: `solve_demo("sphere", seed=1, population=4, maxiter=1)` must
        lower the best loss.

Prints one JSON line `{"kernels": [...]}` (each kernel's launches counted
on the path that runs it: the forward path for detection and the forward
sweep, the gradient path for the backward sweep), the nvidia-smi line,
and last `{"ok": true, "device": {...}}`.  Needs one card; imports nothing
of JAX.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s
# outside the tensor cores; a card below its 700 W limit may not reach them
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations of the detection kernel per (row, column) pair: 6
# differences, 6 squares, 4 adds, 1 min, 1 add, 1 square of the reach,
# 1 compare
DETECT_OPS_PER_PAIR = 20
# f32 instructions per second of an H100 SXM at its boost clock (128 lanes
# x 132 SMs x 1.98 GHz): the detection kernel is built without multiply-add
# contraction, so each of its operations is one instruction; its floor is
# DETECT_OPS_PER_PAIR per admissible pair at this rate
F32_INSTR_PER_S = 128 * 132 * 1.98e9
# f32 operations of the friction sweep per active slot: d (6), the case
# split (sd 5, fN 3, fT 3, |fT|^2 5, sqrt 1, compares 3, t_hat 3, the
# slide force 7), k_red scaling 3, the row add 3
FRICTION_OPS_PER_SLOT = 45
# f32 operations of the backward sweep per active slot: d (9), the case
# split (sd 5, fN 3, fT 3, |fT|^2 5, sqrt 1, slide 2, compares 3), t_hat 3,
# the Jacobian^T product (n.w 5, t.w 5, sign 2, its factor 3, w - (n.w)n -
# (t.w)t 12, the slide scale 7, selects 6), the friction force for the
# k_red cotangent (9), u = k_red jt (3), the row and partner adds and their
# scales (12), the three slot cotangents (16)
FRICTION_BWD_OPS_PER_SLOT = 114
# episodes of the main path's batch (perturbed winds, half starting folded)
BATCH = 32
# the flagship's base wind; the batch's winds are perturbations of it
BASE_WIND = [0.04, 0.004, 0.04]
# episodes of the sphere path's batch: friction coefficients
# linspace(0.05, 0.9)
SPHERE_BATCH = 16
# the forward path's hand-written kernels: (name, symbol substring)
FORWARD_KERNELS = (("selfcol_detect", "detect_kernel"),
                   ("friction_fwd", "friction_kernel"))


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_cuda(fn, reps=20, warmup=3):
    """Mean milliseconds of fn() over `reps` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=20, warmup=3, kernel=None):
    """Mean device milliseconds of fn() over `reps` calls: the summed
    device time of every kernel it launches (torch.profiler), whatever the
    host spends between them.  kernel: the symbol substring of the one
    kernel fn() launches, if it is a wrapper."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a profiler session now and then records only some of the device
    # events, or none: a session with fewer events than calls (for a
    # wrapper, other than one launch of its kernel per call) is taken
    # again, up to five times
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in events)
        if kernel is None:
            whole = sum(e.count for e in events) >= reps
        else:
            whole = sum(e.count for e in events if kernel in e.key) == reps
        if us > 0 and whole:
            return us / 1e3 / reps
    raise AssertionError("the profiler lost device events in five tries")


def profiled_ops(prof):
    """(key, device ms, calls) of the device-side events of a profile
    (kernels, copies): the operators that launch them carry the same time
    again."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]


def log_breakdown(tag, ops, kernels, top=8):
    """The `top` operators by device time, then each hand-written kernel's
    calls and device time per call; kernels: (name, symbol substring)."""
    busy_ms = sum(ms for _, ms, _ in ops)
    for key, ms, count in sorted(ops, key=lambda o: -o[1])[:top]:
        log(f"[{tag}]   {100 * ms / busy_ms:5.1f} % of device time  "
            f"{ms:8.2f} ms  {count:6d} calls  {key[:90]}")
    for name, kernel in kernels:
        hits = [(ms, count) for key, ms, count in ops if kernel in key]
        if not hits:
            raise AssertionError(f"the profiler saw no {kernel}")
        ms, count = map(sum, zip(*hits))
        log(f"[{tag}] {name}: {count} calls, {1e3 * ms / count:.2f} us "
            f"device time per call")


class Timer:
    """`with timer(name):` prints the wall seconds of the phase inside."""

    def __init__(self):
        self.total = 0.0

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.total += dt
        log(f"[time] {name}: {dt:.1f} s")


def flagship(dtype, device, steps=None):
    from diffcloth_tpu_torch.core.sim import ClothSim
    from diffcloth_tpu_torch.geometry import builder as gb
    from diffcloth_tpu_torch.tasks.registry import TSHIRT_GRID_STANDIN
    import dataclasses
    cfg = TSHIRT_GRID_STANDIN
    if steps is not None:
        cfg = dataclasses.replace(cfg, step_num=steps)
    scene = gb.build_scene(cfg)
    return ClothSim(scene, device=device, dtype=dtype)


def initial_states(sim, B):
    """(B, n, 3) f64 numpy: even episodes start folded half over half (the
    last half of the grid's rows folded back, 1.5 r behind the cloth: on
    the flagship the bottom 16 rows, downwind of its +z wind, so the wind
    holds the flap against the cloth while gravity opens it; on the sphere
    scene below the cloth, the fold's middle within the sphere's contact
    band), odd ones flat.  On the flagship the fold asks for more friction
    slots than the budgets hold, so its first steps run every sweep at
    full budget and flag overflow."""
    from diffcloth_tpu_torch.geometry import states
    scene = sim.scene_host
    rows = scene.cfg.fabric.grid_num_y // 2
    folded = states.folded_grid(scene, rows,
                                -1.5 * float(scene.radii.mean()))
    x0 = np.stack([folded if b % 2 == 0 else scene.x_rest
                   for b in range(B)])
    return x0


def kernel_states(sim, x0, rng):
    """The kernel checks' (B, n, 3) numpy positions and velocities: x0 with
    noise, and in sample 1 overflow rows, up to 20 far-apart vertices
    stacked on one point (every 50th from 25: 20 with 19 partners each at
    n = 1024, 12 with 11 at n = 625; K = 8), 10 of them in the first
    512-column segment."""
    B, n = x0.shape[0], sim.n
    x = x0 + rng.randn(B, n, 3) * 0.01
    pile = np.arange(25, n, 50)[:20]
    x[1, pile] = x[1, pile[0]]
    return x, rng.randn(B, n, 3) * 0.5


def lattice_geom(B, n, n_pad, h, dev):
    """Detection input with exact ties: two layers of a 32-wide square
    lattice (spacing and layer gap 0.25, radii 0.3, at rest), sample b
    shifted by 0.5 b in x.  Every d^2 is exact in f32, so a row's hits tie
    in groups at columns that fall to different lanes of the kernel, and
    each row has 13 hits in the other layer alone (> K = 8)."""
    import torch
    from diffcloth_tpu_torch.core import selfcol_cuda as scd
    half = (n + 1) // 2
    i = np.arange(n)
    j = i % half
    x = np.stack([(j % 32) * 0.25, (j // 32) * 0.25, (i // half) * 0.25], -1)
    x = x[None] + np.array([0.5, 0.0, 0.0]) * np.arange(B)[:, None, None]
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                    device=dev)
    return scd.build_geom(f32(x), f32(np.zeros_like(x)),
                          f32(np.full(n, 0.3)), h, n_pad)


def phase_kernels(tag, sim, x0, rng, mu=None):
    """Each kernel against its plain version at a path's shapes: B = the
    batch of x0 ((B, n, 3) numpy, the states `kernel_states` perturbs), n
    and the budgets of `sim`.  On a path with obstacles (mu: the batch's
    (B, P) friction coefficients) the sweeps run on f plus the obstacle
    friction of the states' contacts, their r_init on that path."""
    import dataclasses
    import torch
    from diffcloth_tpu_torch.core import contact as ct
    from diffcloth_tpu_torch.core import friction_cuda as fc
    from diffcloth_tpu_torch.core import selfcol_cuda as scd
    from diffcloth_tpu_torch.core.selfcol import layer_tables_from_partners

    dev = sim.device
    cfg = sim.self_cfg
    n, h = sim.n, sim.h
    B = x0.shape[0]
    x, v = kernel_states(sim, x0, rng)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    vt = torch.as_tensor(v, dtype=torch.float32, device=dev)
    radii = sim.scene_dev.radii
    geom = scd.build_geom(xt, vt, radii, h, cfg.allowed.shape[0])
    K = cfg.k_partners
    n_pad = geom.shape[-1]

    tab_k = scd.detect_partners(geom, cfg.allowed, K)
    tab_p = scd.detect_partners_plain(geom, cfg.allowed, K)
    torch.cuda.synchronize()
    det_err = float((tab_k - tab_p).abs().max())
    if not torch.equal(tab_k, tab_p):
        bad = (tab_k != tab_p).any(-1).nonzero()[:5].tolist()
        raise AssertionError(f"detection kernel != plain at rows {bad}")
    counts = tab_k[:, :n, K]
    n_overflow = int((counts > K).sum())
    n_hits = int((tab_k[:, :n, :K] >= 0).sum())
    if n_overflow == 0 or n_hits == 0:
        raise AssertionError("detection inputs lack hits or overflow rows")
    log(f"[{tag}] detection: kernel == plain exactly on (B={B}, "
        f"n_pad={n_pad}, K={K}); {n_hits} partner slots, {n_overflow} "
        f"overflow rows")
    lat = lattice_geom(B, n, n_pad, h, dev)
    lat_k = scd.detect_partners(lat, cfg.allowed, K)
    lat_p = scd.detect_partners_plain(lat, cfg.allowed, K)
    torch.cuda.synchronize()
    if not torch.equal(lat_k, lat_p):
        bad = (lat_k != lat_p).any(-1).nonzero()[:5].tolist()
        raise AssertionError(f"detection kernel != plain on the lattice at "
                             f"rows {bad}")
    lat_over = int((lat_k[:, :n, K] > K).sum())
    if lat_over == 0:
        raise AssertionError("the lattice input has no overflow row")
    det_err = max(det_err, float((lat_k - lat_p).abs().max()))
    log(f"[{tag}] detection: kernel == plain exactly on a two-layer "
        f"lattice with exact ties (B={B}, n_pad={n_pad}, K={K}); "
        f"{int((lat_k[:, :n, :K] >= 0).sum())} partner slots, {lat_over} "
        f"overflow rows")
    det = lambda: scd.detect_partners(geom, cfg.allowed, K)  # noqa: E731
    det_plain = lambda: scd.detect_partners_plain(  # noqa: E731
        geom, cfg.allowed, K)
    det_ev = (time_cuda(det), time_cuda(det_plain, reps=5))
    det_ms = device_ms(det, kernel="detect_kernel")
    det_plain_ms = device_ms(det_plain, reps=5)
    det_bytes = geom.numel() * 4 + cfg.allowed.numel() + tab_k.numel() * 4
    # the kernel computes a distance only where the pair is admissible
    det_ops = B * int((cfg.allowed > 0).sum()) * DETECT_OPS_PER_PAIR
    det_bound = max(det_bytes / HBM_BYTES_PER_S, det_ops / F32_FLOPS) * 1e3
    det_by = ("bytes" if det_bytes / HBM_BYTES_PER_S > det_ops / F32_FLOPS
              else "operations")
    det_floor = det_ops / F32_INSTR_PER_S * 1e3

    tables = layer_tables_from_partners(tab_k[:, :n, :K], cfg.max_layers)
    kg = fc.build_kernel_geom(tables, sim.scene_dev.area, n, cfg.budgets,
                              x=xt)
    density = torch.full((B,), sim.cfg.fabric.density, dtype=torch.float32,
                         device=dev)
    masses = fc.slot_masses(kg, density)
    f = torch.as_tensor(rng.randn(B, n, 3) * 0.05, dtype=torch.float32,
                        device=dev)
    g = torch.as_tensor(rng.randn(B, n, 3), dtype=torch.float32, device=dev)
    if sim.n_prims:
        contact = ct.detect_obstacle_contacts(sim.prims, xt, vt, h)
        r = ct.obstacle_friction(
            f, contact, density[:, None] * sim.scene_dev.area,
            torch.as_tensor(mu, dtype=torch.float32, device=dev))
        in_contact = int(contact.mask.sum())
        if in_contact == 0 or float(r.abs().max()) == 0.0:
            raise AssertionError("the kernel inputs have no obstacle contact")
        f = f + r
        log(f"[{tag}] the sweeps' input is f + r_init, the obstacle friction "
            f"of {in_contact} particles in contact (of {B} x {n})")
    active = int(kg.counts.sum())
    TC = kg.idx_row.shape[1]
    # the same slot geometry with every count zero: no active slot
    kg0 = dataclasses.replace(kg, counts=torch.zeros_like(kg.counts))
    sweeps = {}
    for label, geom_l in (("with contact", kg), ("zero contact", kg0)):
        ops = fc.sweep_operands(geom_l, masses, cfg.budgets, n)
        out_k, vals_k = fc.friction_sweep(f, ops)
        out_p, vals_p = fc.friction_sweep_plain(f, geom_l, *masses,
                                                cfg.budgets)
        # the backward sweep at the forward's selects, on a random cotangent
        bwd_k = fc.friction_sweep_bwd(g, vals_k, ops)
        bwd_p = fc.friction_sweep_bwd_plain(g, geom_l, *masses, vals_k,
                                            cfg.budgets)
        torch.cuda.synchronize()
        fwd_err = max(float((a - b).abs().max())
                      for a, b in ((out_k, out_p), (vals_k, vals_p)))
        bwd_err = max(float((a - b).abs().max()) for a, b in zip(bwd_k, bwd_p))
        if not (torch.equal(out_k, out_p) and torch.equal(vals_k, vals_p)):
            raise AssertionError(f"friction kernel != plain ({label}): max "
                                 f"error {fwd_err}")
        if not all(torch.equal(a, b) for a, b in zip(bwd_k, bwd_p)):
            raise AssertionError(f"friction_bwd kernel != plain ({label}): "
                                 f"max error {bwd_err}")
        moved = (float((out_p - f).abs().max()),
                 float((bwd_p[0] - g).abs().max()))
        if geom_l is kg and (active == 0 or min(moved) == 0.0):
            raise AssertionError("friction inputs have no active contact")
        if geom_l is kg0 and max(moved) != 0.0:
            raise AssertionError("friction moved a state without contact")
        log(f"[{tag}] friction ({label}): kernel == plain exactly, forward "
            f"(fr', vals) and backward (g' and the three slot cotangents); "
            f"{int(geom_l.counts.sum())} active slots, overflow "
            f"{int(kg.overflow.sum())}")
        fr = lambda: fc.friction_sweep(f, ops)  # noqa: E731
        fr_plain = lambda: fc.friction_sweep_plain(  # noqa: E731
            f, geom_l, *masses, cfg.budgets)
        fb = lambda: fc.friction_sweep_bwd(g, vals_k, ops)  # noqa: E731
        fb_plain = lambda: fc.friction_sweep_bwd_plain(  # noqa: E731
            g, geom_l, *masses, vals_k, cfg.budgets)
        sweeps[label] = dict(
            fwd=(fwd_err, device_ms(fr, kernel="friction_kernel"),
                 device_ms(fr_plain), time_cuda(fr), time_cuda(fr_plain)),
            bwd=(bwd_err, device_ms(fb, kernel="friction_bwd_kernel"),
                 device_ms(fb_plain), time_cuda(fb), time_cuda(fb_plain)))
    # the launch floor: the device time of the least kernel there is
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(lambda: one.zero_(), reps=50)
    fr_err, fr_ms, fr_plain_ms = sweeps["with contact"]["fwd"][:3]
    fb_err, fb_ms, fb_plain_ms = sweeps["with contact"]["bwd"][:3]
    # fr in and out, vals written for every slot, counts, the active slots'
    # data (indices 2, normal 3, masses 3)
    fr_bytes = (2 * f.numel() * 4 + B * 6 * TC * 4 + kg.counts.numel() * 4
                + active * 4 * (2 + 3 + 3))
    fr_ops = active * FRICTION_OPS_PER_SLOT
    fr_bound = max(fr_bytes / HBM_BYTES_PER_S, fr_ops / F32_FLOPS) * 1e3
    fr_by = ("bytes" if fr_bytes / HBM_BYTES_PER_S > fr_ops / F32_FLOPS
             else "operations")
    # g in and out, the active slots' data (indices 2, normal 3, masses 3)
    # and selects (6), the three slot cotangents written for every slot
    fb_bytes = (2 * g.numel() * 4 + active * 4 * (2 + 3 + 3 + 6)
                + 3 * B * TC * 4 + kg.counts.numel() * 4)
    fb_ops = active * FRICTION_BWD_OPS_PER_SLOT
    fb_bound = max(fb_bytes / HBM_BYTES_PER_S, fb_ops / F32_FLOPS) * 1e3
    fb_by = ("bytes" if fb_bytes / HBM_BYTES_PER_S > fb_ops / F32_FLOPS
             else "operations")
    # without contact: the state in and out, zero slot rows, counts
    bound0 = {"fwd": (2 * f.numel() + B * 6 * TC + kg.counts.numel()) * 4,
              "bwd": (2 * g.numel() + 3 * B * TC + kg.counts.numel()) * 4}
    for name, ms, bound in (("detection", det_ms, det_bound),
                            ("friction", fr_ms, fr_bound),
                            ("friction_bwd", fb_ms, fb_bound)):
        if ms < bound:
            raise AssertionError(f"{name}: {ms} ms of device time per call, "
                                 f"below its bound {bound} ms")
    log(f"[{tag}] launch floor: device ms per call of a one-element "
        f"zero_() {floor_ms:.4f} (profiler); byte bounds of the sweeps: "
        f"forward {fr_bound:.5f}, backward {fb_bound:.5f}, without contact "
        f"{bound0['fwd'] / HBM_BYTES_PER_S * 1e3:.5f} and "
        f"{bound0['bwd'] / HBM_BYTES_PER_S * 1e3:.5f}")
    log(f"[{tag}] detection: device ms per call kernel {det_ms:.4f}, "
        f"plain {det_plain_ms:.4f} (profiler); back-to-back wall ms per call "
        f"kernel {det_ev[0]:.4f}, plain {det_ev[1]:.4f} (CUDA events); "
        f"bound {det_bound:.5f} ({det_by}), floor of unfused f32 "
        f"instructions {det_floor:.5f}")
    for label, times in sweeps.items():
        for name, key in (("friction", "fwd"), ("friction_bwd", "bwd")):
            _, ms, plain_ms, ev, plain_ev = times[key]
            log(f"[{tag}] {name} ({label}): device ms per call kernel "
                f"{ms:.4f}, plain {plain_ms:.4f} (profiler); back-to-back "
                f"wall ms per call kernel {ev:.4f}, plain {plain_ev:.4f} "
                f"(CUDA events)")
    return [
        dict(name="selfcol_detect", route="cuda",
             source="diffcloth_tpu_torch/csrc/selfcol_detect.cu",
             replaces="diffcloth_tpu/core/selfcol_pallas.py:53",
             launches=0, max_abs_err=det_err, ms=det_ms,
             plain_ms=det_plain_ms,
             bound_ms=det_bound, bound_by=det_by, library_ms=None),
        dict(name="friction_fwd", route="cuda",
             source="diffcloth_tpu_torch/csrc/friction_fwd.cu",
             replaces="diffcloth_tpu/core/friction_pallas.py:255",
             launches=0, max_abs_err=fr_err, ms=fr_ms,
             plain_ms=fr_plain_ms, bound_ms=fr_bound, bound_by=fr_by,
             library_ms=None),
        dict(name="friction_bwd", route="cuda",
             source="diffcloth_tpu_torch/csrc/friction_bwd.cu",
             replaces="diffcloth_tpu/core/friction_pallas.py:309",
             launches=0, max_abs_err=fb_err, ms=fb_ms,
             plain_ms=fb_plain_ms, bound_ms=fb_bound, bound_by=fb_by,
             library_ms=None),
    ]


def episode_params(sim, B):
    """B perturbed winds around the flagship's (numpy seed 0), half the
    episodes starting folded."""
    import torch
    base = sim.default_params().replace(
        wind=torch.tensor(BASE_WIND, device=sim.device),
        wind_freq=torch.tensor(10.0, device=sim.device),
        wind_phase=torch.tensor(0.5, device=sim.device))
    winds = (np.random.RandomState(0).randn(B, 3) * 0.02
             + np.array(BASE_WIND))
    return base.expand(B).replace(
        wind=torch.as_tensor(winds, dtype=sim.dtype, device=sim.device),
        x0=torch.as_tensor(initial_states(sim, B), dtype=sim.dtype,
                           device=sim.device))


def phase_main_path(sim, B, card):
    """The port's main path: a batched forward episode on the card."""
    import torch
    from diffcloth_tpu_torch.core import friction_cuda as fc
    from diffcloth_tpu_torch.core import selfcol_cuda as scd

    params = episode_params(sim, B)
    torch.cuda.synchronize()
    scd.detect_partners.launches = 0
    fc.friction_sweep.launches = 0
    t0 = time.perf_counter()
    recs = sim.rollout(params)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"selfcol_detect": scd.detect_partners.launches,
                "friction_fwd": fc.friction_sweep.launches}
    st = recs.steps
    N = sim.n_steps
    if tuple(st.x.shape) != (B, N, sim.n, 3):
        raise AssertionError(f"trajectory shape {tuple(st.x.shape)}")
    if not (bool(torch.isfinite(st.x).all())
            and bool(torch.isfinite(st.v).all())):
        raise AssertionError("non-finite trajectory")
    if launches["selfcol_detect"] != N:
        raise AssertionError(f"detection launched {launches} times, "
                             f"expected once per step ({N})")
    iters = st.iters.cpu().numpy()
    sweeps = pd_sweeps(iters, sim)
    if launches["friction_fwd"] != int(sweeps.sum()):
        raise AssertionError(f"friction launched {launches} times, not "
                             f"once per PD sweep ({int(sweeps.sum())})")
    pairs = st.selfcol_pairs.cpu().numpy()
    if pairs.sum() == 0:
        raise AssertionError("no step saw a self-contact")
    # every launch works on the whole batch's active slots of its step
    slots = st.selfcol_slots.cpu().numpy().sum(axis=0)
    slots_per_launch = float((slots * sweeps).sum() / sweeps.sum())
    conv = float(st.converged.float().mean())
    rate = B * N / elapsed
    folded = pairs[0::2]
    log(f"[main] {N} steps x B={B} on {card}: {elapsed:.2f} s, "
        f"{rate:.1f} PD steps/s, converged {conv:.4f}, mean iters "
        f"{iters.mean():.2f}, contact pairs/step {pairs.mean():.2f}, "
        f"folded episodes: {folded.mean():.2f} pairs/step, contact in "
        f"{int((folded > 0).sum())} of {folded.size} steps "
        f"({100 * (folded > 0).mean():.1f} %), overflow in "
        f"{int(st.selfcol_overflow[0::2].sum())}; flat episodes: contact "
        f"in {int((pairs[1::2] > 0).sum())} steps; launches {launches}, "
        f"{slots_per_launch:.1f} active friction slots per launch (of "
        f"{B * sum(sim.self_cfg.budgets)}), "
        f"{elapsed * 1e3 / launches['friction_fwd']:.3f} ms wall per PD "
        f"sweep")
    return launches


def phase_profile(tag, sim, params, card, top=8):
    """Where the time of a forward path goes: the rollout of `params` (the
    path's batch, its first few steps) under torch.profiler, after the
    path's own run, so nothing is cold.  Prints the device-busy share of
    the window, device time and launches per PD sweep (the forward sweep's
    launches) and the operators with the most device time; returns the
    records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        recs = sim.rollout(params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sweeps = int(pd_sweeps(recs.steps.iters.cpu().numpy(), sim).sum())
    ops = profiled_ops(prof)
    busy_ms = sum(ms for _, ms, _ in ops)
    n_kernels = sum(count for _, _, count in ops)
    if busy_ms == 0:
        raise AssertionError("the profiler saw no device time")
    log(f"[{tag}] {sim.n_steps} steps x B={params.batch_size} on {card}: "
        f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %), {sweeps} PD sweeps: "
        f"{wall_ms / sweeps:.3f} ms wall and {busy_ms / sweeps:.3f} ms "
        f"device per sweep (wall inflated by the profiler), "
        f"{n_kernels / sweeps:.1f} device launches per sweep")
    # the hand-written kernels' own device time per call, beside the CUDA
    # event time of back-to-back wrapper calls in phase 2
    log_breakdown(tag, ops, FORWARD_KERNELS, top)
    return recs


def phase_reference(steps):
    """A small folded episode on the card against the plain versions on
    the CPU (the CPU path is held to the JAX package by the tests)."""
    import dataclasses
    import torch
    from diffcloth_tpu_torch.core.sim import ClothSim
    from diffcloth_tpu_torch.geometry import builder as gb
    from diffcloth_tpu_torch.geometry import states
    from diffcloth_tpu_torch.tasks.registry import TSHIRT_GRID_STANDIN

    cfg = TSHIRT_GRID_STANDIN
    cfg = dataclasses.replace(cfg, step_num=steps, fabric=dataclasses.replace(
        cfg.fabric, grid_num_x=10, grid_num_y=10))
    scene = gb.build_scene(cfg)
    x0 = states.folded_grid(scene, 5, 1.5 * float(scene.radii.mean()))
    out = {}
    for dev in ("cuda", "cpu"):
        sim = ClothSim(scene, device=dev, dtype=torch.float64)
        p = sim.default_params().expand(2)
        p = p.replace(x0=torch.as_tensor(np.stack([x0, scene.x_rest]),
                                         dtype=torch.float64, device=dev),
                      wind=torch.tensor([[0.5, 0.05, 0.5], [0.2, 0.0, 0.4]],
                                        dtype=torch.float64, device=dev))
        out[dev] = sim.rollout(p).steps
    g, c = out["cuda"], out["cpu"]
    err = float((g.x.cpu() - c.x).abs().max())
    d_it = int((g.iters.cpu() - c.iters).abs().max())
    if int(c.selfcol_pairs.sum()) == 0:
        raise AssertionError("reference episode has no self-contact")
    if err > 1e-6 or d_it > 1 or not torch.equal(g.converged.cpu(),
                                                 c.converged):
        raise AssertionError(f"card vs CPU: max |dx| {err}, iters "
                             f"differ by {d_it}")
    log(f"[reference] 10x10 folded grid, {steps} steps, f64, B=2: card vs "
        f"CPU max |dx| {err:.3e} (tolerance 1e-6), iters within {d_it}")


def base_wind_target(sim, params):
    """MATCH_TRAJECTORY against the rollout of the same episodes with the
    base wind (forward only, before the gradient's run)."""
    import torch
    from diffcloth_tpu_torch import losses
    from diffcloth_tpu_torch.config import LossType
    base = params.replace(wind=torch.tensor(
        BASE_WIND, dtype=sim.dtype, device=sim.device).expand_as(
            params.wind).contiguous())
    target = sim.rollout_chunked(base).full_x()
    return losses.make_loss_fn(LossType.MATCH_TRAJECTORY,
                               losses.LossInfo(target_x=target))


def phase_gradient(sim, B, card, fwd_sweeps):
    """The port's training path: one batched episode value-and-grad through
    the optimizer's objective, on the card.  `fwd_sweeps`: the forward
    sweep's launches in phase 3's rollout of the same episodes."""
    import torch
    from diffcloth_tpu_torch.core import friction_cuda as fc
    from diffcloth_tpu_torch.core import selfcol_cuda as scd
    from diffcloth_tpu_torch.optim.helper import GradMask, OptimizeHelper

    params = episode_params(sim, B)
    t0 = time.perf_counter()
    loss_fn = base_wind_target(sim, params)
    torch.cuda.synchronize()
    log(f"[gradient] target: the base wind's {sim.n_steps}-step rollout of "
        f"the batch, {time.perf_counter() - t0:.2f} s")
    helper = OptimizeHelper(sim, GradMask(f_wind=True), loss_fn,
                            param_base=params)
    X = np.stack([helper.params_to_vec(params.sample(i)) for i in range(B)])
    torch.cuda.synchronize()
    scd.detect_partners.launches = 0
    fc.friction_sweep.launches = 0
    fc.friction_sweep_bwd.launches = 0
    sim.bwd_stats.reset()
    t0 = time.perf_counter()
    L, G = helper.batched_loss_and_grad(X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"selfcol_detect": scd.detect_partners.launches,
                "friction_fwd": fc.friction_sweep.launches,
                "friction_bwd": fc.friction_sweep_bwd.launches}
    st = sim.bwd_stats.summary()
    N = sim.n_steps
    if L.shape != (B,) or G.shape != (B, X.shape[1]):
        raise AssertionError(f"loss {L.shape}, gradient {G.shape}")
    if not (np.isfinite(L).all() and np.isfinite(G).all()):
        raise AssertionError("non-finite loss or gradient")
    if not ((L > 0).all() and (np.abs(G).max(axis=1) > 0).all()):
        raise AssertionError("a zero loss or gradient")
    if launches["selfcol_detect"] != N:
        raise AssertionError(f"detection launched {launches} times, "
                             f"expected once per step ({N})")
    # the forward runs phase 3's sweeps; each step with a nonzero
    # cotangent adds one forward sweep for the K map, one for the residual
    if launches["friction_fwd"] != fwd_sweeps + 2 * st["residual_vjps"]:
        raise AssertionError(
            f"friction_fwd launched {launches['friction_fwd']} times, not "
            f"the forward's {fwd_sweeps} plus two per residual VJP "
            f"({st['residual_vjps']:.0f})")
    if launches["friction_bwd"] != st["launches"]:
        raise AssertionError(
            f"friction_bwd launched {launches['friction_bwd']} times, not "
            f"once per adjoint trip ({st['trips']:.0f}), GMRES matvec "
            f"({st['gmres_matvecs']:.0f}) and residual VJP "
            f"({st['residual_vjps']:.0f})")
    split = helper.last_split
    log(f"[gradient] {N} steps x B={B} on {card}: {wall:.2f} s, "
        f"{B * N / wall:.1f} episode-gradient steps/s; forward "
        f"{split['forward_s']:.2f} s ({100 * split['forward_s'] / wall:.1f} "
        f"%), backward {split['backward_s']:.2f} s "
        f"({100 * split['backward_s'] / wall:.1f} %)")
    log(f"[gradient] loss mean {L.mean():.6e} (min {L.min():.3e}, max "
        f"{L.max():.3e}); |dL/dwind| max {np.abs(G[:, :3]).max():.3e}; "
        f"launches {launches}; adjoint: {st['trips']:.0f} fixed-point "
        f"trips over the batch, {st['lane_trips'] / st['lane_steps']:.2f} "
        f"mean trips per episode-step, {st['fallback_lanes']:.0f} of "
        f"{st['lane_steps']:.0f} episode-steps fell to GMRES "
        f"({st['gmres_matvecs']:.0f} matvecs), {st['residual_vjps']:.0f} "
        f"residual VJPs; {st['slot_launches'] / st['launches']:.1f} active "
        f"friction slots per backward launch (of "
        f"{B * sum(sim.self_cfg.budgets)}); "
        f"{split['backward_s'] * 1e3 / st['launches']:.3f} ms backward wall "
        f"per friction_bwd launch")
    return launches


def phase_profile_gradient(tag, sim, params, loss_fn, card, top=8):
    """Where the time of a gradient path goes: the batched value-and-grad
    of `params` (a few steps) under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    vg = sim.episode_value_and_grad(loss_fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vg(params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = profiled_ops(prof)
    busy_ms = sum(ms for _, ms, _ in ops)
    if busy_ms == 0:
        raise AssertionError("the profiler saw no device time")
    log(f"[{tag}] {sim.n_steps} steps x B={params.batch_size} on {card}: "
        f"wall {wall_ms:.1f} ms (forward {vg.split['forward_s'] * 1e3:.1f}, "
        f"backward {vg.split['backward_s'] * 1e3:.1f}; inflated by the "
        f"profiler), device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %), "
        f"{sum(c for _, _, c in ops)} device launches")
    log_breakdown(tag, ops,
                  (("friction_bwd", "friction_bwd_kernel"),), top)


def phase_trainer(card):
    """The trainer through its normal entry point: one iteration of a
    population L-BFGS-B fit of the wind demo on the card, seeded (all four
    candidates random restarts).  Every line-search try is a batched
    evaluation of about a minute here (the f32 adjoint's fixed point and
    GMRES fallback run to their caps in many steps); from the default
    guess, or in a second iteration, the line search backtracks about ten
    times, which overran the script's time limit."""
    from diffcloth_tpu_torch.optim.solver import solve_demo

    P = 4

    def report(k, X, F):
        log(f"[trainer] iteration {k}: losses "
            f"{np.array2string(F, precision=6)}")

    res = solve_demo("wind", seed=1, population=P, maxiter=1,
                     callback=report)
    initial = np.array([loss for loss, _ in res.helper.history[:P]])
    final = res.result.loss
    st = res.task.sim.bwd_stats.summary()
    log(f"[trainer] wind demo (n = {res.task.sim.n}, "
        f"{res.task.sim.n_steps} steps) on {card}: {P} candidates, best "
        f"loss {initial.min():.6e} -> {final:.6e} in "
        f"{res.wallclock_s:.1f} s ({res.result.n_evals} batched "
        f"evaluations); initial losses "
        f"{np.array2string(initial, precision=6)}; adjoint over all "
        f"evaluations: {st['lane_trips'] / st['lane_steps']:.2f} trips per "
        f"episode-step, {st['fallback_lanes']:.0f} of {st['lane_steps']:.0f} "
        f"episode-steps fell to GMRES, {st['launches']:.0f} friction_bwd "
        f"launches")
    if not (np.isfinite(final) and final < initial.min()):
        raise AssertionError(f"the fit did not lower the loss: "
                             f"{initial.min()} -> {final}")


def phase_gradient_reference(steps):
    """The f64 value-and-grad of a small folded batch on the card against
    the same call on the CPU (the CPU path is held to the JAX package by
    the tests).  Tolerance: 1e-6 of each parameter class's largest entry;
    the adjoint runs to 1e-8, and the two devices differ only in summation
    order (the kernels equal their plain versions)."""
    import dataclasses
    import torch
    from diffcloth_tpu_torch import losses
    from diffcloth_tpu_torch.config import LossType
    from diffcloth_tpu_torch.core.sim import ClothSim
    from diffcloth_tpu_torch.geometry import builder as gb
    from diffcloth_tpu_torch.geometry import states
    from diffcloth_tpu_torch.tasks.registry import TSHIRT_GRID_STANDIN

    cfg = TSHIRT_GRID_STANDIN
    cfg = dataclasses.replace(
        cfg, step_num=steps, backward_convergence_thresh=1e-8,
        fabric=dataclasses.replace(cfg.fabric, grid_num_x=10,
                                   grid_num_y=10))
    scene = gb.build_scene(cfg)
    x0 = np.stack([states.folded_grid(scene, 5,
                                      1.5 * float(scene.radii.mean())),
                   scene.x_rest])
    winds = np.array([[0.5, 0.05, 0.5], [0.2, 0.0, 0.4]])
    target = None
    out = {}
    for dev in ("cpu", "cuda"):
        sim = ClothSim(scene, device=dev, dtype=torch.float64)
        t64 = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa
                                        device=sim.device)
        p = sim.default_params().expand(2).replace(x0=t64(x0))
        if target is None:
            target = sim.rollout(p.replace(wind=t64(winds))).full_x()
        loss_fn = losses.make_loss_fn(
            LossType.MATCH_TRAJECTORY,
            losses.LossInfo(target_x=target.to(sim.device)))
        L, g = sim.episode_value_and_grad(loss_fn)(
            p.replace(wind=t64(winds * 0.7)))
        out[dev] = (L.cpu(), {k: v.cpu() for k, v in g.items()})
    (Lc, gc), (Lg, gg) = out["cpu"], out["cuda"]
    rel = {}
    for k, a in gc.items():
        scale = float(a.abs().max())
        rel[k] = float((gg[k] - a).abs().max()) / max(scale, 1e-300)
        if rel[k] > 1e-6:
            raise AssertionError(f"card vs CPU gradient {k}: {rel[k]:.3e} "
                                 f"of its largest entry")
    if not torch.allclose(Lg, Lc, rtol=1e-9, atol=0):
        raise AssertionError(f"card vs CPU loss {Lg} vs {Lc}")
    log(f"[grad-reference] 10x10 folded grid, {steps} steps, f64, B=2: card "
        f"vs CPU loss {Lg.tolist()} vs {Lc.tolist()}; gradient max error "
        f"per class / its largest entry (tolerance 1e-6): "
        + ", ".join(f"{k} {v:.1e}" for k, v in rel.items()))


@contextlib.contextmanager
def demo_steps(name, steps):
    """Inside the block, the registry's demo `name` runs `steps` steps
    (None: as registered)."""
    import dataclasses
    from diffcloth_tpu_torch.tasks import registry
    task = registry.DEMOS[name]
    if steps is not None:
        registry.DEMOS[name] = dataclasses.replace(
            task, scene=dataclasses.replace(task.scene, step_num=steps))
    try:
        yield
    finally:
        registry.DEMOS[name] = task


def sphere_candidates(B):
    return np.linspace(0.05, 0.9, B)[:, None]


def pd_sweeps(iters, sim):
    """Launches of the forward sweep per step: the PD loop of a step sweeps
    until its slowest episode is done, rounded up to the host's check
    interval."""
    from diffcloth_tpu_torch.config import pd_total_iters
    from diffcloth_tpu_torch.core import step as step_mod
    ce = step_mod.CHECK_EVERY
    return np.minimum(-(-iters.max(axis=0) // ce) * ce,
                      pd_total_iters(sim.eps_forward))


def phase_sphere_forward(card, B, steps=None, device=None):
    """The obstacle path's forward: `build_task("sphere")` (its ground
    truth a 1-episode rollout at mu = 0.3), then one batched rollout of B
    friction coefficients.  Returns (task, helper, X, forward sweeps)."""
    import torch
    from diffcloth_tpu_torch.core import friction_cuda as fc
    from diffcloth_tpu_torch.core import selfcol_cuda as scd
    from diffcloth_tpu_torch.optim.helper import OptimizeHelper
    from diffcloth_tpu_torch.tasks.setup import build_task

    t0 = time.perf_counter()
    with demo_steps("sphere", steps):
        task = build_task("sphere", device=device)
    sim = task.sim
    torch.cuda.synchronize()
    log(f"[sphere] build_task: n = {sim.n}, {sim.n_steps} steps, h = "
        f"{sim.h:.6f}, {sim.n_prims} primitive (mu {float(sim.prims.mu[0])}"
        f", radius {float(sim.prims.radius[0])}), self-collision "
        f"{sim.self_cfg is not None}; ground truth mu "
        f"{float(task.param_gt.mu[0])}, {time.perf_counter() - t0:.2f} s")
    if sim.self_cfg is None or sim.n_prims != 1:
        raise AssertionError("the sphere demo lacks its sphere or "
                             "self-collision")
    helper = OptimizeHelper(sim, task.mask, task.loss_fn(),
                            param_base=task.param_base)
    X = sphere_candidates(B)
    params = helper.stack_vecs(X)
    torch.cuda.synchronize()
    scd.detect_partners.launches = 0
    fc.friction_sweep.launches = 0
    t0 = time.perf_counter()
    recs = sim.rollout(params)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"selfcol_detect": scd.detect_partners.launches,
                "friction_fwd": fc.friction_sweep.launches}
    st = recs.steps
    N = sim.n_steps
    if tuple(st.x.shape) != (B, N, sim.n, 3):
        raise AssertionError(f"trajectory shape {tuple(st.x.shape)}")
    if not (bool(torch.isfinite(st.x).all())
            and bool(torch.isfinite(st.v).all())):
        raise AssertionError("non-finite trajectory")
    conv = float(st.converged.float().mean())
    if conv != 1.0:
        raise AssertionError(f"converged fraction {conv}")
    sweeps = pd_sweeps(st.iters.cpu().numpy(), sim)
    if launches["selfcol_detect"] != N:
        raise AssertionError(f"detection launched {launches} times, "
                             f"expected once per step ({N})")
    if launches["friction_fwd"] != int(sweeps.sum()):
        raise AssertionError(f"friction launched {launches} times, not "
                             f"once per PD sweep ({int(sweeps.sum())})")
    contacts = st.obstacle_contacts.cpu().numpy()
    share = float((contacts > 0).mean())
    if share <= 0.5:
        raise AssertionError(f"obstacle contact in only {100 * share:.1f} % "
                             f"of the episode-steps")
    pairs = st.selfcol_pairs.cpu().numpy()
    per_step = contacts.mean(axis=0)
    log(f"[sphere] forward {N} steps x B={B} on {card}: {elapsed:.2f} s, "
        f"{B * N / elapsed:.1f} PD steps/s, converged {conv:.4f}, mean "
        f"iters {st.iters.float().mean():.2f} ({sweeps.sum() / N:.2f} PD "
        f"sweeps per step), {elapsed * 1e3 / sweeps.sum():.3f} ms wall per "
        f"PD sweep")
    log(f"[sphere] obstacle contacts per step (particles of {sim.n}, over "
        f"the batch): mean {per_step.mean():.2f}, max of the per-step "
        f"means {per_step.max():.2f}, max {int(contacts.max())}; "
        f"obstacle contact in {100 * share:.1f} % of the episode-steps; "
        f"self-contact pairs per step {pairs.mean():.2f} (max "
        f"{int(pairs.max())}), overflow in "
        f"{int(st.selfcol_overflow.sum())} episode-steps; launches "
        f"{launches} (detection once per step, friction once per PD "
        f"sweep)")
    return task, helper, X, int(sweeps.sum())


def phase_sphere_gradient(task, helper, X, fwd_sweeps, card):
    """The obstacle path's training step: the batched value-and-grad of mu
    at the forward's candidates."""
    import torch
    from diffcloth_tpu_torch.core import friction_cuda as fc
    from diffcloth_tpu_torch.core import selfcol_cuda as scd

    sim = task.sim
    B, N = X.shape[0], sim.n_steps
    torch.cuda.synchronize()
    scd.detect_partners.launches = 0
    fc.friction_sweep.launches = 0
    fc.friction_sweep_bwd.launches = 0
    sim.bwd_stats.reset()
    t0 = time.perf_counter()
    L, G = helper.batched_loss_and_grad(X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"selfcol_detect": scd.detect_partners.launches,
                "friction_fwd": fc.friction_sweep.launches,
                "friction_bwd": fc.friction_sweep_bwd.launches}
    st = sim.bwd_stats.summary()
    mu = X[:, 0]
    mu_gt = float(task.param_gt.mu[0])
    log(f"[sphere] gradient losses "
        f"{np.array2string(L, precision=4, max_line_width=200)}; dL/dmu "
        f"{np.array2string(G[:, 0], precision=4, max_line_width=200)}")
    if L.shape != (B,) or G.shape != (B, 1):
        raise AssertionError(f"loss {L.shape}, gradient {G.shape}")
    if not (np.isfinite(L).all() and np.isfinite(G).all()):
        raise AssertionError("non-finite loss or dL/dmu")
    if int(np.argmin(L)) != int(np.argmin(np.abs(mu - mu_gt))):
        raise AssertionError(f"the loss is smallest at mu "
                             f"{mu[np.argmin(L)]:.4f}, not at the candidate "
                             f"nearest {mu_gt}")
    if launches["selfcol_detect"] != N:
        raise AssertionError(f"detection launched {launches} times, "
                             f"expected once per step ({N})")
    if launches["friction_fwd"] != fwd_sweeps + 2 * st["residual_vjps"]:
        raise AssertionError(
            f"friction_fwd launched {launches['friction_fwd']} times, not "
            f"the forward's {fwd_sweeps} plus two per residual VJP "
            f"({st['residual_vjps']:.0f})")
    if launches["friction_bwd"] != st["launches"]:
        raise AssertionError(
            f"friction_bwd launched {launches['friction_bwd']} times, not "
            f"once per adjoint trip ({st['trips']:.0f}), GMRES matvec "
            f"({st['gmres_matvecs']:.0f}) and residual VJP "
            f"({st['residual_vjps']:.0f})")
    split = helper.last_split
    log(f"[sphere] gradient {N} steps x B={B} on {card}: {wall:.2f} s, "
        f"{B * N / wall:.1f} episode-gradient steps/s; forward "
        f"{split['forward_s']:.2f} s ({100 * split['forward_s'] / wall:.1f} "
        f"%), backward {split['backward_s']:.2f} s "
        f"({100 * split['backward_s'] / wall:.1f} %); loss smallest at mu "
        f"{mu[np.argmin(L)]:.4f} (ground truth {mu_gt})")
    log(f"[sphere] adjoint: "
        f"{st['lane_trips'] / max(st['lane_steps'], 1):.2f} trips "
        f"per episode-step ({st['trips']:.0f} trips of the batch), "
        f"{st['fallback_lanes']:.0f} of {st['lane_steps']:.0f} episode-steps "
        f"fell to GMRES ({st['gmres_matvecs']:.0f} matvecs), "
        f"{st['residual_vjps']:.0f} residual VJPs; launches {launches}; "
        f"{split['backward_s'] * 1e3 / st['launches']:.3f} ms backward wall "
        f"per friction_bwd launch")


def phase_sphere_profile(B, steps, card, top=8, device=None):
    """Where the time of the obstacle path goes: `steps` steps of the
    batch under torch.profiler, forward and value-and-grad, and the
    obstacle functions' own device launches per call at the path's
    shapes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from diffcloth_tpu_torch.core import contact as ct
    from diffcloth_tpu_torch.optim.helper import OptimizeHelper
    from diffcloth_tpu_torch.tasks.setup import build_task

    with demo_steps("sphere", steps):
        task = build_task("sphere", device=device)
    sim = task.sim
    params = OptimizeHelper(sim, task.mask, task.loss_fn(),
                            param_base=task.param_base).stack_vecs(
                                sphere_candidates(B))
    recs = phase_profile("sphere-profile", sim, params, card, top)
    # the obstacle functions alone, once each at the path's shapes: the
    # last state of the rollout, its forces, masses and the batch's mu
    x = recs.steps.x[:, -1].contiguous()
    v = recs.steps.v[:, -1].contiguous()
    t = torch.tensor(sim.n_steps * sim.h, dtype=sim.dtype,
                     device=sim.device)
    m = params.density[:, None] * sim.scene_dev.area
    f = torch.randn_like(x)
    contact = ct.detect_obstacle_contacts(sim.prims, x, v, sim.h, t=t)
    reps = 10
    for name, fn in (
            ("detect_obstacle_contacts",
             lambda: ct.detect_obstacle_contacts(sim.prims, x, v, sim.h,
                                                 t=t)),
            ("obstacle_friction",
             lambda: ct.obstacle_friction(f, contact, m, params.mu))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = profiled_ops(prof)
        log(f"[sphere-profile] {name}: "
            f"{sum(c for _, _, c in ops) / reps:.1f} device launches, "
            f"{1e3 * sum(ms for _, ms, _ in ops) / reps:.1f} us device time "
            f"per call (mean of {reps}; B={B}, n={sim.n})")
    # the value-and-grad of the same window: the backward sweep's device
    # time per call on this path
    phase_profile_gradient("sphere-profile-grad", sim, params,
                           task.loss_fn(), card, top)


def phase_sphere_reference(steps, devices=("cpu", "cuda")):
    """The sphere scene cut to `steps` steps, B = 2 (mu 0.1 and 0.5, on
    both sides of the ground truth's 0.3), f64: the episode and dL/dmu on
    the card against the same calls on the CPU (the CPU path is held to the
    JAX package by the tests).  The cloth reaches the sphere after about 10
    steps and lies on it from then on: at 60 steps the CPU gives 5477
    particle-steps in contact and dL/dmu -3.0e-5 and 6.3e-6, so every
    lane's dL/dmu must exceed 1e-6 in size before the two are compared
    (within 1e-6 of the largest entry)."""
    import torch
    from diffcloth_tpu_torch.optim.helper import OptimizeHelper
    from diffcloth_tpu_torch.tasks.setup import build_task

    X = np.array([[0.1], [0.5]])
    out = []
    for dev in devices:
        with demo_steps("sphere", steps):
            task = build_task("sphere", dtype=torch.float64, device=dev)
        helper = OptimizeHelper(task.sim, task.mask, task.loss_fn(),
                                param_base=task.param_base)
        st = task.sim.rollout(helper.stack_vecs(X)).steps
        L, G = helper.batched_loss_and_grad(X)
        out.append((st, L, G))
    (sc, Lc, Gc), (sg, Lg, Gg) = out
    err = float((sg.x.cpu() - sc.x).abs().max())
    d_it = int((sg.iters.cpu() - sc.iters).abs().max())
    g_rel = float(np.abs(Gg - Gc).max() / max(np.abs(Gc).max(), 1e-300))
    if int(sc.obstacle_contacts.sum()) == 0 or not (np.abs(Gc) > 1e-6).all():
        raise AssertionError(f"the reference episode lacks obstacle contact "
                             f"({int(sc.obstacle_contacts.sum())} "
                             f"particle-steps) or a dL/dmu above 1e-6 in "
                             f"every lane ({Gc[:, 0]})")
    if (err > 1e-6 or d_it > 1 or g_rel > 1e-6
            or not torch.equal(sg.converged.cpu(), sc.converged)
            or not torch.equal(sg.obstacle_contacts.cpu(),
                               sc.obstacle_contacts)):
        raise AssertionError(f"card vs CPU: max |dx| {err}, iters differ "
                             f"by {d_it}, dL/dmu {Gg[:, 0]} vs {Gc[:, 0]}")
    if not np.allclose(Lg, Lc, rtol=1e-9, atol=0):
        raise AssertionError(f"card vs CPU loss {Lg} vs {Lc}")
    log(f"[sphere-reference] {steps} steps, f64, B=2 (mu 0.1, 0.5): card vs "
        f"CPU max |dx| {err:.3e} (tolerance 1e-6), iters within {d_it}, "
        f"obstacle contacts equal ({int(sc.obstacle_contacts.sum())} "
        f"particle-steps); loss {Lg.tolist()} vs {Lc.tolist()}; dL/dmu "
        f"{Gg[:, 0].tolist()} vs {Gc[:, 0].tolist()}, max error / largest "
        f"entry {g_rel:.1e} (tolerance 1e-6)")


def phase_sphere_fit(card, steps=None, device=None):
    """The sphere demo's fit through its normal entry point: one iteration
    of a population L-BFGS-B of 4 seeded candidates on the card."""
    from diffcloth_tpu_torch.optim.solver import solve_demo

    P = 4

    def report(k, X, F):
        log(f"[sphere-fit] iteration {k}: mu "
            f"{np.array2string(X[:, 0], precision=4)}, losses "
            f"{np.array2string(F, precision=6)}")

    with demo_steps("sphere", steps):
        res = solve_demo("sphere", seed=1, population=P, maxiter=1,
                         callback=report, device=device)
    initial = np.array([loss for loss, _ in res.helper.history[:P]])
    final = res.result.loss
    st = res.task.sim.bwd_stats.summary()
    log(f"[sphere-fit] sphere demo (n = {res.task.sim.n}, "
        f"{res.task.sim.n_steps} steps) on {card}: {P} candidates, best "
        f"loss {initial.min():.6e} -> {final:.6e} at mu {res.result.x[0]:.4f}"
        f" in {res.wallclock_s:.1f} s ({res.result.n_evals} batched "
        f"evaluations); initial mu "
        f"{np.array2string(np.array([x[0] for _, x in res.helper.history[:P]]), precision=4)}; "
        f"adjoint over all evaluations: "
        f"{st['lane_trips'] / max(st['lane_steps'], 1):.2f} trips per "
        f"episode-step, {st['fallback_lanes']:.0f} of {st['lane_steps']:.0f} "
        f"episode-steps fell to GMRES")
    if not (np.isfinite(final) and final < initial.min()):
        raise AssertionError(f"the fit did not lower the loss: "
                             f"{initial.min()} -> {final}")


def run_sphere(card, timed):
    """Phase 10, the sphere path."""
    with timed("sphere forward"):
        task, helper, X, sweeps = phase_sphere_forward(card, SPHERE_BATCH)
    with timed("sphere kernels"):
        phase_kernels("sphere-kernels", task.sim,
                      initial_states(task.sim, SPHERE_BATCH),
                      np.random.RandomState(1), mu=X)
    with timed("sphere gradient"):
        phase_sphere_gradient(task, helper, X, sweeps, card)
    del task, helper
    with timed("sphere profile"):
        phase_sphere_profile(SPHERE_BATCH, 20, card)
    with timed("sphere reference"):
        phase_sphere_reference(60)
    with timed("sphere fit"):
        phase_sphere_fit(card)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="episode length (default: the scene's 250)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from diffcloth_tpu_torch.core import cuda_build

    card = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; {card}")
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    for name, out in built.items():
        ptxas = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: " + " | ".join(ptxas))
    log(f"[build] {len(cuda_build.KERNELS)} kernels ready in "
        f"{time.perf_counter() - t0:.1f} s")

    timed = Timer()
    rng = np.random.RandomState(0)
    sim = flagship(torch.float32, "cuda", args.steps)
    with timed("kernels"):
        kernels = phase_kernels("kernels", sim, initial_states(sim, BATCH),
                                rng)
    with timed("forward path"):
        launches = phase_main_path(sim, BATCH, card)
    # the profiled window: the first 10 steps of the same batch
    prof_sim = flagship(torch.float32, "cuda", 10)
    prof_params = episode_params(prof_sim, BATCH)
    with timed("forward profile"):
        phase_profile("profile", prof_sim, prof_params, card)
    with timed("forward reference"):
        phase_reference(10)
    with timed("gradient path"):
        launches["friction_bwd"] = phase_gradient(
            sim, BATCH, card, launches["friction_fwd"])["friction_bwd"]
    with timed("gradient profile"):
        phase_profile_gradient("profile-grad", prof_sim, prof_params,
                               base_wind_target(prof_sim, prof_params), card)
    with timed("trainer"):
        phase_trainer(card)
    with timed("gradient reference"):
        phase_gradient_reference(10)
    run_sphere(card, timed)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(f"[time] all phases {timed.total:.1f} s")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
