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
     over half) for 100 of its 250 steps on the card.  Launch counters are
     zeroed just before and read just after: detection runs once per step,
     friction once per PD sweep.
  4. profile: the first 10 steps of the same batch under torch.profiler
     (device activity alone, as every profile here).
  5. reference: a small folded episode on the card against the same
     episode through the plain versions on the CPU.
  6. gradient path: one batched value-and-grad through
     `OptimizeHelper.batched_loss_and_grad` (GradMask(f_wind=True)) of the
     same 32 episodes, 100 steps, MATCH_TRAJECTORY against the base wind's
     rollout.  Counters zeroed just before and read just after: the
     backward friction kernel launches once per adjoint trip, GMRES matvec
     and residual VJP; the forward one once per PD sweep of the forward
     (as in phase 3) twice (the population's value-and-grad is chunked:
     its backward recomputes each chunk's forward, detection too) and
     twice more per adjoint program (its start linearizes K at one
     forward sweep, its residual VJP makes the other).
     Prints episode-gradient steps/s, the forward and backward shares,
     adjoint trips per step, fallback steps and active slots per backward
     launch.  Then the GMRES least squares kernel against its plain
     version at the path's shapes (B = 32 Hessenbergs of 17 x 16), timed
     beside it and torch.linalg.pinv; it must have launched on the path.
  7. gradient profile: a 10-step value-and-grad of the batch under
     torch.profiler.
  8. trainer: `solve_demo("wind", seed=1, population=4, maxiter=1)` on the
     card, the demo cut to 40 of its 200 steps, the loss per iteration;
     the final loss must be below the initial one.
  9. gradient reference: the f64 value-and-grad of a small folded episode
     batch on the card against the same call on the CPU.
 10. sphere (the obstacle path): `build_task("sphere")` on the card at full
     width (25 x 25, n = 625, h = 1/180, a sphere of radius 2,
     self-collision on), cut to 250 of its 350 steps, then
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
     b'. adjoint kernels: the four kernels of the adjoint's linearized K
        map (`csrc/adjoint_linear.cu`) on the entries of a real adjoint
        program (a step's backward, uncaptured, from the batch's state after
        300 steps: the cloth on the sphere and folded on itself), against
        their plain versions exactly (max error 0), each timed beside its
        plain version on the card and its bound (the JSON line's `ms`,
        `plain_ms`, `bound_ms`; launches: b's), on the dense operators;
     c. profile: phases 4 and 7 on 10 steps of the batch, and the
        obstacle detection and obstacle friction's device launches per
        call;
     d. reference: the scene cut to 60 steps (the cloth on the sphere),
        B = 2, f64, card against CPU (episode within 1e-6; every dL/dmu
        above 1e-6 in size, and within 1e-6 of the largest entry);
     e. fit: `solve_demo("sphere", seed=1, population=4, maxiter=1)`, the
        demo cut to 200 of its 350 steps, must lower the best loss.
 11. large mesh: the flagship stand-in's physics on a 128 x 128 grid
     (n = 16 384, built with dataclasses.replace), B = 8 perturbed winds,
     half the batch folded half over half (64 rows).  ClothSim's size
     switches must pick the CG solve, the sparse operators and the sweep
     detection, and the friction sweeps their global-state route (the
     state does not fit shared memory).
     a. forward: 5 steps; converged 1.0, PD steps/s, CG iterations per
        solve, self-contact pairs and overflow steps; the detection kernel
        never launches, the forward sweep once per PD sweep, all on the
        global-state route;
     a'. kernels: both sweeps on the global-state route at n = 16 384,
        B = 8, on slot geometry from the sweep pipeline, against their plain
        versions exactly, at full layer-0 budget and without contact, timed
        beside their bounds;
     b. gradient: the batched value-and-grad of GradMask(f_wind=True)
        against the base wind's rollout, of 11a's episodes; finite, the
        forward sweep once per PD sweep of 11a plus twice per adjoint
        program (the linearization, the residual VJP), the backward sweep
        once per adjoint trip, GMRES matvec and residual VJP, on the
        global-state route;
     b'. adjoint kernels: 10b' at this path's shapes, on the sparse
        operators' interleaved rows and the global-state sweeps, from one
        step of 11a's folded starts (names ending "_large");
     c. profile: phase 4 on 1 step of the batch;
     d. reference, f64, card against CPU within 1e-6: an episode of a
        48 x 48 grid (sparse operators, dense P^{-1}, detection kernel),
        B = 2, 1 step; and the 128 x 128 scene's modules at its folded and
        flat states (the sweep pipeline exactly, the sparse operators, one
        CG solve at the path's caps; an episode at this size ends by a
        plateau exit that rounding decides, see phase_large_parts).

 12. dress: `build_task("dress")` on the dress stand-in
     (registry.dress_grid_standin: the DRESS_V7K_DRAPE physics and twirl,
     125 steps at h = 1/120, on an 84 x 84 grid, n = 7056, 31 clips);
     ClothSim must pick the dense P^{-1}, the sparse operators and the
     detection kernel (n_pad = 7168), and the sweeps their shared-memory
     route.
     a'. kernels: phase 2's checks at these shapes (B = 1, the folded
        state);
     b. forward: the f32 episode, B = 1, the host P^{-1} timed alone;
        PD steps/s, sweeps per step, self-contact steps and overflow,
        launches checked; then a 10-step profile without the P^{-1};
     c. gradient: the value-and-grad of the dress loss over its mask
        (density, k_bend), trips per step and GMRES fallbacks; chunked
        (n = 7056 > 2000, OptimizeHelper's rule), so the forward twice;
     d. fit: solve_demo("dress"), 8 steps, 2 iterations, with export_dir,
        checkpoint_dir and export_iters; resumed from its checkpoint to 3
        iterations; the exported final episode re-imported, equal to the
        rollout's records to the files' 8 decimals;
     e. reference: 1 step in f64 from the folded state, card against CPU
        (episode within 1e-6, gradients within 1e-6 of each class's
        largest entry).
 13. multistage: the flagship stand-in with two attachment stages (the
     corners until mid-episode, then the top row's middle), B = 1, 20
     steps: the f32 forward (the clips switch) and value-and-grad with
     launch checks, then f64 card against CPU over 4 steps from the flat
     state (bounded as 12e).
 14. ladder: solve_demo_tau_ladder("sock") on the sock stand-in (a 32 x 32
     grid, the FOOT primitives, 6 steps), population 4, two rungs of one
     iteration.
 15. obstacles: the slope stand-in on its plane, a grid dropped on the
     FOOT capsules, one dropped into the Y0PLANE bowl, and the sphere
     scene's corners on a CORNERS_2_WEARHAT trajectory under
     ENDPOINT_AND_TANGENTS: contact in most of 30 f32 steps, then f64 card
     against CPU over 6 steps (bounded as 12e).
 16. precision: the f32 value-and-grad against the f64 one and f64
     central differences (one entry per parameter class), on the flagship
     stand-in (3 steps) and the sphere path (20 steps); reported, not
     bounded.
 17. control (the closed-loop hat controller on `registry.hat_grid_standin`:
     HAT_SCENE's physics, bust and clips on a 25 x 25 grid, n = 625):
     a. kernels: phase 2's checks at its shapes (B = 8: controller start
        poses, the grid folded, the hat on the bust in the head sphere's
        contact band, the folded grid there too);
     b. facade and bridge, f64 on the card and the CPU: 20
        `SimulationAPI.step_nn` steps and one `step_backward_nn`, then
        `PySim` over 5 steps with a scalar loss; states and cotangents
        within 1e-6;
     c. training at the app's defaults: `hat_controller.train` for 2
        epochs, B = 8 poses, 4 validation poses, seed 0, all 400 steps in
        chunks of 50; per epoch the losses, gradient norms and
        episode-gradient steps/s; then one `loss_and_grad` with the
        counters zeroed just before and read just after (detection once
        per step and the forward sweep once per PD sweep, both twice: the
        chunks' backward recomputes their forward; the forward sweep twice
        more per adjoint program, the backward sweep once per trip, GMRES
        matvec and residual VJP); every gradient finite; and its profile
        over 10 steps;
     d. eval: one 400-step closed-loop episode of the trained controller
        in chunks, rendered to a GIF, its loss;
     g. the chunks against the whole episode: the trained controller's
        `loss_and_grad` at 200 steps, B = 8, chunked and as one autograd
        graph in the order chunked, whole, whole, chunked (each route's
        runs bit for bit alike): the loss equal bit for bit, the
        gradients and per-sample norms within 1e-5 of their largest
        entries; the rates; the chunks' forward equal to the whole
        episode's states and free of synchronizing calls (sync debug mode
        "error"); device busy (CUDA events around the programs); peak
        memory; host launches and synchronizing calls per step from a
        fresh profiling process (`--profile-control`, 8 steps, chunk 4);
     e. the GMRES adjoint: the flagship stand-in's batched value-and-grad
        (B = 4, half folded, 6 steps, GradMask(f_wind=True)) in "gmres"
        against "fp", f32 (trips, matvecs, cosine: reported, not bounded);
        "gmres" in f64, card against CPU (2 steps, the adjoint to 1e-12;
        bounded as 12e);
     f. parallel: `parallel/mesh.py` on a world-size-1 NCCL group: the
        dp = 1 objective equal to the plain batched one and the tp = 1
        row-sharded solve equal to the dense P^{-1} product, exactly; the
        step given that tp solve runs captured by default (its all-gather
        the exchange kernels, `csrc/peer_exchange.cu`), equal bit for bit
        to `cuda_graphs=False` (losses, gradients, the kernels' counts)
        and its losses to the plain sim's, the kernels' own counts those
        its programs predict; another `solve_fn` with `cuda_graphs=True`
        raises; the exchange kernels against their plain version (NCCL's
        all-gather) exactly at the flagship's and the dress's blocks, timed
        beside it; then two processes sharing the card (gloo for the
        handles), tp = 2, tests/torch_parallel_cuda_worker.py's cases:
        their exchange in a WHILE body and their flagship tp step
        captured against uncaptured, bit for bit, the ranks equal to each
        other, the losses and the gradients within 1e-4 of the
        plain step's (dL/dk_pertype 2e-2, dL/dx0 and dL/dv0 0.25).

 18. graphs (the compiled step): every earlier phase runs its sims as they
     default, each step's forward and adjoint one launch of a device
     program whose loops end on the device (`core/graphs.py`); here each
     path runs both ways on two sims of one configuration, built once
     for all the path's cases, `cuda_graphs=None` (captured) and `False`
     (the same segments uncaptured): the flagship stand-in's forward and
     value-and-grad (B = 32, 8 steps), the sphere path's (B = 16, 16
     steps), the large path's forward (B = 8, 2 steps) and one control
     `loss_and_grad` (B = 4, 20 steps, a seeded controller).  Per case a
     cold run each way (the graphed one warms up and captures), then
     graphed, uncaptured: every output (states, diagnostic counts, losses,
     gradients), the kernels' counters and the adjoint's counts of all
     four runs equal bit for bit; each PD and trip body's kernels per run
     equal to its length, and, in a run without warm-ups, the kernels' own
     launch counts (each kernel adds one on the device per launch) equal
     to what the programs predict (launches x straight kernels plus body
     runs x body kernels) and the trip bodies' runs the adjoint's trips;
     the rates both ways; then one profiled graphed run on the same sim
     (device busy as the profiler sees it, device and host launches per PD
     sweep or step, program launches per step).

 19. chunked (the chunked episode): the flagship stand-in (B = 32, 50
     steps, chunk 25) and the sphere path (B = 16, 40 steps, chunk 20)
     through `rollout_chunked`, `episode_loss_chunked` and
     `episode_value_and_grad_chunked(batched=True)` against `rollout`,
     `episode_loss` and `episode_value_and_grad` on one sim: the chunked
     states and diagnostics and the loss equal bit for bit, the gradients
     within 1e-5 of each class's largest entry; the kernels' own launch
     counts against the sweeps the iteration counts imply (the forward
     twice in the chunked value-and-grad) and against what the programs'
     launches and body runs predict; the rates both ways (chunked, then
     whole);
     device busy (CUDA events around each step program: the profiler sees
     few or none of the kernels inside the loop bodies); host launches and
     synchronizing runtime calls per step (torch.profiler's runtime
     events, in a fresh process at 8 steps, chunk 4; its failure fails
     the phase); the chunks'
     forward under PyTorch's sync debug mode "error"; the loops' body
     runs; the peak memory of the two value-and-grads.
     Then the chunked value-and-grad in f64, card against CPU (a 10 x 10
     folded grid, B = 2, 6 steps, chunk 3) within 1e-6.

 20. capacity (run after the flagship's phases): the flagship stand-in at
     drop-free self-collision capacity, `ClothSim(self_max_layers=16,
     self_compact_layers=16, self_compact_budgets=(n,) * 16)` (16 384
     slots a sample: the sweeps stream their slot rows from global
     memory), against the default capacity (256, 128, 64, 64):
     a. kernels at those shapes (B = 32): both sweeps on the streamed-slot
        route with the state in shared memory, and detection at K = 64
        (rows past 64 hits), against their plain versions exactly, timed
        beside their bounds; then the global-state streamed route where
        `sweep_operands` picks it (n = 19 500, B = 2, budgets (n,) * 16,
        random matchings in four layers): both sweeps exactly and timed,
        and its path, `self_friction` and its autograd backward between
        zeroed and read launch counts, equal to the plain versions;
     b. forward: `rollout_chunked` (100 steps, chunk 25, captured) at the
        default capacity, then at drop-free capacity with K = 8, 16, 32 in
        turn until no step overflows (else the limit that fired is named);
        PD steps/s, sweeps per step, overflow steps, launches (every
        drop-free sweep on the streamed route);
     c. gradient: `OptimizeHelper(chunked)`'s population value-and-grad
        (wind and x0, the drop-free motion as target) at both capacities,
        episode-gradient steps/s, launches; how far dL/dwind and dL/dx0
        move between them (what the dropped contacts cost);
     d. the ablations "nofric" and "detect_only" (not physical): their PD
        steps/s beside the full step's, detection once per step and no
        sweep;
     e. reference: a 16 x 16 folded grid at drop-free capacity (its sweeps
        streamed), B = 2, 6 steps, f64: the episode and the chunked
        value-and-grad, card against CPU within 1e-6.

The CPU sides of the f64 card-vs-CPU references of the sphere, dress,
multistage and obstacle paths (10d, 12e, 13, 15) run in a process beside
the card phases (`--cpu-references`, started after the build; a phase
waits for its side, and the process's failure fails the phase).

`--only PATH,...` runs some of the paths while iterating (flagship:
phases 2-9, capacity, sphere, large, dress, multistage, ladder,
obstacles, precision, control, graphs, chunked); the acceptance run takes
no arguments.

Prints one JSON line `{"kernels": [...]}` (each kernel's launches counted
on the path that runs it: the forward path for detection and the forward
sweep, the gradient path for the backward sweep, phase 11 for the sweeps'
global-state route, whose entries carry "state": "global", phase 20 for
the streamed-slot route, whose entries carry "slots": "stream", phase 12 for
the dress stand-in's, named with "_dress", phase 10b' for the adjoint's
kernels and 11b' for theirs on the sparse route, named with "_large",
20a's `self_friction` path for
the global-state streamed route, named with "_global_stream", phase 17c's
loss_and_grad for
the control path's, named with "_control", and 17f's captured tp step for
the exchange, which is not a TPU kernel), the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.  Needs one card; imports nothing of JAX.
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
# f64 FLOP/s outside the tensor cores (the GMRES least squares kernel
# computes in f64)
F64_FLOPS = 34e12
# f64 operations of one Jacobi sweep of the least squares kernel per
# column pair: three dot products over the 17 rows (2 each per row)
LSTSQ_OPS_PER_PAIR = 6 * 17
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
# and their depth (of the scene's 250 steps)
BATCH = 32
FLAGSHIP_STEPS = 100
# the flagship's base wind; the batch's winds are perturbations of it
BASE_WIND = [0.04, 0.004, 0.04]
# episodes of the sphere path's batch: friction coefficients
# linspace(0.05, 0.9), and their depth (of the demo's 350 steps)
SPHERE_BATCH = 16
SPHERE_STEPS = 250
# the depth of the sphere path's f64 card-vs-CPU reference
SPHERE_REF_STEPS = 60
# steps of the wind demo's episodes in the trainer phase (of its 200), and
# of the sphere demo's in its fit (of its 350)
TRAINER_STEPS = 30
SPHERE_FIT_STEPS = 200
# the adjoint kernels' state: the batch after this many steps, on the
# sphere and folded on itself
SPHERE_ADJ_STEPS = 300
# the large-mesh scene (phase 11): a LARGE_GRID x LARGE_GRID cloth of the
# flagship's physics, B = LARGE_BATCH; the depth of its forward episode and
# value-and-grad, and of its profiled window (a PD sweep there launches
# about 3600 kernels, 64 CG iterations of sparse gathers, so each step
# costs seconds of host dispatch)
LARGE_GRID = 128
LARGE_BATCH = 8
LARGE_STEPS = 5
LARGE_PROFILE_STEPS = 1
# phase 11d: the dress-scale grid (sparse operators, dense P^{-1}, the
# detection kernel) and the depth of its f64 episode, run on the card and
# on the CPU
LARGE_REF_GRID = 48
LARGE_REF_STEPS = 1
# phase 12: the dress stand-in's grid (84 x 84 = 7056 vertices, the size of
# the reference's 7k-vertex dress); the depths of its profiled window, of
# its fit (solve_demo, of its 125 steps) and of its f64 card-vs-CPU check
DRESS_GRID = 84
DRESS_PROFILE_STEPS = 10
DRESS_FIT_STEPS = 8
DRESS_REF_STEPS = 1
# the adjoint tolerance of the card-against-CPU f64 references (phase 9's)
REF_ADJOINT_EPS = 1e-8
# phase 13: the two-stage scene's f32 depth and its f64 reference's
MULTI_STEPS = 20
MULTI_REF_STEPS = 4
# phase 14: the sock stand-in's depth in the tau ladder (of its 400 steps)
LADDER_STEPS = 6
# phase 15: the obstacle scenes' f32 depth and their f64 reference's
OBSTACLE_STEPS = 30
OBSTACLE_REF_STEPS = 6
# phase 16: the depths of the f32-against-f64 gradients
PRECISION_STEPS = 3
SPHERE_PRECISION_STEPS = 20
# phase 17 (the control path, the hat stand-in): the training batch, the
# validation poses, the epochs and the horizon (None: the hat's 400 steps;
# the app's defaults, its chunk too); the facade's steps and the bridge's; the GMRES comparison's depth and batch (the flagship
# stand-in) and its f64 reference's depth; the world-size-1 NCCL
# objective's depth
HAT_BATCH = 8
HAT_VAL = 4
HAT_EPOCHS = 2
HAT_STEPS = None
# 17g's horizon (of the hat's 400 steps: four chunks of 50)
CONTROL_CHUNKED_STEPS = 200
CONTROL_PROFILE_STEPS = 10
FACADE_STEPS = 20
BRIDGE_STEPS = 5
GMRES_STEPS = 6
GMRES_BATCH = 4
GMRES_REF_STEPS = 2
PARALLEL_STEPS = 5
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
    # again, up to five times.  For a wrapper, whose calls each launch its
    # one kernel, the mean over the kernel events a session did record
    # stands in if no session recorded them all.
    partial = None
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
            hits = [e for e in events if kernel in e.key]
            count = sum(e.count for e in hits)
            whole = count == reps
            if count:
                partial = (sum(e.self_device_time_total for e in hits)
                           / count, count)
        if us > 0 and whole:
            return us / 1e3 / reps
    if partial is not None:
        log(f"[profiler] {kernel}: {partial[1]} of {reps} launches recorded "
            f"in the last session with any; the mean over them")
        return partial[0] / 1e3
    # on some hosts every session loses events: the CUDA-event time of
    # back-to-back calls (device time and the host's gaps between launches,
    # so never under the device time) stands in, and says so
    ms = time_cuda(fn, reps, warmup)
    what = kernel or "every kernel"
    log(f"[profiler] lost device events in five sessions ({what}); "
        f"CUDA-event ms of back-to-back calls instead: {ms:.4f}")
    return ms


def profiled_ops(prof):
    """(key, device ms, calls) of the device-side events of a profile
    (kernels, copies): the operators that launch them carry the same time
    again."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]


# the CUDA runtime calls that put work on the card from the host: a kernel
# launch, or a whole graph's
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


def host_launches(prof):
    """The host's kernel and graph launches in a profile (its CUDA runtime
    events), None where the profiler recorded none."""
    n = sum(e.count for e in prof.key_averages()
            if e.key.split("_v")[0] in HOST_LAUNCHES)
    return n or None


def log_breakdown(tag, ops, kernels, top=8, captured=False):
    """The `top` operators by device time, then each hand-written kernel's
    calls and device time per call; kernels: (name, symbol substring).  On
    a captured path (`captured`) the profiler sees few or none of the
    kernels inside the programs' WHILE loop bodies: a kernel it saw no
    call of is reported so, not an error."""
    busy_ms = sum(ms for _, ms, _ in ops)
    for key, ms, count in sorted(ops, key=lambda o: -o[1])[:top]:
        log(f"[{tag}]   {100 * ms / busy_ms:5.1f} % of device time  "
            f"{ms:8.2f} ms  {count:6d} calls  {key[:90]}")
    for name, kernel in kernels:
        hits = [(ms, count) for key, ms, count in ops if kernel in key]
        if not hits and captured:
            log(f"[{tag}] {name}: no call recorded (inside the programs' "
                f"loop bodies, which the profiler does not see)")
            continue
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


def flagship(dtype, device, steps=None, **sim_kw):
    from diffcloth_tpu_torch.core.sim import ClothSim
    from diffcloth_tpu_torch.geometry import builder as gb
    from diffcloth_tpu_torch.tasks.registry import TSHIRT_GRID_STANDIN
    import dataclasses
    cfg = TSHIRT_GRID_STANDIN
    if steps is not None:
        cfg = dataclasses.replace(cfg, step_num=steps)
    scene = gb.build_scene(cfg)
    return ClothSim(scene, device=device, dtype=dtype, **sim_kw)


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
    noise, and in sample 1 (sample 0 of a batch of one) overflow rows, up
    to 20 far-apart vertices stacked on one point (every 50th from 25: 20
    with 19 partners each at n = 1024, 12 with 11 at n = 625; K = 8), 10 of
    them in the first 512-column segment."""
    B, n = x0.shape[0], sim.n
    x = x0 + rng.randn(B, n, 3) * 0.01
    pile = np.arange(25, n, 50)[:20]
    b = min(1, B - 1)
    x[b, pile] = x[b, pile[0]]
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


def phase_kernels(tag, sim, x0, rng, mu=None, suffix=""):
    """Each kernel against its plain version at a path's shapes: B = the
    batch of x0 ((B, n, 3) numpy, the states `kernel_states` perturbs), n
    and the budgets of `sim`.  On a path with obstacles (mu: the batch's
    (B, P) friction coefficients) the sweeps run on f plus the obstacle
    friction of the states' contacts, their r_init on that path.  Returns
    the JSON line's entries, their names ending in `suffix`."""
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
    sweeps, bounds, floor_ms = check_sweeps(tag, kg, masses, f, g, n, cfg)
    if det_ms < det_bound:
        raise AssertionError(f"detection: {det_ms} ms of device time per "
                             f"call, below its bound {det_bound} ms")
    log(f"[{tag}] detection: device ms per call kernel {det_ms:.4f}, "
        f"plain {det_plain_ms:.4f} (profiler); back-to-back wall ms per call "
        f"kernel {det_ev[0]:.4f}, plain {det_ev[1]:.4f} (CUDA events); "
        f"bound {det_bound:.5f} ({det_by}), floor of unfused f32 "
        f"instructions {det_floor:.5f}")
    return [
        dict(name="selfcol_detect" + suffix, route="cuda",
             source="diffcloth_tpu_torch/csrc/selfcol_detect.cu",
             replaces="diffcloth_tpu/core/selfcol_pallas.py:53",
             launches=0, max_abs_err=det_err, ms=det_ms,
             plain_ms=det_plain_ms,
             bound_ms=det_bound, bound_by=det_by, library_ms=None),
    ] + sweep_entries(sweeps, bounds, suffix)


def phase_lstsq_kernel(B, launches, rng):
    """The GMRES least squares kernel against its plain version (gelsd in
    f64 on the host) at the flagship's shapes: B (17, 16) Hessenbergs in
    f32, random, happy breakdowns (a zero subdiagonal entry, the block
    below it zero) and columns near the cutoff; within 1e-5 of each
    episode's largest entry.  Its time beside the plain version's and
    PyTorch's pinv (the same truncated SVD solution, which reads back to
    the host); the bound counts one Jacobi sweep per episode (the sweep
    that finds nothing to rotate), a floor of the data's sweeps.  Returns
    the JSON line's entry (`launches`: the gradient path's)."""
    import torch
    from diffcloth_tpu_torch.core import lstsq_cuda as lq
    from diffcloth_tpu_torch.core import step as step_mod
    if not launches:
        raise AssertionError("[lstsq] the gradient path launched the GMRES "
                             "least squares kernel no time")
    m = step_mod.GMRES_M
    H = np.triu(rng.randn(B, m + 1, m), -1)
    for i in range(1, B, 3):
        j = rng.randint(m)
        H[i, j + 1, j] = 0.0
        H[i, j + 1:, j + 1:] = 0.0
    for i in range(2, B, 3):
        H[i, :, -3:] *= 1e-9
    e1 = np.zeros((B, m + 1))
    e1[:, 0] = rng.rand(B) + 0.1
    Ht = torch.as_tensor(H, dtype=torch.float32, device="cuda")
    bt = torch.as_tensor(e1, dtype=torch.float32, device="cuda")
    rcond = torch.finfo(torch.float32).eps * (m + 1)
    y = lq.hessenberg_lstsq(Ht, bt, rcond)
    Hc, bc = Ht.cpu(), bt.cpu()
    ref = lq.hessenberg_lstsq_plain(Hc, bc, rcond)
    diff = (y.cpu().double() - ref.double()).abs()
    rel = float((diff.amax(1) / ref.double().abs().amax(1)).max())
    if not rel <= 1e-5:
        raise AssertionError(f"[lstsq] kernel against plain: {rel:.3e} of "
                             f"an episode's largest entry")
    ms = time_cuda(lambda: lq.hessenberg_lstsq(Ht, bt, rcond))
    t0 = time.perf_counter()
    for _ in range(5):
        lq.hessenberg_lstsq_plain(Hc, bc, rcond)
    plain_ms = (time.perf_counter() - t0) / 5 * 1e3
    lib_ms = time_cuda(lambda: torch.linalg.pinv(Ht, rtol=rcond)
                       @ bt[..., None], reps=5, warmup=1)
    pairs = (m // 2) * (m - 1)
    ops_ms = B * pairs * LSTSQ_OPS_PER_PAIR / F64_FLOPS * 1e3
    bytes_ms = 4 * B * ((m + 1) * m + (m + 1) + m) / HBM_BYTES_PER_S * 1e3
    bound, by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
    log(f"[lstsq] B={B} (17 x 16) f32 Hessenbergs: kernel == plain within "
        f"{rel:.2e} of each episode's largest entry (max abs "
        f"{float(diff.max()):.2e}); kernel {ms:.4f} ms (CUDA events), plain "
        f"{plain_ms:.3f} ms (host gelsd), torch.linalg.pinv {lib_ms:.3f} ms; "
        f"bound {bound:.5f} ms ({by}); {launches} launches on the gradient "
        f"path")
    return dict(name="hessenberg_lstsq", route="cuda",
                source="diffcloth_tpu_torch/csrc/hessenberg_lstsq.cu",
                replaces="diffcloth_tpu/core/step.py:136 (jnp.linalg.lstsq, "
                         "a library call; no Pallas kernel)",
                launches=launches, max_abs_err=float(diff.max()), ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)


def sweep_entries(sweeps, bounds, suffix, state="shared", slots="shared"):
    """The JSON line's entries of the two sweeps (names + suffix), from
    check_sweeps' times at full budget, on the operands' `state` and
    `slots` routes."""
    out = []
    for name, key, line in (("friction_fwd", "fwd", 255),
                            ("friction_bwd", "bwd", 309)):
        err, ms, plain_ms = sweeps["with contact"][key][:3]
        bound, by = bounds[key]
        out.append(dict(
            name=name + suffix, route="cuda",
            source=f"diffcloth_tpu_torch/csrc/{name}.cu",
            replaces=f"diffcloth_tpu/core/friction_pallas.py:{line}",
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None, state=state,
            slots=slots))
    return out


def check_sweeps(tag, kg, masses, f, g, n, cfg, route="shared",
                 slots="shared"):
    """Both friction sweeps against their plain versions on the slot
    geometry kg (full budget) and on the same geometry with every count
    zero, exactly, on the state `route` and `slots` route that
    sweep_operands must pick; each timed (profiler device time and CUDA
    events) beside the plain version and its byte bound.
    Returns ({label: {"fwd"/"bwd": (max error, ms, plain ms, wall ms, plain
    wall ms)}}, {"fwd"/"bwd": (bound ms, bound_by)}, launch floor ms)."""
    import dataclasses
    import torch
    from diffcloth_tpu_torch.core import friction_cuda as fc

    B = f.shape[0]
    active = int(kg.counts.sum())
    TC = kg.idx_row.shape[1]
    # the same slot geometry with every count zero: no active slot
    kg0 = dataclasses.replace(kg, counts=torch.zeros_like(kg.counts))
    sweeps = {}
    for label, geom_l in (("with contact", kg), ("zero contact", kg0)):
        ops = fc.sweep_operands(geom_l, masses, cfg.budgets, n)
        if (ops.route, ops.slots) != (route, slots):
            raise AssertionError(f"the sweeps took the ({ops.route}, "
                                 f"{ops.slots}) route at n = {n}, not "
                                 f"({route}, {slots})")
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
            f"(fr', vals) and backward (g' and the three slot cotangents), "
            f"{route}-state route, {slots} slot rows; "
            f"{int(geom_l.counts.sum())} active slots, "
            f"overflow {int(kg.overflow.sum())}")
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
    one = torch.zeros(1, device=f.device)
    floor_ms = device_ms(lambda: one.zero_(), reps=50)
    # fr in and out, vals written for every slot, counts, the active slots'
    # data (indices 2, normal 3, masses 3)
    fr_bytes = (2 * f.numel() * 4 + B * 6 * TC * 4 + kg.counts.numel() * 4
                + active * 4 * (2 + 3 + 3))
    fr_ops = active * FRICTION_OPS_PER_SLOT
    # g in and out, the active slots' data (indices 2, normal 3, masses 3)
    # and selects (6), the three slot cotangents written for every slot
    fb_bytes = (2 * g.numel() * 4 + active * 4 * (2 + 3 + 3 + 6)
                + 3 * B * TC * 4 + kg.counts.numel() * 4)
    fb_ops = active * FRICTION_BWD_OPS_PER_SLOT
    bounds = {}
    for key, nbytes, ops_n in (("fwd", fr_bytes, fr_ops),
                               ("bwd", fb_bytes, fb_ops)):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops_n / F32_FLOPS
        bounds[key] = (max(t_b, t_o) * 1e3,
                       "bytes" if t_b > t_o else "operations")
    # without contact: the state in and out, zero slot rows, counts
    bound0 = {"fwd": (2 * f.numel() + B * 6 * TC + kg.counts.numel()) * 4,
              "bwd": (2 * g.numel() + 3 * B * TC + kg.counts.numel()) * 4}
    for name, key in (("friction", "fwd"), ("friction_bwd", "bwd")):
        ms = sweeps["with contact"][key][1]
        if ms < bounds[key][0]:
            raise AssertionError(f"{name}: {ms} ms of device time per call, "
                                 f"below its bound {bounds[key][0]} ms")
    log(f"[{tag}] launch floor: device ms per call of a one-element "
        f"zero_() {floor_ms:.4f} (profiler); byte bounds of the sweeps: "
        f"forward {bounds['fwd'][0]:.5f}, backward {bounds['bwd'][0]:.5f}, "
        f"without contact {bound0['fwd'] / HBM_BYTES_PER_S * 1e3:.5f} and "
        f"{bound0['bwd'] / HBM_BYTES_PER_S * 1e3:.5f}")
    for label, times in sweeps.items():
        for name, key in (("friction", "fwd"), ("friction_bwd", "bwd")):
            _, ms, plain_ms, ev, plain_ev = times[key]
            log(f"[{tag}] {name} ({label}): device ms per call kernel "
                f"{ms:.4f}, plain {plain_ms:.4f} (profiler); back-to-back "
                f"wall ms per call kernel {ev:.4f}, plain {plain_ev:.4f} "
                f"(CUDA events)")
    return sweeps, bounds, floor_ms


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

    params = episode_params(sim, B)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    recs = sim.rollout(params)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counters()
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


def phase_profile(tag, sim, params, card, top=8, kernels=FORWARD_KERNELS,
                  prefactor=False):
    """Where the time of a forward path goes: the rollout of `params` (the
    path's batch, its first few steps) under torch.profiler, after the
    path's own run, so nothing is cold.  Prints the device-busy share of
    the window, device time and launches per PD sweep (the forward sweep's
    launches) and the operators with the most device time; returns the
    records.  The profiler traces the device alone (host operators are not
    recorded, which cost more to process than the window takes to run).
    prefactor=True leaves the host P^{-1} and its upload out of the window
    (the episode's `simulate` alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run = lambda: sim.rollout(params)  # noqa: E731
    if prefactor:
        p_inv, xfs = sim.p_inv(params), sim.x_fixed_seq(params)
        run = lambda: sim.simulate(params, p_inv, xfs)  # noqa: E731
    run()   # the sim's blocks warmed up and captured outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        recs = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sweeps = int(pd_sweeps(recs.steps.iters.cpu().numpy(), sim).sum())
    ops = profiled_ops(prof)
    busy_ms = sum(ms for _, ms, _ in ops)
    n_kernels = sum(count for _, _, count in ops)
    if busy_ms == 0:
        raise AssertionError("the profiler saw no device time")
    hosted = host_launches(prof)
    log(f"[{tag}] {sim.n_steps} steps x B={params.batch_size} on {card}: "
        f"wall {wall_ms:.1f} ms, device busy (as the profiler sees it) "
        f"{busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %), {sweeps} PD sweeps: "
        f"{wall_ms / sweeps:.3f} ms wall and {busy_ms / sweeps:.3f} ms "
        f"device per sweep (wall inflated by the profiler), "
        f"{n_kernels / sweeps:.1f} device launches and "
        + (f"{hosted / sweeps:.1f}" if hosted else "(not measured)")
        + f" host launches per sweep; graphs {graph_line(sim)}")
    # the hand-written kernels' own device time per call, beside the CUDA
    # event time of back-to-back wrapper calls in phase 2
    log_breakdown(tag, ops, kernels, top, sim.cuda_graphs)
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
    zero_counters()
    sim.bwd_stats.reset()
    t0 = time.perf_counter()
    L, G = helper.batched_loss_and_grad(X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    st = sim.bwd_stats.summary()
    N = sim.n_steps
    if L.shape != (B,) or G.shape != (B, X.shape[1]):
        raise AssertionError(f"loss {L.shape}, gradient {G.shape}")
    if not (np.isfinite(L).all() and np.isfinite(G).all()):
        raise AssertionError("non-finite loss or gradient")
    if not ((L > 0).all() and (np.abs(G).max(axis=1) > 0).all()):
        raise AssertionError("a zero loss or gradient")
    # the population's value-and-grad is chunked: its backward recomputes
    # the forward (phase 3's sweeps twice); every adjoint program sweeps
    # forward twice (the linearization, the residual VJP), and every
    # (dK/dv)^T product (a trip or a GMRES matvec) and residual VJP sweeps
    # backward once
    check_launches("gradient", launches, N, fwd_sweeps, st, passes=2)
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
    vg(params)   # the sim's blocks warmed up and captured outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        f"profiler), device busy (as the profiler sees it) "
        f"{busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %), "
        f"{sum(c for _, _, c in ops)} device launches, "
        f"{host_launches(prof) or '(not measured)'} host launches; graphs "
        f"{graph_line(sim)}")
    log_breakdown(tag, ops,
                  (("friction_bwd", "friction_bwd_kernel"),), top,
                  sim.cuda_graphs)


def phase_trainer(card):
    """The trainer through its normal entry point: one iteration of a
    population L-BFGS-B fit of the wind demo on the card, seeded (all four
    candidates random restarts).  Every line-search try is a batched
    evaluation of about a minute here (the f32 adjoint's fixed point and
    GMRES fallback run to their caps in many steps); from the default
    guess, or in a second iteration, the line search backtracks about ten
    times, which overran the script's time limit.  The demo runs
    TRAINER_STEPS of its 200 steps, so that phase 11 fits the limit too."""
    from diffcloth_tpu_torch.optim.solver import solve_demo

    P = 4

    def report(k, X, F):
        log(f"[trainer] iteration {k}: losses "
            f"{np.array2string(F, precision=6)}")

    with demo_steps("wind", TRAINER_STEPS):
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
def demo_steps(name, steps, scene=None):
    """Inside the block, the registry's demo `name` runs `scene` (None: its
    own) for `steps` steps (None: as the scene says)."""
    import dataclasses
    from diffcloth_tpu_torch.tasks import registry
    task = registry.DEMOS[name]
    scene = scene or task.scene
    if steps is not None:
        scene = dataclasses.replace(scene, step_num=steps)
    registry.DEMOS[name] = dataclasses.replace(task, scene=scene)
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
    from diffcloth_tpu_torch.core import step as step_mod
    ce = step_mod.CHECK_EVERY
    return np.minimum(-(-iters.max(axis=0) // ce) * ce,
                      sim.max_forward_iters)


def phase_sphere_forward(card, B, steps=None, device=None):
    """The obstacle path's forward: `build_task("sphere")` (its ground
    truth a 1-episode rollout at mu = 0.3), then one batched rollout of B
    friction coefficients.  Returns (task, helper, X, forward sweeps)."""
    import torch
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
    zero_counters()
    t0 = time.perf_counter()
    recs = sim.rollout(params)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counters()
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

    sim = task.sim
    B, N = X.shape[0], sim.n_steps
    torch.cuda.synchronize()
    zero_counters()
    sim.bwd_stats.reset()
    t0 = time.perf_counter()
    L, G = helper.batched_loss_and_grad(X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
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
    check_launches("sphere-gradient", launches, N, fwd_sweeps, st, passes=2)
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
    return launches


def adjoint_entries(sim, x, v, params, x_fixed, p_inv, t, step_idx):
    """One step from (x, v) and its backward at a fixed cotangent, on a sim
    whose programs run uncaptured: the dict its adjoint program read and
    wrote (its inputs, its start's entries, the linearization of K)."""
    import torch
    x = x.detach().clone().requires_grad_(True)
    x1, v1, aux = sim.step(x, v.detach(), params, x_fixed, p_inv, t,
                           step_idx)
    gen = torch.Generator().manual_seed(0)
    cot = [torch.randn(a.shape, generator=gen, dtype=a.dtype).to(a.device)
           for a in (x1, v1)]
    torch.autograd.grad([x1, v1], x, cot)
    return sim.step.graphs.bind(("adj", x.shape[0], x.dtype, ()), {}), aux


def phase_adjoint_kernels(tag, sim, params, x, v, k, suffix=""):
    """The adjoint's kernels (`csrc/adjoint_linear.cu`) on the entries of
    the adjoint program of step k + 1 from (x, v) (`sim` uncaptured), each
    against its plain version exactly and timed beside it (the plain
    version on the card's tensors) and beside its bound, the larger of
    its bytes at HBM speed and its operations at the f32 peak.  Returns
    the JSON line's entries (launches 0: the caller's path counts them)."""
    import torch
    from diffcloth_tpu_torch.core import adjoint_linear as al
    from diffcloth_tpu_torch.core import friction_cuda as fc

    dev = x.device
    B, n = x.shape[0], sim.n
    t = torch.tensor((k + 1) * sim.h, dtype=x.dtype, device=dev)
    xf, p_inv = sim.x_fixed_seq(params)[:, k], sim.p_inv(params)
    st, aux = adjoint_entries(sim, x, v, params, xf, p_inv, t, k + 1)
    lin = sim.step.lin
    counts, split, consts = lin.counts, lin.split, lin.consts
    T, Bn, F, S = counts
    R = 2 * T + Bn + F + S
    y = lin.rows_at(st["x_n"] + sim.h * st["v_new"])
    obs = None
    if "kdv_jobs" in st:
        obs = (aux.f.detach(), st["m"], st["c_normal"], st["c_v_out"],
               st["c_mask"], st["c_prim"], st["mu"])
    rng = np.random.RandomState(4)
    u = torch.as_tensor(rng.randn(B, n, 3), dtype=torch.float32, device=dev)
    s = (fc.friction_sweep_bwd(u, st["kdv_vals"], st["ops"])[0]
         if "kdv_vals" in st else None)
    jobs = st.get("kdv_jobs")
    H = 2 if (s is not None or jobs is not None) else 1
    rows = torch.as_tensor(rng.randn(R, H, B, 3), dtype=torch.float32,
                           device=dev).permute(1, 2, 0, 3)
    h2 = sim.h * sim.h
    lam = torch.as_tensor(rng.randn(B, n, 3), dtype=torch.float32,
                          device=dev)
    # deltas far from eps either way: 1e-3 or 1e-7 a coordinate, by turns
    size = np.where(np.arange(B) % 2 == 0, 1e-3, 1e-7)[:, None, None]
    nxt = lam + torch.as_tensor(size * rng.randn(B, n, 3),
                                dtype=torch.float32, device=dev)
    w_norm = torch.ones(B, device=dev)
    flags = (torch.ones(B, dtype=torch.int32, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev))
    nh = n / 180.0
    cpu = (lambda a: None if a is None else a.detach().cpu())

    def err(got, want):
        got, want = cpu(got), cpu(want)
        if got.shape != want.shape:
            raise AssertionError(f"{got.shape} against {want.shape}")
        return float((got.double() - want.double()).abs().max()
                     .nan_to_num(float("inf")))

    errs = {}
    # the row Jacobians as the adjoint stored them, and the kernel's and
    # the plain version's at its rows; J_obs at the step's last PD sweep's
    # f (the adjoint's own f is not stored)
    jac, jo = al.linearize(y, *consts, counts, split, obs)
    want_jac, want_jo = al.linearize_plain(y, *consts, counts, split, obs)
    errs["kdv_linearize"] = max(err(jac, want_jac), err(st["kdv_jac"],
                                                        want_jac))
    if obs is not None:
        errs["kdv_linearize"] = max(errs["kdv_linearize"], err(jo, want_jo))
    zg = al.kdv_pre(u, s, jobs, H, split)
    want = torch.empty((H, B, n, 3))
    al.kdv_pre_plain(cpu(u), cpu(s), cpu(jobs), want)
    errs["kdv_pre"] = err(zg, want)
    q = al.kdv_rows(rows, st["kdv_jac"], st["k_pertype"], h2, counts, split,
                    split)
    want = torch.empty((B, R, 3))
    al.kdv_rows_plain(cpu(rows), cpu(st["kdv_jac"]), cpu(st["k_pertype"]),
                      h2, want, counts, split)
    errs["kdv_rows"] = err(q, want)
    got = [lam.clone(), nxt, w_norm] + [f.clone() for f in flags]
    want = [cpu(a).clone() for a in got]
    al.trip_update(*got, 1e-5, nh)
    al.trip_update_plain(*want, 1e-5, nh)
    errs["trip_update"] = max(err(a, b) for a, b in zip(got, want))
    if not bool(cpu(got[4]).any()) or bool(cpu(got[4]).all()):
        raise AssertionError(f"[{tag}] trip_update: every episode or none "
                             f"converged, {cpu(got[4]).tolist()}")
    bad = {k_: e for k_, e in errs.items() if e != 0.0}
    if bad:
        raise AssertionError(f"[{tag}] kernel != plain: {bad}")

    W = al.jac_width(T, Bn, S)
    on = B * n if obs is not None else 0
    # bytes each call moves and operations it makes (f32; the stretch
    # Jacobian's forward mode about 600 a triangle)
    work = {
        "kdv_linearize": (4 * (B * R * 3 + T + Bn + S + B * W)
                          + on * (4 * 19 + 1 + 8),
                          B * (600 * T + 20 * (Bn + S)) + on * 60),
        "kdv_pre": (4 * B * n * (3 + 3 * (s is not None)
                                 + 9 * (jobs is not None) + 3 * H),
                    B * n * 30),
        "kdv_rows": (4 * (H * B * R * 3 + B * W + 4 * B + B * R * 3),
                     B * (90 * T + 25 * (Bn + S) + 3 * F)),
        "trip_update": (4 * 3 * B * n * 3, 8 * B * n * 3),
    }
    calls = {
        "kdv_linearize": (lambda: al.linearize(y, *consts, counts, split,
                                               obs),
                          lambda: al.linearize_plain(y, *consts, counts,
                                                     split, obs),
                          "linearize_kernel"),
        "kdv_pre": (lambda: al.kdv_pre(u, s, jobs, H, split),
                    lambda: al.kdv_pre_plain(
                        u, s, jobs, torch.empty((H, B, n, 3), device=dev)),
                    "pre_kernel"),
        "kdv_rows": (lambda: al.kdv_rows(rows, st["kdv_jac"],
                                         st["k_pertype"], h2, counts, split,
                                         split),
                     lambda: al.kdv_rows_plain(
                         rows, st["kdv_jac"], st["k_pertype"], h2,
                         torch.empty((B, R, 3), device=dev), counts, split),
                     "rows_kernel"),
        "trip_update": (lambda: al.trip_update(
            lam.clone(), nxt, w_norm, *[f.clone() for f in flags], 1e-5,
            nh),
            lambda: al.trip_update_plain(
                lam.clone(), nxt, w_norm, *[f.clone() for f in flags],
                1e-5, nh),
            "update_kernel"),
    }
    entries = []
    for name, (fn, plain, sym) in calls.items():
        ms = device_ms(fn, kernel=sym)
        plain_ms = device_ms(plain, reps=5)
        nbytes, ops = work[name]
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        by = ("bytes" if nbytes / HBM_BYTES_PER_S > ops / F32_FLOPS
              else "operations")
        if ms < bound:
            raise AssertionError(f"[{tag}] {name}: {ms} ms of device time "
                                 f"per call, below its bound {bound} ms")
        log(f"[{tag}] {name}: kernel == plain exactly; device ms per call "
            f"kernel {ms:.5f}, plain {plain_ms:.5f} (profiler); bound "
            f"{bound:.5f} ({by}: {nbytes / 1e6:.3f} MB, "
            f"{ops / 1e6:.3f} Mop)")
        entries.append(dict(
            name=name + suffix, route="cuda",
            source="diffcloth_tpu_torch/csrc/adjoint_linear.cu",
            replaces=None, launches=0, max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None))
    log(f"[{tag}] (B={B}, n={n}, rows {counts}, "
        f"{'dense split' if split else 'sparse interleaved'}; "
        f"{int(st['c_mask'].sum()) if 'c_mask' in st else 0} obstacle "
        f"contacts, {int(st['counts'].sum()) if 'counts' in st else 0} "
        f"friction slots)")
    return entries


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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def sphere_reference_side(dev, steps=SPHERE_REF_STEPS):
    """One device's side of `phase_sphere_reference`: the f64 episode and
    the batched loss and dL/dmu at mu 0.1 and 0.5."""
    import torch
    from diffcloth_tpu_torch.optim.helper import OptimizeHelper
    from diffcloth_tpu_torch.tasks.setup import build_task
    X = np.array([[0.1], [0.5]])
    with demo_steps("sphere", steps):
        task = build_task("sphere", dtype=torch.float64, device=dev)
    helper = OptimizeHelper(task.sim, task.mask, task.loss_fn(),
                            param_base=task.param_base)
    st = task.sim.rollout(helper.stack_vecs(X)).steps
    L, G = helper.batched_loss_and_grad(X)
    return dict(x=st.x.cpu(), iters=st.iters.cpu(),
                converged=st.converged.cpu(),
                obstacle_contacts=st.obstacle_contacts.cpu(), L=L, G=G)


def phase_sphere_reference(steps=SPHERE_REF_STEPS):
    """The sphere scene cut to `steps` steps, B = 2 (mu 0.1 and 0.5, on
    both sides of the ground truth's 0.3), f64: the episode and dL/dmu on
    the card against the same calls on the CPU (the CPU path is held to the
    JAX package by the tests; its side from the process beside the card
    phases, `cpu_side`).  The cloth reaches the sphere after about 10
    steps and lies on it from then on: at 60 steps the CPU gives 5477
    particle-steps in contact and dL/dmu -3.0e-5 and 6.3e-6, so every
    lane's dL/dmu must exceed 1e-6 in size before the two are compared
    (within 1e-6 of the largest entry)."""
    import torch
    c = cpu_side("sphere-reference", lambda: sphere_reference_side("cpu",
                                                                   steps))
    g = sphere_reference_side("cuda", steps)
    Lc, Gc, Lg, Gg = c["L"], c["G"], g["L"], g["G"]
    err = float((g["x"] - c["x"]).abs().max())
    d_it = int((g["iters"] - c["iters"]).abs().max())
    g_rel = float(np.abs(Gg - Gc).max() / max(np.abs(Gc).max(), 1e-300))
    contacts = int(c["obstacle_contacts"].sum())
    if contacts == 0 or not (np.abs(Gc) > 1e-6).all():
        raise AssertionError(f"the reference episode lacks obstacle contact "
                             f"({contacts} particle-steps) or a dL/dmu above "
                             f"1e-6 in every lane ({Gc[:, 0]})")
    if (err > 1e-6 or d_it > 1 or g_rel > 1e-6
            or not torch.equal(g["converged"], c["converged"])
            or not torch.equal(g["obstacle_contacts"],
                               c["obstacle_contacts"])):
        raise AssertionError(f"card vs CPU: max |dx| {err}, iters differ "
                             f"by {d_it}, dL/dmu {Gg[:, 0]} vs {Gc[:, 0]}")
    if not np.allclose(Lg, Lc, rtol=1e-9, atol=0):
        raise AssertionError(f"card vs CPU loss {Lg} vs {Lc}")
    log(f"[sphere-reference] {steps} steps, f64, B=2 (mu 0.1, 0.5): card vs "
        f"CPU max |dx| {err:.3e} (tolerance 1e-6), iters within {d_it}, "
        f"obstacle contacts equal ({contacts} particle-steps); loss "
        f"{Lg.tolist()} vs {Lc.tolist()}; dL/dmu {Gg[:, 0].tolist()} vs "
        f"{Gc[:, 0].tolist()}, max error / largest entry {g_rel:.1e} "
        f"(tolerance 1e-6)")


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
        task, helper, X, sweeps = phase_sphere_forward(card, SPHERE_BATCH,
                                                       SPHERE_STEPS)
    with timed("sphere kernels"):
        phase_kernels("sphere-kernels", task.sim,
                      initial_states(task.sim, SPHERE_BATCH),
                      np.random.RandomState(1), mu=X)
    with timed("sphere gradient"):
        launches = phase_sphere_gradient(task, helper, X, sweeps, card)
    del task, helper
    with timed("sphere adjoint kernels"):
        import torch
        from diffcloth_tpu_torch.tasks.setup import build_task
        with demo_steps("sphere", SPHERE_ADJ_STEPS + 1):
            adj = build_task("sphere", device="cuda", cuda_graphs=False)
        p = adj.param_base.expand(SPHERE_BATCH)
        mu = p.mu.clone()
        mu[:, 0] = torch.as_tensor(X[:, 0], dtype=mu.dtype, device="cuda")
        p = p.replace(mu=mu)
        recs = adj.sim.rollout_chunked(p, 50).steps
        entries = phase_adjoint_kernels(
            "sphere-adjoint", adj.sim, p, recs.x[:, -2], recs.v[:, -2],
            SPHERE_ADJ_STEPS)
        for e in entries:
            e["launches"] = launches[e["name"]]
        del adj, recs
    with timed("sphere profile"):
        phase_sphere_profile(SPHERE_BATCH, 10, card)
    with timed("sphere reference"):
        phase_sphere_reference()
    with timed("sphere fit"):
        phase_sphere_fit(card, SPHERE_FIT_STEPS)
    return entries


def large_mesh(dtype, device, steps, grid=LARGE_GRID, **sim_kw):
    """The flagship stand-in's physics on a grid x grid cloth (the large-mesh
    scene, 128 x 128 = 16 384 vertices), cut to `steps` steps."""
    import dataclasses
    from diffcloth_tpu_torch.core.sim import ClothSim
    from diffcloth_tpu_torch.geometry import builder as gb
    from diffcloth_tpu_torch.tasks.registry import TSHIRT_GRID_STANDIN
    cfg = TSHIRT_GRID_STANDIN
    cfg = dataclasses.replace(cfg, step_num=steps, fabric=dataclasses.replace(
        cfg.fabric, grid_num_x=grid, grid_num_y=grid))
    return ClothSim(gb.build_scene(cfg), device=device, dtype=dtype,
                    **sim_kw)


def large_modes(sim):
    return (sim.solve_mode, "sparse" if sim.sparse is not None else "dense",
            sim.self_cfg.method)


def zero_counters():
    """Zero the kernels' launch counts (kept on the device by the kernels
    themselves, `core/launch_count.py`)."""
    from diffcloth_tpu_torch.core import launch_count as lc
    lc.zero()


def read_counters():
    """{counter: launches since zero_counters()} (one device read)."""
    from diffcloth_tpu_torch.core import launch_count as lc
    return lc.read_all()


def phase_large_forward(sim, B, card):
    """11a: the large-mesh scene's batched forward episode on the card.  The
    size switches must pick CG, sparse operators and the sweep, and the
    friction sweeps the global-state route.  Returns the counters."""
    import torch
    if large_modes(sim) != ("cg", "sparse", "sweep"):
        raise AssertionError(f"n = {sim.n} took {large_modes(sim)}, not "
                             f"cg, sparse operators and the sweep")
    params = episode_params(sim, B)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    recs = sim.rollout(params)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counters()
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
    iters = st.iters.cpu().numpy()
    sweeps = int(pd_sweeps(iters, sim).sum())
    if launches["selfcol_detect"] != 0:
        raise AssertionError(f"the detection kernel ran on the sweep path: "
                             f"{launches}")
    if not (launches["friction_fwd"] == launches["friction_fwd_global"]
            == sweeps):
        raise AssertionError(f"friction launches {launches}, not once per PD "
                             f"sweep ({sweeps}) on the global-state route")
    pairs = st.selfcol_pairs.cpu().numpy()
    if pairs[0::2].sum() == 0:
        raise AssertionError("no folded step saw a self-contact")
    cg_per_solve = float(st.cg_iters.sum()) / float(st.iters.sum())
    slots = st.selfcol_slots.cpu().numpy()
    log(f"[large] n = {sim.n}: modes {large_modes(sim)} (solve, operators, "
        f"self-collision), window {sim.self_cfg.window}, cap_pairs "
        f"{sim.self_cfg.cap_pairs}; friction sweeps on the global-state "
        f"route")
    log(f"[large] forward {N} steps x B={B} on {card}: {elapsed:.2f} s, "
        f"{B * N / elapsed:.2f} PD steps/s, converged {conv:.4f}, mean "
        f"iters {iters.mean():.2f} ({sweeps / N:.2f} PD sweeps per step), "
        f"{cg_per_solve:.2f} CG iterations per solve (cap "
        f"{sim.cg_max_iters}, rtol {sim.cg_rtol}), "
        f"{elapsed * 1e3 / sweeps:.3f} ms wall per PD sweep")
    log(f"[large] self-contact pairs per step: folded episodes "
        f"{pairs[0::2].mean():.1f} (max {int(pairs.max())}), flat "
        f"{pairs[1::2].mean():.1f}; {slots[0::2].mean():.1f} friction slots "
        f"per folded episode-step; overflow in "
        f"{int(st.selfcol_overflow.sum())} of {st.selfcol_overflow.numel()} "
        f"episode-steps ({int(st.selfcol_overflow[0::2].sum())} folded); "
        f"launches {launches}")
    return launches


def phase_large_kernels(sim, B, rng):
    """11a': both friction kernels on the global-state route at the large
    scene's n and B, on slot geometry from the sweep pipeline (folded and
    flat states perturbed as in phase 2), against their plain versions."""
    import torch
    from diffcloth_tpu_torch.core import friction_cuda as fc
    from diffcloth_tpu_torch.core import selfcol as sc
    cfg = sim.self_cfg
    n, h, dev = sim.n, sim.h, sim.device
    x, v = kernel_states(sim, initial_states(sim, B), rng)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    vt = torch.as_tensor(v, dtype=torch.float32, device=dev)
    cs = sc.detect_self_collisions_sweep(cfg.allowed, sim.scene_dev.radii,
                                         xt, vt, h, cfg.window,
                                         cfg.cap_pairs)
    cs = sc.assign_layers(cs, n, cfg.max_layers)
    tables = sc.build_layer_tables(cs, n, cfg.max_layers)
    kg = fc.build_kernel_geom(tables, sim.scene_dev.area, n, cfg.budgets,
                              x=xt)
    density = torch.full((B,), sim.cfg.fabric.density, dtype=torch.float32,
                         device=dev)
    f = torch.as_tensor(rng.randn(B, n, 3) * 0.05, dtype=torch.float32,
                        device=dev)
    g = torch.as_tensor(rng.randn(B, n, 3), dtype=torch.float32, device=dev)
    log(f"[large-kernels] sweep pipeline on (B={B}, n={n}): "
        f"{int(cs.mask.sum())} layered pairs, {int(tables.n_layers.max())} "
        f"layers, overflow in {int(cs.overflow.sum())} samples")
    sweeps, bounds, _ = check_sweeps("large-kernels", kg,
                                     fc.slot_masses(kg, density), f, g, n,
                                     cfg, route="global")
    return sweep_entries(sweeps, bounds, "_global", "global")


def phase_large_gradient(sim, B, card, fwd_sweeps):
    """11b: the batched value-and-grad of GradMask(f_wind=True) against the
    base wind's rollout through the optimizer's objective, on the large
    scene, of 11a's episodes (`fwd_sweeps`: the forward sweep's launches in
    11a).  Returns the counters."""
    import torch
    from diffcloth_tpu_torch.optim.helper import GradMask, OptimizeHelper

    params = episode_params(sim, B)
    loss_fn = base_wind_target(sim, params)
    helper = OptimizeHelper(sim, GradMask(f_wind=True), loss_fn,
                            param_base=params)
    X = np.stack([helper.params_to_vec(params.sample(i)) for i in range(B)])
    torch.cuda.synchronize()
    zero_counters()
    sim.bwd_stats.reset()
    t0 = time.perf_counter()
    L, G = helper.batched_loss_and_grad(X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    st = sim.bwd_stats.summary()
    N = sim.n_steps
    if not (np.isfinite(L).all() and np.isfinite(G).all()):
        raise AssertionError("non-finite loss or gradient")
    if not ((L > 0).all() and (np.abs(G).max(axis=1) > 0).all()):
        raise AssertionError("a zero loss or gradient")
    # chunked: the backward recomputes the forward's sweeps
    if launches["friction_fwd"] != 2 * fwd_sweeps + 2 * st["residual_vjps"]:
        raise AssertionError(
            f"friction_fwd launched {launches['friction_fwd']} times, not "
            f"the forward's {fwd_sweeps} twice plus two per adjoint program "
            f"(the linearization and the residual VJP, "
            f"{st['residual_vjps']:.0f} programs)")
    if not (launches["friction_bwd"] == launches["friction_bwd_global"]
            == st["launches"]):
        raise AssertionError(
            f"friction_bwd launched {launches}, not once per adjoint trip "
            f"({st['trips']:.0f}), GMRES matvec ({st['gmres_matvecs']:.0f}) "
            f"and residual VJP ({st['residual_vjps']:.0f}) on the "
            f"global-state route")
    split = helper.last_split
    log(f"[large-gradient] {N} steps x B={B} on {card}: {wall:.2f} s, "
        f"{B * N / wall:.2f} episode-gradient steps/s; forward "
        f"{split['forward_s']:.2f} s, backward {split['backward_s']:.2f} s "
        f"({100 * split['backward_s'] / wall:.1f} %); loss mean "
        f"{L.mean():.6e}; |dL/dwind| max {np.abs(G[:, :3]).max():.3e}")
    log(f"[large-gradient] adjoint: "
        f"{st['lane_trips'] / st['lane_steps']:.2f} trips per episode-step, "
        f"{st['fallback_lanes']:.0f} of {st['lane_steps']:.0f} episode-steps "
        f"fell to GMRES ({st['gmres_matvecs']:.0f} matvecs), "
        f"{st['residual_vjps']:.0f} residual VJPs; "
        f"{st['cg_iters'] / max(st['cg_solves'] * B, 1):.2f} CG iterations "
        f"per episode-solve over {st['cg_solves']:.0f} solves; launches "
        f"{launches}")
    return launches


def phase_large_reference(grid, B, steps, modes):
    """11d: an f64 episode of the large-mesh physics on a grid x grid cloth
    on the card against the CPU (the CPU path is held to the JAX package by
    the tests), the first episode folded; the size switches must pick
    `modes` on both."""
    import torch
    out = {}
    for dev in ("cuda", "cpu"):
        sim = large_mesh(torch.float64, dev, steps, grid)
        if large_modes(sim) != modes:
            raise AssertionError(f"{grid} x {grid} on {dev} took "
                                 f"{large_modes(sim)}, not {modes}")
        x0 = initial_states(sim, B)
        winds = np.array([[0.5, 0.05, 0.5], [0.2, 0.0, 0.4]])[:B]
        p = sim.default_params().expand(B).replace(
            x0=torch.as_tensor(x0, dtype=torch.float64, device=sim.device),
            wind=torch.as_tensor(winds, dtype=torch.float64,
                                 device=sim.device))
        t0 = time.perf_counter()
        out[dev] = sim.rollout(p).steps
        log(f"[large-reference] {grid} x {grid}, {steps} steps, B={B} on "
            f"{dev}: {time.perf_counter() - t0:.1f} s")
    g, c = out["cuda"], out["cpu"]
    err = float((g.x.cpu() - c.x).abs().max())
    d_it = int((g.iters.cpu() - c.iters).abs().max())
    if int(c.selfcol_pairs.sum()) == 0:
        raise AssertionError("the reference episode has no self-contact")
    if err > 1e-6 or d_it > 1 or not torch.equal(g.converged.cpu(),
                                                 c.converged):
        raise AssertionError(f"card vs CPU: max |dx| {err}, iters differ "
                             f"by {d_it}")
    log(f"[large-reference] {grid} x {grid} (n = {grid * grid}, modes "
        f"{modes}), {steps} steps, f64, B={B}: card vs CPU max |dx| "
        f"{err:.3e} (tolerance 1e-6), iters within {d_it}, "
        f"{int(c.selfcol_pairs.sum())} self-contact pairs, CG iterations "
        f"{int(g.cg_iters.sum())} (card) and {int(c.cg_iters.sum())} (CPU)")


def phase_large_parts(seed=3):
    """11d (2): the large scene's own modules in f64 on the card against the
    CPU, at its folded and flat states (B = 2) with random velocities:
    the sweep pipeline (pairs, layers, partner tables and overflow
    exactly), the sparse operators (A^T A and the projections) and one CG
    solve at the path's caps (its iterations equal, the solution within
    1e-6).  An episode is not compared at this size: with the CG caps the
    PD loop does not converge at n = 16 384 and ends by its plateau exit at
    a sweep that rounding decides (on the CPU alone, x0 moved by 1e-13
    ends one step 4 sweeps apart and 1.6e-2 away)."""
    import torch
    from diffcloth_tpu_torch.core import selfcol as sc
    from diffcloth_tpu_torch.core import sparse_ops as spo
    from diffcloth_tpu_torch.core import step as step_mod

    rng = np.random.RandomState(seed)
    out = {}
    v_np = rhs_np = None
    for dev in ("cuda", "cpu"):
        sim = large_mesh(torch.float64, dev, 1)
        if large_modes(sim) != ("cg", "sparse", "sweep"):
            raise AssertionError(f"{dev}: {large_modes(sim)}")
        n, cfg = sim.n, sim.self_cfg
        if v_np is None:
            v_np = rng.randn(2, n, 3) * 0.5
            rhs_np = rng.randn(2, n, 3)
        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa
                                        device=sim.device)
        x, v = f64(initial_states(sim, 2)), f64(v_np)
        t0 = time.perf_counter()
        cs = sc.detect_self_collisions_sweep(cfg.allowed, sim.scene_dev.radii,
                                             x, v, sim.h, cfg.window,
                                             cfg.cap_pairs)
        cs = sc.assign_layers(cs, n, cfg.max_layers)
        tables = sc.build_layer_tables(cs, n, cfg.max_layers)
        p = sim.default_params().expand(2)
        k = p.k_pertype
        m = p.density[:, None] * sim.scene_dev.area
        proj = spo.projections(sim.sparse, sim.scene_dev, x,
                               sim.x_fixed_seq(p)[:, 0])
        ata = spo.apply_AtA(sim.sparse, k, x)
        h2 = sim.h * sim.h
        u, it = step_mod.pcg(
            lambda q: m[..., None] * q + h2 * spo.apply_AtA(sim.sparse, k, q),
            f64(rhs_np), sim.p_inv(p), sim.cg_max_iters, sim.cg_rtol)
        out[dev] = {"pair_i": cs.pair_i, "pair_j": cs.pair_j,
                    "mask": cs.mask, "layer": cs.layer,
                    "overflow": cs.overflow, "partner": tables.partner,
                    "ata": ata, "u": u, "it": it,
                    **{f"proj{i}": t for i, t in enumerate(proj)}}
        out[dev] = {key: t.cpu() for key, t in out[dev].items()}
        log(f"[large-reference] {LARGE_GRID} x {LARGE_GRID} modules on {dev}: "
            f"{time.perf_counter() - t0:.1f} s")
    g, c = out["cuda"], out["cpu"]
    for key in ("pair_i", "pair_j", "mask", "layer", "overflow", "partner",
                "it"):
        if not torch.equal(g[key], c[key]):
            raise AssertionError(f"card vs CPU: the sweep pipeline's {key} "
                                 f"differs")
    errs = {key: float((g[key] - c[key]).abs().max()) for key in g
            if (key.startswith("proj") or key in ("ata", "u"))
            and g[key].numel()}
    if max(errs.values()) > 1e-6:
        raise AssertionError(f"card vs CPU: {errs}")
    if int(c["mask"].sum()) == 0:
        raise AssertionError("the large reference state has no contact")
    log(f"[large-reference] {LARGE_GRID} x {LARGE_GRID} modules, f64, B=2 "
        f"(folded, flat): "
        f"card vs CPU: {int(c['mask'].sum())} layered pairs, their layers "
        f"and partner tables equal, overflow {c['overflow'].tolist()}; "
        f"max |error| (tolerance 1e-6): "
        + ", ".join(f"{key} {e:.1e}" for key, e in errs.items())
        + f"; CG iterations {c['it'].tolist()} on both")


def run_large_mesh(card, timed):
    """Phase 11, the large-mesh path.  Returns the JSON line's entries of
    the sweeps' global-state route, their launches counted on this path."""
    import torch
    with timed("large forward"):
        sim = large_mesh(torch.float32, "cuda", LARGE_STEPS)
        fwd = phase_large_forward(sim, LARGE_BATCH, card)
    with timed("large kernels"):
        entries = phase_large_kernels(sim, LARGE_BATCH,
                                      np.random.RandomState(2))
    with timed("large gradient"):
        bwd = phase_large_gradient(sim, LARGE_BATCH, card,
                                   fwd["friction_fwd"])
    del sim
    with timed("large adjoint kernels"):
        sim = large_mesh(torch.float32, "cuda", 1, cuda_graphs=False)
        p = episode_params(sim, LARGE_BATCH)
        x0 = torch.as_tensor(initial_states(sim, LARGE_BATCH),
                             dtype=torch.float32, device="cuda")
        adj = phase_adjoint_kernels("large-adjoint", sim, p, x0,
                                    torch.zeros_like(x0), 0, "_large")
        for e in adj:
            e["launches"] = bwd[e["name"][:-len("_large")]]
    del sim
    with timed("large profile"):
        sim = large_mesh(torch.float32, "cuda", LARGE_PROFILE_STEPS)
        phase_profile("large-profile", sim, episode_params(sim, LARGE_BATCH),
                      card, kernels=(("friction_fwd", "friction_kernel"),))
    del sim
    with timed("large reference"):
        phase_large_reference(LARGE_REF_GRID, 2, LARGE_REF_STEPS,
                              ("dense", "sparse", "kernel"))
        phase_large_parts()
    entries[0]["launches"] = fwd["friction_fwd_global"]
    entries[1]["launches"] = bwd["friction_bwd_global"]
    return entries + adj


def dress_task(steps=None, dtype=None, device=None, **changes):
    """build_task("dress") on the dress stand-in (registry.
    dress_grid_standin: the DRESS_V7K_DRAPE physics and twirl on a
    DRESS_GRID x DRESS_GRID grid, 31 clips), cut to `steps` steps;
    `changes` replace fields of its SceneConfig."""
    import dataclasses
    import torch
    from diffcloth_tpu_torch.tasks.registry import dress_grid_standin
    from diffcloth_tpu_torch.tasks.setup import build_task
    scene = dataclasses.replace(dress_grid_standin(DRESS_GRID), **changes)
    with demo_steps("dress", steps, scene):
        return build_task("dress", dtype=dtype or torch.float32,
                          device=device)


def check_launches(tag, launches, n_steps, fwd_sweeps, bwd=None, passes=1):
    """Detection once per step, the forward sweep once per PD sweep of the
    forward (`fwd_sweeps`) plus, on a gradient path (bwd: its
    BackwardStats summary), twice per adjoint program (the linearization
    at its start and the residual VJP, one each per residual VJP), and
    the backward sweep once per adjoint trip, GMRES matvec and residual
    VJP; passes=2 for a chunked value-and-grad, whose backward recomputes
    the forward."""
    want_fwd = passes * fwd_sweeps + (2 * bwd["residual_vjps"] if bwd
                                      else 0)
    n_steps = passes * n_steps
    if launches["selfcol_detect"] != n_steps:
        raise AssertionError(f"[{tag}] detection launched {launches}, not "
                             f"once per step ({n_steps})")
    if launches["friction_fwd"] != want_fwd:
        raise AssertionError(f"[{tag}] friction_fwd launched {launches}, not "
                             f"{want_fwd} (the forward's PD sweeps"
                             + (" plus two per adjoint program)" if bwd
                                else ")"))
    if bwd and launches["friction_bwd"] != bwd["launches"]:
        raise AssertionError(f"[{tag}] friction_bwd launched {launches}, not "
                             f"once per adjoint trip, GMRES matvec and "
                             f"residual VJP ({bwd['launches']:.0f})")


def phase_dress_forward(task, card):
    """12b: the dress stand-in's forward episode (B = 1, f32) through
    `simulate`, the host P^{-1} timed on its own first.  Returns (the
    counters, the forward sweep's launches)."""
    import torch
    sim = task.sim
    if large_modes(sim) != ("dense", "sparse", "kernel"):
        raise AssertionError(f"the dress stand-in took {large_modes(sim)}, "
                             f"not the dense P^-1, sparse operators and the "
                             f"detection kernel")
    params = task.param_base.expand(1)
    t0 = time.perf_counter()
    p_inv = sim.p_inv(params)
    torch.cuda.synchronize()
    inv_s = time.perf_counter() - t0
    xfs = sim.x_fixed_seq(params)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    recs = sim.simulate(params, p_inv, xfs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counters()
    st = recs.steps
    N = sim.n_steps
    if tuple(st.x.shape) != (1, N, sim.n, 3):
        raise AssertionError(f"trajectory shape {tuple(st.x.shape)}")
    if not (bool(torch.isfinite(st.x).all())
            and bool(torch.isfinite(st.v).all())):
        raise AssertionError("non-finite trajectory")
    iters = st.iters.cpu().numpy()
    sweeps = int(pd_sweeps(iters, sim).sum())
    check_launches("dress", launches, N, sweeps)
    pairs = st.selfcol_pairs.cpu().numpy()[0]
    twist = float((st.x_fixed[0, -1] - st.x_fixed[0, 0]).norm(dim=-1).max())
    log(f"[dress] n = {sim.n} ({DRESS_GRID} x {DRESS_GRID}), "
        f"{len(sim.stage_host.particle_idx)} clips, {N} steps at h = "
        f"{sim.h:.6f}; modes {large_modes(sim)} (solve, operators, "
        f"self-collision), n_pad {sim.self_cfg.allowed.shape[0]}, "
        f"admissibility table {sim.self_cfg.allowed.numel() / 1e6:.1f} MB; "
        f"the clips moved up to {twist:.3f} by the twirl")
    log(f"[dress] forward {N} steps x B=1 on {card}: {elapsed:.2f} s, "
        f"{N / elapsed:.2f} PD steps/s, converged "
        f"{float(st.converged.float().mean()):.4f}, "
        f"{sweeps / N:.2f} PD sweeps per step, "
        f"{elapsed * 1e3 / sweeps:.3f} ms wall per PD sweep; host P^-1 "
        f"(f64 Cholesky inverse of {sim.n} x {sim.n}, to the card) "
        f"{inv_s:.2f} s per evaluation")
    log(f"[dress] self-contact in {int((pairs > 0).sum())} of {N} steps "
        f"(pairs per step mean {pairs.mean():.1f}, max {int(pairs.max())}), "
        f"overflow in {int(st.selfcol_overflow.sum())} steps; launches "
        f"{launches}")
    return launches, sweeps


def phase_dress_gradient(task, card, fwd_sweeps):
    """12c: the dress loss's value-and-grad over the dress mask (density,
    k_bend) through the optimizer's objective at the scene's parameters.
    Returns the counters."""
    import torch
    from diffcloth_tpu_torch.optim.helper import OptimizeHelper
    sim = task.sim
    helper = OptimizeHelper(sim, task.mask, task.loss_fn(),
                            param_base=task.param_base)
    x = helper.params_to_vec(task.param_base)
    torch.cuda.synchronize()
    zero_counters()
    sim.bwd_stats.reset()
    t0 = time.perf_counter()
    L, G = helper.loss_and_grad(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    st = sim.bwd_stats.summary()
    N = sim.n_steps
    if not (np.isfinite(L) and np.isfinite(G).all() and np.abs(G).max() > 0):
        raise AssertionError(f"dress loss {L}, gradient {G}")
    if not helper.chunked:
        raise AssertionError("the dress (n = 7056) fit is not chunked")
    check_launches("dress-gradient", launches, N, fwd_sweeps, st, passes=2)
    split = helper.last_split
    log(f"[dress-gradient] {N} steps x B=1 on {card}: {wall:.2f} s "
        f"({N / wall:.2f} episode-gradient steps/s; host P^-1, forward "
        f"{split['forward_s']:.2f} s, backward {split['backward_s']:.2f} s); "
        f"loss {L:.6e}, dL/d(density, k_bend) "
        f"{np.array2string(G, precision=4)}")
    log(f"[dress-gradient] adjoint: "
        f"{st['lane_trips'] / max(st['lane_steps'], 1):.2f} trips per step, "
        f"{st['fallback_lanes']:.0f} of {st['lane_steps']:.0f} steps fell "
        f"to GMRES ({st['gmres_matvecs']:.0f} matvecs), "
        f"{st['residual_vjps']:.0f} residual VJPs; launches {launches}")
    return launches


def phase_dress_fit(card):
    """12d: solve_demo("dress") on the stand-in cut to DRESS_FIT_STEPS
    steps, 2 iterations, with export_dir, checkpoint_dir and export_iters;
    a run resumed from its checkpoint to 3 iterations; and the exported
    final episode re-imported, equal to the records of the same rollout
    (to the files' 8 decimals)."""
    import tempfile
    import torch
    from diffcloth_tpu_torch.io import export as ioexp
    from diffcloth_tpu_torch.optim.solver import solve_demo
    from diffcloth_tpu_torch.tasks.registry import dress_grid_standin
    from diffcloth_tpu_torch.utils import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp, \
            demo_steps("dress", DRESS_FIT_STEPS,
                       dress_grid_standin(DRESS_GRID)):
        out, root = os.path.join(tmp, "fit"), os.path.join(tmp, "ckpt")
        res = solve_demo("dress", maxiter=2, export_dir=out,
                         checkpoint_dir=root, export_iters=True)
        r = res.result
        if not (np.isfinite(r.loss) and r.loss <= r.loss_history[0]):
            raise AssertionError(f"the dress fit: {r.loss_history}")
        if ckpt.latest_step(root) != r.n_iters or r.n_iters == 0:
            raise AssertionError(f"checkpoints {os.listdir(root)} after "
                                 f"{r.n_iters} iterations")
        iters = sorted(f for f in os.listdir(out) if f.startswith("iter"))
        if len(iters) != r.n_iters:
            raise AssertionError(f"exported iterates {iters}")
        log(f"[dress-fit] solve_demo('dress'), {res.task.sim.n_steps} steps "
            f"on {card}: loss {r.loss_history[0]:.6e} -> {r.loss:.6e}, "
            f"{r.n_iters} iterations, {r.n_evals} evaluations, "
            f"{res.wallclock_s:.1f} s; x {np.array2string(r.x, precision=5)};"
            f" exported {sorted(os.listdir(out))}, checkpoints "
            f"{sorted(os.listdir(root))}")
        t0 = time.perf_counter()
        res2 = solve_demo("dress", maxiter=3, checkpoint_dir=root,
                          resume=True)
        r2 = res2.result
        if r2.loss_history[:len(r.loss_history)] != r.loss_history or \
                not r2.loss <= r.loss:
            raise AssertionError(f"the resumed fit did not continue the "
                                 f"first: {r.loss_history} then "
                                 f"{r2.loss_history}")
        log(f"[dress-fit] resumed from ckpt_{r.n_iters:08d} to "
            f"{r2.n_iters} iterations: loss {r.loss:.6e} -> {r2.loss:.6e}, "
            f"{r2.n_evals - r.n_evals} more evaluations, "
            f"{time.perf_counter() - t0:.1f} s")
        xs, tris, info = ioexp.import_episode(os.path.join(out, "final"))
        recs = res.task.sim.rollout_chunked(res.helper.vec_to_params(r.x))
        want = recs.full_x().cpu().numpy()
        err = float(np.abs(xs - want).max())
        if xs.shape != want.shape or err > 1e-8 or not np.array_equal(
                tris, res.task.sim.scene_host.tris):
            raise AssertionError(f"import_episode: shape {xs.shape} vs "
                                 f"{want.shape}, max |dx| {err}")
        log(f"[dress-fit] import_episode(final): {xs.shape[0]} frames equal "
            f"to the rollout's records within {err:.1e} (the files' 8 "
            f"decimals); {info['episode_report']}")
        del res, res2
        torch.cuda.empty_cache()


def grads_rel(g_ref, g):
    """Per parameter class: max |g - g_ref| over the class's largest entry
    of g_ref (classes that are zero in both are left out)."""
    out = {}
    for k, a in g_ref.items():
        if a.numel() == 0:
            continue
        scale = float(a.abs().max())
        diff = float((g[k] - a).abs().max())
        if scale > 0 or diff > 0:
            out[k] = diff / max(scale, 1e-300)
    return out


def card_vs_cpu_side(make, dev):
    """One device's side of `phase_card_vs_cpu`: make(dev)'s f64 episode
    and value-and-grad, on the host."""
    sim, p, loss_fn = make(dev)
    t0 = time.perf_counter()
    st = sim.rollout(p).steps
    L, g = sim.episode_value_and_grad(loss_fn)(p)
    return dict(x=st.x.cpu(), iters=st.iters.cpu(),
                obstacle_contacts=st.obstacle_contacts.cpu(),
                selfcol_pairs=st.selfcol_pairs.cpu(), L=L.cpu(),
                g={k: v.cpu() for k, v in g.items()},
                seconds=time.perf_counter() - t0)


# the process beside the card phases that computes the CPU sides of the
# f64 references (`--cpu-references`): (process, its directory) once
# started; its share of the host's threads
CPU_REFS = None
CPU_REF_THREADS = max(1, (os.cpu_count() or 2) // 2)


def cpu_reference_jobs(only):
    """[(tag, compute)]: the CPU sides of the f64 references of the paths
    in `only` (sphere, dress, multistage, obstacles), in the order the
    card phases reach them."""
    jobs = []
    if "sphere" in only:
        jobs.append(("sphere-reference",
                     lambda: sphere_reference_side("cpu")))
    if "dress" in only:
        jobs.append(("dress-reference",
                     lambda: card_vs_cpu_side(dress_reference_make, "cpu")))
    if "multistage" in only:
        jobs.append(("multistage-reference",
                     lambda: card_vs_cpu_side(multistage_reference_make,
                                              "cpu")))
    if "obstacles" in only:
        for name, make in obstacle_scenes():
            jobs.append((f"obstacles-{name}",
                         lambda make=make: card_vs_cpu_side(
                             obstacle_reference_make(make), "cpu")))
    return jobs


def start_cpu_references(only, out):
    """Start the process beside the card phases (`--cpu-references out`)."""
    global CPU_REFS
    log_path = os.path.join(out, "cpu_references.log")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-references", out,
         "--only", ",".join(only)],
        stdout=open(log_path, "w"), stderr=subprocess.STDOUT)
    CPU_REFS = (proc, out, {tag for tag, _ in cpu_reference_jobs(only)})


def cpu_references(out, only):
    """The process beside the card phases: each job's CPU side saved to
    out/<tag>.pt as it is done."""
    import torch
    torch.set_num_threads(CPU_REF_THREADS)
    for tag, compute in cpu_reference_jobs(only):
        t0 = time.perf_counter()
        res = compute()
        res["seconds"] = time.perf_counter() - t0
        path = os.path.join(out, tag + ".pt")
        torch.save(res, path + ".tmp")
        os.replace(path + ".tmp", path)
        log(f"[cpu-references] {tag}: {res['seconds']:.1f} s")


def cpu_side(tag, compute):
    """The CPU side of reference `tag`: from the process beside the card
    phases where it computes it (waiting for it; its failure fails the
    phase), else compute() here."""
    import torch
    if CPU_REFS is None or tag not in CPU_REFS[2]:
        return compute()
    proc, out, _ = CPU_REFS
    path = os.path.join(out, tag + ".pt")
    while not os.path.exists(path):
        if proc.poll() is not None and not os.path.exists(path):
            with open(os.path.join(out, "cpu_references.log")) as fh:
                tail = fh.read()[-3000:]
            raise AssertionError(f"[{tag}] the CPU references' process "
                                 f"ended (rc {proc.returncode}) without it:"
                                 f"\n{tail}")
        time.sleep(0.2)
    return torch.load(path, weights_only=False)


def phase_card_vs_cpu(tag, make, tol=1e-6):
    """f64 on the card against the CPU (the CPU path is held to the JAX
    package by the tests; its side from the process beside the card phases
    where that computes it, `cpu_side`): make(device) -> (sim, single
    params, loss_fn), its scene's adjoint run to REF_ADJOINT_EPS (as phase
    9's), so that the two devices' fixed points stop at the same trip; the
    episode within `tol`, iterations within one sweep, the loss to 1e-9 and
    each gradient class within `tol` of its largest entry."""
    import torch
    c = cpu_side(tag, lambda: card_vs_cpu_side(make, "cpu"))
    g = card_vs_cpu_side(make, "cuda")
    for dev, side in (("cuda", g), ("cpu", c)):
        log(f"[{tag}] f64 episode and value-and-grad on {dev}: "
            f"{side['seconds']:.1f} s")
    err = float((g["x"] - c["x"]).abs().max())
    d_it = int((g["iters"] - c["iters"]).abs().max())
    rel = grads_rel(c["g"], g["g"])
    if (err > tol or d_it > 1 or max(rel.values()) > tol
            or not torch.allclose(g["L"], c["L"], rtol=1e-9, atol=0)
            or not torch.equal(g["obstacle_contacts"],
                               c["obstacle_contacts"])):
        raise AssertionError(f"[{tag}] card vs CPU: max |dx| {err}, iters "
                             f"within {d_it}, loss {g['L']} vs {c['L']}, "
                             f"gradient {rel}")
    log(f"[{tag}] f64 card vs CPU: max |dx| {err:.3e} (tolerance {tol}), "
        f"iters within {d_it}, obstacle contacts equal "
        f"({int(c['obstacle_contacts'].sum())} particle-steps), self-contact "
        f"pairs {int(c['selfcol_pairs'].sum())}; loss {float(g['L']):.10e}; "
        f"gradient max error / largest entry per class (tolerance {tol}): "
        + ", ".join(f"{k} {v:.1e}" for k, v in rel.items()))
    return c


def dress_reference_make(dev):
    """12e's scene: the dress stand-in in f64, DRESS_REF_STEPS steps,
    started folded half over half (so that friction acts)."""
    import torch
    task = dress_task(DRESS_REF_STEPS, torch.float64, dev,
                      backward_convergence_thresh=REF_ADJOINT_EPS)
    sim = task.sim
    if large_modes(sim) != ("dense", "sparse", "kernel"):
        raise AssertionError(f"{dev}: {large_modes(sim)}")
    x0 = torch.as_tensor(initial_states(sim, 1)[0], dtype=torch.float64,
                         device=sim.device)
    return sim, task.param_base.replace(x0=x0), task.loss_fn()


def phase_dress_reference():
    """12e: the dress stand-in in f64 on the card against the CPU: the
    episode and the dress loss's gradient."""
    c = phase_card_vs_cpu("dress-reference", dress_reference_make)
    if int(c["selfcol_pairs"].sum()) == 0:
        raise AssertionError("the dress reference has no self-contact")


def run_dress(card, timed):
    """Phase 12, the dress stand-in (n = 7056).  Returns the JSON line's
    entries of the three kernels at its shapes, their launches counted on
    its forward (detection, forward sweep) and gradient (backward sweep)."""
    import torch
    with timed("dress build"):
        t0 = time.perf_counter()
        task = dress_task()
        torch.cuda.synchronize()
        log(f"[dress] build_task('dress') on the stand-in: "
            f"{time.perf_counter() - t0:.1f} s")
    with timed("dress kernels"):
        entries = phase_kernels("dress-kernels", task.sim,
                                initial_states(task.sim, 1),
                                np.random.RandomState(4), suffix="_dress")
    with timed("dress forward"):
        fwd, sweeps = phase_dress_forward(task, card)
    with timed("dress profile"):
        prof = dress_task(DRESS_PROFILE_STEPS)
        phase_profile("dress-profile", prof.sim, prof.param_base.expand(1),
                      card, prefactor=True)
        del prof
    with timed("dress gradient"):
        bwd = phase_dress_gradient(task, card, sweeps)
    del task
    torch.cuda.empty_cache()
    with timed("dress fit"):
        phase_dress_fit(card)
    with timed("dress reference"):
        phase_dress_reference()
    for e in entries:
        key = e["name"][:-len("_dress")]
        e["launches"] = (bwd if key == "friction_bwd" else fwd)[key]
    return entries


def multistage_sim(dtype, device, steps, **changes):
    """The flagship stand-in with two attachment stages: its corners (0, 31)
    clipped until mid-episode, then the top row's middle (15, 16);
    `changes` replace fields of its SceneConfig."""
    import dataclasses
    from diffcloth_tpu_torch.config import AttachmentConfig
    from diffcloth_tpu_torch.core.sim import ClothSim
    from diffcloth_tpu_torch.geometry import builder as gb
    from diffcloth_tpu_torch.tasks.registry import TSHIRT_GRID_STANDIN
    cfg = dataclasses.replace(
        TSHIRT_GRID_STANDIN, step_num=steps,
        attachment_points=AttachmentConfig.CUSTOM_ARRAY,
        custom_attachment_vertex_idx=((0.0, (0, 31)), (0.5, (15, 16))),
        **changes)
    return ClothSim(gb.build_scene(cfg), device=device, dtype=dtype)


def squared_positions(recs):
    """A loss of every frame: the sum of the squared positions of one
    episode (the card-against-CPU gradients' loss)."""
    return (recs.steps.x ** 2).sum()


def folded_params(sim):
    """The flagship's base wind, the episode starting folded."""
    import torch
    t = lambda a: torch.as_tensor(a, dtype=sim.dtype,  # noqa: E731
                                  device=sim.device)
    return sim.default_params().replace(
        wind=t(BASE_WIND), wind_freq=t(10.0), wind_phase=t(0.5),
        x0=t(initial_states(sim, 1)[0]))


def phase_multistage(card):
    """Phase 13: a two-stage scene at the flagship's width (32 x 32,
    self-collision on, B = 1), the stages switching mid-episode: the f32
    forward and value-and-grad on the card, then f64 card against CPU."""
    import torch
    from diffcloth_tpu_torch import losses
    from diffcloth_tpu_torch.config import LossType
    from diffcloth_tpu_torch.optim.helper import GradMask, OptimizeHelper

    sim = multistage_sim(torch.float32, "cuda", MULTI_STEPS)
    if sim.n_stages != 2 or sim.segments[1][1] != MULTI_STEPS // 2:
        raise AssertionError(f"segments {sim.segments}")
    params = folded_params(sim)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    recs = sim.rollout(params)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counters()
    st = recs.steps
    N = sim.n_steps
    if not bool(torch.isfinite(st.x).all()):
        raise AssertionError("non-finite multi-stage trajectory")
    sweeps = int(pd_sweeps(st.iters.cpu().numpy()[None], sim).sum())
    check_launches("multistage", launches, N, sweeps)
    x, xf = st.x.cpu(), st.x_fixed.cpu()
    rest = torch.as_tensor(sim.scene_host.x_rest, dtype=x.dtype)
    last0 = sim.segments[0][2] - 2     # the record of stage 0's last frame
    held0 = float((x[last0, [0, 31]] - xf[last0, :2]).norm(dim=-1).max())
    held1 = float((x[-1, [15, 16]] - xf[-1, :2]).norm(dim=-1).max())
    freed = float((x[-1, [0, 31]] - rest[[0, 31]]).norm(dim=-1).min())
    if not (held0 < 0.05 and held1 < 0.05
            and freed > 10 * max(held0, held1)):
        raise AssertionError(f"the stages did not switch: stage-0 clips "
                             f"{held0} from their targets before the switch, "
                             f"stage-1 clips {held1} at the end, the corners "
                             f"{freed} from rest")
    pairs = st.selfcol_pairs.cpu().numpy()
    log(f"[multistage] 32 x 32, segments {sim.segments}: forward {N} steps "
        f"x B=1 on {card}: {elapsed:.2f} s ({N / elapsed:.1f} PD steps/s), "
        f"converged {float(st.converged.float().mean()):.4f}, "
        f"{sweeps / N:.2f} sweeps per step; corners held to {held0:.2e} "
        f"before the switch, the middle clips to {held1:.2e} after it, the "
        f"corners then {freed:.3f} from rest; self-contact in "
        f"{int((pairs > 0).sum())} steps; launches {launches}")
    target = sim.rollout_chunked(params.replace(
        wind=params.wind * 0.5)).full_x()
    loss_fn = losses.make_loss_fn(LossType.MATCH_TRAJECTORY,
                                  losses.LossInfo(target_x=target))
    helper = OptimizeHelper(sim, GradMask(f_wind=True), loss_fn,
                            param_base=params)
    torch.cuda.synchronize()
    zero_counters()
    sim.bwd_stats.reset()
    t0 = time.perf_counter()
    L, G = helper.loss_and_grad(helper.params_to_vec(params))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    bst = sim.bwd_stats.summary()
    if not (np.isfinite(L) and np.isfinite(G).all() and np.abs(G).max() > 0):
        raise AssertionError(f"multi-stage loss {L}, gradient {G}")
    check_launches("multistage-gradient", launches, N, sweeps, bst)
    log(f"[multistage] value-and-grad of GradMask(f_wind=True) on {card}: "
        f"{wall:.2f} s, loss {L:.6e}, gradient "
        f"{np.array2string(G, precision=4)}; "
        f"{bst['lane_trips'] / max(bst['lane_steps'], 1):.2f} trips per step, "
        f"{bst['fallback_lanes']:.0f} GMRES fallbacks; launches {launches}")

    phase_card_vs_cpu("multistage-reference", multistage_reference_make)


def multistage_reference_make(dev):
    """13's f64 reference: from the flat rest shape, the stage switch
    alone, without the self-contact whose f32 sweep inside f64 rounds a
    few slots apart on the two devices."""
    import torch
    s = multistage_sim(torch.float64, dev, MULTI_REF_STEPS,
                       backward_convergence_thresh=REF_ADJOINT_EPS)
    p = folded_params(s)
    return s, p.replace(x0=s.scene_dev.x_rest.clone(), wind=torch.tensor(
        [0.5, 0.05, 0.5], dtype=torch.float64,
        device=s.device)), squared_positions


def sock_standin():
    """The sock scene (FOOT primitives, CORNERS_2_WEARSOCK under
    ENDPOINT_AND_TANGENTS, the keypoint loss) with its mesh replaced by a
    32 x 32 grid (its keypoint indices reach 995), as the tests build it."""
    import dataclasses
    from diffcloth_tpu_torch.tasks.registry import SOCK_SCENE
    return dataclasses.replace(SOCK_SCENE, fabric=dataclasses.replace(
        SOCK_SCENE.fabric, is_model=False, custom_init_pos=False,
        init_pos_file="", grid_num_x=32, grid_num_y=32))


def phase_ladder(card):
    """Phase 14: solve_demo_tau_ladder("sock") on the sock stand-in cut to
    LADDER_STEPS steps, population 4, two rungs (tau 0.5, then the hard
    max) of one iteration each, on the card."""
    from diffcloth_tpu_torch.optim.solver import solve_demo_tau_ladder

    def report(r, tau, k, X, F):
        log(f"[ladder] rung {r} (tau {tau:g}) iteration {k}: losses "
            f"{np.array2string(F, precision=5)}")

    with demo_steps("sock", LADDER_STEPS, sock_standin()):
        res = solve_demo_tau_ladder("sock", taus=(0.5, 0.0),
                                    maxiter_per_rung=1, final_maxiter=1,
                                    population=4, callback=report)
    rungs = res.rungs
    hard = [r["hard_max_loss"] for r in rungs]
    if len(rungs) != 2 or not np.isfinite(hard).all() or not np.isfinite(
            res.result.x).all():
        raise AssertionError(f"the ladder's rungs {rungs}")
    sim = res.task.sim
    log(f"[ladder] sock stand-in (n = {sim.n}, {sim.n_prims} primitives, "
        f"{sim.n_steps} steps, {sim.spline_type.name}) on {card}: rungs "
        + "; ".join(f"tau {r['tau']:g}: smoothed {r['smoothed_loss']:.5f}, "
                    f"hard max {r['hard_max_loss']:.5f} (winner "
                    f"{r['winner']}, {r['n_batched_evals']} batched evals)"
                    for r in rungs)
        + f"; {res.wallclock_s:.1f} s")


def obstacle_scenes():
    """Check 3's asset-free scenes, each (name, builder(dtype, device,
    steps) -> (sim, single params)): the slope stand-in's grid resting on
    its SLOPE_SIMPLIFIED plane; a 25 x 25 grid dropped onto the FOOT
    primitives (over the leg capsule's top); a 0.6 x 0.6 grid dropped
    into the Y0PLANE bowl; and the sphere scene's grid with its corners
    clipped on a CORNERS_2_WEARHAT trajectory under ENDPOINT_AND_TANGENTS
    (its tangents perturbed, numpy seed 0) lying on the sphere.  mu 0.3 on
    every primitive, so that friction acts."""
    import dataclasses
    import torch
    from diffcloth_tpu_torch import config as tc
    from diffcloth_tpu_torch.core.sim import ClothSim
    from diffcloth_tpu_torch.geometry import builder as gb
    from diffcloth_tpu_torch.tasks import registry as reg
    from diffcloth_tpu_torch.tasks import setup as ts

    def sim_of(cfg, dtype, device, steps, spline_type=tc.SplineType.ENDPOINT):
        cfg = dataclasses.replace(cfg, step_num=steps)
        if dtype == torch.float64:      # the card-against-CPU references
            cfg = dataclasses.replace(
                cfg, backward_convergence_thresh=REF_ADJOINT_EPS)
        scene = gb.build_scene(cfg)
        prims, entries = ts._make_primitives(scene, dtype, device)
        sim = ClothSim(scene, prims=prims, device=device, dtype=dtype,
                       spline_type=spline_type)
        p = sim.default_params()
        return sim, p.replace(mu=torch.full_like(p.mu, 0.3)), entries

    def grid(pc, dim, g):
        return tc.SceneConfig(
            fabric=tc.FabricConfig(cloth_dim_x=dim, cloth_dim_y=dim,
                                   k_stiff_stretching=150,
                                   k_stiff_bending=1e-5, grid_num_x=g,
                                   grid_num_y=g, density=0.3),
            orientation=tc.Orientation.DOWN, primitive_config=pc,
            sock_leg_orientation=(0.3, 1.0, 0.2), time_step=1.0 / 180.0,
            name="grid")

    def slope(dtype, device, steps):
        cfg = reg.SLOPE_SCENE
        cfg = dataclasses.replace(cfg, fabric=dataclasses.replace(
            cfg.fabric, custom_init_pos=False, init_pos_file=""))
        return sim_of(cfg, dtype, device, steps)[:2]

    def foot(dtype, device, steps):
        sim, p, ent = sim_of(grid(tc.PrimitiveConfig.FOOT, 4.5, 25), dtype,
                             device, steps)
        leg = ent[2]
        top = leg["center"] + leg["rot"] @ np.array([0, leg["length"], 0])
        shift = top + np.array([0.0, leg["radius"] + 0.15, 0.0])
        return sim, p.replace(x0=p.x0 + torch.as_tensor(shift).to(p.x0))

    def bowl(dtype, device, steps):
        sim, p, _ = sim_of(grid(tc.PrimitiveConfig.Y0PLANE, 0.6, 10), dtype,
                           device, steps)
        return sim, p.replace(x0=p.x0 + torch.tensor(
            [0.0, 0.25, 0.0]).to(p.x0))

    def hat_trajectory(dtype, device, steps):
        cfg = dataclasses.replace(
            reg.ROTATING_SPHERE_SCENE,
            attachment_points=tc.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
            trajectory=tc.TrajectoryConfig.CORNERS_2_WEARHAT)
        sim, p, _ = sim_of(cfg, dtype, device, steps,
                           tc.SplineType.ENDPOINT_AND_TANGENTS)
        kick = np.random.RandomState(0).randn(*p.spline.shape)
        kick[:, :3] = 0.0            # the endpoints stay, the tangents move
        return sim, p.replace(spline=p.spline + torch.as_tensor(kick).to(
            p.spline))

    return (("slope", slope), ("foot", foot), ("bowl", bowl),
            ("hat-trajectory", hat_trajectory))


def phase_obstacles(card):
    """Phase 15 (ROADMAP check 3): the plane, capsule and bowl primitives
    and ENDPOINT_AND_TANGENTS on the card.  Each scene's f32 episode of
    OBSTACLE_STEPS steps must touch its obstacle in most steps, with the
    kernels' launches as on every path; then f64 card against CPU over
    OBSTACLE_REF_STEPS steps, the episode and the gradient of the last
    frame's squared positions."""
    import torch
    for name, make in obstacle_scenes():
        sim, p = make(torch.float32, "cuda", OBSTACLE_STEPS)
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        st = sim.rollout(p.expand(1)).steps
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_counters()
        N = sim.n_steps
        if not bool(torch.isfinite(st.x).all()):
            raise AssertionError(f"[{name}] non-finite trajectory")
        check_launches(name, launches, N,
                       int(pd_sweeps(st.iters.cpu().numpy(), sim).sum()))
        contact = st.obstacle_contacts.cpu().numpy()[0]
        share = float((contact > 0).mean())
        if share <= 0.5:
            raise AssertionError(f"[{name}] obstacle contact in only "
                                 f"{100 * share:.1f} % of the steps")
        kinds = sorted(set(int(k) for k in sim.prims.kind))
        log(f"[obstacles] {name}: n = {sim.n}, primitive kinds {kinds}, "
            f"spline {sim.spline_type.name}; {N} steps on {card} in "
            f"{elapsed:.2f} s, converged "
            f"{float(st.converged.float().mean()):.4f}, obstacle contact in "
            f"{100 * share:.1f} % of the steps (max {int(contact.max())} "
            f"particles), self-contact pairs "
            f"{int(st.selfcol_pairs.sum())}; launches {launches}")
        phase_card_vs_cpu(f"obstacles-{name}", obstacle_reference_make(make))


def obstacle_reference_make(make):
    """15's f64 reference of one obstacle scene: make(dev) for
    phase_card_vs_cpu."""
    import torch
    return lambda dev: make(torch.float64, dev, OBSTACLE_REF_STEPS) + (
        squared_positions,)


def precision_report(tag, g32, g64, fd):
    """The f32 gradient against the f64 one, and the f64 one against f64
    central differences: cosines and per-class relative errors."""
    def cos(a, b):
        return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b),
                                 1e-300))
    rel32 = np.abs(g32 - g64) / np.maximum(np.abs(g64), 1e-300)
    relfd = np.abs(fd - g64) / np.maximum(np.abs(fd), 1e-300)
    log(f"[{tag}] f32 gradient {np.array2string(g32, precision=6)}; f64 "
        f"{np.array2string(g64, precision=6)}; f64 central differences "
        f"{np.array2string(fd, precision=6)}")
    log(f"[{tag}] cosine(f32, f64) {cos(g32, g64):.8f}, cosine(f64, FD) "
        f"{cos(g64, fd):.8f}; per-entry |f32 - f64| / |f64| "
        f"{np.array2string(rel32, precision=2)}; |f64 - FD| / |FD| "
        f"{np.array2string(relfd, precision=2)}")


def phase_precision(card):
    """Phase 16 (ROADMAP check 2): the card's f32 value-and-grad against its
    f64 one, beside f64 central differences (forward tolerance 1e-9) of one
    entry per parameter class, on the flagship stand-in cut to
    PRECISION_STEPS steps (the folded start,
    B = 1, GradMask(f_wind=True, density, k_stretch, k_bend) against the
    base wind's rollout, evaluated at 0.7 of that wind and 1.2 of its
    k_stretch) and on the sphere path (mu at 0.5, SPHERE_PRECISION_STEPS
    steps).  No bound: the numbers go to PERF.md."""
    import torch
    from diffcloth_tpu_torch import losses
    from diffcloth_tpu_torch.config import LossType
    from diffcloth_tpu_torch.optim.helper import GradMask, OptimizeHelper
    from diffcloth_tpu_torch.tasks.setup import build_task

    def gradients(helpers, x, probe):
        """The f32 and f64 gradients at the scene's tolerances, and central
        differences of the f64 episode at the tight ones (step 1e-6 of
        max(|x|, 1)) at the entries `probe`, one per parameter class."""
        g32, g64 = (h.loss_and_grad(x)[1][probe] for h in helpers[:2])
        fd = np.zeros(len(probe))
        for k, i in enumerate(probe):
            d = 1e-6 * max(abs(x[i]), 1.0)
            up, dn = x.copy(), x.copy()
            up[i] += d
            dn[i] -= d
            fd[k] = (helpers[2].loss(up) - helpers[2].loss(dn)) / (2 * d)
        return g32, g64, fd

    import dataclasses
    from diffcloth_tpu_torch.core.sim import ClothSim
    from diffcloth_tpu_torch.geometry import builder as gb
    from diffcloth_tpu_torch.tasks.registry import (ROTATING_SPHERE_SCENE,
                                                    TSHIRT_GRID_STANDIN)

    def tight(cfg):
        """The scene with the FD check's forward tolerance
        (Simulation.cpp:3648)."""
        return dataclasses.replace(cfg, forward_convergence_thresh=1e-9)

    mask = GradMask(f_wind=True, density=True,
                    k_pertype=(False, False, True, True))
    base = dataclasses.replace(TSHIRT_GRID_STANDIN, step_num=PRECISION_STEPS)
    target = None
    helpers = []
    for dtype, cfg in ((torch.float32, base), (torch.float64, base),
                       (torch.float64, tight(base))):
        sim = ClothSim(gb.build_scene(cfg), device="cuda", dtype=dtype)
        p = folded_params(sim)
        if target is None:
            target = sim.rollout(p).full_x().to(torch.float64)
        loss_fn = losses.make_loss_fn(
            LossType.MATCH_TRAJECTORY,
            losses.LossInfo(target_x=target.to(dtype)))
        helpers.append(OptimizeHelper(sim, mask, loss_fn, param_base=p))
    x = helpers[1].params_to_vec(helpers[1].base)
    x[:3] *= 0.7
    x[5] *= 1.2                     # k_stretch off the target's
    precision_report(f"precision-flagship ({PRECISION_STEPS} steps; wind "
                     f"x, freq, phase, k_stretch, k_bend, density)",
                     *gradients(helpers, x, [0, 3, 4, 5, 6, 7]))
    helpers = []
    for dtype, cfg in ((torch.float32, ROTATING_SPHERE_SCENE),
                       (torch.float64, ROTATING_SPHERE_SCENE),
                       (torch.float64, tight(ROTATING_SPHERE_SCENE))):
        with demo_steps("sphere", SPHERE_PRECISION_STEPS, cfg):
            task = build_task("sphere", dtype=dtype)
        helpers.append(OptimizeHelper(task.sim, task.mask, task.loss_fn(),
                                      param_base=task.param_base))
    precision_report(f"precision-sphere ({SPHERE_PRECISION_STEPS} steps; "
                     f"mu at 0.5)", *gradients(helpers, np.array([0.5]), [0]))


def hat_task(dtype, device, **sim_kw):
    """build_task("hat") on the hat's grid stand-in (registry.
    hat_grid_standin: HAT_SCENE's physics, bust and clips on a 25 x 25
    grid, n = 625; the hat mesh is not in the repository)."""
    from diffcloth_tpu_torch.tasks.registry import hat_grid_standin
    from diffcloth_tpu_torch.tasks.setup import build_task
    return build_task("hat", dtype=dtype, device=device,
                      scene=hat_grid_standin(), **sim_kw)


def control_states(prob, rng):
    """17a's (HAT_BATCH, n, 3) positions, by fours: a controller start pose
    (sample_pose, another in each four), the grid folded half over half,
    the hat on the bust (the loss's target: inside the head sphere's
    contact band) and the folded grid moved there too."""
    import torch
    from diffcloth_tpu_torch.apps import hat_controller as hc
    sim = prob.sim
    folded = initial_states(sim, 1)[0]
    shift = (prob.target - prob.x0).mean(dim=0).cpu().numpy()
    target = prob.target.to(torch.float64).cpu().numpy()
    return np.stack([x for _ in range(HAT_BATCH // 4) for x in (
        hc.sample_pose(prob, rng)[0].cpu().numpy(), folded, target,
        folded + shift)])


def phase_control_facade(card):
    """17b: the facade and the bridge on the hat stand-in in f64, on the
    card and on the CPU: FACADE_STEPS `SimulationAPI.step_nn` steps with
    the clips raised a little every step, one `step_backward_nn` of the
    last, then `PySim` over BRIDGE_STEPS steps from the start with a
    scalar loss of the last state, its x0 and clip-target gradients
    (after the bridge's dL/da clamp).  The card within 1e-6 of the CPU on
    the states and of each cotangent's largest entry."""
    import torch
    from diffcloth_tpu_torch.api.pysim import SimulationAPI
    from diffcloth_tpu_torch.api.torch_bridge import PySim
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        api = SimulationAPI(hat_task(torch.float64, dev))
        lift = torch.tensor([0.0, 0.02, 0.0], dtype=torch.float64,
                            device=api.sim.device)
        a0 = api.get_state_info().x_fixedpoints.reshape(-1, 3)
        for k in range(1, FACADE_STEPS + 1):
            info = api.get_state_info()
            api.step_nn(k, info.x, info.v, (a0 + k * lift).reshape(-1))
        recs = api.forward_records
        rng = np.random.RandomState(5)
        g = torch.as_tensor(rng.randn(recs[-1].x.shape[0]),
                            device=api.sim.device)
        back = api.step_backward_nn(FACADE_STEPS, recs[-2].x, recs[-2].v,
                                    recs[-1].x_fixedpoints, g,
                                    torch.zeros_like(g))
        api.reset_system()
        module = PySim(api)
        info = api.get_state_info()
        x0 = info.x.clone().requires_grad_(True)
        x, v = x0, info.v
        clips = []
        for k in range(1, BRIDGE_STEPS + 1):
            a = (a0 + k * lift).reshape(-1).clone().requires_grad_(True)
            clips.append(a)
            x, v = module(x, v, a)
        loss = (x * g).sum() + 0.5 * (v * v).sum()
        loss.backward()
        if api.sim.device.type == "cuda":
            torch.cuda.synchronize()
        out[dev] = {"states": torch.stack([r.x for r in recs]).cpu(),
                    "dx": back[0].cpu(), "dv": back[1].cpu(),
                    "da": back[2].cpu(), "bridge_x0": x0.grad.cpu(),
                    "bridge_a": torch.stack([a.grad for a in clips]).cpu(),
                    "loss": float(loss.detach()),
                    "s": time.perf_counter() - t0}
    c, g = out["cpu"], out["cuda"]
    err = float((g["states"] - c["states"]).abs().max())
    rel = {k: float((g[k] - c[k]).abs().max())
           / max(float(c[k].abs().max()), 1e-300)
           for k in ("dx", "dv", "da", "bridge_x0", "bridge_a")}
    moved = float((c["states"][-1] - c["states"][0]).abs().max())
    if not all(np.isfinite(list(rel.values()))) or err > 1e-6 or \
            max(rel.values()) > 1e-6 or moved == 0.0 or \
            float(c["da"].abs().max()) == 0.0:
        raise AssertionError(f"[control-facade] card vs CPU: states {err}, "
                             f"cotangents {rel}, moved {moved}")
    log(f"[control-facade] hat stand-in, f64: {FACADE_STEPS} step_nn steps "
        f"and one step_backward_nn, then PySim over {BRIDGE_STEPS} steps; "
        f"card {g['s']:.1f} s, CPU {c['s']:.1f} s; card vs CPU states max "
        f"|dx| {err:.3e} (tolerance 1e-6), the clips moved the cloth "
        f"{moved:.3f}; cotangents max error / largest entry (tolerance "
        f"1e-6): " + ", ".join(f"{k} {v:.1e}" for k, v in rel.items())
        + f"; bridge loss card {g['loss']:.10e}, CPU {c['loss']:.10e}")


def phase_control_train(card):
    """17c: `train()` on the hat stand-in, f32 on the card, HAT_EPOCHS
    epochs of HAT_BATCH poses (HAT_VAL validation poses, seed 0) over the
    hat's 400 steps in chunks of 50 (the app's defaults); each
    epoch's episode-gradient steps/s and shares.  Then the trained
    controller's `loss_and_grad` once more with the counters zeroed just
    before and read just after: detection once per step and the forward
    sweep once per PD sweep, both twice (the chunks' backward recomputes
    each chunk's forward), the forward sweep twice more per adjoint
    program (the linearization and the residual VJP), the backward sweep
    once per adjoint trip, GMRES matvec and residual VJP.  Returns
    (launches, the controller, the temporary directory holding
    controller.pkl)."""
    import tempfile
    import torch
    from diffcloth_tpu_torch.apps import hat_controller as hc
    task = hat_task(torch.float32, "cuda")
    prob = hc.make_problem(task, HAT_STEPS)
    sim = prob.sim
    tmp = tempfile.TemporaryDirectory()
    grads = []

    def on_epoch(epoch, pg):
        finite = all(bool(torch.isfinite(g).all()) for g in pg.grads)
        if not (finite and np.isfinite(pg.sample_gnorms).all()
                and bool(torch.isfinite(pg.loss))):
            raise AssertionError(f"epoch {epoch}: a non-finite gradient")
        wall = pg.forward_s + pg.backward_s
        grads.append(wall)
        log(f"[control-train] epoch {epoch}: loss_and_grad {wall:.2f} s, "
            f"{HAT_BATCH * prob.n_steps / wall:.1f} episode-gradient "
            f"steps/s (forward {100 * pg.forward_s / wall:.1f} %, backward "
            f"{100 * pg.backward_s / wall:.1f} %), PD sweeps per step "
            f"{pg.iters.float().mean():.2f}")

    t0 = time.perf_counter()
    res = hc.train(prob, hc.TrainConfig(
        epochs=HAT_EPOCHS, train_samples=HAT_BATCH, val_samples=HAT_VAL,
        seed=0, out=tmp.name), log=lambda m: log(f"[control-train] {m}"),
        on_epoch=on_epoch)
    wall = time.perf_counter() - t0
    hist = res["log"]
    if len(hist) != HAT_EPOCHS or not all(
            np.isfinite([e["train"], e["val"], e["gnorm"]]).all()
            for e in hist):
        raise AssertionError(f"the training log {hist}")
    log(f"[control-train] hat stand-in (n = {sim.n}, {prob.n_steps} of "
        f"{sim.n_steps} steps in chunks of {hc.CHUNK}, B = {HAT_BATCH}, "
        f"{HAT_VAL} validation poses) "
        f"on {card}: {HAT_EPOCHS} epochs in {wall:.1f} s; train loss "
        + " -> ".join(f"{e['train']:.5f}" for e in hist) + "; val "
        + " -> ".join(f"{e['val']:.5f}" for e in hist))
    xs, aas = hc.stack_poses(prob, np.random.RandomState(3), HAT_BATCH)
    torch.cuda.synchronize()
    zero_counters()
    sim.bwd_stats.reset()
    t0 = time.perf_counter()
    pg = hc.loss_and_grad(prob, res["controller"], xs, aas)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    st = sim.bwd_stats.summary()
    if not all(bool(torch.isfinite(g).all()) for g in pg.grads):
        raise AssertionError("a non-finite policy gradient")
    sweeps = int(pd_sweeps(pg.iters.cpu().numpy(), sim).sum())
    check_launches("control", launches, prob.n_steps, sweeps, st, passes=2)
    log(f"[control] loss_and_grad of the trained controller, {prob.n_steps} "
        f"steps x B={HAT_BATCH}, chunk {hc.CHUNK} on {card}: {wall:.2f} s, "
        f"{HAT_BATCH * prob.n_steps / wall:.1f} episode-gradient steps/s "
        f"(forward {pg.forward_s:.2f} s, backward {pg.backward_s:.2f} s); "
        f"loss {float(pg.loss):.5f}, per-sample gradient norms "
        f"{np.array2string(pg.sample_gnorms, precision=4)}, dropped "
        f"{int(pg.dropped.sum())}; {sweeps / prob.n_steps:.2f} PD sweeps "
        f"per step; adjoint {st['lane_trips'] / max(st['lane_steps'], 1):.2f}"
        f" trips per episode-step, {st['fallback_lanes']:.0f} of "
        f"{st['lane_steps']:.0f} to GMRES ({st['gmres_matvecs']:.0f} "
        f"matvecs); launches {launches} (detection and the forward sweeps "
        f"twice: the chunks' backward recomputes their forward)")
    return launches, res["controller"], tmp


def phase_control_profile(card, ctrl):
    """17c': where the time of one loss_and_grad goes: the trained
    controller on CONTROL_PROFILE_STEPS steps of HAT_BATCH poses under
    torch.profiler (device activity alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from diffcloth_tpu_torch.apps import hat_controller as hc
    prob = hc.make_problem(hat_task(torch.float32, "cuda"),
                           CONTROL_PROFILE_STEPS)
    xs, aas = hc.stack_poses(prob, np.random.RandomState(3), HAT_BATCH)
    hc.loss_and_grad(prob, ctrl, xs, aas)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pg = hc.loss_and_grad(prob, ctrl, xs, aas)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = profiled_ops(prof)
    busy_ms = sum(ms for _, ms, _ in ops)
    if busy_ms == 0:
        raise AssertionError("the profiler saw no device time")
    log(f"[control-profile] loss_and_grad, {prob.n_steps} steps x "
        f"B={HAT_BATCH} on {card}: wall {wall_ms:.1f} ms (forward "
        f"{pg.forward_s * 1e3:.1f}, backward {pg.backward_s * 1e3:.1f}; "
        f"inflated by the profiler), device busy (as the profiler sees "
        f"it) {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %), "
        f"{sum(c for _, _, c in ops)} device launches")
    log_breakdown("control-profile", ops, FORWARD_KERNELS
                  + (("friction_bwd", "friction_bwd_kernel"),),
                  captured=prob.sim.cuda_graphs)


def phase_control_eval(card, pkl):
    """17d: one full 400-step closed-loop episode of the trained
    controller (`evaluate`, in chunks), rendered to a GIF."""
    import torch
    from diffcloth_tpu_torch.apps import hat_controller as hc
    prob = hc.make_problem(hat_task(torch.float32, "cuda"))
    gif = os.path.join(os.path.dirname(pkl), "eval.gif")
    t0 = time.perf_counter()
    res = hc.evaluate(prob, pkl, seed=0, gif=gif,
                      log=lambda m: log(f"[control-eval] {m}"))
    if not (np.isfinite(res["loss"]) and np.isfinite(res["frames"]).all()
            and res["frames"].shape == (prob.n_steps + 1, prob.sim.n, 3)):
        raise AssertionError(f"the eval episode: loss {res['loss']}")
    log(f"[control-eval] {prob.n_steps}-step episode in chunks of "
        f"{hc.CHUNK} on {card} and its GIF "
        f"({os.path.getsize(gif)} bytes, every 8th frame) in "
        f"{time.perf_counter() - t0:.1f} s; loss {res['loss']:.5f}")


def control_case(steps, cuda_graphs=None, seed=0):
    """The control path at HAT_BATCH poses (seed 3) of the hat stand-in cut
    to `steps` (None: its 400): (problem, poses, clip targets, a
    controller of seeded random weights)."""
    import torch
    from diffcloth_tpu_torch.apps import hat_controller as hc
    prob = hc.make_problem(hat_task(torch.float32, "cuda",
                                    cuda_graphs=cuda_graphs), steps)
    feat = hc.featurize(prob, prob.x0[None], torch.zeros_like(prob.x0)[None])
    ctrl = hc.Controller([feat.shape[1], *hc.HIDDEN,
                          3 * prob.clip0.shape[0]], prob.sim.dtype,
                         prob.sim.device,
                         generator=torch.Generator().manual_seed(seed))
    xs, aas = hc.stack_poses(prob, np.random.RandomState(3), HAT_BATCH)
    return prob, xs, aas, ctrl


def phase_control_chunked(card, ctrl):
    """17g: the trained controller's `loss_and_grad` over
    CONTROL_CHUNKED_STEPS of the hat's 400 steps at B = HAT_BATCH, chunked (the default, 50) against the
    whole episode as one autograd graph (chunk=None), after a warm-up of
    both on a 2-step horizon of the same problem: chunked, whole, whole,
    chunked, each route's two runs equal bit for bit; the loss of the two
    routes equal bit for bit, the gradients and per-sample norms within
    1e-5 of each layer's (the norms') largest entry, the same samples
    dropped; the chunks' forward (`rollout_chunked`) equal to the whole
    episode's states bit for bit and free of synchronizing calls (sync
    debug mode "error"); device busy (CUDA events around the step and
    controller programs); host launches and synchronizing runtime calls
    per step from a fresh profiling process; peak memory."""
    import dataclasses
    import torch
    from diffcloth_tpu_torch.apps import hat_controller as hc
    prob, xs, aas, _ = control_case(CONTROL_CHUNKED_STEPS)
    units = HAT_BATCH * prob.n_steps
    ways = {"chunked": hc.CHUNK, "whole": None}
    short = dataclasses.replace(prob, n_steps=2)
    for chunk in ways.values():     # warm-ups and captures
        hc.loss_and_grad(short, ctrl, xs, aas, chunk=chunk)
    rates, first = {w: [] for w in ways}, {}
    for way in ("chunked", "whole", "whole", "chunked"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pg = hc.loss_and_grad(prob, ctrl, xs, aas, chunk=ways[way])
        torch.cuda.synchronize()
        rates[way].append(units / (time.perf_counter() - t0))
        if way not in first:
            first[way] = pg
            continue
        a = first[way]
        if not (torch.equal(a.loss, pg.loss) and all(
                torch.equal(g, h) for g, h in zip(a.grads, pg.grads))):
            raise AssertionError(f"[control-chunked] {way}: two runs differ")
    c, w = first["chunked"], first["whole"]
    rel = {f"layer{i}": float((g - h).abs().max())
           / max(float(h.abs().max()), 1e-30)
           for i, (g, h) in enumerate(zip(c.grads, w.grads))}
    rel["gnorms"] = float(np.abs(c.sample_gnorms - w.sample_gnorms).max()
                          / max(np.abs(w.sample_gnorms).max(), 1e-30))
    if not torch.equal(c.loss, w.loss) or not torch.equal(c.iters, w.iters) \
            or not np.array_equal(c.dropped, w.dropped) or not all(
                np.isfinite(v) and v <= 1e-5 for v in rel.values()):
        raise AssertionError(f"[control-chunked] chunked against whole: loss "
                             f"{c.loss} vs {w.loss}, gradient {rel}, dropped "
                             f"{c.dropped} vs {w.dropped}")
    log(f"[control-chunked] loss_and_grad, {prob.n_steps} steps x "
        f"B={HAT_BATCH}, chunk {hc.CHUNK} against the whole episode on "
        f"{card}: loss {float(c.loss):.6f} equal bit for bit, PD sweeps per "
        f"step equal; gradient max error / largest entry (tolerance 1e-5): "
        + ", ".join(f"{k} {v:.1e}" for k, v in rel.items())
        + f"; dropped {int(c.dropped.sum())} in both")
    log(f"[control-chunked] episode-gradient steps/s (chunked, whole, whole, "
        f"chunked): chunked " + ", ".join(f"{r:.1f}" for r in
                                          rates["chunked"])
        + "; whole " + ", ".join(f"{r:.1f}" for r in rates["whole"])
        + f"; chunked / whole {np.mean(rates['chunked']) / np.mean(rates['whole']):.2f}x")

    # the chunks' forward against the whole episode's, and with no
    # synchronizing call once built
    ws = ctrl.layers()
    v0 = torch.zeros_like(xs)
    with torch.no_grad():
        whole = hc.closed_loop_rollout(prob, ws, xs, v0, aas, record=True)
        hc.rollout_chunked(short, ws, xs, v0, aas, hc.CHUNK)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ch, _ = hc.rollout_chunked(prob, ws, xs, v0, aas, hc.CHUNK,
                                       record=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for k in ("x", "v", "a", "clip_traj", "iters", "states"):
        if not torch.equal(getattr(ch, k), getattr(whole, k)):
            raise AssertionError(f"[control-chunked] rollout_chunked's {k} "
                                 f"differs from closed_loop_rollout's")
    log(f"[control-chunked] the chunks' forward ({prob.n_steps} steps, "
        f"states, clips, actions, sweeps) equals the whole episode's bit for "
        f"bit and ran under PyTorch's sync debug mode 'error'")

    # device busy from CUDA events around every program launch: the step's
    # forward and adjoint and, chunked, the controller's
    for way, chunk in ways.items():
        wall, busy = program_busy(
            lambda: hc.loss_and_grad(prob, ctrl, xs, aas, chunk=chunk))
        log(f"[control-chunked] {way}: wall {wall:.3f} s, the programs busy "
            f"on the device {busy:.3f} s ({100 * busy / wall:.1f} %)"
            + ("" if chunk else "; the controller and autograd's glue run "
               "outside the programs and are not counted"))
    peaks = {}
    for way, chunk in ways.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        hc.loss_and_grad(prob, ctrl, xs, aas, chunk=chunk)
        torch.cuda.synchronize()
        peaks[way] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    log(f"[control-chunked] peak allocated memory over a loss_and_grad: "
        f"whole episode {peaks['whole']:.1f} MiB, chunked "
        f"{peaks['chunked']:.1f} MiB "
        f"({100 * peaks['chunked'] / peaks['whole']:.0f} %)")
    del prob, whole, ch
    torch.cuda.empty_cache()

    # host launches and waits per step, in a fresh process
    prof = subprocess.run(
        [sys.executable, "-X", "faulthandler", os.path.abspath(__file__),
         "--profile-control"], capture_output=True, text=True, timeout=600)
    rows = [json.loads(ln) for ln in prof.stdout.splitlines()
            if ln.startswith("{")]
    want = ["chunked forward", "chunked loss_and_grad",
            "whole loss_and_grad"]
    if prof.returncode or [r["what"] for r in rows] != want:
        raise AssertionError(
            f"[control-chunked] the profiling process ended with rc "
            f"{prof.returncode} and rows {[r['what'] for r in rows]}; its "
            f"output ends:\n{prof.stdout[-1500:]}\n{prof.stderr[-3000:]}")
    for row in rows:
        log(f"[control-chunked] {row['what']} ({row['steps']} steps x "
            f"B={HAT_BATCH}, chunk {row['chunk']}; profiled in a fresh "
            f"process): {row['launches'] / row['steps']:.1f} host launches "
            f"and {row['waits'] / row['steps']:.2f} synchronizing runtime "
            f"calls per step ({row['syncs']} in all, {row['base_syncs']} in "
            f"an empty profiled region)")


def profile_control():
    """`--profile-control`: the control path cut to CHUNKED_PROFILE (steps,
    chunk), B = HAT_BATCH, a seeded random controller: the chunked forward,
    the chunked and the whole loss_and_grad, each warmed up, then
    profiled (the CUDA runtime's events); one JSON line each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from diffcloth_tpu_torch.apps import hat_controller as hc
    steps, chunk = CHUNKED_PROFILE
    prob, xs, aas, ctrl = control_case(steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
    base = sum(runtime_counts(prof)[1].values())

    def forward():
        with torch.no_grad():
            hc.rollout_chunked(prob, ctrl.layers(), xs, torch.zeros_like(xs),
                               aas, chunk)

    for what, fn, c in (
            ("chunked forward", forward, chunk),
            ("chunked loss_and_grad",
             lambda: hc.loss_and_grad(prob, ctrl, xs, aas, chunk=chunk),
             chunk),
            ("whole loss_and_grad",
             lambda: hc.loss_and_grad(prob, ctrl, xs, aas, chunk=None),
             None)):
        fn()
        fn()                        # warm-ups and captures
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launches, syncs = runtime_counts(prof)
        print(json.dumps(dict(what=what, steps=steps, chunk=c,
                              launches=launches, syncs=syncs,
                              base_syncs=base,
                              waits=sum(syncs.values()) - base)), flush=True)


def gmres_sim(dtype, device, steps, mode, eps_backward=None,
              max_backward_iters=64):
    """The flagship stand-in cut to `steps` steps, its adjoint in `mode`."""
    import dataclasses
    from diffcloth_tpu_torch.config import SimFlags
    from diffcloth_tpu_torch.core.sim import ClothSim
    from diffcloth_tpu_torch.geometry import builder as gb
    from diffcloth_tpu_torch.tasks.registry import TSHIRT_GRID_STANDIN
    cfg = dataclasses.replace(TSHIRT_GRID_STANDIN, step_num=steps)
    return ClothSim(gb.build_scene(cfg), device=device, dtype=dtype,
                    eps_backward=eps_backward,
                    flags=SimFlags(wind_enabled=True, adjoint_mode=mode,
                                   max_backward_iters=max_backward_iters))


def phase_control_gmres(card):
    """17e: the GMRES adjoint.  The flagship stand-in (B = GMRES_BATCH, half
    folded, GMRES_STEPS steps): the batched value-and-grad of
    GradMask(f_wind=True) against the base wind's rollout in "gmres" and in
    "fp", f32 on the card, their trips, matvecs and cosine (reported, not
    bounded); then "gmres" in f64, card against CPU (GMRES_REF_STEPS steps
    from the folded state, the adjoint to 1e-12), bounded as 12e."""
    import torch
    from diffcloth_tpu_torch.optim.helper import GradMask, OptimizeHelper
    out = {}
    for mode in ("fp", "gmres"):
        sim = gmres_sim(torch.float32, "cuda", GMRES_STEPS, mode)
        params = episode_params(sim, GMRES_BATCH)
        helper = OptimizeHelper(sim, GradMask(f_wind=True),
                                base_wind_target(sim, params),
                                param_base=params)
        X = np.stack([helper.params_to_vec(params.sample(i))
                      for i in range(GMRES_BATCH)])
        torch.cuda.synchronize()
        zero_counters()
        sim.bwd_stats.reset()
        t0 = time.perf_counter()
        L, G = helper.batched_loss_and_grad(X)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = sim.bwd_stats.summary()
        launches = read_counters()
        if not (np.isfinite(L).all() and np.isfinite(G).all()):
            raise AssertionError(f"[control-gmres] {mode}: non-finite")
        if launches["friction_bwd"] != st["launches"]:
            raise AssertionError(f"[control-gmres] {mode}: friction_bwd "
                                 f"{launches} vs {st}")
        out[mode] = G
        log(f"[control-gmres] {mode}, f32, {GMRES_STEPS} steps x "
            f"B={GMRES_BATCH} on {card}: {wall:.2f} s; loss mean "
            f"{L.mean():.6e}; {st['trips']:.0f} fixed-point trips, "
            f"{st['gmres_cycles']:.0f} GMRES cycles over the batch, "
            f"{st['gmres_matvecs']:.0f} GMRES matvecs, "
            f"{st['lane_trips'] / st['lane_steps']:.2f} trips (fp) or cycles "
            f"(gmres) per episode-step, {st['residual_vjps']:.0f} residual "
            f"VJPs; friction_bwd {launches['friction_bwd']}")
    a, b = out["fp"].reshape(-1), out["gmres"].reshape(-1)
    cos = float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))
    per = [float(x @ y / max(np.linalg.norm(x) * np.linalg.norm(y), 1e-300))
           for x, y in zip(out["fp"], out["gmres"])]
    log(f"[control-gmres] cosine(fp, gmres) of the batch's wind gradients "
        f"{cos:.8f}, per episode {np.array2string(np.array(per), precision=6)}"
        f"; max |gmres - fp| / max |fp| "
        f"{np.abs(b - a).max() / max(np.abs(a).max(), 1e-300):.3e} "
        f"(reported, not bounded)")

    def make(dev):
        # run to convergence (1e-12, up to 22 GMRES(16) cycles): at
        # REF_ADJOINT_EPS the two devices' cycles can stop on either side
        # of a threshold (on an H100 80GB HBM3, x0's gradient came 3.0e-6
        # of its largest entry apart)
        sim = gmres_sim(torch.float64, dev, GMRES_REF_STEPS, "gmres",
                        eps_backward=1e-12, max_backward_iters=400)
        return sim, folded_params(sim), squared_positions

    phase_card_vs_cpu("control-gmres-reference", make)


def phase_control_parallel(card):
    """17f: parallel/mesh.py on a world-size-1 NCCL group on the one card:
    the dp = 1 `batched_value_and_grad` equal to the plain batched
    value-and-grad averaged over the batch, exactly; the tp = 1
    `make_tp_solve` equal to the dense P^{-1} product, exactly; a step
    given that tp solve runs captured by default (its gather is the
    exchange kernels), equal bit for bit to `cuda_graphs=False` (losses,
    gradients, the kernels' launch counts) and its losses to the plain
    sim's, the kernels' own counts those the programs predict; another
    `solve_fn` with `cuda_graphs=True` raises.  The exchange kernels
    against their plain version (`exchange_entry`).  Then two processes
    sharing the card (`exchange_pair`).  Returns the JSON line's entry of
    the exchange, its launches those of the captured tp step's run."""
    import torch
    import torch.distributed as dist
    from diffcloth_tpu_torch.core import dense_ops as dn
    from diffcloth_tpu_torch.parallel import mesh as pmesh
    pmesh.initialize_distributed("nccl", f"tcp://localhost:{free_port()}",
                                 1, 0)
    try:
        mesh = pmesh.make_mesh(1, 1)
        sim = flagship(torch.float32, "cuda", PARALLEL_STEPS)
        params = episode_params(sim, 2)
        loss_fn = base_wind_target(sim, params)
        p_inv = sim.p_inv(params)
        L, g = pmesh.batched_value_and_grad(sim, loss_fn, mesh)(params,
                                                                p_inv)
        L_ref, g_ref = sim.episode_value_and_grad(loss_fn)(params)
        diffs = {k: float((getattr(g, k) - v.mean(dim=0)).abs().max())
                 for k, v in g_ref.items()}
        if not torch.equal(L, L_ref) or max(diffs.values()) != 0.0:
            raise AssertionError(f"[control-parallel] dp=1 vs plain: losses "
                                 f"{L} vs {L_ref}, gradients {diffs}")
        rhs = torch.randn((2, sim.n, 3), device=sim.device,
                          generator=torch.Generator(
                              sim.device).manual_seed(0))
        tp = pmesh.make_tp_solve(mesh.tp_group)(p_inv, rhs)
        dense = dn.mm(p_inv, rhs)
        if not torch.equal(tp, dense):
            raise AssertionError(f"[control-parallel] tp=1 solve differs "
                                 f"by {float((tp - dense).abs().max())}")
        log(f"[control-parallel] NCCL world size 1 on {card}: dp = 1 "
            f"batched_value_and_grad ({PARALLEL_STEPS} steps, B = 2) equals "
            f"the plain one exactly (losses {L.tolist()}, |dL/dwind| max "
            f"{float(g.wind.abs().max()):.4e}); the tp = 1 row-sharded solve "
            f"equals the dense P^-1 product exactly")

        def tp_step(cuda_graphs):
            sim_tp = flagship(torch.float32, "cuda", PARALLEL_STEPS,
                              solve_fn=pmesh.make_tp_solve(mesh.tp_group),
                              cuda_graphs=cuda_graphs)
            fn = pmesh.batched_value_and_grad(sim_tp, loss_fn, mesh,
                                              reduce_grads=False,
                                              p_inv_spec="tp")
            # captured: the warm-up, the capture, then a launch
            for _ in range(3 if sim_tp.cuda_graphs else 1):
                reset_graphs(sim_tp)
                torch.cuda.synchronize()
                zero_counters()
                out = fn(params, p_inv)
                torch.cuda.synchronize()
            return sim_tp, out, read_counters()

        sim_c, (L_c, g_c), launches = tp_step(None)
        if not sim_c.cuda_graphs or not graph_launches(sim_c)[0] \
                or not launches["peer_exchange"]:
            raise AssertionError(f"[control-parallel] the tp step: captured "
                                 f"{sim_c.cuda_graphs}, "
                                 f"{graph_launches(sim_c)[0]} program "
                                 f"launches, launches {launches}")
        check_graph_counts("control-parallel", sim_c, launches, tp=True)
        line = graph_line(sim_c)
        del sim_c
        sim_u, (L_u, g_u), launches_u = tp_step(False)
        del sim_u
        _equal_outputs("control-parallel", dict(g_u.items(), losses=L_u),
                       dict(g_c.items(), losses=L_c))
        if launches_u != launches or not torch.equal(L_c, L_ref):
            raise AssertionError(f"[control-parallel] the tp step: launches "
                                 f"captured {launches}, uncaptured "
                                 f"{launches_u}; losses {L_c} vs plain "
                                 f"{L_ref}")
        try:
            flagship(torch.float32, "cuda", PARALLEL_STEPS,
                     solve_fn=lambda p, rhs: dn.mm(p, rhs), cuda_graphs=True)
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("[control-parallel] cuda_graphs=True with "
                                 "another solve_fn did not raise")
        log(f"[control-parallel] tp = 1 step on NCCL ({PARALLEL_STEPS} "
            f"steps, B = 2): captured by default, equal bit for bit to "
            f"cuda_graphs=False (losses, gradients, launches {launches}) and "
            f"its losses to the plain sim's; {line}; another solve_fn with "
            f"cuda_graphs=True raises: {refused}")
        entry = exchange_entry(mesh, launches["peer_exchange"])
    finally:
        dist.destroy_process_group()
    exchange_pair(card)
    return entry


def exchange_entry(mesh, launches):
    """The exchange kernels on one rank (tp = 1: the block copied into the
    result) against their plain version, NCCL's all_gather_into_tensor in
    the tp solve's layout, exactly, at the flagship's block (B = 32, n =
    1024) and the dress's (B = 2, n = 7056); device times (torch.profiler)
    beside the plain version's, NCCL's one call over the same bytes (the
    library call) and the byte bound (the block read once, the result
    written once).  Returns the flagship's entry."""
    import torch
    import torch.distributed as dist
    from diffcloth_tpu_torch.parallel import exchange
    gather = exchange.RowGather(mesh.tp_group)
    out = []
    for tag, B, n in (("flagship", BATCH, 1024), ("dress", 2, 7056)):
        # the solve's block: the transpose of a contiguous (n, B, 3)
        x = torch.randn((n, B, 3), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
        flat, x = x.reshape(-1), x.transpose(0, 1)
        y = exchange.all_gather_rows(x, gather)
        ref = exchange.all_gather_rows_plain(x, mesh.tp_group)
        err = float((y - ref).abs().max())
        if not torch.equal(y, ref):
            raise AssertionError(f"[exchange] {tag}: kernel against NCCL "
                                 f"differs by {err}")
        buf = torch.empty_like(flat)
        fns = (lambda: exchange.all_gather_rows(x, gather),
               lambda: exchange.all_gather_rows_plain(x, mesh.tp_group),
               lambda: dist.all_gather_into_tensor(buf, flat,
                                                   group=mesh.tp_group))
        # device ms (torch.profiler) and CUDA-event ms of back-to-back
        # calls (the host's rate, where it is slower)
        ms, plain_ms, lib_ms = (device_ms(f, 200, 10) for f in fns)
        ev = [time_cuda(f, 200, 10) for f in fns]
        bound = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
        log(f"[exchange] {tag} block (B = {B}, n = {n}) on one rank: "
            f"kernel == NCCL's all-gather exactly; device ms (CUDA events "
            f"of back-to-back calls): kernel {ms:.4f} ({ev[0]:.4f}), plain "
            f"(NCCL in the solve's layout) {plain_ms:.4f} ({ev[1]:.4f}), "
            f"NCCL all_gather_into_tensor over the same bytes {lib_ms:.4f} "
            f"({ev[2]:.4f}); bound {bound:.5f} ms (bytes)")
        out.append(dict(name="peer_exchange" + ("" if tag == "flagship"
                                                else "_dress"),
                        route="cuda",
                        source="diffcloth_tpu_torch/csrc/peer_exchange.cu",
                        replaces="diffcloth_tpu/parallel/mesh.py:55 "
                                 "(jax.lax.all_gather in make_tp_solve; no "
                                 "Pallas kernel)",
                        launches=launches, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                        library_ms=lib_ms))
    return out[0]


EXCHANGE_PAIR_S = 300


def exchange_pair(card):
    """17f's two ranks on the one card, tp = 2: the cases `exchange_while`
    (the exchange in a WHILE body, 100 rounds, at the dress's block) and
    `tp_step` (the flagship's tp step, captured against uncaptured and
    against the plain step) of tests/torch_parallel_cuda_worker.py, each
    as two processes sharing card 0 (gloo for the handles: NCCL refuses
    two ranks on one card; CUDA IPC maps within it), each within
    EXCHANGE_PAIR_S, held by the worker's own checks."""
    import tempfile
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_parallel_cuda_worker as tpw
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        probe = tpw.passed(tpw.run_ranks("exchange_while", f"{tmp}/x",
                                         [0, 0], EXCHANGE_PAIR_S,
                                         backend="gloo"))["ranks"]
        if probe[0]["body_runs"] != probe[1]["body_runs"] \
                or not all(r["equal"] and r["launches"] for r in probe):
            raise AssertionError(f"[exchange-pair] {probe}")
        step = tpw.run_ranks("tp_step", f"{tmp}/s", [0, 0], EXCHANGE_PAIR_S,
                             backend="gloo")
        tpw.check_tp_step(step, 2, "exchange-pair")
    a, info = step["arrays"][0], step["ranks"][0]["captured"]
    err = float(np.abs(a["captured_losses"] - a["plain_losses"]).max())
    log(f"[exchange-pair] two processes on {card}, tp = 2: the exchange "
        f"in a WHILE body, {probe[0]['body_runs']} rounds, equal to the "
        f"expected blocks; the flagship's tp step captured == uncaptured "
        f"bit for bit, the ranks equal, {info['launches']} program "
        f"launches; losses and gradients within "
        f"{tpw.F32_RTOL} of the plain step's, those in "
        f"{tpw.GRAD_RTOL} within theirs (losses by {err:.3e}); "
        f"{time.perf_counter() - t0:.1f} s")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_control(card, timed):
    """Phase 17, the control path (the closed-loop hat controller on the
    hat stand-in).  Returns the JSON line's entries of the three kernels at
    its shapes (names ending "_control"), their launches counted around
    17c's loss_and_grad."""
    import torch
    from diffcloth_tpu_torch.apps import hat_controller as hc
    with timed("control kernels"):
        task = hat_task(torch.float32, "cuda")
        prob = hc.make_problem(task, HAT_STEPS)
        rng = np.random.RandomState(8)
        x0 = control_states(prob, rng)
        mu = task.sim.prims.mu.cpu().numpy()[None].repeat(len(x0), 0)
        entries = phase_kernels("control-kernels", task.sim, x0, rng, mu=mu,
                                suffix="_control")
        del task, prob
    with timed("control facade"):
        phase_control_facade(card)
    with timed("control train"):
        launches, ctrl, tmp = phase_control_train(card)
    with timed("control profile"):
        phase_control_profile(card, ctrl)
    with timed("control eval"):
        phase_control_eval(card, os.path.join(tmp.name, "controller.pkl"))
    tmp.cleanup()
    with timed("control chunked"):
        phase_control_chunked(card, ctrl)
    with timed("control gmres"):
        phase_control_gmres(card)
    with timed("control parallel"):
        exchange = phase_control_parallel(card)
    for e in entries:
        e["launches"] = launches[e["name"][:-len("_control")]]
    return entries + [exchange]


# ---------------------------------------------------------------------------
# phase 18: the compiled step, graphed against uncaptured

GRAPHS_FLAGSHIP_STEPS = 8
GRAPHS_SPHERE_STEPS = 16
GRAPHS_LARGE_STEPS = 2
GRAPHS_CONTROL_STEPS = 20


def graph_blocks(sim) -> dict:
    """{(loop, block length): [body runs, program launches, kernels per
    body run]} over the sim's step programs' loops since their last reset;
    loop "pd" (PD sweeps), "trips" (fixed-point trips), "fallback" (the
    GMRES fallback's cycles) or "gmres" (the GMRES mode's cycles)."""
    out = {}
    for g in sim.graphs:
        for p in g.summary().values():
            for lp in p["loops"]:
                row = out.setdefault((lp["name"], lp["every"]), [0, 0, {}])
                row[0] += lp["runs"]
                row[1] += p["launches"]
                row[2].update(lp["kernels"])
    return out


def graph_launches(sim) -> tuple:
    """(program launches, warm-up runs) since the programs' last reset."""
    ps = [p for g in sim.graphs for p in g.summary().values()]
    return sum(p["launches"] for p in ps), sum(p["eager"] for p in ps)


def graph_line(sim) -> str:
    rows = graph_blocks(sim)
    if not rows:
        return "none (uncaptured)"
    launches, eager = graph_launches(sim)
    return f"{launches} program launches, {eager} warm-ups; " + "; ".join(
        f"{name}[{k}] {runs} body runs ({kern or 'no kernel'} per run)"
        for (name, k), (runs, _, kern) in sorted(rows.items()))


def reset_graphs(sim):
    for g in sim.graphs:
        g.reset()


def check_graph_counts(tag, sim, launches, adjoint=None, tp=False,
                       sweeps=True):
    """The programs' bookkeeping against the counters: each PD body holds
    one forward sweep per PD sweep and each trip body one backward sweep
    and the linearized product's kernels per trip (kernels per body run
    equal to its length);
    in a run without warm-ups, the launches' straight kernels plus the
    bodies' device-counted runs x their kernels are the counters, and the
    trip bodies' runs x length the adjoint's trips (adjoint: its trips);
    tp: the step's solve is the tensor-parallel one, whose exchange runs
    once per PD sweep and per trip too; sweeps=False: an ablated step
    (`self_ablate`), whose bodies hold no sweep."""
    rows = graph_blocks(sim)
    for (name, k), (runs, _, kern) in rows.items():
        want = {"pd": {"friction_fwd": k},
                "trips": {"friction_bwd": k, "kdv_pre": k, "kdv_rows": k,
                          "trip_update": k}}.get(name)
        if want is not None and not sweeps:
            want = ({"kdv_pre": k, "kdv_rows": k, "trip_update": k}
                    if name == "trips" else {})
        if want is not None and tp:
            want = dict(want, peer_exchange=k)
        got = {n: c for n, c in kern.items()
               if not n.endswith(("_global", "_stream"))}
        if want is not None and got != want:
            raise AssertionError(f"[{tag}] {name}[{k}]: kernels per body "
                                 f"run {kern}, not {want}")
    if graph_launches(sim)[1]:
        return
    derived = {}
    for g in sim.graphs:
        for p in g.summary().values():
            for name, c in p["kernels"].items():
                derived[name] = derived.get(name, 0) + c * p["launches"]
            for lp in p["loops"]:
                for name, c in lp["kernels"].items():
                    derived[name] = derived.get(name, 0) + c * lp["runs"]
    got = {k: v for k, v in launches.items() if v}
    derived = {k: v for k, v in derived.items() if v}
    trips = sum(runs * k for (name, k), (runs, _, _) in rows.items()
                if name == "trips")
    if derived != got or (adjoint is not None and trips != adjoint):
        raise AssertionError(
            f"[{tag}] the programs derive {derived} launches and {trips} "
            f"trips; counted {got}, the adjoint's trips {adjoint}")


def _equal_outputs(tag, ref, out):
    """Every output bit for bit: max abs difference 0 (tensors or numpy)."""
    import torch
    for k, a in ref.items():
        b = out[k]
        if isinstance(a, torch.Tensor):
            if not torch.equal(a, b):
                d = float((a.double() - b.double()).abs().max())
                raise AssertionError(f"[graphs] {tag}: {k} differs between "
                                     f"graphed and uncaptured by {d:.3e}")
        elif not np.array_equal(a, b):
            raise AssertionError(f"[graphs] {tag}: {k} differs between "
                                 f"graphed and uncaptured by "
                                 f"{float(np.abs(a - b).max()):.3e}")


def graph_paths():
    """(path, B, steps, make(graphs, steps) -> {case: run}) per path; a
    path builds its sim once per way, and each run of its cases returns
    (outputs, counters, adjoint summary or None, PD sweeps or None)."""
    import torch
    from diffcloth_tpu_torch.apps import hat_controller as hc
    from diffcloth_tpu_torch.optim.helper import GradMask, OptimizeHelper
    from diffcloth_tpu_torch.tasks.setup import build_task

    def forward(sim, params):
        def run():
            zero_counters()
            st = sim.rollout(params).steps
            out = {k: getattr(st, k) for k in (
                "x", "v", "f", "r", "iters", "cg_iters", "converged",
                "selfcol_pairs", "selfcol_slots", "selfcol_overflow",
                "obstacle_contacts")}
            return (out, read_counters(), None,
                    int(pd_sweeps(st.iters.cpu().numpy(), sim).sum()))
        return run

    def gradient(sim, helper, X):
        def run():
            zero_counters()
            sim.bwd_stats.reset()
            L, G = helper.batched_loss_and_grad(X)
            return ({"loss": L, "grad": G}, read_counters(),
                    sim.bwd_stats.summary(), None)
        return run

    def flagship_path(g, steps):
        sim = flagship(torch.float32, "cuda", steps, cuda_graphs=g)
        params = episode_params(sim, BATCH)
        helper = OptimizeHelper(sim, GradMask(f_wind=True),
                                base_wind_target(sim, params),
                                param_base=params)
        X = np.stack([helper.params_to_vec(params.sample(i))
                      for i in range(BATCH)])
        return sim, {"forward": forward(sim, params),
                     "value-and-grad": gradient(sim, helper, X)}

    def sphere_path(g, steps):
        with demo_steps("sphere", steps):
            task = build_task("sphere", device="cuda", cuda_graphs=g)
        helper = OptimizeHelper(task.sim, task.mask, task.loss_fn(),
                                param_base=task.param_base)
        X = sphere_candidates(SPHERE_BATCH)
        return task.sim, {"forward": forward(task.sim, helper.stack_vecs(X)),
                          "value-and-grad": gradient(task.sim, helper, X)}

    def large_path(g, steps):
        sim = large_mesh(torch.float32, "cuda", steps, cuda_graphs=g)
        return sim, {"forward": forward(sim, episode_params(sim,
                                                            LARGE_BATCH))}

    def control_path(g, steps):
        prob, xs, aas, ctrl = control_case(steps, cuda_graphs=g)

        def run():
            zero_counters()
            prob.sim.bwd_stats.reset()
            pg = hc.loss_and_grad(prob, ctrl, xs, aas)
            out = {"loss": pg.loss, "iters": pg.iters,
                   "gnorms": pg.sample_gnorms}
            out.update({f"grad{i}": g for i, g in enumerate(pg.grads)})
            return (out, read_counters(), prob.sim.bwd_stats.summary(),
                    int(pd_sweeps(pg.iters.cpu().numpy(), prob.sim).sum()))
        return prob.sim, {"loss_and_grad": run}

    return (("flagship", BATCH, GRAPHS_FLAGSHIP_STEPS, flagship_path),
            ("sphere", SPHERE_BATCH, GRAPHS_SPHERE_STEPS, sphere_path),
            ("large", LARGE_BATCH, GRAPHS_LARGE_STEPS, large_path),
            ("control", HAT_BATCH, GRAPHS_CONTROL_STEPS, control_path))


def phase_graphs(card):
    """18: each path's runs with cuda_graphs=None (captured) and False
    (uncaptured), on two sims of one configuration, one a way for all the
    path's cases: per case a cold run each way (the graphed one warms up
    and captures its blocks), then graphed, uncaptured; every output
    (states, diagnostic counts, losses, gradients) and every kernel counter
    of every run equal to the first's bit for bit; the graphs' replays and
    the launches they derive held to the counters and the adjoint's trips;
    the rates of the warm runs; then a profiled graphed run on the same
    sim: device busy, device and host launches per PD sweep (forward) or
    per step, replays per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for path, B, N, make in graph_paths():
        units = B * N
        sims = {g: make(g, N) for g in (None, False)}
        for case in sims[None][1]:
            name = f"{path} {case}"
            ref = None
            rates = {}
            for i, g in enumerate((None, False, None, False)):
                sim, runs = sims[g]
                reset_graphs(sim)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, launches, st, sweeps = runs[case]()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if ref is None:
                    ref = (out, launches, st)
                _equal_outputs(name, ref[0], out)
                if launches != ref[1] or (st or {}) != (ref[2] or {}):
                    raise AssertionError(f"[graphs] {name}: counters "
                                         f"{launches} {st}, the first "
                                         f"run's {ref[1]} {ref[2]}")
                if g is None:
                    check_graph_counts(name, sim, launches,
                                       st and st["trips"])
                    if i >= 2 and not graph_launches(sim)[0]:
                        raise AssertionError(f"[graphs] {name}: no program "
                                             f"launch")
                if i >= 2:
                    rates[g] = units / wall
                log(f"[graphs] {name}, run {i} "
                    f"({'graphed' if g is None else 'uncaptured'}"
                    f"{', cold' if i < 2 else ''}) on {card}: {wall:.3f} s, "
                    f"{units / wall:.1f} "
                    f"{'PD' if st is None else 'episode-gradient'} steps/s; "
                    f"launches {launches}"
                    + (f"; {sweeps} PD sweeps" if sweeps else "")
                    + (f"; graphs {graph_line(sim)}" if g is None else ""))
            log(f"[graphs] {name} on {card}: graphed {rates[None]:.1f} "
                f"against uncaptured {rates[False]:.1f} steps/s (runs 2-3), "
                f"{rates[None] / rates[False]:.2f}x; every output and "
                f"counter of the four runs equal bit for bit")
            # the graphed way alone: the profiler takes tens of seconds to
            # sum an uncaptured run's events
            sim, runs = sims[None]
            reset_graphs(sim)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out, launches, st, sweeps = runs[case]()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            ops = profiled_ops(prof)
            busy = sum(ms for _, ms, _ in ops)
            # a forward per PD sweep, a gradient path per step
            div, per = (sweeps, "PD sweep") if st is None else (N, "step")
            hosted = host_launches(prof)
            log(f"[graphs-profile] {name}, {N} steps x B={B} (graphed) on "
                f"{card}: wall {wall_ms:.1f} ms (inflated by the profiler), "
                f"device busy (as the profiler sees it) {busy:.1f} ms "
                f"({100 * busy / wall_ms:.1f} %); per {per} ({div}): "
                f"{sum(c for _, _, c in ops) / div:.1f} device launches, "
                + (f"{hosted / div:.1f}" if hosted else "(not measured)")
                + f" host launches; {graph_launches(sim)[0] / N:.2f} program "
                f"launches per step")
        del sims
        torch.cuda.empty_cache()


CHUNKED_FLAGSHIP = (BATCH, 50, 25)          # B, steps, chunk
CHUNKED_SPHERE = (SPHERE_BATCH, 40, 20)
CHUNKED_REF_STEPS = 6                        # f64 card vs CPU, chunk 3
# the profiled runs' depth and chunk (phase 19's profiling process; the
# profiler's cost grows with its events)
CHUNKED_PROFILE = (8, 4)
# the CUDA runtime calls with which the host waits on the card
HOST_SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")


def runtime_counts(prof) -> tuple:
    """(host launches: kernels, graphs and async copies / sets; host waits:
    {synchronizing runtime call: count}) among a profile's CUDA runtime
    events."""
    launches, syncs = 0, {}
    for e in prof.key_averages():
        key = e.key.split("_v")[0]
        if key in HOST_LAUNCHES or key in ("cudaMemcpyAsync",
                                           "cudaMemsetAsync"):
            launches += e.count
        elif key in HOST_SYNCS:
            syncs[key] = syncs.get(key, 0) + e.count
    return launches, syncs


def program_busy(fn):
    """(wall s, device busy s) of fn(): the device time of the step
    programs it launches (CUDA events around each launch; the profiler sees
    few or none of the kernels inside the programs' loop bodies, so its
    sums cannot stand in), against the wall time."""
    import torch
    from diffcloth_tpu_torch.core import graphs as gr
    torch.cuda.synchronize()
    gr.TIMING = []
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy = sum(a.elapsed_time(b) for a, b in gr.TIMING) / 1e3
    finally:
        gr.TIMING = None
    return wall, busy


def chunked_cases():
    """(name, (B, steps, chunk), make(steps) -> (sim, batched params,
    loss_fn)) per path of phase 19."""
    import torch
    from diffcloth_tpu_torch.optim.helper import OptimizeHelper
    from diffcloth_tpu_torch.tasks.setup import build_task

    def flagship_case(steps):
        sim = flagship(torch.float32, "cuda", steps)
        params = episode_params(sim, CHUNKED_FLAGSHIP[0])
        return sim, params, base_wind_target(sim, params)

    def sphere_case(steps):
        with demo_steps("sphere", steps):
            task = build_task("sphere", device="cuda")
        helper = OptimizeHelper(task.sim, task.mask, task.loss_fn(),
                                param_base=task.param_base)
        return (task.sim,
                helper.stack_vecs(sphere_candidates(CHUNKED_SPHERE[0])),
                task.loss_fn())

    return (("flagship", CHUNKED_FLAGSHIP, flagship_case),
            ("sphere", CHUNKED_SPHERE, sphere_case))


def phase_chunked_path(name, shape, make, card):
    """19 on one path: the gates, the rates both ways, device busy, host
    launches and waits per step, the loops' body runs and peak memory."""
    import torch
    tag = f"chunked-{name}"
    B, N, chunk = shape
    sim, params, loss_fn = make(N)
    vg_whole = sim.episode_value_and_grad(loss_fn)
    vg_chunk = sim.episode_value_and_grad_chunked(loss_fn, chunk,
                                                  batched=True)
    whole = sim.rollout(params).steps       # warm-up and capture
    reset_graphs(sim)
    zero_counters()
    t0 = time.perf_counter()
    ch = sim.rollout_chunked(params, chunk).steps
    torch.cuda.synchronize()
    wall_fwd = time.perf_counter() - t0
    launches = read_counters()
    # the kernels' own counts against what the programs' launches and the
    # loops' device-counted body runs predict
    check_graph_counts(tag, sim, launches)
    for k in ("x", "v", "x_fixed", "iters", "converged", "avg_deformation",
              "max_deformation", "selfcol_overflow", "selfcol_pairs",
              "selfcol_slots", "obstacle_contacts", "cg_iters"):
        if not torch.equal(getattr(ch, k), getattr(whole, k)):
            raise AssertionError(f"[{tag}] rollout_chunked's {k} differs "
                                 f"from rollout's")
    iters = ch.iters.cpu().numpy()
    sweeps = int(pd_sweeps(iters, sim).sum())
    # the kernels' counts against the sweeps the episodes' iteration
    # counts imply
    check_launches(tag, launches, N, sweeps)
    L_whole = sim.episode_loss(loss_fn)(params)
    L_chunk = sim.episode_loss_chunked(loss_fn, chunk, batched=True)(params)
    if not torch.equal(L_whole, L_chunk):
        raise AssertionError(f"[{tag}] chunked loss {L_chunk} != whole "
                             f"{L_whole}")
    Lw, gw = vg_whole(params)
    reset_graphs(sim)
    zero_counters()
    sim.bwd_stats.reset()
    Lc, gc = vg_chunk(params)
    launches_g = read_counters()
    st = sim.bwd_stats.summary()
    check_launches(tag + "-gradient", launches_g, N, sweeps, st, passes=2)
    check_graph_counts(tag + "-gradient", sim, launches_g, st["trips"])
    if not torch.equal(Lw, Lc):
        raise AssertionError(f"[{tag}] value-and-grad losses differ")
    rel = grads_rel({k: v for k, v in gw.items()},
                    {k: v for k, v in gc.items()})
    if not all(np.isfinite(v) and v <= 1e-5 for v in rel.values()):
        raise AssertionError(f"[{tag}] chunked gradient against whole: "
                             f"{rel} of each class's largest entry")
    log(f"[{tag}] {N} steps x B={B}, chunk {chunk} on {card}: "
        f"rollout_chunked == rollout bit for bit (states, diagnostics), "
        f"{sweeps} PD sweeps; launches {launches} (detection once per "
        f"step, friction_fwd once per sweep); chunked loss == whole bit for "
        f"bit; chunked value-and-grad launches {launches_g} (the forward "
        f"twice: the backward recomputes each chunk), adjoint "
        f"{st['trips']:.0f} trips, {st['fallback_lanes']:.0f} of "
        f"{st['lane_steps']:.0f} episode-steps to the GMRES fallback; "
        f"gradient against the whole episode's (tolerance 1e-5): "
        + ", ".join(f"{k} {v:.1e}" for k, v in rel.items()))

    # the rates both ways: chunked, then whole
    rates = {"chunked": [], "whole": []}
    for way in ("chunked", "whole"):
        fwd = ((lambda: sim.rollout_chunked(params, chunk)) if way ==
               "chunked" else (lambda: sim.rollout(params)))
        vg = vg_chunk if way == "chunked" else vg_whole
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vg(params)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rates[way].append((B * N / (t1 - t0), B * N / (t2 - t1)))
    for way, rs in rates.items():
        log(f"[{tag}] {way}: " + "; ".join(
            f"{f:.1f} PD steps/s, {g:.1f} episode-gradient steps/s"
            for f, g in rs))
    log(f"[{tag}] first forward (rollout_chunked after rollout's capture): "
        f"{B * N / wall_fwd:.1f} PD steps/s")

    # device busy, from CUDA events around every program launch; the
    # loops' body runs over the chunked value-and-grad
    p_inv, xfs = sim.p_inv(params), sim.x_fixed_seq(params)
    for what, fn in (
            ("forward", lambda: sim._chunk_forward(params, p_inv, xfs,
                                                   chunk)),
            ("value-and-grad", lambda: vg_chunk(params))):
        reset_graphs(sim)
        wall, busy = program_busy(fn)
        log(f"[{tag}] {what}: wall {wall:.3f} s, the step programs busy on "
            f"the device {busy:.3f} s ({100 * busy / wall:.1f} %)")
    log(f"[{tag}] that chunked value-and-grad: {graph_line(sim)}; loops "
        f"end on the device (no body is launched to be skipped)")

    # host launches and waits per step, profiled in a fresh process (the
    # profiler's runtime events then hold this path's calls alone); a
    # profiling process that fails or leaves out a row fails the phase
    prof = subprocess.run(
        [sys.executable, "-X", "faulthandler", os.path.abspath(__file__),
         "--profile-chunked", name], capture_output=True, text=True,
        timeout=600)
    rows = [json.loads(ln) for ln in prof.stdout.splitlines()
            if ln.startswith("{")]
    if prof.returncode or [r["what"] for r in rows] != ["forward",
                                                       "value-and-grad"]:
        raise AssertionError(
            f"[{tag}] the profiling process ended with rc "
            f"{prof.returncode} and rows {[r['what'] for r in rows]}; its "
            f"output ends:\n{prof.stdout[-1500:]}\n{prof.stderr[-3000:]}")
    for row in rows:
        log(f"[{tag}] {row['what']} ({row['steps']} steps, chunk "
            f"{row['chunk']}; profiled in a fresh process): "
            f"{row['launches'] / row['steps']:.1f} host launches and "
            f"{row['waits'] / row['steps']:.2f} synchronizing runtime "
            f"calls per step ({row['syncs']} in all, "
            f"{row['base_syncs']} in an empty profiled region; a "
            f"value-and-grad's come at its start and end: the host "
            f"P^-1 and the forward / backward split)")
    torch.cuda.set_sync_debug_mode("error")
    try:
        sim._chunk_forward(params, p_inv, xfs, chunk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[{tag}] the chunks' forward ran under PyTorch's sync debug mode "
        f"'error': no synchronizing PyTorch call")


    # peak memory of the two value-and-grads at the same depth
    peaks = {}
    for way, vg in (("whole", vg_whole), ("chunked", vg_chunk)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        vg(params)
        torch.cuda.synchronize()
        peaks[way] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    log(f"[{tag}] peak allocated memory over the call: whole episode "
        f"{peaks['whole']:.1f} MiB, chunked {peaks['chunked']:.1f} MiB")
    del sim
    torch.cuda.empty_cache()


def phase_chunked_reference():
    """19c: the chunked value-and-grad of a small folded batch in f64 on
    the card against the CPU (10 x 10 grid, B = 2, CHUNKED_REF_STEPS
    steps, chunk 3): the loss to 1e-9 and each gradient class within 1e-6
    of its largest entry."""
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
        cfg, step_num=CHUNKED_REF_STEPS, backward_convergence_thresh=1e-8,
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
            target = sim.rollout_chunked(p.replace(wind=t64(winds)),
                                         3).full_x()
        loss_fn = losses.make_loss_fn(
            LossType.MATCH_TRAJECTORY,
            losses.LossInfo(target_x=target.to(sim.device)))
        L, g = sim.episode_value_and_grad_chunked(loss_fn, 3, batched=True)(
            p.replace(wind=t64(winds * 0.7)))
        out[dev] = (L.cpu(), {k: v.cpu() for k, v in g.items()})
    (Lc, gc), (Lg, gg) = out["cpu"], out["cuda"]
    rel = grads_rel(gc, gg)
    if max(rel.values()) > 1e-6 or not torch.allclose(Lg, Lc, rtol=1e-9,
                                                      atol=0):
        raise AssertionError(f"[chunked-reference] card vs CPU loss {Lg} vs "
                             f"{Lc}, gradient {rel}")
    log(f"[chunked-reference] 10x10 folded grid, {CHUNKED_REF_STEPS} steps, "
        f"chunk 3, f64, B=2: card vs CPU loss {Lg.tolist()} vs "
        f"{Lc.tolist()}; gradient max error per class / its largest entry "
        f"(tolerance 1e-6): " + ", ".join(f"{k} {v:.1e}"
                                          for k, v in rel.items()))


def profile_chunked(name):
    """`--profile-chunked NAME`: phase 19's path NAME cut to
    CHUNKED_PROFILE (steps, chunk), its chunked forward and value-and-grad
    each warmed up, then profiled (torch.profiler, the CUDA runtime's
    events); one JSON line each: host launches, synchronizing calls, and
    those of an empty profiled region."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    make = dict((n, m) for n, _, m in chunked_cases())[name]
    steps, chunk = CHUNKED_PROFILE
    sim, params, loss_fn = make(steps)
    vg = sim.episode_value_and_grad_chunked(loss_fn, chunk, batched=True)
    p_inv, xfs = sim.p_inv(params), sim.x_fixed_seq(params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
    base = sum(runtime_counts(prof)[1].values())
    for what, fn in (("forward",
                      lambda: sim._chunk_forward(params, p_inv, xfs, chunk)),
                     ("value-and-grad", lambda: vg(params))):
        fn()                        # warm-ups and captures
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launches, syncs = runtime_counts(prof)
        print(json.dumps(dict(what=what, steps=steps, chunk=chunk,
                              launches=launches, syncs=syncs,
                              base_syncs=base,
                              waits=sum(syncs.values()) - base)), flush=True)


def phase_chunked(card, timed):
    """Phase 19, the chunked episode."""
    for name, shape, make in chunked_cases():
        with timed(f"chunked {name}"):
            phase_chunked_path(name, shape, make, card)
    with timed("chunked reference"):
        phase_chunked_reference()


# 20: the flagship stand-in at drop-free self-collision capacity
CAPACITY_K = (8, 16, 32)     # partner slots tried in turn until none drops
CAPACITY_CHUNK = 25
CAPACITY_REF = (16, 2, 6)    # the f64 reference: grid, B, steps
CAPACITY_PILE = 100          # stacked vertices of the K = 64 input


def drop_free(n, k=CAPACITY_K[0]):
    """ClothSim options that drop no self-contact slot on an n-vertex
    cloth: 16 layering rounds, each with a friction budget of n, and k
    partner slots per row."""
    return dict(self_k_partners=k, self_max_layers=16,
                self_compact_layers=16, self_compact_budgets=(n,) * 16)


def phase_capacity_kernels(sim, rng):
    """20a: the kernels at the flagship's drop-free shapes (B = 32, budgets
    (n,) * 16: 16 384 slots a sample, past shared memory): both sweeps on
    the streamed-slot route with the state in shared memory (the route
    the path takes), against their plain versions exactly; detection at
    K = 64 (the kernel's second instantiation) on the folded states with
    CAPACITY_PILE vertices of the first segment stacked in sample 1 (rows
    past 64 hits), exactly.  Returns the JSON line's entries of the
    streamed route."""
    import torch
    from diffcloth_tpu_torch.core import selfcol_cuda as scd

    dev, cfg, n, h = sim.device, sim.self_cfg, sim.n, sim.h
    x, v = kernel_states(sim, initial_states(sim, BATCH), rng)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                    device=dev)
    radii = sim.scene_dev.radii
    n_pad = cfg.allowed.shape[0]
    x64 = x.copy()
    # in the first 512-column segment: hits split across segments may
    # stop the count at K (csrc/selfcol_detect.cu)
    pile = np.arange(5, 512, 5)[:CAPACITY_PILE]
    x64[1, pile] = x64[1, pile[0]]
    geom64 = scd.build_geom(f32(x64), f32(v), radii, h, n_pad)
    tab_k = scd.detect_partners(geom64, cfg.allowed, 64)
    tab_p = scd.detect_partners_plain(geom64, cfg.allowed, 64)
    torch.cuda.synchronize()
    if not torch.equal(tab_k, tab_p):
        bad = (tab_k != tab_p).any(-1).nonzero()[:5].tolist()
        raise AssertionError(f"detection kernel != plain at K = 64, rows "
                             f"{bad}")
    over = int((tab_k[:, :n, 64] > 64).sum())
    past32 = int((tab_k[:, :n, 32:64] >= 0).any(-1).sum())
    if over == 0 or past32 == 0:
        raise AssertionError("the K = 64 input lacks overflow rows or rows "
                             "past 32 slots")
    det = lambda: scd.detect_partners(geom64, cfg.allowed, 64)  # noqa: E731
    det_ms = device_ms(det, kernel="detect_kernel")
    det_plain_ms = device_ms(
        lambda: scd.detect_partners_plain(geom64, cfg.allowed, 64), reps=5)
    det_bytes = (geom64.numel() * 4 + cfg.allowed.numel()
                 + tab_k.numel() * 4)
    det_ops = BATCH * int((cfg.allowed > 0).sum()) * DETECT_OPS_PER_PAIR
    det_bound = max(det_bytes / HBM_BYTES_PER_S, det_ops / F32_FLOPS) * 1e3
    log(f"[capacity-kernels] detection at K = 64: kernel == plain exactly "
        f"on (B={BATCH}, n_pad={n_pad}); {over} overflow rows, {past32} "
        f"rows holding slots past 32; device ms per call kernel "
        f"{det_ms:.4f} (phase 2 times K = 8), plain "
        f"{det_plain_ms:.4f}; bound {det_bound:.5f}")

    kg, masses, f, g = capacity_sweep_inputs(sim, x, v, rng)
    layers = int((kg.counts > 0).sum(-1).max())
    if layers < 3:
        raise AssertionError(f"contact in {layers} layers only")
    log(f"[capacity-kernels] slot geometry at budgets (n,) * 16: TC "
        f"{kg.idx_row.shape[1]} a sample, contact in up to {layers} "
        f"layers")
    sweeps, bounds, _ = check_sweeps("capacity-kernels", kg, masses, f, g,
                                     n, cfg, route="shared", slots="stream")
    return sweep_entries(sweeps, bounds, "_stream", "shared", "stream")


def capacity_sweep_inputs(sim, x, v, rng):
    """20a's sweep inputs on the drop-free sim's states x, v (numpy, (B,
    n, 3)): detection at the sim's K, the layer tables, the slot geometry
    at its budgets, the slot masses, and random f and g (B, n, 3) f32.
    Returns (geometry, masses, f, g)."""
    import torch
    from diffcloth_tpu_torch.core import friction_cuda as fc
    from diffcloth_tpu_torch.core import selfcol_cuda as scd
    from diffcloth_tpu_torch.core.selfcol import layer_tables_from_partners

    dev, cfg, n = sim.device, sim.self_cfg, sim.n
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                    device=dev)
    B, K = x.shape[0], cfg.k_partners
    geom = scd.build_geom(f32(x), f32(v), sim.scene_dev.radii, sim.h,
                          cfg.allowed.shape[0])
    tab = scd.detect_partners(geom, cfg.allowed, K)
    tables = layer_tables_from_partners(tab[:, :n, :K], cfg.max_layers)
    kg = fc.build_kernel_geom(tables, sim.scene_dev.area, n, cfg.budgets,
                              x=f32(x))
    density = torch.full((B,), sim.cfg.fabric.density, dtype=torch.float32,
                         device=dev)
    masses = fc.slot_masses(kg, density)
    f = f32(rng.randn(B, n, 3) * 0.05)
    g = f32(rng.randn(B, n, 3))
    return kg, masses, f, g


# 20a's global-state streamed route: n (a state past shared memory), B,
# and the pairs of random matchings in layers 0-3
CAPACITY_GLOBAL = (19500, 2, (400, 300, 150, 70))


def phase_capacity_global_stream(rng):
    """20a, the global-state streamed route where sweep_operands picks it:
    n = 19 500, B = 2, budgets (n,) * 16, random matchings in four layers;
    both sweeps against their plain versions exactly (with and without
    contact), timed; then its path: `self_friction` on f and its autograd
    backward of g, between zeroed and read launch counts, against the
    plain versions exactly.  Returns the JSON line's entries."""
    import types
    import torch
    from diffcloth_tpu_torch.core import friction_cuda as fc
    from diffcloth_tpu_torch.core.selfcol import SelfContactTables

    n, B, pairs = CAPACITY_GLOBAL
    budgets = (n,) * 16
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
    f = f32(rng.randn(B, n, 3) * 0.1)
    g = f32(rng.randn(B, n, 3))
    log(f"[capacity-kernels] the global-state streamed route: n = {n}, "
        f"B = {B}, budgets (n,) * 16 (TC {kg.idx_row.shape[1]} a sample), "
        f"active slots per layer {kg.counts[0, :4].tolist()}")
    sweeps, bounds, _ = check_sweeps(
        "capacity-kernels", kg, masses, f, g, n,
        types.SimpleNamespace(budgets=budgets), route="global",
        slots="stream")
    entries = sweep_entries(sweeps, bounds, "_global_stream", "global",
                            "stream")
    ops = fc.sweep_operands(kg, masses, budgets, n)
    fr = f.clone().requires_grad_(True)
    r0 = torch.zeros_like(f)
    torch.cuda.synchronize()
    zero_counters()
    r = fc.self_friction(fr, ops, r0)
    r.backward(g)
    launches = read_counters()
    for k in ("fwd", "bwd"):
        ran = [launches[f"friction_{k}{r}"]
               for r in ("", "_global", "_stream")]
        if ran != [1, 1, 1]:
            raise AssertionError(f"[capacity-kernels] self_friction's "
                                 f"friction_{k} launches {launches}, not "
                                 f"one on the global-state streamed route")
    out_p, vals_p = fc.friction_sweep_plain(f, kg, *masses, budgets)
    g_p = fc.friction_sweep_bwd_plain(g, kg, *masses, vals_p, budgets)[0]
    if not (torch.equal(r.detach(), out_p - f)
            and torch.equal(fr.grad, g_p - g)):
        raise AssertionError("[capacity-kernels] self_friction on the "
                             "global-state streamed route != plain")
    log(f"[capacity-kernels] its path: self_friction and its backward == "
        f"plain exactly; launches {launches}")
    entries[0]["launches"] = launches["friction_fwd_global"]
    entries[1]["launches"] = launches["friction_bwd_global"]
    return entries


def capacity_forward(tag, sim, params, card):
    """A chunked forward of `params` on `sim` (warmed up and captured by a
    first run), then the timed run between zeroed and read counters;
    returns (records, PD steps/s, launches, PD sweeps).  The kernels'
    counts are held to what the programs predict (an ablated sim's bodies
    hold no sweep)."""
    import torch
    sim.rollout_chunked(params, CAPACITY_CHUNK)
    reset_graphs(sim)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    st = sim.rollout_chunked(params, CAPACITY_CHUNK).steps
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    B, N = params.batch_size, sim.n_steps
    if not (bool(torch.isfinite(st.x).all()) and float(
            st.converged.float().mean()) == 1.0):
        raise AssertionError(f"[{tag}] non-finite or unconverged episode")
    sweeps = int(pd_sweeps(st.iters.cpu().numpy(), sim).sum())
    check_graph_counts(tag, sim, launches,
                       sweeps=sim.self_cfg.ablate == "")
    return st, B * N / wall, launches, sweeps


def capacity_gradient(tag, sim, params, loss_fn):
    """OptimizeHelper's chunked population value-and-grad (wind and x0) of
    `params`: a first call (warm-up and capture, its (L, G) kept), then the
    timed call between zeroed and read counters; returns ((L, G),
    episode-gradient steps/s, launches, BackwardStats summary)."""
    import torch
    from diffcloth_tpu_torch.optim.helper import GradMask, OptimizeHelper
    helper = OptimizeHelper(sim, GradMask(f_wind=True, x0=True), loss_fn,
                            param_base=params, chunk=CAPACITY_CHUNK)
    B = params.batch_size
    X = np.stack([helper.params_to_vec(params.sample(i)) for i in range(B)])
    first = helper.batched_loss_and_grad(X)
    reset_graphs(sim)
    torch.cuda.synchronize()
    zero_counters()
    sim.bwd_stats.reset()
    t0 = time.perf_counter()
    L, G = helper.batched_loss_and_grad(X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    st = sim.bwd_stats.summary()
    if not (np.array_equal(L, first[0]) and np.array_equal(G, first[1])):
        raise AssertionError(f"[{tag}] a repeated value-and-grad differs")
    if not (np.isfinite(L).all() and np.isfinite(G).all()
            and np.abs(G[:, :3]).max() > 0 and np.abs(G[:, 5:]).max() > 0):
        raise AssertionError(f"[{tag}] non-finite or zero gradient")
    check_graph_counts(tag, sim, launches, st["trips"])
    return (L, G), B * sim.n_steps / wall, launches, st


def phase_capacity_reference():
    """20e: a 16 x 16 grid folded half over half at drop-free capacity
    (budgets (256,) * 16: 4096 slots a sample, past shared memory, so the
    card's sweeps stream their slot rows), B = 2, 6 steps, f64: the episode
    and the chunked value-and-grad (chunk 3) on the card against the CPU,
    within 1e-6 (states) and 1e-6 of each class's largest entry."""
    import dataclasses
    import torch
    from diffcloth_tpu_torch import losses
    from diffcloth_tpu_torch.config import LossType
    from diffcloth_tpu_torch.core import friction_cuda as fc
    from diffcloth_tpu_torch.core.sim import ClothSim
    from diffcloth_tpu_torch.geometry import builder as gb
    from diffcloth_tpu_torch.geometry import states
    from diffcloth_tpu_torch.tasks.registry import TSHIRT_GRID_STANDIN

    grid, B, steps = CAPACITY_REF
    cfg = TSHIRT_GRID_STANDIN
    cfg = dataclasses.replace(cfg, step_num=steps, fabric=dataclasses.replace(
        cfg.fabric, grid_num_x=grid, grid_num_y=grid))
    scene = gb.build_scene(cfg)
    x0 = states.folded_grid(scene, grid // 2, 1.5 * float(scene.radii.mean()))
    out = {}
    for side, dev in (("card", "cuda"), ("cpu", "cpu")):
        sim = ClothSim(scene, device=dev, dtype=torch.float64,
                       **drop_free(scene.n))
        p = sim.default_params().expand(B).replace(
            x0=torch.as_tensor(np.stack([x0] * B), dtype=torch.float64,
                               device=sim.device),
            wind=torch.tensor([[0.5, 0.05, 0.5], [0.2, 0.0, 0.4]],
                              dtype=torch.float64, device=sim.device))
        if side == "card":
            zero_counters()
        recs = sim.rollout(p).steps
        target = torch.zeros((steps + 1, scene.n, 3), dtype=torch.float64,
                             device=sim.device)
        loss_fn = losses.make_loss_fn(LossType.MATCH_TRAJECTORY,
                                      losses.LossInfo(target_x=target))
        L, g = sim.episode_value_and_grad_chunked(loss_fn, 3,
                                                  batched=True)(p)
        if side == "card":
            launches = read_counters()
        out[side] = (recs, L, {k: v.cpu() for k, v in g.items()
                               if v is not None})
    (gr_, gL, gg), (cr, cL, cg) = out["card"], out["cpu"]
    if int(cr.selfcol_pairs.sum()) == 0 or bool(cr.selfcol_overflow.any()):
        raise AssertionError("the reference lacks contact or drops some")
    if launches["friction_fwd_stream"] == 0 or (
            launches["friction_fwd_stream"] != launches["friction_fwd"]):
        raise AssertionError(f"the reference's sweeps did not all stream: "
                             f"{launches}")
    err = float((gr_.x.cpu() - cr.x).abs().max())
    rel = grads_rel(cg, gg)
    lrel = float(((gL.cpu() - cL).abs() / cL.abs()).max())
    if err > 1e-6 or lrel > 1e-6 or not all(v <= 1e-6 for v in rel.values()):
        raise AssertionError(f"[capacity-reference] card vs CPU: max |dx| "
                             f"{err}, loss {lrel}, gradients {rel}")
    slots = int(cr.selfcol_slots.max())
    log(f"[capacity-reference] {grid} x {grid} folded grid at budgets "
        f"({scene.n},) * 16 (TC {fc.layer_specs((scene.n,) * 16)[1]}, the "
        f"streamed route: {launches['friction_fwd_stream']} forward and "
        f"{launches['friction_bwd_stream']} backward streamed sweeps), "
        f"{steps} steps, f64, B={B}: card vs CPU max |dx| {err:.3e}, loss "
        f"{lrel:.1e}, gradients " + ", ".join(f"{k} {v:.1e}" for k, v in
                                             rel.items())
        + f" (tolerance 1e-6); up to {slots} active slots a step")


def phase_capacity(card, timed):
    """20: the flagship stand-in (n = 1024, B = 32, half folded, 100 steps,
    chunks of 25) at drop-free capacity against the default capacity, all
    captured.  Returns the JSON line's entries of the streamed route."""
    import torch
    N, B, n = FLAGSHIP_STEPS, BATCH, 1024
    rng = np.random.RandomState(20)
    with timed("capacity kernels"):
        entries = phase_capacity_kernels(
            flagship(torch.float32, "cuda", 10, **drop_free(n, 32)), rng)
        entries += phase_capacity_global_stream(rng)
    with timed("capacity forward"):
        default = flagship(torch.float32, "cuda", N)
        params = episode_params(default, B)
        fwd = {"default": capacity_forward("capacity-default", default,
                                           params, card)}
        # K: the first of CAPACITY_K at which no folded step overflows
        tried = {}
        for K in CAPACITY_K:
            sim = flagship(torch.float32, "cuda", N, **drop_free(n, K))
            fwd["drop-free"] = capacity_forward(f"capacity-K{K}", sim,
                                                params, card)
            tried[K] = int(fwd["drop-free"][0].selfcol_overflow.sum())
            if tried[K] == 0:
                break
        limit = "none"
        if tried[K]:
            # which limit fired: detection's K, or the 16 layering rounds
            probe = flagship(torch.float32, "cuda", N,
                             **drop_free(n, 127))
            left = int(capacity_forward("capacity-K127", probe, params,
                                        card)[0].selfcol_overflow.sum())
            limit = (f"the 16 layering rounds ({left} steps at K = 127)"
                     if left else f"detection's K (none at K = 127)")
            del probe
        for name, (st, rate, launches, sweeps) in fwd.items():
            over = st.selfcol_overflow
            folded = over[0::2]
            slots = st.selfcol_slots.cpu().numpy()
            log(f"[capacity] {name} forward ({N} steps x B={B}, "
                f"rollout_chunked, chunk {CAPACITY_CHUNK}, captured) on "
                f"{card}: {rate:.1f} PD steps/s, {sweeps / N:.2f} sweeps "
                f"per step, overflow in {int(folded.sum())} of "
                f"{folded.numel()} folded episode-steps ({int(over.sum())} "
                f"of {over.numel()} in all), contact pairs per step "
                f"{float(st.selfcol_pairs.float().mean()):.2f}, active "
                f"slots a sample up to {int(slots.max())}; launches "
                f"{launches}")
            check_launches(f"capacity-{name}", launches, N, sweeps)
        st, _, launches, _ = fwd["drop-free"]
        if launches["friction_fwd_stream"] != launches["friction_fwd"]:
            raise AssertionError(f"[capacity] the drop-free sweeps did not "
                                 f"all stream their slots: {launches}")
        log(f"[capacity] drop-free K: overflow steps by K {tried}; K = "
            f"{sim.self_cfg.k_partners}; the limit that fired: {limit}")
    with timed("capacity gradient"):
        loss_fn = base_wind_target(sim, params)   # the drop-free motion
        grads = {}
        for name, s in (("default", default), ("drop-free", sim)):
            grads[name] = capacity_gradient(f"capacity-{name}-gradient", s,
                                            params, loss_fn)
            (L, G), rate, launches, bst = grads[name]
            sweeps = fwd[name][3]
            check_launches(f"capacity-{name}-gradient", launches, N, sweeps,
                           bst, passes=2)
            log(f"[capacity] {name} value-and-grad (OptimizeHelper, "
                f"chunked, captured): {rate:.1f} episode-gradient steps/s; "
                f"{bst['trips']:.0f} trips, {bst['fallback_lanes']:.0f} of "
                f"{bst['lane_steps']:.0f} episode-steps to GMRES; launches "
                f"{launches}")
        launches_g = grads["drop-free"][2]
        if launches_g["friction_bwd_stream"] != launches_g["friction_bwd"]:
            raise AssertionError(f"[capacity] the drop-free backward sweeps "
                                 f"did not all stream: {launches_g}")
        (_, Gd), (_, Gf) = grads["default"][0], grads["drop-free"][0]
        moved = {what: float(np.abs(Gf[:, sl] - Gd[:, sl]).max()
                             / np.abs(Gf[:, sl]).max())
                 for what, sl in (("wind", slice(0, 3)),
                                  ("x0", slice(5, None)))}
        log(f"[capacity] what the dropped contacts cost: default against "
            f"drop-free gradient (the drop-free motion as target), max "
            f"|difference| over the drop-free class's largest entry: "
            f"dL/dwind {moved['wind']:.3e}, dL/dx0 {moved['x0']:.3e}")
        entries[0]["launches"] = fwd["drop-free"][2]["friction_fwd_stream"]
        entries[1]["launches"] = launches_g["friction_bwd_stream"]
    with timed("capacity ablations"):
        rates = {"full": fwd["default"][1]}
        for ablate in ("nofric", "detect_only"):
            s = flagship(torch.float32, "cuda", N, self_ablate=ablate)
            st, rate, launches, sweeps = capacity_forward(
                f"capacity-{ablate}", s, params, card)
            if (launches["selfcol_detect"] != N
                    or launches["friction_fwd"] != 0):
                raise AssertionError(f"[capacity-{ablate}] launches "
                                     f"{launches}")
            rates[ablate] = rate
            log(f"[capacity] ablate {ablate!r} (not physical; profiling "
                f"only), default capacity: {rate:.1f} PD steps/s, "
                f"{sweeps / N:.2f} sweeps per step; launches {launches}")
            del s
        log(f"[capacity] PD steps/s full {rates['full']:.1f}, nofric "
            f"{rates['nofric']:.1f}, detect_only {rates['detect_only']:.1f} "
            f"(the sweep counts differ between them: see sweeps per step)")
    with timed("capacity reference"):
        phase_capacity_reference()
    del default, sim
    torch.cuda.empty_cache()
    return entries


PATHS = ("flagship", "capacity", "sphere", "large", "dress", "multistage",
         "ladder", "obstacles", "precision", "control", "graphs", "chunked")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=FLAGSHIP_STEPS,
                    help="the flagship's episode length (default "
                         f"{FLAGSHIP_STEPS} of its 250)")
    ap.add_argument("--profile-chunked", default=None,
                    help=argparse.SUPPRESS)   # phase 19's profiling process
    ap.add_argument("--profile-control", action="store_true",
                    help=argparse.SUPPRESS)   # 17g's profiling process
    ap.add_argument("--cpu-references", default=None,
                    help=argparse.SUPPRESS)   # the process beside
    ap.add_argument("--only", default=",".join(PATHS),
                    help="comma-separated paths to run while iterating "
                         f"(default, the acceptance run: all of "
                         f"{','.join(PATHS)})")
    args = ap.parse_args()
    only = args.only.split(",")
    if not set(only) <= set(PATHS):
        ap.error(f"--only: {sorted(set(only) - set(PATHS))} not in {PATHS}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from diffcloth_tpu_torch.core import cuda_build
    if args.profile_chunked:
        profile_chunked(args.profile_chunked)
        return 0
    if args.profile_control:
        profile_control()
        return 0
    if args.cpu_references:
        cpu_references(args.cpu_references, only)
        return 0

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

    import tempfile
    refs = tempfile.TemporaryDirectory()
    start_cpu_references(only, refs.name)
    try:
        kernels = run_paths(only, args, card)
    finally:
        CPU_REFS[0].kill()
        CPU_REFS[0].wait()
        refs.cleanup()
    torch.cuda.empty_cache()

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_paths(only, args, card):
    """The phases of the paths in `only`; returns the JSON line's kernel
    entries."""
    import torch
    timed = Timer()
    kernels = []
    if "flagship" in only:
        rng = np.random.RandomState(0)
        sim = flagship(torch.float32, "cuda", args.steps)
        with timed("kernels"):
            kernels = phase_kernels("kernels", sim,
                                    initial_states(sim, BATCH), rng)
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
            grad_launches = phase_gradient(sim, BATCH, card,
                                           launches["friction_fwd"])
            launches["friction_bwd"] = grad_launches["friction_bwd"]
        with timed("lstsq kernel"):
            lstsq = phase_lstsq_kernel(BATCH,
                                       grad_launches["hessenberg_lstsq"], rng)
        with timed("gradient profile"):
            phase_profile_gradient("profile-grad", prof_sim, prof_params,
                                   base_wind_target(prof_sim, prof_params),
                                   card)
        del sim, prof_sim
        with timed("trainer"):
            phase_trainer(card)
        with timed("gradient reference"):
            phase_gradient_reference(10)
        for k in kernels:
            k["launches"] = launches[k["name"]]
        kernels.append(lstsq)      # its launches: the gradient path's
    if "capacity" in only:
        kernels += phase_capacity(card, timed)
    if "sphere" in only:
        kernels += run_sphere(card, timed)
    if "large" in only:
        kernels += run_large_mesh(card, timed)
    if "dress" in only:
        kernels += run_dress(card, timed)
    if "multistage" in only:
        with timed("multistage"):
            phase_multistage(card)
    if "ladder" in only:
        with timed("ladder"):
            phase_ladder(card)
    if "obstacles" in only:
        with timed("obstacles"):
            phase_obstacles(card)
    if "precision" in only:
        with timed("precision"):
            phase_precision(card)
    if "control" in only:
        kernels += run_control(card, timed)
    if "graphs" in only:
        with timed("graphs"):
            phase_graphs(card)
    if "chunked" in only:
        phase_chunked(card, timed)
    log(f"[time] all phases {timed.total:.1f} s")
    return kernels


if __name__ == "__main__":
    sys.exit(main())
