#!/usr/bin/env python3
"""Device time of the self-collision detection kernel on one NVIDIA GPU, by
input, at the flagship stand-in's shapes (B = 32, n_pad = 1024, K = 8).

    python3 bench_detect.py

Inputs, each checked equal to the plain PyTorch version first:

  phase2    chip_smoke.py phase 2's states (half the batch folded, noise,
            a pile of 20 stacked vertices)
  lattice   chip_smoke.py's two-layer lattice with exact ties (every row
            has 13 or more hits)
  nohit     phase 2's positions scaled by 1000, at rest: no pair hits, so
            the kernel never leaves its common path

Prints per input: device ms per call (torch.profiler), hits per row, and
the share of a warp's steps (4 rows x 128 columns) that hold a hit and so
enter the kernel's hit path; then the floor of the kernel's unfused f32
instructions (chip_smoke.py's), and the instructions of the kernel's
column step as compiled (cuobjdump -sass of the built library: from the
step's first 16-byte shared-memory load of column geometry to its vote,
by opcode).  The card's name and power limit come first.  Needs nvcc
(CUDA_HOME, PATH or /usr/local/cuda).
"""
import collections
import os
import re
import subprocess
import sys

import numpy as np


def hit_matrix(geom, allowed):
    """(B, n_pad, n_pad) bool, in the plain version's f32 arithmetic."""
    import torch

    def d2(row0):
        out = None
        for c in range(row0, row0 + 3):
            diff = geom[:, c, :, None] - geom[:, c, None, :]
            out = diff * diff if out is None else out + diff * diff
        return out
    reach = geom[:, 6, :, None] + geom[:, 6, None, :]
    return ((torch.minimum(d2(0), d2(3)) < reach * reach)
            & (allowed[None] > 0))


def step_instructions(lib):
    """Opcode counts of the kernel's column step in the library's SASS:
    the instructions from the second LDS.128 (the first one of the step;
    the one before it reads the segment's counts) to the first VOTE.ANY."""
    from diffcloth_tpu_torch.core import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    ops = [m.group(1) for m in re.finditer(
        r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", sass)]
    lds = [i for i, op in enumerate(ops) if op == "LDS.128"]
    end = next(i for i, op in enumerate(ops) if op.startswith("VOTE.ANY"))
    return collections.Counter(ops[lds[1]:end])


def main():
    import torch
    if not torch.cuda.is_available():
        print("bench_detect: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from diffcloth_tpu_torch.core import selfcol_cuda as scd

    print(cs.nvidia_smi_line(), flush=True)
    sim = cs.flagship(torch.float32, "cuda")
    cfg, n, h, B = sim.self_cfg, sim.n, sim.h, cs.BATCH
    K = cfg.k_partners
    n_pad = cfg.allowed.shape[0]
    x, v = cs.kernel_states(sim, cs.initial_states(sim, B),
                            np.random.RandomState(0))
    xt = torch.as_tensor(x, dtype=torch.float32, device="cuda")
    vt = torch.as_tensor(v, dtype=torch.float32, device="cuda")
    radii = sim.scene_dev.radii
    inputs = {
        "phase2": scd.build_geom(xt, vt, radii, h, n_pad),
        "lattice": cs.lattice_geom(B, n, n_pad, h, "cuda"),
        "nohit": scd.build_geom(xt * 1000, vt * 0, radii, h, n_pad),
    }
    for label, geom in inputs.items():
        tab = scd.detect_partners(geom, cfg.allowed, K)
        if not torch.equal(tab, scd.detect_partners_plain(geom, cfg.allowed,
                                                          K)):
            raise AssertionError(f"detection kernel != plain on {label}")
        hit = hit_matrix(geom, cfg.allowed)
        steps = hit.reshape(B, n_pad // 4, 4, n_pad // 128, 128).any(-1)
        ms = cs.device_ms(lambda: scd.detect_partners(geom, cfg.allowed, K),
                          reps=100, kernel="detect_kernel")
        print(f"[detect] {label}: device ms per call {ms:.5f}; "
              f"{float(hit[:, :n].sum(-1).float().mean()):.2f} hits per "
              f"row; {100 * float(steps.any(2).float().mean()):.1f} % of "
              f"warp steps hold a hit", flush=True)
    ops = B * int((cfg.allowed > 0).sum()) * cs.DETECT_OPS_PER_PAIR
    print(f"[detect] floor of unfused f32 instructions "
          f"{ops / cs.F32_INSTR_PER_S * 1e3:.5f} ms", flush=True)
    from diffcloth_tpu_torch.core import cuda_build
    step = step_instructions(cuda_build.library_path("selfcol_detect"))
    print(f"[detect] column step as compiled: {sum(step.values())} "
          f"instructions for 16 pairs a lane: " + ", ".join(
              f"{n} {op}" for op, n in step.most_common(8)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
