"""The episode gradient of the bending stiffness against central
differences, by adjoint solver and tolerance (f64).

    python -m diffcloth_tpu_torch.apps.adjoint_check [--cpu] [--steps 5]

The scene is the flagship stand-in (registry.TSHIRT_GRID_STANDIN: the
tshirt wind system-ID physics on a 32 x 32 grid, self-collision on) cut
to --steps steps, started folded half over half (as chip_smoke.py's phase
16), its MATCH_TRAJECTORY loss against the rollout of the base wind
(0.04, 0.004, 0.04), evaluated at 0.7 of that wind and 1.2 of its
k_stretch.  The forward runs to 1e-10 (pd_total_iters' cap) in every
evaluation.  Gradients of one entry per parameter class (wind x,
k_stretch, k_bend, density) from three adjoints:
  * "fp" at the scene's tolerance (5e-4, 64 trips), the default;
  * "fp" at 1e-10 with 400 trips;
  * "gmres" at 1e-10 with a 400-matvec budget;
against central differences at two steps (1e-6 and 1e-4 of max(|x|, 1)).
Prints one line per gradient and a JSON summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from diffcloth_tpu_torch import losses
from diffcloth_tpu_torch.config import C_BEND, C_STRETCH, LossType, SimFlags
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.geometry import states
from diffcloth_tpu_torch.tasks.registry import TSHIRT_GRID_STANDIN

BASE_WIND = (0.04, 0.004, 0.04)
EPS_FORWARD = 1e-10
ADJOINTS = (("fp, 5e-4 (scene)", "fp", None, 64),
            ("fp, 1e-10, 400 trips", "fp", 1e-10, 400),
            ("gmres, 1e-10, 400 matvecs", "gmres", 1e-10, 400))
FD_STEPS = (1e-6, 1e-4)
# the probed entries: (name, SimParams field, index)
PROBES = (("wind x", "wind", 0), ("k_stretch", "k_pertype", C_STRETCH),
          ("k_bend", "k_pertype", C_BEND), ("density", "density", None))


def _sim(scene, device, mode="fp", eps_backward=None, max_back=64):
    return ClothSim(scene, device=device, dtype=torch.float64,
                    flags=SimFlags(wind_enabled=True, adjoint_mode=mode,
                                   max_backward_iters=max_back),
                    eps_forward=EPS_FORWARD, eps_backward=eps_backward)


def _bump(params, field, index, delta):
    t = getattr(params, field).clone()
    if index is None:
        t = t + delta
    else:
        t[index] += delta
    return params.replace(**{field: t})


def _entry(tree, field, index):
    t = getattr(tree, field)
    return float(t if index is None else t[index])


def run(steps: int, device) -> dict:
    scene = gb.build_scene(dataclasses.replace(TSHIRT_GRID_STANDIN,
                                               step_num=steps))
    base_sim = _sim(scene, device)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                  device=base_sim.device)
    rows = scene.cfg.fabric.grid_num_y // 2
    folded = states.folded_grid(scene, rows, -1.5 * float(scene.radii.mean()))
    p = base_sim.default_params().replace(
        wind=t(BASE_WIND), wind_freq=t(10.0), wind_phase=t(0.5), x0=t(folded))
    loss_fn = losses.make_loss_fn(LossType.MATCH_TRAJECTORY, losses.LossInfo(
        target_x=base_sim.rollout(p).full_x()))
    k = p.k_pertype.clone()
    k[C_STRETCH] *= 1.2
    p = p.replace(wind=p.wind * 0.7, k_pertype=k)
    out = {"steps": steps, "n": scene.n, "adjoint": {}, "fd": {}}
    for label, mode, eps_b, cap in ADJOINTS:
        sim = _sim(scene, device, mode, eps_b, cap)
        sim.bwd_stats.reset()
        L, g = sim.episode_value_and_grad(loss_fn)(p)
        st = sim.bwd_stats.summary()
        out["loss"] = float(L)
        out["adjoint"][label] = {
            "grad": {name: _entry(g, f, i) for name, f, i in PROBES},
            "trips_or_cycles_per_step": st["lane_trips"] / max(
                st["lane_steps"], 1),
            "fallback_steps": st["fallback_lanes"],
            "gmres_matvecs": st["gmres_matvecs"]}
    loss_of = base_sim.episode_loss(loss_fn)
    for h in FD_STEPS:
        fd = {}
        for name, f, i in PROBES:
            d = h * max(abs(_entry(p, f, i)), 1.0)
            fd[name] = (float(loss_of(_bump(p, f, i, d)))
                        - float(loss_of(_bump(p, f, i, -d)))) / (2 * d)
        out["fd"][f"{h:g}"] = fd
    return out


def report(out: dict, log=print) -> None:
    log(f"flagship stand-in (n = {out['n']}), {out['steps']} steps, f64, "
        f"forward to {EPS_FORWARD:g}; loss {out['loss']:.10e}")
    for h, fd in out["fd"].items():
        log(f"central differences, step {h}: " + ", ".join(
            f"{k} {v:.6e}" for k, v in fd.items()))
    ref = out["fd"][f"{FD_STEPS[0]:g}"]
    for label, a in out["adjoint"].items():
        rel = {k: abs(v - ref[k]) / max(abs(ref[k]), 1e-300)
               for k, v in a["grad"].items()}
        log(f"{label}: " + ", ".join(
            f"{k} {v:.6e} ({100 * rel[k]:.2f} % from FD {FD_STEPS[0]:g})"
            for k, v in a["grad"].items())
            + f"; {a['trips_or_cycles_per_step']:.2f} trips or cycles per "
              f"step, {a['fallback_steps']:.0f} steps to the GMRES "
              f"fallback, {a['gmres_matvecs']:.0f} GMRES matvecs")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    out = run(args.steps, "cpu" if args.cpu else None)
    report(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
