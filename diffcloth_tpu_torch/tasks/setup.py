"""Per-demo task setup: gradient masks, ground-truth parameters and loss
targets.

Counterpart of `diffcloth_tpu/tasks/setup.py` (reference
optimization/OptimizationTaskSetup.cpp: `setInitialConditions` :154-224,
`setLossFunctionInformationAndType` :50-152) for the obstacle-free,
single-stage demos whose episodes the port runs: `wind`, `wind_sim2real`
and `tshirt` (where its mesh asset exists).  `sphere`, `hat`, `sock` and
`slope` need obstacle contacts, and `dress` the twirl trajectory and its
mesh; they raise NotImplementedError until those pieces are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from diffcloth_tpu_torch import losses
from diffcloth_tpu_torch.config import C_BEND, C_STRETCH, LossType, SimFlags
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.core.types import SimParams
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.optim.helper import GradMask
from diffcloth_tpu_torch.tasks import registry

PORTED_DEMOS = ("wind", "wind_sim2real", "tshirt")


@dataclasses.dataclass
class TaskSetup:
    sim: ClothSim
    mask: GradMask
    loss_type: LossType
    loss_info: losses.LossInfo
    param_gt: SimParams              # ground-truth / "actual" params
    param_base: SimParams            # scene-state defaults (optimizer base)
    name: str

    def loss_fn(self):
        return losses.make_loss_fn(self.loss_type, self.loss_info)


def build_task(demo: str, dtype=torch.float32, device=None,
               max_backward_iters: Optional[int] = None) -> TaskSetup:
    """The demo's sim (on the card unless device="cpu"), mask, ground
    truth and loss target (a rollout of the ground truth)."""
    if demo not in registry.DEMOS:
        raise KeyError(demo)
    if demo not in PORTED_DEMOS:
        raise NotImplementedError(
            f"demo {demo!r} needs obstacle contacts or the dress twirl, "
            f"which are not ported yet (ported: {', '.join(PORTED_DEMOS)})")
    cfg = registry.DEMOS[demo].scene
    scene = gb.build_scene(cfg)
    flags = SimFlags(wind_enabled=True, contact_enabled=True,
                     self_collision_enabled=True)
    if max_backward_iters is not None:
        flags = dataclasses.replace(flags,
                                    max_backward_iters=max_backward_iters)
    sim = ClothSim(scene, flags=flags, device=device, dtype=dtype)
    base = sim.default_params()

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(sim.device,
                                                               dtype)

    if demo == "wind":
        # setInitialConditions DEMO_WIND (:158-164)
        mask = GradMask(f_ext=True)
        param_gt = base.replace(wind=t(np.array([0.0, 1.0, 1.0]) * 0.02
                                       * 0.2))
    elif demo == "tshirt":
        # DEMO_WIND_TSHIRT (:165-175): optimize k_stretch + wind-5
        mask = GradMask(k_pertype=(False, False, True, False), f_wind=True)
        wind_gt = np.array([1.0, 0.1, 1.0])
        wind_gt = wind_gt / np.linalg.norm(wind_gt) * 0.1 * 0.15
        k = base.k_pertype.clone()
        k[C_STRETCH] = cfg.fabric.k_stiff_stretching
        param_gt = base.replace(k_pertype=k, wind=t(wind_gt),
                                wind_freq=t(10.0), wind_phase=t(0.5))
    else:
        # DEMO_WIND_SIM2REAL (OptimizationTaskSetup.cpp:21-36): wind-5 +
        # k_stretch + k_bend + density toward the "actual" sim2real
        # parameters; the ground truth is generated by simulation (the
        # reference's captured animation frames are not shipped)
        mask = GradMask(f_wind=True, density=True,
                        k_pertype=(False, False, True, True))
        wind_gt = np.array([1.0, 0.1, 1.0])
        wind_gt = wind_gt / np.linalg.norm(wind_gt)
        k = base.k_pertype.clone()
        k[C_STRETCH], k[C_BEND] = 3000.0, 0.01
        param_gt = base.replace(wind=t(wind_gt), wind_freq=t(14.0),
                                wind_phase=t(0.0), k_pertype=k,
                                density=t(0.15))

    loss_info = losses.LossInfo(
        target_x=sim.rollout_chunked(param_gt).full_x())
    return TaskSetup(sim=sim, mask=mask,
                     loss_type=registry.DEMOS[demo].loss_type,
                     loss_info=loss_info, param_gt=param_gt,
                     param_base=base, name=demo)
