"""Per-demo task setup: gradient masks, ground-truth parameters, loss
targets and scene primitives.

Counterpart of `diffcloth_tpu/tasks/setup.py` (reference
optimization/OptimizationTaskSetup.cpp: `setInitialConditions` :154-224,
`setLossFunctionInformationAndType` :50-152; primitive placement
`Simulation::initScene`, Simulation.cpp:1804-2067) for all eight demos:
`wind`, `wind_sim2real` and `sphere` build from grids; `tshirt`, `slope`,
`hat`, `sock` and `dress` read mesh or position assets, and the builder
raises FileNotFoundError where those are missing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from diffcloth_tpu_torch import losses
from diffcloth_tpu_torch.config import (C_BEND, C_STRETCH, LossType,
                                        PrimitiveConfig, SceneConfig,
                                        SimFlags, SplineType)
from diffcloth_tpu_torch.core import contact as ct
from diffcloth_tpu_torch.core import spline as spl
from diffcloth_tpu_torch.core.device import resolve_device
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.core.types import SimParams
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.optim.helper import GradMask
from diffcloth_tpu_torch.tasks import registry

# the demos whose episodes have wind (tasks/setup.py:189-191)
WIND_DEMOS = ("wind", "tshirt", "wind_sim2real")
# the slope plane's corners relative to its center (Simulation.h:474)
SLOPE_UL = np.array([-8.0, -1.0, -1.0]) - np.array([0.0, -11.0, 10.0])
SLOPE_UR = np.array([8.0, -1.0, -1.0]) - np.array([0.0, -11.0, 10.0])


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


def _prim_struct(entries, dtype=torch.float32, device=None
                 ) -> ct.PrimitiveSet:
    """A PrimitiveSet from a list of dicts (tasks/setup.py:44-65), on the
    card unless `device` says otherwise."""
    device = resolve_device(device)
    P = len(entries)

    def g(key, default, shape):
        a = (np.stack([np.broadcast_to(np.asarray(e.get(key, default),
                                                  np.float64), shape)
                       for e in entries]) if P else np.zeros((0,) + shape))
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return ct.PrimitiveSet(
        kind=np.asarray([e["kind"] for e in entries], np.int32),
        center=g("center", (0, 0, 0), (3,)),
        velocity=g("velocity", (0, 0, 0), (3,)),
        radius=g("radius", 0.0, ()), length=g("length", 0.0, ()),
        axis_rot=g("rot", np.eye(3), (3, 3)),
        plane_normal=g("normal", (0, 1, 0), (3,)),
        plane_upper_left=g("ul", (0, 0, 0), (3,)),
        plane_upper_right=g("ur", (0, 0, 0), (3,)),
        rotates=np.asarray([bool(e.get("rotates", False)) for e in entries],
                           bool),
        mu=g("mu", 0.0, ()), enabled=np.ones((P,), bool),
        kinematic=np.asarray([bool(e.get("kinematic", False))
                              for e in entries], bool))


def lower_leg_entries(center, axis, leg_length=5.0, foot_length=4.0,
                      mu=0.0):
    """The LowerLeg composite flattened to a joint sphere, a foot capsule
    and a leg capsule, in the reference's contact order (tasks/setup.py
    :68-105; LowerLeg ctor, Primitive.cpp:383-407).  `axis` is the foot
    direction; the leg bends along local (0, 0.7, 0.3); the knee sits at
    the end of the foot capsule.  Returns (entries, geometry dict)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    radius = 0.8
    e_y = np.array([0.0, 1.0, 0.0])
    rot_foot = gb.axis_to_rotation(axis, e_y)
    leg_local_axis = np.array([0.0, 0.7, 0.3])
    rot_from_parent = gb.axis_to_rotation(
        leg_local_axis / np.linalg.norm(leg_local_axis), e_y)
    rot_leg = gb.axis_to_rotation(rot_from_parent @ axis, e_y)
    knee = rot_foot @ np.array([0.0, foot_length, 0.0])
    center = np.asarray(center, np.float64)
    return [
        dict(kind=ct.P_SPHERE, center=center + knee, radius=radius + 0.05,
             mu=mu),
        dict(kind=ct.P_CAPSULE, center=center, radius=radius,
             length=foot_length, rot=rot_foot, mu=mu),
        dict(kind=ct.P_CAPSULE, center=center + knee, radius=radius,
             length=leg_length, rot=rot_leg, mu=mu),
    ], dict(knee=knee, rot_leg=rot_leg, rot_foot=rot_foot, radius=radius)


def _make_primitives(scene: gb.Scene, dtype=torch.float32, device=None):
    """Obstacle placement per scene (tasks/setup.py:108-169; initScene,
    Simulation.cpp:1804-1990).  Returns (PrimitiveSet, host entry dicts):
    task setup reads geometry from the host entries."""
    cfg = scene.cfg
    pc = cfg.primitive_config
    lo, hi = scene.rest_min, scene.rest_max

    def mk(entries):
        return _prim_struct(entries, dtype, device), entries

    mid = 0.5 * (lo + hi)
    center_low = np.array([mid[0], lo[1], mid[2]])
    center_high = np.array([mid[0], hi[1], mid[2]])

    if pc == PrimitiveConfig.NONE:
        return ct.empty_primitive_set(dtype, device), []
    if pc == PrimitiveConfig.PLANE_AND_SPHERE:
        # only sphere2 (r = 2) is a contact primitive, below the cloth
        # (Simulation.cpp:1826-1829, 1894-1903)
        radius = 2.0
        plane_center = center_low - np.array([0, radius * 2 + 0.1, 0])
        center = plane_center + np.array([radius * 0.3, radius,
                                          radius * 0.1])
        return mk([dict(kind=ct.P_SPHERE, center=center, radius=radius,
                        mu=0.9, rotates=False)])
    if pc == PrimitiveConfig.BIG_SPHERE:
        return mk([dict(kind=ct.P_SPHERE, center=(-0.5, -16.0, 0.0),
                        radius=15.0, mu=0.0)])
    if pc == PrimitiveConfig.PLANE_BUST_WEARHAT:
        # the sphere head (r = 2.1) above a plane (Simulation.cpp
        # :1932-1943); only the head is a contact primitive
        radius = 2.1
        plane_center = (center_low - np.array([0, 0.5, 0])
                        - np.array([0, 0, 4]))
        head = plane_center + np.array([0, radius + 0.5, -4])
        return mk([dict(kind=ct.P_SPHERE, center=head, radius=radius,
                        mu=0.1)])
    if pc in (PrimitiveConfig.SLOPE, PrimitiveConfig.SLOPE_SIMPLIFIED):
        # initScene SLOPE_SIMPLIEFIED (Simulation.cpp:1963-1976)
        normal = np.cross(SLOPE_UR, SLOPE_UL)
        normal = normal / np.linalg.norm(normal)
        shift = (-SLOPE_UL - SLOPE_UR) * 0.4
        ref_idx = 285 if scene.n > 285 else scene.n // 2
        center = scene.x_rest[ref_idx] + shift + np.array([0.0, -0.3, 0.0])
        return mk([dict(kind=ct.P_PLANE, center=center, normal=normal,
                        ul=SLOPE_UL, ur=SLOPE_UR, mu=0.2)])
    if pc == PrimitiveConfig.FOOT:
        center = center_high + np.array([0.0, 3.0, -4.0])  # :1922
        entries, _ = lower_leg_entries(
            center, np.asarray(cfg.sock_leg_orientation), 5.0, 4.0, mu=0.0)
        return mk(entries)
    if pc == PrimitiveConfig.Y0PLANE:
        return mk([dict(kind=ct.P_BOWL, center=(0, 0.5, 0), radius=0.5,
                        mu=0.0)])
    raise NotImplementedError(pc)


def sock_keypoints(center, leg_orientation, step_num: int):
    """ASSISTED_DRESSING_KEYPOINTS on the foot and leg anatomy (tasks/
    setup.py:294-340; OptimizationTaskSetup.cpp:75-125): (frames (K,),
    targets (K, 3), candidates (K, C) padded with -1), numpy."""
    _, geo = lower_leg_entries(center, np.asarray(leg_orientation))
    leg_len, foot_len, r = 5.0, 4.0, geo["radius"]
    center = np.asarray(center, np.float64)

    def leg_pt(o):
        return center + geo["knee"] + geo["rot_leg"] @ np.asarray(
            o, np.float64)

    def foot_pt(o):
        return center + geo["rot_foot"] @ np.asarray(o, np.float64)

    N = step_num
    top_front = [104, 27, 43, 475, 392, 903, 416, 413, 895]
    top_left = [11, 30, 164, 755, 30]
    top_right = [563, 43, 474, 14]
    opening_back = [102, 81, 842, 318, 12]
    kp = [(N, foot_pt((0, foot_len, -r)), [2, 20, 336, 792, 995]),
          (N, foot_pt((0, -r, 0)), [865, 420, 946, 250, 80]),
          (N, foot_pt((0, foot_len * 0.5, r)), [282, 343, 249]),
          (N, leg_pt((0, leg_len, r)), top_front),
          (N, leg_pt((-r, leg_len, 0)), top_left),
          (N, leg_pt((r, leg_len, 0)), top_right),
          (N, leg_pt((0, leg_len, -r)), opening_back),
          (N, leg_pt((0, leg_len * 0.4, -r)), [37, 241, 349])]
    for i in range(3):   # the opening's weighting (:115-120)
        fr = int(N * 0.62) + i
        kp += [(fr, foot_pt((0, -r, 0)), top_front),
               (fr, foot_pt((0, 0, -r)), opening_back),
               (fr, foot_pt((-r, 0, 0)), top_left),
               (fr, foot_pt((r, 0, 0)), top_right)]
    C = max(len(c) for _, _, c in kp)
    frames = np.array([f for f, _, _ in kp], np.int32)
    targets = np.stack([t for _, t, _ in kp])
    cands = np.full((len(kp), C), -1, np.int32)
    for i, (_, _, c) in enumerate(kp):
        cands[i, :len(c)] = c
    return frames, targets, cands


def _moved_spline(sim: ClothSim, translation, yup: float):
    """Spline params whose endpoints are the clips' rest positions moved by
    `translation`, with the given yUp (initScene CORNERS_2_WEARHAT /
    CORNERS_2_WEARSOCK, Simulation.cpp:1994-2053)."""
    p1 = torch.as_tensor(sim.stage_host.fixed_pos_rest + translation).to(
        sim.device, sim.dtype)
    yup_t = torch.full((p1.shape[0],), yup, dtype=sim.dtype,
                       device=sim.device)
    return spl.default_params_from_endpoints(sim.stage_dev.spline_p0, p1,
                                             yup_t)


def build_task(demo: str, dtype=torch.float32, device=None,
               keypoint_tau: float = 0.0,
               max_backward_iters: Optional[int] = None,
               scene: Optional[SceneConfig] = None,
               **sim_kwargs) -> TaskSetup:
    """The demo's sim (on the card unless device="cpu"), mask, ground
    truth and loss target (a rollout of the ground truth where the task
    generates one).  `keypoint_tau` > 0 smooths the keypoint loss's hard
    max into a softmax of that temperature (the sock demo); `scene`
    replaces the demo's scene (a grid stand-in of a mesh demo,
    registry.hat_grid_standin); `sim_kwargs` go to ClothSim (its size
    switches and self-collision capacity options)."""
    if demo not in registry.DEMOS:
        raise KeyError(demo)
    device = resolve_device(device)
    task = registry.DEMOS[demo]
    cfg = scene or task.scene
    scene = gb.build_scene(cfg)
    prims, prim_entries = _make_primitives(scene, dtype, device)
    spline_type = SplineType.ENDPOINT
    if demo in ("hat", "sock"):
        # resetSplineConfigsForControlTasks (OptimizationTaskSetup.cpp:38-46)
        spline_type = SplineType.ENDPOINT_AND_TANGENTS
    flags = SimFlags(wind_enabled=demo in WIND_DEMOS, contact_enabled=True,
                     self_collision_enabled=True)
    if max_backward_iters is not None:
        flags = dataclasses.replace(flags,
                                    max_backward_iters=max_backward_iters)
    sim = ClothSim(scene, flags=flags, prims=prims, spline_type=spline_type,
                   device=device, dtype=dtype, **sim_kwargs)
    base = sim.default_params()
    loss_info = losses.LossInfo()

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(sim.device,
                                                               dtype)

    def mu_set(i, value):
        mu = base.mu.clone()
        mu[i] = value
        return base.replace(mu=mu)

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
    elif demo == "sphere":
        # DEMO_SPHERE_ROTATE (:178-184): friction system-ID
        mask = GradMask(mu_primitives=(0,))
        param_gt = mu_set(0, 0.3)
    elif demo == "dress":
        # DEMO_DRESS_TWIRL (:213-220): optimize density and k_bend; the
        # loss holds the skirt's loop (the vertices within 1.2 of the
        # lowest) at 0.3 of the rest height while the waist twirls
        mask = GradMask(density=True, k_pertype=(False, False, False, True))
        k = base.k_pertype.clone()
        k[C_STRETCH] = 2.0
        param_gt = base.replace(density=t(0.01), k_pertype=k)
        loop = np.where(np.abs(scene.x_rest[:, 1] - scene.rest_min[1])
                        < 1.2)[0]
        loss_info = losses.LossInfo(
            target_twirl_height=0.3,
            loop_points=torch.as_tensor(loop.astype(np.int32),
                                        device=device),
            rest_min=t(scene.rest_min), rest_max=t(scene.rest_max))
    elif demo == "slope":
        # DEMO_SLOPE_PERF (:205-211): optimize friction; the target is the
        # cloth translated to the slope's end (:127-133)
        mask = GradMask(mu_primitives=(0,))
        param_gt = mu_set(0, 0.5)
        translation = (-SLOPE_UR) + (-SLOPE_UL) - scene.rest_mid
        loss_info = losses.LossInfo(x_init=t(scene.x_rest),
                                    target_translation=t(translation))
    elif demo == "hat":
        # DEMO_WEAR_HAT (:196-203, :56-72): optimize the spline control
        # points; the target is the hat translated onto the bust, and the
        # spline endpoints move there with yUp = 15
        mask = GradMask(control_points=True)
        head_center = np.asarray(prim_entries[0]["center"], np.float64)
        head_radius = float(prim_entries[0]["radius"])
        bust_center = head_center + np.array([0, head_radius * 0.6, 0])
        translation = bust_center - scene.rest_mid
        loss_info = losses.LossInfo(x_init=t(scene.x_rest),
                                    target_translation=t(translation))
        base = param_gt = base.replace(
            spline=_moved_spline(sim, translation, 15.0))
    elif demo == "sock":
        # DEMO_WEAR_SOCK (:196-203, :75-125): optimize the spline control
        # points against keypoints on the foot and leg; the endpoints move
        # from the sock's top to the foot's top with yUp = -28
        mask = GradMask(control_points=True)
        center = np.asarray(prim_entries[1]["center"], np.float64)
        frames, targets, cands = sock_keypoints(
            center, cfg.sock_leg_orientation, cfg.step_num)
        loss_info = losses.LossInfo(
            keypoint_frames=torch.as_tensor(frames, device=device),
            keypoint_targets=t(targets),
            keypoint_candidates=torch.as_tensor(cands, device=device),
            keypoint_tau=keypoint_tau)
        r = 0.8
        foot_top = center + np.array([0.0, 5.0 + 2 * r, 0.0])
        sock_top = np.array([
            0.5 * (scene.rest_min[0] + scene.rest_max[0]),
            scene.rest_max[1], scene.rest_min[2] + r])
        base = param_gt = base.replace(
            spline=_moved_spline(sim, foot_top - sock_top, -28.0))
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

    if task.generate_groundtruth_simulation:
        loss_info = dataclasses.replace(
            loss_info, target_x=sim.rollout_chunked(param_gt).full_x())
    return TaskSetup(sim=sim, mask=mask, loss_type=task.loss_type,
                     loss_info=loss_info, param_gt=param_gt,
                     param_base=base, name=demo)
