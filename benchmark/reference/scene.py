"""A configuration file's scene, flags, obstacles and starts, built by the
reference's own copies (the builder, the obstacle placement, the folded
start), so that the program's set-up is worked out again here.

`scene_config` reads the file's "scene" entry into the SceneConfig of the
config module it is given: the reference's, or the program's (the harness
builds the program's scene from the same entry)."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import builder as gb
from benchmark.reference import config as rc
from benchmark.reference import contact as ct
from benchmark.reference.sim import ClothSim

# the forward tolerance's floor in f32 (the program's and the JAX
# package's ClothSim)
F32_EPS_FORWARD = 1e-6
# SceneConfig entries named by an enum member, and their enums
_ENUMS = {"orientation": "Orientation", "attachment_points":
          "AttachmentConfig", "trajectory": "TrajectoryConfig",
          "primitive_config": "PrimitiveConfig", "wind_config": "WindConfig"}


def scene_config(mod, spec: dict):
    """The SceneConfig of config module `mod` for a file's "scene" entry:
    enums by member name, "fabric" a FabricConfig's fields, "scene_bbox"
    [lo, hi], sequences as tuples."""
    kw = {}
    for k, v in spec.items():
        if k == "fabric":
            v = mod.FabricConfig(**v)
        elif k in _ENUMS:
            v = getattr(getattr(mod, _ENUMS[k]), v)
        elif k == "scene_bbox":
            v = mod.AABB(tuple(v[0]), tuple(v[1]))
        elif isinstance(v, list):
            v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
        kw[k] = v
    return mod.SceneConfig(**kw)


def sim_flags(mod, spec: dict):
    """The file's "flags" entry as config module `mod`'s SimFlags."""
    return mod.SimFlags(**spec)


def build_scene(cfg: dict) -> gb.Scene:
    return gb.build_scene(scene_config(rc, cfg["scene"]))


def folded_grid(scene: gb.Scene, rows: int, gap: float) -> np.ndarray:
    """(n, 3) positions of a flat grid scene with its last `rows` rows
    folded back over the others at distance `gap` along the cloth's normal,
    the normal's largest component taken positive."""
    fab = scene.cfg.fabric
    gy, gx = fab.grid_num_y, fab.grid_num_x
    if fab.is_model or scene.n != gx * gy or not 0 < rows < gy:
        raise ValueError("folded_grid needs a grid scene and 0 < rows < gy")
    x = np.array(scene.x_rest, np.float64).reshape(gy, gx, 3)
    normal = np.cross(x[0, 1] - x[0, 0], x[1, 0] - x[0, 0])
    normal = normal / np.linalg.norm(normal)
    normal = normal * np.sign(normal[np.argmax(np.abs(normal))])
    hinge = gy - rows
    mid = 0.5 * (x[hinge - 1] + x[hinge])
    x[hinge:] = 2.0 * mid - x[hinge:] + gap * normal
    return x.reshape(-1, 3)


def starts(scene: gb.Scene, kind: str, B: int) -> np.ndarray:
    """(B, n, 3) f64 initial positions: "rest" every episode at rest;
    "fold_even" even episodes folded half over half (the last half of the
    rows folded back 1.5 r behind the cloth), odd ones at rest."""
    if kind == "rest":
        return np.repeat(np.asarray(scene.x_rest, np.float64)[None], B, 0)
    if kind != "fold_even":
        raise ValueError(f"starts {kind!r}: 'rest' or 'fold_even'")
    rows = scene.cfg.fabric.grid_num_y // 2
    folded = folded_grid(scene, rows, -1.5 * float(scene.radii.mean()))
    return np.stack([folded if b % 2 == 0 else scene.x_rest
                     for b in range(B)])


def primitives(scene: gb.Scene, dtype, device) -> ct.PrimitiveSet:
    """The scene's obstacles (Simulation::initScene): PLANE_AND_SPHERE
    holds one contact sphere of radius 2 below the cloth (its plane is not
    a contact primitive), mu 0.9; NONE holds none."""
    pc = scene.cfg.primitive_config
    if pc == rc.PrimitiveConfig.NONE:
        return ct.empty_primitive_set(dtype, device)
    if pc != rc.PrimitiveConfig.PLANE_AND_SPHERE:
        raise NotImplementedError(f"primitives {pc}")
    lo, hi = scene.rest_min, scene.rest_max
    mid = 0.5 * (lo + hi)
    radius = 2.0
    plane_center = np.array([mid[0], lo[1], mid[2]]) - np.array(
        [0, radius * 2 + 0.1, 0])
    center = plane_center + np.array([radius * 0.3, radius, radius * 0.1])

    def t(a, shape):
        return torch.as_tensor(np.asarray(a, np.float64).reshape(shape),
                               dtype=dtype, device=device)

    return ct.PrimitiveSet(
        kind=np.asarray([ct.P_SPHERE], np.int32), center=t(center, (1, 3)),
        velocity=t(np.zeros(3), (1, 3)), radius=t(radius, (1,)),
        length=t(0.0, (1,)), axis_rot=t(np.eye(3), (1, 3, 3)),
        plane_normal=t((0, 1, 0), (1, 3)), plane_upper_left=t(np.zeros(3),
                                                              (1, 3)),
        plane_upper_right=t(np.zeros(3), (1, 3)),
        rotates=np.asarray([False]), mu=t(0.9, (1,)),
        enabled=np.ones((1,), bool), kinematic=np.asarray([False]))


def reference_sim(cfg: dict, dtype=torch.float64, device="cuda"):
    """The reference's ClothSim of a configuration: its own scene, flags,
    obstacles, operators and P^{-1}, every step uncaptured; (sim, scene)."""
    scene = build_scene(cfg)
    flags = sim_flags(rc, cfg["flags"])
    # the forward tolerance the configuration's precision runs at: an f32
    # configuration floors it at 1e-6 (f32 cannot resolve smaller deltas)
    eps = scene.cfg.forward_convergence_thresh
    if cfg["dtype"] == "float32":
        eps = max(eps, F32_EPS_FORWARD)
    sim = ClothSim(scene, flags=flags,
                   prims=primitives(scene, dtype, device), device=device,
                   dtype=dtype, cuda_graphs=False, eps_forward=eps,
                   **cfg.get("sim", {}))
    return sim, scene
