"""Scene / fabric / task configuration dataclasses and enums.

The port's own copy of `diffcloth_tpu/config.py` (numpy only; the port
imports nothing from the JAX package).  Mirrors the reference's static
configuration registry (engine/Constants.h:12-137,
simulation/Simulation.h:103-118,268-294).

These are host-side static descriptions.  Everything that the simulator
differentiates through lives in `core.types.SimParams` instead.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np


class WindConfig(enum.IntEnum):
    # reference: engine/Constants.h:55-61
    NO_WIND = 0
    WIND_CONSTANT = 1
    WIND_SIN = 2
    WIND_SIN_AND_FALLOFF = 3
    WIND_FACTOR_PER_STEP = 4


class AttachmentConfig(enum.IntEnum):
    # reference: engine/Constants.h:39-43
    NO_ATTACHMENTS = 0
    LEFT_RIGHT_CORNERS_2 = 1
    CUSTOM_ARRAY = 2


class TrajectoryConfig(enum.IntEnum):
    # reference: engine/Constants.h:44-53
    NO_TRAJECTORY = 0
    CORNERS_2_UP = 1
    CORNERS_2_WEARHAT = 2
    CORNERS_1_WEARHAT = 3
    CORNERS_2_WEARSOCK = 4
    FIXED_POINT_TRAJECTORY = 5
    TRAJECTORY_DRESS_TWIRL = 6
    PER_STEP_TRAJECTORY = 7


class PrimitiveConfig(enum.IntEnum):
    # reference: engine/Constants.h:90-99
    PLANE_BUST_WEARHAT = 0
    SLOPE = 1
    SLOPE_SIMPLIFIED = 2
    PLANE_AND_SPHERE = 3
    FOOT = 4
    NONE = 5
    Y0PLANE = 6
    BIG_SPHERE = 7


class Orientation(enum.IntEnum):
    # reference: engine/Constants.h:35-37
    FRONT = 0
    DOWN = 1
    BACK = 2
    CUSTOM_ORIENTATION = 3


class LossType(enum.IntEnum):
    # reference: engine/Constants.h:12-22
    MATCHSHAPE_WITH_TRANSLATION = 0
    MULTISTEP_MATCHSHAPE = 1
    MATCHSHAPE_TRANSLATION_INVARIANT = 2
    ASSISTED_DRESSING_KEYPOINTS = 3
    MATCH_TRAJECTORY = 4
    MATCH_TRAJECTORY_MAX = 5
    MATCH_VELOCITY = 6
    DRESS_ANGLE = 7


class SplineType(enum.IntEnum):
    # reference: simulation/Spline.h:27-29
    ENDPOINT = 0
    ENDPOINT_AND_UP = 1
    ENDPOINT_AND_TANGENTS = 2

    @property
    def n_params(self) -> int:
        # reference: Spline.h:183-197
        return {SplineType.ENDPOINT: 3,
                SplineType.ENDPOINT_AND_UP: 4,
                SplineType.ENDPOINT_AND_TANGENTS: 9}[self]


# Constraint type indices (reference: simulation/Constraint.h:17-22)
C_SPRING = 0
C_ATTACH = 1
C_STRETCH = 2
C_BEND = 3
C_NUM = 4

GRAVITY = np.array([0.0, -9.8, 0.0])  # reference: Simulation.h:356


@dataclasses.dataclass(frozen=True)
class AABB:
    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """reference: Simulation.h FabricConfiguration (:103-118)."""
    cloth_dim_x: float = 6.0
    cloth_dim_y: float = 6.0
    k_stiff_stretching: float = 100.0
    k_stiff_bending: float = 0.0
    grid_num_x: int = 25
    grid_num_y: int = 25
    density: float = 0.054
    keep_original_scale_point: bool = False
    is_model: bool = False
    custom_init_pos: bool = False
    init_pos_file: str = ""
    # add per-edge length springs (reference Spring element — deprecated
    # there in favor of Triangle, kept for capability parity)
    use_spring_constraints: bool = False
    name: str = "fabric"


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """reference: Simulation.h SceneConfiguration (:268-294)."""
    fabric: FabricConfig
    orientation: Orientation = Orientation.FRONT
    up_vector: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    attachment_points: AttachmentConfig = AttachmentConfig.NO_ATTACHMENTS
    # list of (start_fraction, [vertex indices]) — one entry per attachment stage
    custom_attachment_vertex_idx: Tuple[Tuple[float, Tuple[int, ...]], ...] = ()
    trajectory: TrajectoryConfig = TrajectoryConfig.NO_TRAJECTORY
    primitive_config: PrimitiveConfig = PrimitiveConfig.NONE
    wind_config: WindConfig = WindConfig.NO_WIND
    scene_bbox: AABB = AABB((-7.0, -7.0, -7.0), (7.0, 7.0, 7.0))
    time_step: float = 1.0 / 90.0
    step_num: int = 250
    forward_convergence_thresh: float = 1e-8
    backward_convergence_thresh: float = 5e-4
    sock_leg_orientation: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    # WIND_SIN_AND_FALLOFF / WIND_FACTOR_PER_STEP: per-particle wind falloff
    # min(1/|focus - x_rest|, 1) from this focus point (reference sim2real
    # scene setup, Simulation.cpp:3125-3131)
    wind_falloff_focus: Optional[Tuple[float, float, float]] = None
    name: str = "scene"


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """reference: Simulation.h TaskConfiguration and
    optimization/OptimizationTaskConfigurations.cpp:353-409."""
    scene: SceneConfig
    has_groundtruth: bool
    generate_groundtruth_simulation: bool
    loss_type: LossType
    name: str = "task"


@dataclasses.dataclass(frozen=True)
class SimFlags:
    """Global toggles (reference: volatile statics, Simulation.cpp:9-22) as an
    immutable config object."""
    gravity_enabled: bool = True
    wind_enabled: bool = False
    contact_enabled: bool = True
    self_collision_enabled: bool = True
    constant_forcefield_enabled: bool = False
    gradient_clipping: bool = True
    gradient_clipping_threshold: float = 16.0  # reference: Simulation.h:330
    # PD forward-iteration cap rule: -log10(eps) * 150 (Simulation.cpp:1182)
    max_forward_iters: Optional[int] = None
    # adjoint settings, kept field-for-field with the JAX package's
    # SimFlags (diffcloth_tpu/config.py) for the adjoint slice of the port:
    # fixed-point matvec cap (the reference caps at 400,
    # Simulation.cpp:1561) and solver ('fp' fixed point with GMRES
    # fallback, or the experimental 'gmres')
    max_backward_iters: int = 64
    adjoint_mode: str = "fp"
    adjoint_gmres_m: int = 16      # Krylov vectors per restarted cycle
    # dL/da (action gradient) norm clamp used by the NN bridge
    action_grad_max_norm: float = 4.0  # reference: pySim/functional.py:92


def pd_total_iters(eps: float) -> int:
    """reference: Simulation.cpp:1182."""
    return int(-np.log10(eps) * 150)
