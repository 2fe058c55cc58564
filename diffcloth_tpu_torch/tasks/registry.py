"""Fabric / scene / task registry — verbatim replication of the reference's
static configuration database (the port's own copy of
`diffcloth_tpu/tasks/registry.py`), plus the flagship grid stand-in.

reference: optimization/OptimizationTaskConfigurations.cpp
(fabrics :10-163, scenes :168-349, tasks :353-409, demo map :412-421).
"""
from __future__ import annotations

from typing import Dict

from diffcloth_tpu_torch.config import (AABB, AttachmentConfig,
                                        FabricConfig, LossType, Orientation,
                                        PrimitiveConfig, SceneConfig,
                                        TaskConfig, TrajectoryConfig,
                                        WindConfig)

# ---------------------------------------------------------------------------
# fabrics (OptimizationTaskConfigurations.cpp:10-163)

NORMAL_FABRIC_6_LOWRES = FabricConfig(
    cloth_dim_x=6, cloth_dim_y=6, k_stiff_stretching=250, k_stiff_bending=0.05,
    grid_num_x=5, grid_num_y=5, density=0.324, name="dim6x6-grid5x5")

NORMAL_FABRIC_6 = FabricConfig(
    cloth_dim_x=6, cloth_dim_y=6, k_stiff_stretching=100, k_stiff_bending=0.0,
    grid_num_x=25, grid_num_y=25, density=0.054,
    name="dim6x6-grid25x25-dens0.32-k50")

TSHIRT1000 = FabricConfig(
    cloth_dim_x=6, cloth_dim_y=6, k_stiff_stretching=550,
    k_stiff_bending=0.01, grid_num_x=40, grid_num_y=80, density=0.124,
    is_model=True, name="remeshed/T-shirt/tshirt1000-tri.obj")

SPHERE_FABRIC = FabricConfig(
    cloth_dim_x=4.5, cloth_dim_y=4.5, k_stiff_stretching=150,
    k_stiff_bending=1e-5, grid_num_x=25, grid_num_y=25, density=0.3,
    name="sphereFabric")

SLOPE_FABRIC_REST_ON_PLANE = FabricConfig(
    cloth_dim_x=4.5, cloth_dim_y=4.5, k_stiff_stretching=50,
    k_stiff_bending=0.0, grid_num_x=25, grid_num_y=25, density=0.2,
    custom_init_pos=True, init_pos_file="remeshed/Slope/slopeFabric_onPlane.txt",
    name="dim3x3-grid5x5-dens0.2-k50")

DRESS_V7K_DRAPE = FabricConfig(
    cloth_dim_x=13, cloth_dim_y=13, k_stiff_stretching=3000,
    k_stiff_bending=0.3, grid_num_x=40, grid_num_y=80, density=0.3,
    is_model=True, name="remeshed/dress-handsup-drape.obj")

AGENT_HAT_579 = FabricConfig(
    cloth_dim_x=6, cloth_dim_y=6, k_stiff_stretching=1200,
    k_stiff_bending=120, grid_num_x=40, grid_num_y=80, density=0.224,
    is_model=True, name="remeshed/agenthat2-579-rotated.obj")

SOCK_482 = FabricConfig(
    cloth_dim_x=5, cloth_dim_y=5, k_stiff_stretching=600, k_stiff_bending=1,
    grid_num_x=40, grid_num_y=80, density=0.224, is_model=True,
    name="remeshed/sock1055-2081.obj")

# ---------------------------------------------------------------------------
# scenes (OptimizationTaskConfigurations.cpp:168-349)

WIND_SCENE = SceneConfig(
    fabric=NORMAL_FABRIC_6, orientation=Orientation.FRONT,
    attachment_points=AttachmentConfig.LEFT_RIGHT_CORNERS_2,
    trajectory=TrajectoryConfig.NO_TRAJECTORY,
    primitive_config=PrimitiveConfig.NONE,
    wind_config=WindConfig.WIND_CONSTANT,
    scene_bbox=AABB((-7, -7, -7), (7, 7, 7)),
    time_step=1.0 / 90.0, step_num=200,
    forward_convergence_thresh=1e-9, backward_convergence_thresh=5e-4,
    name="wind")

TSHIRT_SCENE = SceneConfig(
    fabric=TSHIRT1000, orientation=Orientation.BACK,
    attachment_points=AttachmentConfig.LEFT_RIGHT_CORNERS_2,
    trajectory=TrajectoryConfig.NO_TRAJECTORY,
    primitive_config=PrimitiveConfig.NONE,
    wind_config=WindConfig.WIND_SIN,
    scene_bbox=AABB((-7, -7, -7), (7, 7, 7)),
    time_step=1.0 / 90.0, step_num=250,
    forward_convergence_thresh=1e-8, backward_convergence_thresh=5e-4,
    name="wind_tshirt")

HAT_SCENE = SceneConfig(
    fabric=AGENT_HAT_579, orientation=Orientation.FRONT,
    attachment_points=AttachmentConfig.CUSTOM_ARRAY,
    custom_attachment_vertex_idx=((0.0, (394, 32)),),
    trajectory=TrajectoryConfig.CORNERS_2_WEARHAT,
    primitive_config=PrimitiveConfig.PLANE_BUST_WEARHAT,
    wind_config=WindConfig.NO_WIND,
    scene_bbox=AABB((-5, -1.5, -14), (7, 10, 5)),
    time_step=1.0 / 100.0, step_num=400,
    forward_convergence_thresh=1e-8, backward_convergence_thresh=5e-4,
    name="demo_wearhat")

SOCK_SCENE = SceneConfig(
    fabric=SOCK_482, orientation=Orientation.CUSTOM_ORIENTATION,
    up_vector=(0.0, 1.0, 0.0),
    attachment_points=AttachmentConfig.CUSTOM_ARRAY,
    custom_attachment_vertex_idx=((0.0, (14, 30, 3, 81)),),
    trajectory=TrajectoryConfig.CORNERS_2_WEARSOCK,
    primitive_config=PrimitiveConfig.FOOT,
    wind_config=WindConfig.NO_WIND,
    scene_bbox=AABB((-7, -5, -7), (7, 15, 6)),
    sock_leg_orientation=(0.0, 1.0, 0.0),
    time_step=1.0 / 160.0, step_num=400,
    forward_convergence_thresh=1e-9, backward_convergence_thresh=5e-4,
    name="wear_sock1")

DRESS_SCENE = SceneConfig(
    fabric=DRESS_V7K_DRAPE, orientation=Orientation.FRONT,
    attachment_points=AttachmentConfig.CUSTOM_ARRAY,
    custom_attachment_vertex_idx=((0.0, (
        1335, 1336, 1334, 1360, 1339, 1347, 1345, 1342, 1349, 1351, 1352,
        3604, 1145, 1150, 1137, 1142, 1143, 1285, 3496, 3497, 3501, 1152,
        1153, 3499, 3498, 3500, 3559, 1146, 1333, 1355, 1350)),),
    trajectory=TrajectoryConfig.TRAJECTORY_DRESS_TWIRL,
    primitive_config=PrimitiveConfig.NONE,
    wind_config=WindConfig.NO_WIND,
    scene_bbox=AABB((-7, -7, -7), (7, 7, 7)),
    time_step=1.0 / 120.0, step_num=125,
    forward_convergence_thresh=1e-10, backward_convergence_thresh=5e-4,
    name="dress_twirl")

ROTATING_SPHERE_SCENE = SceneConfig(
    fabric=SPHERE_FABRIC, orientation=Orientation.DOWN,
    attachment_points=AttachmentConfig.NO_ATTACHMENTS,
    trajectory=TrajectoryConfig.NO_TRAJECTORY,
    primitive_config=PrimitiveConfig.PLANE_AND_SPHERE,
    wind_config=WindConfig.NO_WIND,
    scene_bbox=AABB((-7, -7, -7), (7, 7, 7)),
    time_step=1.0 / 180.0, step_num=350,
    forward_convergence_thresh=1e-9, backward_convergence_thresh=5e-4,
    name="rotating_sphere")

SLOPE_SCENE = SceneConfig(
    fabric=SLOPE_FABRIC_REST_ON_PLANE, orientation=Orientation.FRONT,
    attachment_points=AttachmentConfig.NO_ATTACHMENTS,
    trajectory=TrajectoryConfig.NO_TRAJECTORY,
    primitive_config=PrimitiveConfig.SLOPE_SIMPLIFIED,
    wind_config=WindConfig.NO_WIND,
    scene_bbox=AABB((-7, -7, -7), (7, 7, 7)),
    time_step=1.0 / 100.0, step_num=300,
    forward_convergence_thresh=1e-8, backward_convergence_thresh=5e-4,
    name="slope_simplified")

CONTINUOUS_NORMAL_SCENE = SceneConfig(
    fabric=NORMAL_FABRIC_6, orientation=Orientation.FRONT,
    up_vector=(1.0, 0.0, 1.0),
    attachment_points=AttachmentConfig.NO_ATTACHMENTS,
    trajectory=TrajectoryConfig.NO_TRAJECTORY,
    primitive_config=PrimitiveConfig.BIG_SPHERE,
    wind_config=WindConfig.NO_WIND,
    scene_bbox=AABB((-5, -1.5, -14), (7, 10, 5)),
    time_step=1.0 / 100.0, step_num=50,
    forward_convergence_thresh=1e-9, backward_convergence_thresh=5e-4,
    name="bigsphere_continuousNormal")  # :188-205

SIMPLE_SCENE = SceneConfig(
    fabric=NORMAL_FABRIC_6_LOWRES, orientation=Orientation.FRONT,
    attachment_points=AttachmentConfig.NO_ATTACHMENTS,
    trajectory=TrajectoryConfig.NO_TRAJECTORY,
    primitive_config=PrimitiveConfig.NONE,
    wind_config=WindConfig.NO_WIND,
    scene_bbox=AABB((-7, -7, -7), (7, 7, 7)),
    time_step=1.0 / 30.0, step_num=100,
    forward_convergence_thresh=1e-9, backward_convergence_thresh=5e-4,
    name="none")  # :208-225

# wind sim2real: the wind scene at stepNum=100 with WIND_SIN_AND_FALLOFF and
# the per-particle falloff focus used by loadWindSim2RealAnimationSequence
# (Simulation.cpp:3125-3131; task config :353-358, setup
# OptimizationTaskSetup.cpp:21-36,186-193).  The reference fits captured
# animation frames; the public repo ships no animation assets, so the task
# here generates its ground truth by simulation with the reference's
# "actual" sim2real parameters.
import dataclasses as _dc

WIND_SIM2REAL_SCENE = _dc.replace(
    WIND_SCENE, wind_config=WindConfig.WIND_SIN_AND_FALLOFF, step_num=100,
    wind_falloff_focus=(0.0, -1.0, 0.0), name="wind_sim2real")

# flagship stand-in: the tshirt wind system-ID physics (TSHIRT1000
# stiffness / density, WIND_SIN, h = 1/90, 250 steps, two corners attached)
# on a 32x32 grid — n = 1024, the size of the reference's tshirt1000 demo —
# for checkouts without the tshirt mesh asset.  The same grid as the JAX
# package's `__graft_entry__._flagship_sim` fallback.
TSHIRT_GRID_STANDIN = SceneConfig(
    fabric=FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                        k_stiff_stretching=550, k_stiff_bending=0.01,
                        grid_num_x=32, grid_num_y=32, density=0.124),
    attachment_points=AttachmentConfig.LEFT_RIGHT_CORNERS_2,
    wind_config=WindConfig.WIND_SIN, time_step=1.0 / 90.0,
    step_num=250, name="tshirt_grid_standin")



def dress_grid_standin(grid: int = 84) -> SceneConfig:
    """The dress twirl (DRESS_SCENE: the DRESS_V7K_DRAPE physics, h =
    1/120, 125 steps, TRAJECTORY_DRESS_TWIRL) on a grid x grid cloth of the
    dress's 13 x 13 size, for checkouts without the dress mesh: 84 x 84 is
    n = 7056, the size of the reference's 7k-vertex dress.  The dress's
    attachment indices address its mesh, so the stand-in attaches the 31
    middle vertices of the grid's top row (vertices 0 .. grid-1 of a FRONT
    grid; all of them on a narrower grid), as many as the dress attaches."""
    n_attached = min(len(DRESS_SCENE.custom_attachment_vertex_idx[0][1]),
                     grid)
    lo = (grid - n_attached) // 2
    return _dc.replace(
        DRESS_SCENE,
        fabric=_dc.replace(DRESS_V7K_DRAPE, is_model=False, grid_num_x=grid,
                           grid_num_y=grid, name="dress_grid_standin"),
        custom_attachment_vertex_idx=(
            (0.0, tuple(range(lo, lo + n_attached))),),
        name="dress_grid_standin")


def hat_grid_standin(grid: int = 25) -> SceneConfig:
    """The hat demo (HAT_SCENE: the AGENT_HAT_579 physics, h = 1/100, 400
    steps, CORNERS_2_WEARHAT, PLANE_BUST_WEARHAT, clips at vertices 394
    and 32) on a grid x grid cloth of the hat's 6 x 6 size, for checkouts
    without the hat mesh: 25 x 25 is n = 625, near the hat's 579
    vertices, and holds every vertex the demo and its controller name
    (the clips; the controller's direction pairs 394-562 and 32-108)."""
    return _dc.replace(
        HAT_SCENE,
        fabric=_dc.replace(AGENT_HAT_579, is_model=False, grid_num_x=grid,
                           grid_num_y=grid, name="hat_grid_standin"),
        name="hat_grid_standin")


# ---------------------------------------------------------------------------
# demo -> task map (OptimizationTaskConfigurations.cpp:353-421)

DEMOS: Dict[str, TaskConfig] = {
    "wind": TaskConfig(WIND_SCENE, True, True, LossType.MATCH_TRAJECTORY,
                       "wind"),
    "wind_sim2real": TaskConfig(WIND_SIM2REAL_SCENE, True, True,
                                LossType.MATCH_TRAJECTORY, "wind_sim2real"),
    "tshirt": TaskConfig(TSHIRT_SCENE, True, True, LossType.MATCH_TRAJECTORY,
                         "wind_tshirt"),
    "sphere": TaskConfig(ROTATING_SPHERE_SCENE, True, True,
                         LossType.MATCH_TRAJECTORY, "sphere"),
    "hat": TaskConfig(HAT_SCENE, False, False,
                      LossType.MATCHSHAPE_WITH_TRANSLATION, "wear_hat"),
    "sock": TaskConfig(SOCK_SCENE, False, False,
                       LossType.ASSISTED_DRESSING_KEYPOINTS, "wear_sock"),
    "slope": TaskConfig(SLOPE_SCENE, True, True,
                        LossType.MATCHSHAPE_WITH_TRANSLATION, "slope"),
    "dress": TaskConfig(DRESS_SCENE, False, False, LossType.DRESS_ANGLE,
                        "dress_twirl"),
}
