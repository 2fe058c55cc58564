"""A small keypoint task for the port's optimizer tests (imported by them,
not collected): ASSISTED_DRESSING_KEYPOINTS on a 5 x 5 grid whose two
corners follow CORNERS_2_WEARHAT splines, the spline control points
optimized (the sock demo's loss and mask; its own mesh and foot are too
large for a CPU test), built for either package.  `patch_build_task`
installs it as the solvers' `build_task` for one demo name, so that
`solve_demo` and `solve_demo_tau_ladder` run it through their normal
code."""
import numpy as np

STEPS = 6
FRAMES = np.array([STEPS, STEPS, STEPS - 2], np.int32)
CANDIDATES = np.array([[0, 1, 2], [22, 23, 24], [12, -1, -1]], np.int32)
# offsets of the targets from the rest positions of vertices 1, 23, 12
OFFSETS = np.array([[0.3, 0.6, -0.2], [-0.2, 0.7, 0.3], [0.1, 0.5, 0.4]])


def scene_cfg(m):
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=2.0, cloth_dim_y=2.0,
                              k_stiff_stretching=300.0,
                              k_stiff_bending=0.05, grid_num_x=5,
                              grid_num_y=5, density=0.3),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        trajectory=m.TrajectoryConfig.CORNERS_2_WEARHAT,
        time_step=1.0 / 100.0, step_num=STEPS,
        forward_convergence_thresh=1e-9, backward_convergence_thresh=1e-8,
        name="keypoint_grid")


def _targets(x_rest):
    return x_rest[[1, 23, 12]] + OFFSETS


def torch_task(keypoint_tau=0.0):
    import torch
    from diffcloth_tpu_torch import config as tc
    from diffcloth_tpu_torch import losses as tl
    from diffcloth_tpu_torch.core.sim import ClothSim
    from diffcloth_tpu_torch.geometry import builder as gb
    from diffcloth_tpu_torch.optim.helper import GradMask
    from diffcloth_tpu_torch.tasks.setup import TaskSetup
    scene = gb.build_scene(scene_cfg(tc))
    sim = ClothSim(scene, device="cpu", dtype=torch.float64)
    base = sim.default_params()
    info = tl.LossInfo(
        keypoint_frames=torch.as_tensor(FRAMES),
        keypoint_targets=torch.as_tensor(_targets(scene.x_rest)),
        keypoint_candidates=torch.as_tensor(CANDIDATES),
        keypoint_tau=keypoint_tau)
    return TaskSetup(sim=sim, mask=GradMask(control_points=True),
                     loss_type=tc.LossType.ASSISTED_DRESSING_KEYPOINTS,
                     loss_info=info, param_gt=base, param_base=base,
                     name="keypoint_grid")


def jax_task(keypoint_tau=0.0):
    import jax.numpy as jnp
    from diffcloth_tpu import config as jc
    from diffcloth_tpu import losses as jl
    from diffcloth_tpu.core.sim import ClothSim
    from diffcloth_tpu.geometry import builder as gb
    from diffcloth_tpu.optim.helper import GradMask
    from diffcloth_tpu.tasks.setup import TaskSetup
    scene = gb.build_scene(scene_cfg(jc))
    sim = ClothSim(scene, dtype=jnp.float64, self_method="pallas",
                   self_friction_impl="pallas")
    base = sim.default_params()
    info = jl.LossInfo(
        keypoint_frames=jnp.asarray(FRAMES),
        keypoint_targets=jnp.asarray(_targets(scene.x_rest)),
        keypoint_candidates=jnp.asarray(CANDIDATES),
        keypoint_tau=keypoint_tau)
    return TaskSetup(sim=sim, mask=GradMask(control_points=True),
                     loss_type=jc.LossType.ASSISTED_DRESSING_KEYPOINTS,
                     loss_info=info, param_gt=base, param_base=base,
                     name="keypoint_grid")


def patch_build_task(monkeypatch, solver_module, make_task, demo="sock"):
    """Make `solver_module.build_task(demo, ...)` return make_task(tau)."""
    real = solver_module.build_task

    def build_task(name, *args, keypoint_tau=0.0, **kwargs):
        if name != demo:
            return real(name, *args, keypoint_tau=keypoint_tau, **kwargs)
        return make_task(keypoint_tau)

    monkeypatch.setattr(solver_module, "build_task", build_task)
