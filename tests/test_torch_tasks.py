"""Port parity for the task setup with obstacles (`tasks/setup.py`):
primitive placement for every `PrimitiveConfig` branch, the lower-leg
composite, and `build_task` for the obstacle demos against the JAX
package's, on the CPU in f64.

The `slope`, `hat`, `sock` and `dress` demos read mesh or position assets
that are not in the repository (their builds raise the builder's FileNotFoundError,
tests/test_torch_optimize.py); here both packages' registries are patched
to asset-free grid stand-ins of those scenes (the same obstacles,
attachments, trajectory and physics; a grid of at least as many vertices
as the task's keypoint and attachment indices need) cut to 3 steps.
`sphere` and the wind demos build from grids and are only cut in length.

Tolerances: primitive fields, masks, parameters, loss targets and
attachment trajectories equal to 1e-12 (the same f64 numpy arithmetic,
then a cast); the ground-truth rollouts within 1e-6 and the losses within
rtol 1e-6 (the f32 friction sweep inside the f64 simulation, as in
tests/test_torch_sim.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu.core.sim import ClothSim as JaxSim
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu.tasks import registry as jreg
from diffcloth_tpu.tasks import setup as jsetup
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch.convert import sim_params_from_numpy
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.geometry import builder as tgb
from diffcloth_tpu_torch.tasks import registry as treg
from diffcloth_tpu_torch.tasks import setup as tsetup
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64
ATOL = 1e-12
STEPS = 3
PRIM_FIELDS = ("center", "velocity", "radius", "length", "axis_rot",
               "plane_normal", "plane_upper_left", "plane_upper_right", "mu")
HOST_FIELDS = ("kind", "rotates", "enabled", "kinematic")
PRIM_CONFIGS = ("PLANE_AND_SPHERE", "BIG_SPHERE", "PLANE_BUST_WEARHAT",
                "SLOPE_SIMPLIFIED", "FOOT", "Y0PLANE")
# grid sizes of the stand-ins: enough vertices for every index the task
# names (hat attaches vertex 394, sock's keypoints reach 995; the dress's
# attachments, which address its mesh, become the middle DRESS_CLIPS
# vertices of the grid's top row)
GRID = {"slope": 25, "hat": 25, "sock": 32, "tshirt": 25, "dress": 8}
DRESS_CLIPS = 4


def grid_scene(m, pc):
    """An asset-free 25 x 25 grid scene with primitive config `pc`."""
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=4.5, cloth_dim_y=4.5,
                              grid_num_x=25, grid_num_y=25, density=0.3),
        orientation=m.Orientation.DOWN,
        primitive_config=getattr(m.PrimitiveConfig, pc),
        sock_leg_orientation=(0.3, 1.0, 0.2), name="grid")


def assert_prims_equal(jp, tp):
    for name in HOST_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tp, name)),
                                      np.asarray(getattr(jp, name)), name)
    for name in PRIM_FIELDS:
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)), rtol=0,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("pc", PRIM_CONFIGS)
def test_make_primitives_matches(pc):
    jscene = jgb.build_scene(grid_scene(jc, pc))
    tscene = tgb.build_scene(grid_scene(tc, pc))
    jp, jent = jsetup._make_primitives(jscene, jnp.float64)
    tp, tent = tsetup._make_primitives(tscene, F64, "cpu")
    assert tp.n == jp.kind.shape[0] == len(tent) == len(jent) > 0
    assert_prims_equal(jp, tp)
    assert tp.center.device.type == "cpu" and tp.center.dtype == F64


def test_lower_leg_entries_match():
    for axis in ((0.0, 1.0, 0.0), (0.3, 1.0, 0.2), (1.0, -0.5, 0.1)):
        center = np.array([0.2, 3.0, -4.0])
        jent, jgeo = jsetup.lower_leg_entries(center, axis, 5.0, 4.0, 0.2)
        tent, tgeo = tsetup.lower_leg_entries(center, axis, 5.0, 4.0, 0.2)
        for je, te in zip(jent, tent):
            assert je.keys() == te.keys()
            for k in je:
                np.testing.assert_array_equal(np.asarray(te[k]),
                                              np.asarray(je[k]), k)
        for k in jgeo:
            np.testing.assert_array_equal(tgeo[k], jgeo[k], k)


@pytest.mark.parametrize("axis", [(0.0, 1.0, 0.0), (0.3, 1.0, 0.2)])
@pytest.mark.parametrize("step_num", [3, 200])
def test_sock_keypoint_table(axis, step_num):
    """ASSISTED_DRESSING_KEYPOINTS: 8 targets at the last frame and the
    opening's 4 at three frames from 0.62 N, candidates padded with -1,
    every target on the surface of the foot or leg capsule."""
    center = np.array([0.2, 3.0, -4.0])
    frames, targets, cands = tsetup.sock_keypoints(center, axis, step_num)
    assert frames.dtype == cands.dtype == np.int32
    assert targets.shape == (20, 3) and cands.shape == (20, 9)
    np.testing.assert_array_equal(
        frames, [step_num] * 8 + [int(step_num * 0.62) + i for i in range(3)
                                  for _ in range(4)])
    for row in cands:   # indices first, then the padding
        k = int((row >= 0).sum())
        assert k >= 3 and (row[k:] == -1).all()
    entries, geo = tsetup.lower_leg_entries(center, axis)
    r = geo["radius"]

    def axis_dist(p, base, rot, length):
        tip = rot @ np.array([0.0, length, 0.0])
        s = np.clip((p - base) @ tip / (tip @ tip), 0.0, 1.0)
        return np.linalg.norm(p - base - s * tip)

    foot, leg = entries[1], entries[2]
    for p in targets:
        d = min(axis_dist(p, foot["center"], foot["rot"], 4.0),
                axis_dist(p, leg["center"], leg["rot"], 5.0))
        assert abs(d - r) < 1e-9, d


@pytest.mark.parametrize("demo", ["slope", "hat", "sock", "dress"])
def test_asset_demos_raise_like_jax(demo):
    """Without their mesh or position assets, both builders raise
    FileNotFoundError for the same demos."""
    with pytest.raises(FileNotFoundError):
        jsetup.build_task(demo, dtype=jnp.float64)
    with pytest.raises(FileNotFoundError):
        tsetup.build_task(demo, dtype=F64, device="cpu")


def stand_in(m, reg, demo):
    """The registry's task with its scene cut to STEPS steps and, for the
    asset demos, its mesh replaced by a grid."""
    task = reg.DEMOS[demo]
    scene = dataclasses.replace(task.scene, step_num=STEPS)
    if demo in GRID:
        fab = dataclasses.replace(
            scene.fabric, is_model=False, custom_init_pos=False,
            init_pos_file="", grid_num_x=GRID[demo], grid_num_y=GRID[demo])
        scene = dataclasses.replace(scene, fabric=fab)
    if demo == "dress":
        lo = (GRID[demo] - DRESS_CLIPS) // 2
        scene = dataclasses.replace(scene, custom_attachment_vertex_idx=(
            (0.0, tuple(range(lo, lo + DRESS_CLIPS))),))
    return dataclasses.replace(task, scene=scene)


@pytest.fixture
def stand_ins(monkeypatch):
    """Patch both registries for the demos given, return the port's
    TaskSetup builder."""
    def install(*demos):
        for demo in demos:
            monkeypatch.setitem(jreg.DEMOS, demo, stand_in(jc, jreg, demo))
            monkeypatch.setitem(treg.DEMOS, demo, stand_in(tc, treg, demo))
    return install


def assert_value_equal(a, b, what, atol=ATOL):
    if b is None:
        assert a is None, what
        return
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("demo", ["sphere", "slope", "hat", "sock",
                                  "dress"])
def test_build_task_matches_jax(demo, stand_ins):
    stand_ins(demo)
    jt = jsetup.build_task(demo, dtype=jnp.float64, self_method="pallas",
                           self_friction_impl="pallas")
    tt = tsetup.build_task(demo, dtype=F64, device="cpu")
    assert dataclasses.asdict(tt.mask) == dataclasses.asdict(jt.mask)
    assert tt.loss_type.name == jt.loss_type.name
    assert tt.sim.flags.wind_enabled == jt.sim.flags.wind_enabled
    assert tt.sim.spline_type.name == jt.sim.spline_type.name
    assert_prims_equal(jt.sim.prims, tt.sim.prims)
    for which in ("param_gt", "param_base"):
        tp, jp = getattr(tt, which), getattr(jt, which)
        for name, a in tp.items():
            assert_value_equal(a, getattr(jp, name), f"{which}.{name}")
    for f in dataclasses.fields(jt.loss_info):
        a, b = getattr(tt.loss_info, f.name), getattr(jt.loss_info, f.name)
        assert_value_equal(a, b, f"loss_info.{f.name}",
                           1e-6 if f.name == "target_x" else ATOL)
    assert_value_equal(tt.sim.x_fixed_seq(tt.param_base),
                       jt.sim.x_fixed_seq(jt.param_base), "x_fixed_seq")
    if demo in ("sphere", "slope"):
        # the ground truth is the rollout at the true mu; the base episode
        # (the scene's own mu) misses it by a loss both packages agree on
        jl = jt.loss_fn()(jt.sim.rollout(jt.param_base))
        tl = tt.loss_fn()(tt.sim.rollout(tt.param_base))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        assert tt.loss_info.target_x.shape == (STEPS + 1, tt.sim.n, 3)
        assert tt.sim.n_prims == 1 and float(tt.param_gt.mu[0]) != float(
            tt.param_base.mu[0])
    if demo == "sock":
        K = tt.loss_info.keypoint_frames.shape[0]
        assert K == 20 and int(tt.loss_info.keypoint_candidates.max()) < \
            tt.sim.n


@pytest.mark.parametrize("demo", ["wind", "wind_sim2real", "tshirt",
                                  "sphere", "slope", "hat", "sock", "dress"])
def test_wind_enabled_per_demo(demo, stand_ins):
    """Wind acts only in the wind demos (tasks/setup.py:189-191)."""
    stand_ins(demo)
    task = tsetup.build_task(demo, dtype=F64, device="cpu")
    assert task.sim.flags.wind_enabled == (demo in ("wind", "tshirt",
                                                    "wind_sim2real"))


def spline_cfg(m):
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=2.0, cloth_dim_y=2.0,
                              grid_num_x=5, grid_num_y=5, density=0.3),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        trajectory=m.TrajectoryConfig.CORNERS_2_WEARHAT, step_num=6,
        name="tangents")


def test_x_fixed_seq_evaluates_the_spline_type():
    """ENDPOINT_AND_TANGENTS reads the tangents from the spline params:
    tangents that differ from the endpoint-derived ones move the clips."""
    jsim = JaxSim(jgb.build_scene(spline_cfg(jc)), dtype=jnp.float64,
                  spline_type=jc.SplineType.ENDPOINT_AND_TANGENTS)
    tsim = TorchSim(tgb.build_scene(spline_cfg(tc)), device="cpu",
                    dtype=F64,
                    spline_type=tc.SplineType.ENDPOINT_AND_TANGENTS)
    rng = np.random.RandomState(0)
    spline = np.asarray(jsim.default_params().spline) + rng.randn(2, 9)
    jp = jsim.default_params()._replace(spline=jnp.asarray(spline))
    tp = sim_params_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu", F64)
    xf = tsim.x_fixed_seq(tp)
    np.testing.assert_allclose(xf.numpy(), np.asarray(jsim.x_fixed_seq(jp)),
                               rtol=0, atol=ATOL)
    ends = TorchSim(tgb.build_scene(spline_cfg(tc)), device="cpu",
                    dtype=F64).x_fixed_seq(tp)
    assert float((ends - xf).abs().max()) > 1e-3
    np.testing.assert_allclose(ends[-1].numpy(), xf[-1].numpy(), rtol=0,
                               atol=ATOL)


def twirl_cfg(m, steps=7):
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=3.0, cloth_dim_y=2.0,
                              grid_num_x=6, grid_num_y=5, density=0.3),
        attachment_points=m.AttachmentConfig.CUSTOM_ARRAY,
        custom_attachment_vertex_idx=((0.0, (1, 2, 4, 9)),),
        trajectory=m.TrajectoryConfig.TRAJECTORY_DRESS_TWIRL,
        step_num=steps, name="twirl")


def test_dress_twirl_x_fixed_seq_matches_jax():
    """TRAJECTORY_DRESS_TWIRL: 0.02 rad per step about the vertical axis
    through the rest shape's middle, single and batched."""
    jsim = JaxSim(jgb.build_scene(twirl_cfg(jc)), dtype=jnp.float64)
    tsim = TorchSim(tgb.build_scene(twirl_cfg(tc)), device="cpu", dtype=F64)
    jxf = np.asarray(jsim.x_fixed_seq(jsim.default_params()))
    xf = tsim.x_fixed_seq(tsim.default_params())
    np.testing.assert_allclose(xf.numpy(), jxf, rtol=0, atol=ATOL)
    batch = tsim.x_fixed_seq(tsim.default_params().expand(2))
    assert tuple(batch.shape) == (2, 7, 4, 3)
    np.testing.assert_array_equal(batch[1].numpy(), xf.numpy())
    # heights stay, radii about the axis stay, the angle grows 0.02 a step
    rest = tsim.stage_host.fixed_pos_rest
    mid = tsim.scene_host.rest_mid
    np.testing.assert_allclose(xf[..., 1].numpy(), np.broadcast_to(
        rest[:, 1], (7, 4)), rtol=0, atol=ATOL)
    rel = rest - mid
    ang = np.arctan2(-(xf[-1, :, 2].numpy() - mid[2]),
                     xf[-1, :, 0].numpy() - mid[0]) - np.arctan2(
        -rel[:, 2], rel[:, 0])
    np.testing.assert_allclose(np.mod(ang, 2 * np.pi), 0.14, atol=1e-12)


def test_dress_task_episode_and_gradient_match_jax(stand_ins):
    """The dress demo on an 8 x 8 grid stand-in: its DRESS_ANGLE loss and
    the gradient over its mask (density, k_bend) against the JAX
    package's.  Tolerances: the loss rtol 1e-6 and the gradient rtol 1e-5
    of each class's entry (f64 episodes; the f32 friction sweep inside
    both, as in tests/test_torch_sim.py)."""
    stand_ins("dress")
    jt = jsetup.build_task("dress", dtype=jnp.float64, self_method="pallas",
                           self_friction_impl="pallas")
    tt = tsetup.build_task("dress", dtype=F64, device="cpu")
    assert tt.sim.cfg.trajectory == tc.TrajectoryConfig.TRAJECTORY_DRESS_TWIRL
    assert int(tt.loss_info.loop_points.numel()) > 0
    L, g = tt.sim.episode_value_and_grad(tt.loss_fn())(tt.param_gt)
    jL, jg = jt.sim.episode_value_and_grad(jt.loss_fn())(jt.param_gt)
    np.testing.assert_allclose(float(L), float(jL), rtol=1e-6)
    for name in ("density", "k_pertype"):
        np.testing.assert_allclose(getattr(g, name).numpy(),
                                   np.asarray(getattr(jg, name)), rtol=1e-5,
                                   atol=1e-12, err_msg=name)
    assert float(g.density) != 0.0 and float(g.k_pertype[3]) != 0.0


def test_keypoint_tau_smooths_the_sock_loss(stand_ins):
    """keypoint_tau reaches the loss: on the same frames (the sock
    stand-in's rest shape plus noise, numpy seed 5), the port task's
    softmax loss at tau 0.5 equals the JAX task's and differs from the
    hard max.  Tolerance rtol 1e-12 (the same f64 arithmetic)."""
    import types

    from diffcloth_tpu_torch import losses as tl
    stand_ins("sock")
    jt = jsetup.build_task("sock", dtype=jnp.float64, keypoint_tau=0.5,
                           self_method="pallas", self_friction_impl="pallas")
    tt = tsetup.build_task("sock", dtype=F64, device="cpu", keypoint_tau=0.5)
    assert tt.loss_info.keypoint_tau == jt.loss_info.keypoint_tau == 0.5
    rng = np.random.RandomState(5)
    rest = tt.sim.scene_host.x_rest
    frames = rest + 0.3 * rng.randn(STEPS + 1, tt.sim.n, 3)

    def recs(f):
        return types.SimpleNamespace(
            x0=f(frames[0]), v0=f(np.zeros_like(rest)),
            steps=types.SimpleNamespace(x=f(frames[1:]),
                                        v=f(np.zeros_like(frames[1:]))))

    soft = float(tt.loss_fn()(recs(torch.as_tensor)))
    np.testing.assert_allclose(soft, float(jt.loss_fn()(recs(jnp.asarray))),
                               rtol=1e-12)
    hard = float(tl.make_loss_fn(tt.loss_type, dataclasses.replace(
        tt.loss_info, keypoint_tau=0.0))(recs(torch.as_tensor)))
    assert soft != hard
