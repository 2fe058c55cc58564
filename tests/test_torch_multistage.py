"""Port parity for multi-stage attachment scenes (reference: one `sysMat`
per attachment set with `startFrameNum`, selected per frame,
Simulation.h:361-405, Simulation.cpp:1053-1068), mirroring
tests/test_multistage.py: the port's ClothSim against the JAX package's on
the same 5 x 5 grid scenes, f64 on the CPU.

Tolerances: segments, padding and clip trajectories exactly (the same f64
arithmetic); episodes within 1e-9 of the JAX package's (f64 throughout,
summation order apart; no self-contact on these flat grids, so no f32
friction sweep enters); the prefix before the switch within 1e-12 of a
single-stage episode (the same port code, bitwise in practice); the wind
gradient within rtol 1e-6 of the JAX package's and within rtol 2e-3 of
central differences (as tests/test_multistage.py holds the JAX package).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu.core.sim import ClothSim as JaxSim
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch.core import diagnostics as diag
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.geometry import builder as tgb
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64
WIND = [0.3, 0.05, 0.3]
SWITCH = ((0.0, (0, 4)), (0.5, (20, 24)))


def scene_cfg(m, stages, steps=10, grid=5):
    fab = m.FabricConfig(cloth_dim_x=2.0, cloth_dim_y=2.0,
                         k_stiff_stretching=250.0, k_stiff_bending=0.05,
                         grid_num_x=grid, grid_num_y=grid, density=0.324)
    return m.SceneConfig(
        fabric=fab, attachment_points=m.AttachmentConfig.CUSTOM_ARRAY,
        custom_attachment_vertex_idx=stages,
        trajectory=m.TrajectoryConfig.NO_TRAJECTORY,
        primitive_config=m.PrimitiveConfig.NONE,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 60.0,
        step_num=steps, forward_convergence_thresh=1e-9,
        name="test_multistage")


def torch_sim(stages, steps=10):
    return TorchSim(tgb.build_scene(scene_cfg(tc, stages, steps)),
                    device="cpu", dtype=F64)


def jax_sim(stages, steps=10):
    return JaxSim(jgb.build_scene(scene_cfg(jc, stages, steps)),
                  dtype=jnp.float64, self_method="pallas",
                  self_friction_impl="pallas")


def windy(sim):
    return sim.default_params().replace(
        wind=torch.tensor(WIND, dtype=F64))


def jax_windy(sim):
    return sim.default_params()._replace(wind=jnp.array(WIND, jnp.float64))


def last_x_loss(recs):
    return (recs.steps.x[-1] ** 2).sum()


def test_stage_segments_and_padding():
    stages = ((0.0, (0, 4)), (0.5, (20, 24, 22)))
    sim, jsim = torch_sim(stages), jax_sim(stages)
    assert sim.n_stages == jsim.n_stages == 2
    assert sim.max_fixed == jsim.max_fixed == 3
    # frames 1..4 run stage 0, frames 5..10 stage 1
    assert sim.segments == jsim._segments == [(0, 1, 5), (1, 5, 11)]
    p = windy(sim)
    assert tuple(p.spline.shape) == (2, 3, 9)
    np.testing.assert_array_equal(p.spline.numpy(),
                                  np.asarray(jsim.default_params().spline))
    xfs = sim.x_fixed_seq(p)
    assert tuple(xfs.shape) == (10, 3, 3)
    np.testing.assert_array_equal(xfs[:4, 2].numpy(), 0.0)
    np.testing.assert_array_equal(
        xfs.numpy(), np.asarray(jsim.x_fixed_seq(jax_windy(jsim))))
    assert isinstance(sim.p_inv(p), tuple) and len(sim.p_inv(p)) == 2


def test_attachments_actually_switch():
    sim, jsim = torch_sim(SWITCH), jax_sim(SWITCH)
    recs = sim.rollout(windy(sim))
    X = recs.steps.x.numpy()
    assert np.all(np.isfinite(X)) and bool(recs.steps.converged.all())
    jX = np.asarray(jsim.rollout(jax_windy(jsim)).steps.x)
    np.testing.assert_allclose(X, jX, rtol=0, atol=1e-9)
    assert tuple(recs.steps.x_fixed.shape) == (10, 2, 3)
    rest = sim.scene_host.x_rest
    # stage 0 holds vertices 0 and 4; after the switch 20 and 24 are held
    # and 0 and 4, released, move under wind and gravity
    assert np.linalg.norm(X[3, [0, 4]] - rest[[0, 4]]) < 5e-2
    assert np.linalg.norm(X[-1, [20, 24]] - rest[[20, 24]]) < 5e-2
    assert np.linalg.norm(X[-1, [0, 4]] - rest[[0, 4]]) > \
        2 * np.linalg.norm(X[-1, [20, 24]] - rest[[20, 24]])


def test_prefix_matches_single_stage():
    two = torch_sim(SWITCH, steps=10)
    one = torch_sim(((0.0, (0, 4)),), steps=4)
    X2 = two.rollout(windy(two)).steps.x[:4].numpy()
    X1 = one.rollout(windy(one)).steps.x.numpy()
    np.testing.assert_allclose(X2, X1, rtol=0, atol=1e-12)


def test_gradients_flow_across_the_switch():
    """The wind gradient through both segments against the JAX package's
    and against central differences of the port's own episode."""
    sim, jsim = torch_sim(SWITCH), jax_sim(SWITCH)
    params = windy(sim)
    L, g = sim.episode_value_and_grad(last_x_loss)(params)
    jL, jg = jsim.episode_value_and_grad(last_x_loss)(jax_windy(jsim))
    np.testing.assert_allclose(float(L), float(jL), rtol=1e-9)
    np.testing.assert_allclose(g.wind.numpy(), np.asarray(jg.wind),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(g.x0.numpy(), np.asarray(jg.x0), rtol=0,
                               atol=1e-6 * float(np.abs(jg.x0).max()))
    assert abs(float(g.wind[0])) > 0

    def loss_of(p):
        return last_x_loss(sim.rollout(p))

    fd = diag.finite_difference_gradients(loss_of, params, fields=("wind",),
                                          delta=1e-6)
    rep = diag.compare_fd_adjoint(fd, g, rtol=2e-3)
    assert rep["wind"][2], rep


def test_batched_multistage_raises():
    """The JAX package's batched routes have no multi-stage form: the
    port's batched episode functions refuse such a scene."""
    sim = torch_sim(SWITCH)
    batch = windy(sim).expand(2)
    for call in (lambda: sim.rollout(batch),
                 lambda: sim.episode_loss(last_x_loss)(batch),
                 lambda: sim.episode_value_and_grad(last_x_loss)(batch)):
        with pytest.raises(ValueError, match="several attachment stages"):
            call()
