"""The port's optimizer stack on the CPU: `optim.helper.OptimizeHelper` and
its own copy of L-BFGS-B recover the wind of the test_optimize.py:22-43
scene (5 x 5 grid, 15 steps, f64), and the lockstep population solver
matches the single one (its batched evaluations equal the per-candidate
ones, and its first candidate, started where the single run starts,
follows it to the same endpoint), mirroring tests/test_optimize.py.

Tolerances: the recovered wind within 2e-3 (population: 5e-3) and the
final loss below 1e-8 (population: 1e-6), as test_optimize.py holds the
JAX package; batched against per-candidate evaluations rtol 1e-9 (the same
arithmetic, wider dense products); the population's first candidate within
1e-6 of the single run's endpoint.
"""
import numpy as np
import pytest
import torch

from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.optim.helper import GradMask, OptimizeHelper
from diffcloth_tpu_torch.optim.lbfgsb import (minimize_lbfgsb,
                                              minimize_lbfgsb_population)
from diffcloth_tpu_torch.optim.solver import solve_demo
from diffcloth_tpu_torch.tasks.setup import build_task
from torch_cpu import one_intra_op_thread  # noqa: F401

GT_WIND = np.array([0.06, 0.01, 0.05])


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


@pytest.fixture(scope="module")
def wind_sysid():
    fab = tc.FabricConfig(cloth_dim_x=2.0, cloth_dim_y=2.0,
                          k_stiff_stretching=300.0, k_stiff_bending=0.05,
                          grid_num_x=5, grid_num_y=5, density=0.3)
    cfg = tc.SceneConfig(
        fabric=fab, attachment_points=tc.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=tc.WindConfig.WIND_SIN, time_step=1.0 / 60.0,
        step_num=15, forward_convergence_thresh=1e-10, name="sysid")
    sim = ClothSim(gb.build_scene(cfg), device="cpu", dtype=torch.float64,
                   flags=tc.SimFlags(wind_enabled=True,
                                     gradient_clipping=False))
    p_gt = sim.default_params().replace(
        wind=t64(GT_WIND), wind_freq=t64(10.0), wind_phase=t64(0.5))
    loss_fn = tl.make_loss_fn(
        tc.LossType.MATCH_TRAJECTORY,
        tl.LossInfo(target_x=sim.rollout(p_gt).full_x()))
    helper = OptimizeHelper(sim, GradMask(f_wind=True), loss_fn,
                            param_base=p_gt.replace(wind=t64([0, 0, 0])))
    x0 = helper.params_to_vec(helper.base)
    res = minimize_lbfgsb(helper.loss_and_grad, x0, helper.lower_bound,
                          helper.upper_bound, maxiter=60, ftol=1e-12)
    return sim, loss_fn, helper, x0, res


def test_lbfgsb_recovers_wind(wind_sysid):
    _, _, helper, _, res = wind_sysid
    L0 = helper.history[0][0]
    assert res.loss < 1e-8, f"loss stayed at {res.loss} (init {L0})"
    np.testing.assert_allclose(res.x[0:3], GT_WIND, atol=2e-3)


def test_population_lbfgsb_matches_single(wind_sysid):
    sim, loss_fn, helper, x0, res = wind_sysid
    assert helper.can_batch
    X0 = np.stack([x0, helper.random_param(3)])
    Lb = helper.batched_loss(X0)
    L1, G1 = helper.batched_loss_and_grad(X0)
    for i in range(2):
        np.testing.assert_allclose(Lb[i], helper.loss(X0[i]), rtol=1e-9)
        l, g = helper.loss_and_grad(X0[i])
        np.testing.assert_allclose(L1[i], l, rtol=1e-9)
        np.testing.assert_allclose(G1[i], g, rtol=1e-9, atol=1e-15)
    pop = minimize_lbfgsb_population(
        helper.batched_loss_and_grad, X0, helper.lower_bound,
        helper.upper_bound, maxiter=60, ftol=1e-12)
    assert pop.best.loss < 1e-6, (pop.losses, pop.messages)
    np.testing.assert_allclose(pop.best.x[0:3], GT_WIND, atol=5e-3)
    np.testing.assert_allclose(pop.X[0], res.x, rtol=0, atol=1e-6)


def test_param_pack_roundtrip(wind_sysid):
    sim, loss_fn, _, _, _ = wind_sysid
    mask = GradMask(f_wind=True, density=True,
                    k_pertype=(False, False, True, True))
    helper = OptimizeHelper(sim, mask, loss_fn)
    # wind(3) + freq + phase + k_stretch + k_bend + density
    assert helper.n_params == 8 and not helper.can_batch
    x = helper.random_param(0)
    np.testing.assert_allclose(helper.params_to_vec(helper.vec_to_params(x)),
                               x, rtol=1e-12)
    assert np.all(x >= helper.lower_bound) and np.all(x <= helper.upper_bound)
    with pytest.raises(ValueError):
        helper.batched_loss_and_grad(np.stack([x, x]))


@pytest.mark.parametrize("demo", ["hat", "sock", "slope", "dress"])
def test_unported_demos_raise(demo):
    """dress (the twirl) is not ported; hat, sock and slope are, but their
    mesh or position assets are not in the repository, and the builder
    raises for them (sphere builds: tests/test_torch_tasks.py)."""
    err = NotImplementedError if demo == "dress" else FileNotFoundError
    with pytest.raises(err):
        build_task(demo, device="cpu")


def test_solve_demo_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        solve_demo("wind", device="cpu", export_dir="out")
