"""The port's optimizer stack on the CPU: `optim.helper.OptimizeHelper` and
its own copy of L-BFGS-B recover the wind of the test_optimize.py:22-43
scene (5 x 5 grid, 15 steps, f64), and the lockstep population solver
matches the single one (its batched evaluations equal the per-candidate
ones, and its first candidate, started where the single run starts,
follows it to the same endpoint), mirroring tests/test_optimize.py.

The tau ladder, the resumed fit and the export run on the keypoint task
of tests/keypoint_task.py (a 5 x 5 grid, ASSISTED_DRESSING_KEYPOINTS),
installed as the solvers' build_task for the `sock` demo.

Tolerances: the recovered wind within 2e-3 (population: 5e-3) and the
final loss below 1e-8 (population: 1e-6), as test_optimize.py holds the
JAX package; batched against per-candidate evaluations rtol 1e-9 (the same
arithmetic, wider dense products); the population's first candidate within
1e-6 of the single run's endpoint.  The ladder against the JAX package's:
rung losses rtol 1e-6 and the endpoint within 1e-5 (f64 episodes whose
gradients agree to about 1e-15 where the cloth does not touch itself; an
iterate that reaches self-contact brings in the f32 friction sweep, about
1e-7 relative, and L-BFGS carries it on).  A resumed fit equals the
unbroken one exactly (the same evaluations in the same order).
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
from diffcloth_tpu_torch.optim import solver as tsolver
from diffcloth_tpu_torch.optim.solver import solve_demo
from diffcloth_tpu_torch.tasks.setup import build_task
from torch_cpu import one_intra_op_thread  # noqa: F401

import keypoint_task

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
    """hat, sock, slope and dress are ported, but their mesh or position
    assets are not in the repository, and the builder raises for them
    (their grid stand-ins build: tests/test_torch_tasks.py)."""
    with pytest.raises(FileNotFoundError):
        build_task(demo, device="cpu")


def test_solve_demo_refuses_what_is_not_ported():
    """The JAX package's "matrix" detection is not a method of the port,
    and checkpoints and per-iterate exports cover the single L-BFGS-B run,
    not a population."""
    with pytest.raises(ValueError, match="self-collision method"):
        solve_demo("wind", device="cpu", self_method="matrix")
    for kw in (dict(checkpoint_dir="ckpts"), dict(export_iters=True)):
        with pytest.raises(ValueError, match="population"):
            solve_demo("wind", device="cpu", population=2, **kw)


def run_ladders(monkeypatch, population):
    """The same two-rung ladder (tau 0.5 then 0, two iterations each)
    through both packages' solve_demo_tau_ladder; returns the port's
    result, its population results per rung, and the JAX package's."""
    import jax.numpy as jnp
    from diffcloth_tpu.optim import solver as jsolver
    keypoint_task.patch_build_task(monkeypatch, tsolver,
                                   keypoint_task.torch_task)
    keypoint_task.patch_build_task(monkeypatch, jsolver,
                                   keypoint_task.jax_task)
    pops = []
    real = tsolver.minimize_lbfgsb_population

    def recording(*args, **kwargs):
        pops.append(real(*args, **kwargs))
        return pops[-1]

    monkeypatch.setattr(tsolver, "minimize_lbfgsb_population", recording)
    kw = dict(taus=(0.5, 0.0), maxiter_per_rung=2, final_maxiter=2,
              population=population)
    res = tsolver.solve_demo_tau_ladder("sock", dtype=torch.float64,
                                        device="cpu", **kw)
    jres = jsolver.solve_demo_tau_ladder("sock", dtype=jnp.float64, **kw)
    return res, pops, jres


def assert_ladders_equal(res, jres):
    np.testing.assert_allclose(res.x_init, jres.x_init, rtol=0, atol=0)
    np.testing.assert_allclose(res.result.x, jres.result.x, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(res.result.loss, jres.result.loss, rtol=1e-6)
    assert [r["tau"] for r in res.rungs] == [0.5, 0.0]


def test_tau_ladder_matches_jax(monkeypatch):
    res, pops, jres = run_ladders(monkeypatch, 0)
    assert not pops
    assert_ladders_equal(res, jres)
    soft, hard = res.rungs
    # the smoothed rung's loss is not the hard max; the last rung's is
    assert soft["smoothed_loss"] != soft["hard_max_loss"]
    assert hard["smoothed_loss"] == pytest.approx(hard["hard_max_loss"],
                                                  rel=1e-12)
    assert hard["hard_max_loss"] < soft["hard_max_loss"]
    assert res.result.n_iters == hard["n_iters"] == 2


def test_tau_ladder_population_reports_its_winner(monkeypatch):
    """Population 4: every rung's winner b (the lowest hard-max loss) is
    the result, with b's own iterations, convergence and message; x and
    the loss equal the JAX package's."""
    res, pops, jres = run_ladders(monkeypatch, 4)
    assert len(pops) == 2 and pops[0].X.shape[0] == 4
    assert_ladders_equal(res, jres)
    for rung, pop in zip(res.rungs, pops):
        b = rung["winner"]
        assert b == int(np.argmin(rung["hard_all"]))
        assert rung["smoothed_loss"] == float(pop.losses[b])
    b, pop, r = res.rungs[-1]["winner"], pops[-1], res.result
    np.testing.assert_array_equal(r.x, pop.X[b])
    assert (r.n_iters, r.message, r.converged) == (
        int(pop.n_iters[b]), pop.messages[b], bool(pop.converged[b]))


def test_resumed_fit_equals_unbroken(monkeypatch, tmp_path):
    """Checkpoints hold the solver's whole state: a fit stopped after two
    iterations and resumed to four ends where an unbroken four-iteration
    fit ends, with the same evaluations."""
    from diffcloth_tpu_torch.utils import checkpoint as ckpt
    keypoint_task.patch_build_task(monkeypatch, tsolver,
                                   keypoint_task.torch_task)
    kw = dict(dtype=torch.float64, device="cpu")
    whole = solve_demo("sock", maxiter=4, checkpoint_dir=str(tmp_path / "a"),
                       **kw).result
    assert whole.n_iters == 4
    assert ckpt.latest_step(str(tmp_path / "a")) == 4
    root = str(tmp_path / "b")
    first = solve_demo("sock", maxiter=2, checkpoint_dir=root, **kw).result
    assert ckpt.latest_step(root) == 2
    _, saved = ckpt.restore_checkpoint(root)
    np.testing.assert_array_equal(saved["x"], first.x)
    rest = solve_demo("sock", maxiter=4, checkpoint_dir=root, resume=True,
                      **kw).result
    np.testing.assert_array_equal(rest.x, whole.x)
    assert rest.loss == whole.loss
    assert rest.loss_history == whole.loss_history
    assert (rest.n_iters, rest.n_evals) == (whole.n_iters, whole.n_evals)
    assert ckpt.latest_step(root) == 4


def test_export_optimization_files(monkeypatch, tmp_path):
    """solve_demo's export_dir: optimization.json, the final episode, one
    episode per accepted iterate with export_iters, population.json for a
    population."""
    import json
    import os
    from diffcloth_tpu_torch.io import export as texport
    keypoint_task.patch_build_task(monkeypatch, tsolver,
                                   keypoint_task.torch_task)
    out = str(tmp_path / "single")
    res = solve_demo("sock", maxiter=2, dtype=torch.float64, device="cpu",
                     export_dir=out, export_iters=True)
    with open(os.path.join(out, "optimization.json")) as fh:
        log = json.load(fh)
    assert log["demo"] == "sock" and log["n_iters"] == res.result.n_iters
    assert log["final_loss"] == res.result.loss
    np.testing.assert_array_equal(log["x_final"], res.result.x)
    xs, tris, info = texport.import_episode(os.path.join(out, "final"))
    n_frames = keypoint_task.STEPS + 1
    assert xs.shape == (n_frames, 25, 3) and "episode_report" in info
    recs = res.task.sim.rollout(res.helper.vec_to_params(res.result.x))
    np.testing.assert_allclose(xs, recs.full_x().numpy(), rtol=0, atol=1e-8)
    for k in range(res.result.n_iters):
        assert len([f for f in os.listdir(os.path.join(out, f"iter{k}"))
                    if f.endswith(".obj")]) == n_frames
    assert not os.path.exists(os.path.join(out, f"iter{res.result.n_iters}"))
    pop_out = str(tmp_path / "pop")
    solve_demo("sock", maxiter=1, population=2, dtype=torch.float64,
               device="cpu", export_dir=pop_out)
    with open(os.path.join(pop_out, "population.json")) as fh:
        pop = json.load(fh)
    assert pop["P"] == 2 and len(pop["losses"]) == 2
    assert os.path.isdir(os.path.join(pop_out, "final"))
