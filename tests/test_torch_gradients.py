"""Port parity for the episode gradient: `ClothSim.episode_value_and_grad`
(the implicit adjoint of every step, plain versions of the three kernels on
the CPU) against the JAX package's episode gradient on its Pallas pipeline
(kernels in interpret mode), and against central differences, mirroring
tests/test_gradients.py:22-91,227-285.

Scenes: the flagship stand-in's physics on an 8 x 8 grid started folded
half over half (self-contact in its steps), and the 4 x 4 no-contact
gradient-check scene of test_gradients.py, both in f64 with the forward
converged to 1e-11 and the adjoint to 1e-8.

Tolerances, with their reasons:
  * against JAX f64: the loss within rtol 1e-6 (the trajectories differ
    by about 1e-10 against |x - target| of about 1e-3), every parameter
    class within 1e-6 of its largest entry.  Both adjoints run the same
    fixed point and GMRES fallback to 1e-8; the friction sweep is f32
    inside the f64 simulation in both, its sums in another order (about
    1e-7 relative).
  * against central differences on the wind (delta 1e-6): rtol 2e-3
    without contact and 3e-2 with it, as in test_gradients.py (a bump moves
    the frozen per-step contact set, a discrete sensitivity the adjoint does
    not represent).
  * the forced GMRES fallback (cap 1, eps 1e-16) against the default
    adjoint: rtol 1e-4 on the wind, and 2e-3 against central differences.
  * batched against per-episode calls: rtol 1e-9 (the same arithmetic; a
    batch only widens the dense products' columns).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu import losses as jl
from diffcloth_tpu.core.sim import ClothSim as JaxSim
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.convert import (sim_params_from_numpy,
                                         sim_params_to_numpy)
from diffcloth_tpu_torch.core import diagnostics as diag
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.geometry import builder as tgb
from diffcloth_tpu_torch.geometry import states
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64
GRID = 8
STEPS = 6


def folded_cfg(m):
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                              k_stiff_stretching=550, k_stiff_bending=0.01,
                              grid_num_x=GRID, grid_num_y=GRID,
                              density=0.124),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=STEPS, forward_convergence_thresh=1e-11,
        backward_convergence_thresh=1e-8, name="folded_grad")


def gradcheck_cfg(eps_backward=1e-8):
    """test_gradients.py make_sim's scene (no contact in its 6 steps)."""
    return tc.SceneConfig(
        fabric=tc.FabricConfig(cloth_dim_x=1.5, cloth_dim_y=1.5,
                               k_stiff_stretching=300.0,
                               k_stiff_bending=0.08, grid_num_x=4,
                               grid_num_y=4, density=0.3),
        attachment_points=tc.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=tc.WindConfig.WIND_SIN, time_step=1.0 / 60.0,
        step_num=6, forward_convergence_thresh=1e-11,
        backward_convergence_thresh=eps_backward, name="gradcheck")


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def match_traj(target_x):
    return tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                           tl.LossInfo(target_x=target_x))


@pytest.fixture(scope="module")
def folded():
    jscene = jgb.build_scene(folded_cfg(jc))
    tscene = tgb.build_scene(folded_cfg(tc))
    x0 = states.folded_grid(tscene, GRID // 2,
                            1.5 * float(tscene.radii.mean()))
    jsim = JaxSim(jscene, dtype=jnp.float64, self_method="pallas",
                  self_friction_impl="pallas")
    tsim = TorchSim(tscene, device="cpu", dtype=F64)
    base = jsim.default_params()._replace(x0=jnp.asarray(x0))
    target = np.array(jsim.rollout(
        base._replace(wind=jnp.asarray([0.5, 0.05, 0.5]))).full_x())
    p0 = base._replace(wind=jnp.asarray([0.3, 0.1, 0.6]),
                       wind_freq=jnp.asarray(12.0),
                       wind_phase=jnp.asarray(0.2))
    tp0 = sim_params_from_numpy(
        {k: np.asarray(v) for k, v in p0._asdict().items()}, "cpu", F64)
    return jsim, tsim, p0, tp0, target


def test_episode_gradients_match_jax_with_contact(folded):
    jsim, tsim, p0, tp0, target = folded
    lf_j = jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                           jl.LossInfo(target_x=jnp.asarray(target)))
    L_j, g_j = jsim.episode_value_and_grad(lf_j)(p0)
    L_t, g_t = tsim.episode_value_and_grad(match_traj(target))(tp0)
    pairs = tsim.rollout(tp0).steps.selfcol_pairs
    assert int(pairs.min()) > 0, "a step lacks self-contact"
    np.testing.assert_allclose(float(L_t), float(L_j), rtol=1e-6)
    for name, a in sim_params_to_numpy(g_t).items():
        b = np.asarray(getattr(g_j, name))
        assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1e-300), \
            (name, np.abs(a - b).max(), np.abs(b).max())
    for name in ("wind", "wind_freq", "wind_phase", "k_pertype", "density",
                 "x0", "v0"):
        assert np.abs(np.asarray(getattr(g_j, name))).max() > 0, name


def central_wind(loss_of, params, delta=1e-6):
    out = []
    for i in range(3):
        def bump(s):
            w = params.wind.clone()
            w[i] += s * delta
            return params.replace(wind=w)
        out.append((float(loss_of(bump(1))) - float(loss_of(bump(-1))))
                   / (2 * delta))
    return np.array(out)


def test_wind_gradient_matches_central_differences_with_contact(folded):
    _, tsim, _, tp0, target = folded
    lf = match_traj(target)
    _, g = tsim.episode_value_and_grad(lf)(tp0)
    fd = central_wind(tsim.episode_loss(lf), tp0)
    np.testing.assert_allclose(g.wind.numpy(), fd, rtol=3e-2, atol=1e-9)


@pytest.fixture(scope="module")
def gradcheck():
    flags = tc.SimFlags(wind_enabled=True, gradient_clipping=False)
    sim = TorchSim(tgb.build_scene(gradcheck_cfg()), device="cpu",
                   dtype=F64, flags=flags)
    p_gt = sim.default_params().replace(
        wind=t64([0.4, 0.1, 0.3]), wind_freq=t64(10.0), wind_phase=t64(0.5))
    lf = match_traj(sim.rollout(p_gt).full_x())
    p0 = sim.default_params().replace(
        wind=t64([0.25, 0.05, 0.2]), wind_freq=t64(12.0),
        wind_phase=t64(0.1))
    return sim, lf, p0


def test_gradients_match_finite_differences(gradcheck):
    sim, lf, p0 = gradcheck
    _, g = sim.episode_value_and_grad(lf)(p0)
    loss_of = sim.episode_loss(lf)
    fd = diag.finite_difference_gradients(loss_of, p0, fields=("wind",))
    fd.update(diag.finite_difference_gradients(
        loss_of, p0, fields=("x0", "v0"), max_entries_per_field=1))
    for name, g_fd in fd.items():
        probe = np.isfinite(g_fd)
        assert probe.sum() == (3 if name == "wind" else 1)
        np.testing.assert_allclose(
            getattr(g, name).numpy()[probe], g_fd[probe],
            rtol=2e-3 if name == "wind" else 5e-3,
            atol=1e-7 * np.abs(g_fd[probe]).max(), err_msg=name)


def test_forced_gmres_fallback_gradient(gradcheck):
    """The fixed point capped at one trip with an unreachable tolerance, so
    the GMRES fallback produces every step's adjoint (test_gradients.py
    :227-285)."""
    sim, lf, p0 = gradcheck
    flags = tc.SimFlags(wind_enabled=True, gradient_clipping=False,
                        max_backward_iters=1)
    sim_fb = TorchSim(tgb.build_scene(gradcheck_cfg(eps_backward=1e-16)),
                      device="cpu", dtype=F64, flags=flags)
    L_ok, g_ok = sim.episode_value_and_grad(lf)(p0)
    sim_fb.bwd_stats.reset()
    L_fb, g_fb = sim_fb.episode_value_and_grad(lf)(p0)
    st = sim_fb.bwd_stats.summary()
    assert st["trips"] == 0 and st["fallback_lanes"] == sim.n_steps, st
    np.testing.assert_allclose(float(L_fb), float(L_ok), rtol=1e-10)
    np.testing.assert_allclose(g_fb.wind.numpy(), g_ok.wind.numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(g_fb.wind.numpy(), central_wind(
        sim_fb.episode_loss(lf), p0), rtol=2e-3, atol=1e-10)


def test_batched_equals_per_episode_and_exploded_lane_is_zero(folded):
    """Three episodes in one batch: folded, flat with another wind, and one
    whose runaway wind explodes it at step 1.  The first two equal their
    single calls; the exploded one is frozen at x0, so its loss is finite,
    its x0 gradient is the loss's own, and every other gradient is zero."""
    _, tsim, _, tp0, target = folded
    lf = match_traj(target)
    vg = tsim.episode_value_and_grad(lf)
    flat = tp0.replace(x0=tsim.scene_dev.x_rest.clone(),
                       wind=t64([0.2, 0.0, 0.4]))
    boom = tp0.replace(wind=t64([1e30, 0.0, 1e30]))
    singles = [tp0, flat, boom]
    batch = tp0.expand(3)
    batch = batch.replace(**{k: torch.stack([getattr(p, k) for p in singles])
                             for k, _ in batch.items()})
    L_b, g_b = vg(batch)
    for i, p in enumerate(singles[:2]):
        L_i, g_i = vg(p)
        np.testing.assert_allclose(float(L_b[i]), float(L_i), rtol=1e-12)
        for name, a in g_i.items():
            np.testing.assert_allclose(getattr(g_b, name)[i].numpy(),
                                       a.numpy(), rtol=1e-9, atol=1e-15,
                                       err_msg=name)
    assert bool(torch.isfinite(L_b).all())
    for name, g in g_b.items():
        assert bool(torch.isfinite(g).all()), name
        if name != "x0":
            assert not g[2].any(), name
    # the frozen episode's frames are all x0: its loss gradient by hand
    tgt = t64(target)
    N1, n = tgt.shape[0], tgt.shape[1]
    g_x0 = 2.0 * (boom.x0[None] - tgt).sum(0) / (N1 * n)
    torch.testing.assert_close(g_b.x0[2], g_x0, rtol=1e-12, atol=1e-15)
