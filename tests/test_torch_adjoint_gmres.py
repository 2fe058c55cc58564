"""Port parity for the GMRES adjoint (`SimFlags(adjoint_mode="gmres")`,
diffcloth_tpu/core/step.py:704-757): restarted preconditioned GMRES as
the primary solver of every step's adjoint, against the JAX package's on
its Pallas pipeline (kernels in interpret mode), in f64, on the folded
8 x 8 scene of tests/test_torch_step_bwd.py and on the same grid flat.

Tolerances, with their reasons: every cotangent class within 1e-8 of its
largest entry where no self-contact enters (all f64; both packages run
the same cycles from the same start and judge them by the same true
residual); within 1e-6 where it does, as the fixed point's parity tests:
the friction sweep is f32 inside the f64 simulation in both packages, its
sums in another order (measured 6e-8 on the folded step).  A batch whose
episodes stop after different numbers of cycles equals the same episodes
run one at a time within rtol 1e-9 (the same arithmetic; a batch only
widens the dense products).
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
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.core.types import SimParams
from diffcloth_tpu_torch.geometry import builder as tgb
from diffcloth_tpu_torch.geometry import states
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64
GRID = 8
STEPS = 3
WIND = np.array([0.5, 0.05, 0.5])
TOL = {"flat": 1e-8, "folded": 1e-6}


def scene_cfg(m):
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                              k_stiff_stretching=550, k_stiff_bending=0.01,
                              grid_num_x=GRID, grid_num_y=GRID,
                              density=0.124),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=STEPS, forward_convergence_thresh=1e-11,
        backward_convergence_thresh=1e-8, name="gmres_step")


@pytest.fixture(scope="module")
def sims():
    jscene = jgb.build_scene(scene_cfg(jc))
    tscene = tgb.build_scene(scene_cfg(tc))
    folded = states.folded_grid(tscene, GRID // 2,
                                1.5 * float(tscene.radii.mean()))
    jsim = JaxSim(jscene, dtype=jnp.float64, self_method="pallas",
                  self_friction_impl="pallas",
                  flags=jc.SimFlags(wind_enabled=True, adjoint_mode="gmres"))
    tsim = TorchSim(tscene, device="cpu", dtype=F64,
                    flags=tc.SimFlags(wind_enabled=True,
                                      adjoint_mode="gmres"))
    starts = {"flat": tscene.x_rest, "folded": folded}
    return jsim, tsim, starts


def to_port(jp, batch=None):
    arrays = {k: np.asarray(v) for k, v in jp._asdict().items()}
    if batch is not None:
        arrays = {k: np.stack([a] * batch) for k, a in arrays.items()}
    return sim_params_from_numpy(arrays, "cpu", F64)


def assert_classes_close(got, ref, tol):
    for name, b in ref.items():
        a = np.asarray(got[name])
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1e-300)
        assert np.abs(a - b).max() <= tol * scale, (
            name, np.abs(a - b).max(), scale)


@pytest.mark.parametrize("start", ["flat", "folded"])
def test_gmres_step_vjp_matches_jax(sims, start):
    jsim, tsim, starts = sims
    n, h = tsim.n, tsim.h
    jp = jsim.default_params()._replace(x0=jnp.asarray(starts[start]),
                                        wind=jnp.asarray(WIND))
    rec = jsim.rollout(jp)
    x1, v1 = np.asarray(rec.steps.x[0]), np.asarray(rec.steps.v[0])
    rng = np.random.RandomState(11)
    x_bar, v_bar = rng.randn(n, 3) * 0.5, rng.randn(n, 3) * 0.5
    p_inv = jsim.p_inv(jp)
    xf = jsim.x_fixed_seq(jp)[1]

    def jstep(x, v, params, x_fixed):
        x2, v2, _ = jsim.step(x, v, params, x_fixed, p_inv,
                              jnp.asarray(2.0 * h), jnp.asarray(2.0))
        return x2, v2

    _, vjp = jax.vjp(jstep, jnp.asarray(x1), jnp.asarray(v1), jp, xf)
    gj = vjp((jnp.asarray(x_bar), jnp.asarray(v_bar)))

    leaves = {k: v.requires_grad_(True) for k, v in to_port(jp, 1).items()}
    xs = torch.tensor(x1[None], requires_grad=True)
    vs = torch.tensor(v1[None], requires_grad=True)
    xft = torch.tensor(np.asarray(xf)[None], requires_grad=True)
    x2, v2, aux = tsim.step(xs, vs, SimParams(**leaves), xft,
                            tsim.p_inv(SimParams(**leaves)),
                            torch.tensor(2.0 * h, dtype=F64), 2)
    assert (int(aux.selfcol_pairs[0]) > 0) == (start == "folded")
    tsim.bwd_stats.reset()
    gt = torch.autograd.grad(
        (x2, v2), [xs, vs, xft] + list(leaves.values()),
        (torch.tensor(x_bar[None]), torch.tensor(v_bar[None])),
        allow_unused=True)
    st = tsim.bwd_stats.summary()
    assert st["trips"] == 0 and st["gmres_cycles"] >= 1, st
    assert st["launches"] == st["gmres_matvecs"] + 1, st
    names = ["x", "v", "x_fixed"] + list(leaves)
    got = {k: np.zeros_like(np.asarray(r)) if g is None else g[0].numpy()
           for k, g, r in zip(names, gt, list(gj[:2]) + [gj[3]] + [
               getattr(gj[2], k) for k in leaves])}
    ref = {"x": gj[0], "v": gj[1], "x_fixed": gj[3]}
    ref.update({k: getattr(gj[2], k) for k in leaves})
    assert_classes_close(got, ref, TOL[start])
    for name in ("x", "v", "x_fixed", "k_pertype", "density", "wind"):
        assert np.abs(np.asarray(ref[name])).max() > 0, name


def test_gmres_episode_gradient_matches_jax(sims):
    """A batch of two episodes (folded, flat) through the port's
    episode_value_and_grad against the JAX package's, one episode at a
    time, MATCH_TRAJECTORY against the rollout of another wind."""
    jsim, tsim, starts = sims
    base = jsim.default_params()
    ps, targets = [], []
    for start in ("folded", "flat"):
        p = base._replace(x0=jnp.asarray(starts[start]))
        targets.append(np.asarray(jsim.rollout(
            p._replace(wind=jnp.asarray(WIND))).full_x()))
        ps.append(p._replace(wind=jnp.asarray([0.3, 0.1, 0.6]),
                             wind_freq=jnp.asarray(12.0),
                             wind_phase=jnp.asarray(0.2)))
    tp = sim_params_from_numpy(
        {k: np.stack([np.asarray(getattr(p, k)) for p in ps])
         for k in ps[0]._fields}, "cpu", F64)
    lf_t = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY, tl.LossInfo(
        target_x=torch.as_tensor(np.stack(targets))))
    L_t, g_t = tsim.episode_value_and_grad(lf_t)(tp)
    g_t = sim_params_to_numpy(g_t)
    for b, (start, p, target) in enumerate(zip(("folded", "flat"), ps,
                                               targets)):
        lf_j = jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                               jl.LossInfo(target_x=jnp.asarray(target)))
        L_j, g_j = jsim.episode_value_and_grad(lf_j)(p)
        np.testing.assert_allclose(float(L_t[b]), float(L_j),
                                   rtol=TOL[start])
        assert_classes_close({k: v[b] for k, v in g_t.items()},
                             g_j._asdict(), TOL[start])
        assert np.abs(np.asarray(g_j.wind)).max() > 0


def test_gmres_batch_equals_episodes(sims):
    """Three episodes whose adjoints stop after different numbers of
    GMRES cycles (GMRES(4) to 1e-10: 15, 15 and 13 cycles over the three
    steps): the batched gradient equals the per-episode ones (a finished
    episode's iterate is frozen while the others go on)."""
    _, sim, starts = sims
    tsim = TorchSim(sim.scene_host, device="cpu", dtype=F64,
                    flags=tc.SimFlags(wind_enabled=True, adjoint_mode="gmres",
                                      adjoint_gmres_m=4),
                    eps_backward=1e-10)
    winds = np.array([[0.5, 0.05, 0.5], [0.2, 0.0, 0.4], [0.9, 0.3, 0.1]])
    x0 = np.stack([starts["folded"], starts["flat"], starts["folded"]])
    base = tsim.default_params().expand(3).replace(
        x0=torch.as_tensor(x0), wind=torch.as_tensor(winds))
    lf = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY, tl.LossInfo(
        target_x=tsim.rollout(base.replace(
            wind=torch.as_tensor(winds * 0.5))).full_x()))
    L, g = tsim.episode_value_and_grad(lf)(base)
    cycles = []
    for b in range(3):
        one = base.sample(b).as_batched()
        lf_one = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY, tl.LossInfo(
            target_x=tsim.rollout(one.replace(
                wind=one.wind * 0.5)).full_x()))
        tsim.bwd_stats.reset()
        L_b, g_b = tsim.episode_value_and_grad(lf_one)(one)
        cycles.append(tsim.bwd_stats.summary()["lane_trips"])
        np.testing.assert_allclose(L[b].item(), L_b[0].item(), rtol=1e-9)
        for k, v in g_b.items():
            np.testing.assert_allclose(
                getattr(g, k)[b].numpy(), v[0].numpy(), rtol=1e-9,
                atol=1e-9 * max(float(v.abs().max()), 1e-300), err_msg=k)
    assert len(set(cycles)) > 1, cycles


@pytest.fixture(scope="module")
def bend_check(sims):
    """The folded 8 x 8 scene over 5 steps, the forward to 1e-10, the
    MATCH_TRAJECTORY loss against the rollout of WIND evaluated at 0.7 of
    it, and the central difference of dL/dk_bend (step 1e-4)."""
    _, sim, starts = sims
    scene = sim.scene_host
    t = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    base = TorchSim(scene, device="cpu", dtype=F64, eps_forward=1e-10,
                    flags=tc.SimFlags(wind_enabled=True))
    p = base.default_params().replace(
        wind=t(WIND), wind_freq=t(10.0), wind_phase=t(0.5),
        x0=t(starts["folded"]))
    lf = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                         tl.LossInfo(target_x=base.rollout(p).full_x()))
    p = p.replace(wind=p.wind * 0.7)
    loss_of = base.episode_loss(lf)
    h = 1e-4
    k_up, k_dn = p.k_pertype.clone(), p.k_pertype.clone()
    k_up[tc.C_BEND] += h
    k_dn[tc.C_BEND] -= h
    fd = (float(loss_of(p.replace(k_pertype=k_up)))
          - float(loss_of(p.replace(k_pertype=k_dn)))) / (2 * h)
    return scene, p, lf, fd


@pytest.mark.parametrize("mode", ["fp", "gmres"])
def test_bend_gradient_matches_central_differences(bend_check, mode):
    """dL/dk_bend with the adjoint run to 1e-10 (400 trips or matvecs)
    agrees with central differences within 0.2 % in both modes (measured
    0.06 %; at the scene's 5e-4 the same gradient is 30-48 % off: the
    adjoint's absolute tolerance is loose for this loss's cotangents, see
    apps/adjoint_check.py)."""
    scene, p, lf, fd = bend_check
    sim = TorchSim(scene, device="cpu", dtype=F64, eps_forward=1e-10,
                   eps_backward=1e-10,
                   flags=tc.SimFlags(wind_enabled=True, adjoint_mode=mode,
                                     max_backward_iters=400))
    _, g = sim.episode_value_and_grad(lf)(p)
    assert int(sim.rollout(p).steps.selfcol_pairs.min()) > 0
    np.testing.assert_allclose(float(g.k_pertype[tc.C_BEND]), fd, rtol=2e-3)
