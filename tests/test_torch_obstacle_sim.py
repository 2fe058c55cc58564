"""Port parity for episodes with obstacles: `ClothSim(prims=...)` (plain
versions of the three kernels on the CPU) against the JAX package's
ClothSim on its Pallas pipeline (self_method="pallas",
self_friction_impl="pallas", the kernels in interpret mode), with
self-collision on, in f64, on the same scene and obstacles.

Scenes: the 7 x 7 drop of tests/test_contact.py:34-53 (a vertical 2 x 2
cloth, no attachments, h = 1/90) for 40 steps onto a static sphere, a
plane floor and a sphere moving at constant speed (kinematic, detected at
each step's time), one episode each, and the sphere drop as a batch of
three friction coefficients; then the episode gradient on the
contact-stiff scene of tests/test_gradients.py:287-344 (6 x 6, WIND_SIN,
12 steps, a sphere below the cloth).

Tolerances, with their reasons:
  * episodes: |dx| <= 1e-6 and |dv| <= 1e-5 at every step, PD iteration
    counts within 1, contact masks equal.  The self-friction sweep runs in
    f32 inside the f64 simulation in both packages (~1e-7 relative on r,
    sums in another order); P^{-1} spreads that over the cloth and v = dx/h
    scales it by 90 (tests/test_torch_sim.py).  The obstacle tests and the
    obstacle friction are f64 in both.
  * gradient against JAX: the loss within rtol 1e-6, dL/dmu and dL/dwind
    within 1e-6 of each class's largest entry: both adjoints run the same
    fixed point and GMRES fallback to 1e-8, the friction VJP in f32.
  * dL/dmu against central differences (delta 1e-6): rtol 3e-2, as
    tests/test_gradients.py:365-371 holds the JAX package on this scene
    (the adjoint differentiates with each step's contact set frozen; the
    two part by about 2 % here for every delta from 1e-4 to 1e-6).
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
from diffcloth_tpu.tasks import setup as jsetup
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.convert import (primitive_set_from_numpy,
                                         sim_params_from_numpy,
                                         sim_params_to_numpy)
from diffcloth_tpu_torch.core import diagnostics as diag
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.geometry import builder as tgb
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64
TOL = dict(x=1e-6, v=1e-5)

SPHERE = dict(kind=0, center=(0.0, -2.0, 0.0), radius=1.0, mu=0.5)
FLOOR = dict(kind=1, center=(0.0, -1.3, 0.0), normal=(0.0, 1.0, 0.0),
             ul=(-3.0, 0.0, -3.0), ur=(3.0, 0.0, -3.0), mu=0.4)
MOVING = dict(kind=0, center=(0.0, -2.0, 0.0), radius=0.8, mu=0.9,
              velocity=(0.5, 0.0, 0.0), kinematic=True)


def drop_cfg(m, steps=40):
    """tests/test_contact.py drop_scene."""
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=2.0, cloth_dim_y=2.0,
                              k_stiff_stretching=250.0,
                              k_stiff_bending=0.05, grid_num_x=7,
                              grid_num_y=7, density=0.3),
        attachment_points=m.AttachmentConfig.NO_ATTACHMENTS,
        trajectory=m.TrajectoryConfig.NO_TRAJECTORY,
        primitive_config=m.PrimitiveConfig.PLANE_AND_SPHERE,
        wind_config=m.WindConfig.NO_WIND, time_step=1.0 / 90.0,
        step_num=steps, forward_convergence_thresh=1e-9, name="drop")


def capcheck_cfg(m):
    """tests/test_gradients.py test_grad_parity_reduced_adjoint_cap_contact."""
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=2.0, cloth_dim_y=2.0,
                              k_stiff_stretching=250.0,
                              k_stiff_bending=0.05, grid_num_x=6,
                              grid_num_y=6, density=0.3),
        attachment_points=m.AttachmentConfig.NO_ATTACHMENTS,
        trajectory=m.TrajectoryConfig.NO_TRAJECTORY,
        primitive_config=m.PrimitiveConfig.PLANE_AND_SPHERE,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=12, forward_convergence_thresh=1e-11,
        backward_convergence_thresh=1e-8, name="capcheck")


def make_pair(cfg_fn, entries, **flag_kw):
    """Both packages' sims of one scene with the same primitives (the JAX
    set from its task setup's `_prim_struct`, carried across as numpy)."""
    jprims = jsetup._prim_struct(entries, jnp.float64)
    tprims = primitive_set_from_numpy(
        {k: (v if v is None else np.asarray(v))
         for k, v in jprims._asdict().items()}, F64, "cpu")
    jflags = jc.SimFlags(**flag_kw)
    jsim = JaxSim(jgb.build_scene(cfg_fn(jc)), dtype=jnp.float64,
                  prims=jprims, flags=jflags, self_method="pallas",
                  self_friction_impl="pallas")
    tsim = TorchSim(tgb.build_scene(cfg_fn(tc)), device="cpu", dtype=F64,
                    prims=tprims, flags=tc.SimFlags(**flag_kw))
    assert jsim.self_cfg is not None and tsim.self_cfg is not None
    return jsim, tsim


def to_torch(jparams):
    return sim_params_from_numpy(
        {k: np.asarray(v) for k, v in jparams._asdict().items()}, "cpu", F64)


def assert_episodes_match(jsteps, tsteps):
    """jsteps: a list of per-episode JAX records or one record; tsteps the
    port's records with the same leading dims."""
    stack = (lambda name: np.stack([np.asarray(getattr(s, name))
                                    for s in jsteps])) \
        if isinstance(jsteps, list) else \
        (lambda name: np.asarray(getattr(jsteps, name)))
    tx, tv = tsteps.x.numpy(), tsteps.v.numpy()
    assert np.isfinite(tx).all() and tx.shape == stack("x").shape
    np.testing.assert_allclose(tx, stack("x"), rtol=0, atol=TOL["x"])
    np.testing.assert_allclose(tv, stack("v"), rtol=0, atol=TOL["v"])
    d_it = np.abs(tsteps.iters.numpy().astype(np.int64)
                  - stack("iters").astype(np.int64))
    assert d_it.max() <= 1, d_it
    np.testing.assert_array_equal(tsteps.converged.numpy(),
                                  stack("converged"))
    np.testing.assert_array_equal(tsteps.selfcol_overflow.numpy(),
                                  stack("selfcol_overflow"))


@pytest.mark.parametrize("obstacle,kind", [
    ("sphere", [SPHERE]), ("floor", [FLOOR]), ("moving", [MOVING])],
    ids=["sphere", "floor", "moving"])
def test_episode_with_obstacle_matches_pallas_pipeline(obstacle, kind):
    jsim, tsim = make_pair(drop_cfg, kind, gradient_clipping=False)
    jp = jsim.default_params()
    jr = jsim.rollout(jp)
    tp = to_torch(jp)
    assert torch.equal(tsim.default_params().mu, tp.mu)
    tr = tsim.rollout(tp)
    assert_episodes_match(jr.steps, tr.steps)
    np.testing.assert_allclose(tr.steps.r.numpy(), np.asarray(jr.steps.r),
                               rtol=0, atol=1e-6)
    contacts = tr.steps.obstacle_contacts.numpy()
    # the cloth reaches the obstacle and stays on it
    assert contacts[-10:].min() > 0, contacts
    assert np.abs(tr.steps.r.numpy()).max() > 0
    if obstacle == "moving":
        # the moving pose matters: the static sphere gives another episode
        static = dict(MOVING, kinematic=False, velocity=(0.0, 0.0, 0.0))
        _, tsim_s = make_pair(drop_cfg, [static], gradient_clipping=False)
        xs = tsim_s.rollout(tp).steps.x
        assert float((xs[-1] - tr.steps.x[-1]).abs().max()) > 1e-3


def test_batched_friction_coefficients_match_per_episode_jax():
    """A batch of three mu on the sphere drop against three JAX episodes."""
    jsim, tsim = make_pair(drop_cfg, [SPHERE], gradient_clipping=False)
    base = jsim.default_params()
    mus = (0.05, 0.4, 0.9)
    jrs = [jsim.rollout(base._replace(mu=jnp.asarray([mu]))).steps
           for mu in mus]
    tp = to_torch(base).expand(3).replace(
        mu=torch.tensor([[mu] for mu in mus], dtype=F64))
    tr = tsim.rollout(tp)
    assert_episodes_match(jrs, tr.steps)
    # the coefficient moves the episodes apart
    x_last = tr.steps.x[:, -1]
    assert float((x_last[0] - x_last[2]).abs().max()) > 1e-4


@pytest.fixture(scope="module")
def capcheck():
    flags = dict(wind_enabled=True, gradient_clipping=False)
    jsim, tsim = make_pair(capcheck_cfg, [dict(
        kind=0, center=(0.0, -1.6, 0.0), radius=1.0, mu=0.5)], **flags)
    p0 = jsim.default_params()._replace(wind=jnp.array([0.3, 0.0, 0.2]))
    target = np.asarray(jsim.rollout(
        p0._replace(wind=jnp.array([0.45, 0.05, 0.25]))).full_x())
    lf_t = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                           tl.LossInfo(target_x=torch.as_tensor(
                               np.array(target))))
    return jsim, tsim, p0, to_torch(p0), target, lf_t


def test_episode_gradient_matches_jax_with_obstacle(capcheck):
    jsim, tsim, p0, tp0, target, lf_t = capcheck
    lf_j = jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                           jl.LossInfo(target_x=jnp.asarray(target)))
    L_j, g_j = jsim.episode_value_and_grad(lf_j)(p0)
    L_t, g_t = tsim.episode_value_and_grad(lf_t)(tp0)
    steps = tsim.rollout(tp0).steps
    assert steps.converged.all()
    assert int(steps.obstacle_contacts[-1]) > 0, "no contact at the end"
    np.testing.assert_allclose(float(L_t), float(L_j), rtol=1e-6)
    gt = sim_params_to_numpy(g_t)
    for name in ("mu", "wind"):
        a, b = gt[name], np.asarray(getattr(g_j, name))
        assert np.abs(b).max() > 0, name
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), \
            (name, a, b)


def test_mu_gradient_matches_central_differences(capcheck):
    """rtol 3e-2, as tests/test_gradients.py:365-371 holds the JAX package
    on this scene: the adjoint and central differences part by about 2 %
    here for every delta from 1e-4 to 1e-6, in both packages alike."""
    _, tsim, _, tp0, _, lf_t = capcheck
    _, g = tsim.episode_value_and_grad(lf_t)(tp0)
    fd = diag.finite_difference_gradients(tsim.episode_loss(lf_t), tp0,
                                          fields=("mu",))
    assert np.isfinite(fd["mu"]).all() and abs(fd["mu"][0]) > 0
    np.testing.assert_allclose(g.mu.numpy(), fd["mu"], rtol=3e-2,
                               atol=1e-12)
