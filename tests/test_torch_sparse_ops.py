"""Port parity for the scatter-free sparse operators (large-mesh path):
`diffcloth_tpu_torch.core.sparse_ops` against the JAX package's
`core/sparse_ops.py`, operator by operator, and `ClothSim(dense_ops=False,
sparse_ops=True)` against the JAX ClothSim with the same flags, forward and
gradient, single and batched; mirrors tests/test_sparse_ops.py.

Scenes: test_sparse_ops.py's 5 x 5 grid for the operators, and the flagship
stand-in's physics on an 8 x 8 grid started folded half over half (its
steps have self-contact) for the episodes, f64.

Tolerances, with their reasons:
  * operators and projections: 1e-12 absolute (f64, the same products
    summed in another order; the JAX package's own test holds its operators
    to 1e-13 .. 1e-10);
  * the operators' VJPs against the transposes: 1e-12;
  * episodes against JAX: |dx| <= 1e-6, |dv| <= 1e-5, iteration counts
    within 1, as tests/test_torch_sim.py (the f32 friction sweep inside
    the f64 simulation, its sums in another order, spread by P^{-1});
  * the episode gradient against JAX: the loss within rtol 1e-6 and every
    parameter class within 1e-6 of its largest entry, as
    tests/test_torch_gradients.py;
  * the sparse path against the port's dense path: |dx| <= 1e-9 (f64; the
    JAX package's test_rollout_matches_dense bound);
  * batched against per-episode: rtol 1e-9 (the same arithmetic; a batch
    only widens the gathers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu import losses as jl
from diffcloth_tpu.core import sparse_ops as jspo
from diffcloth_tpu.core.sim import ClothSim as JaxSim
from diffcloth_tpu.core.sim import scene_to_device as j_scene_to_device
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.convert import (sim_params_from_numpy,
                                         sim_params_to_numpy)
from diffcloth_tpu_torch.core import sparse_ops as tspo
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.core.sim import scene_to_device as t_scene_to_device
from diffcloth_tpu_torch.geometry import builder as tgb
from diffcloth_tpu_torch.geometry import states
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64
K = np.array([2.0, 1e4, 300.0, 0.08])


def ops_cfg(m):
    """test_sparse_ops.py make_scene (5 x 5 grid)."""
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=1.5, cloth_dim_y=1.5,
                              k_stiff_stretching=300.0, k_stiff_bending=0.08,
                              grid_num_x=5, grid_num_y=5, density=0.3),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        trajectory=m.TrajectoryConfig.NO_TRAJECTORY,
        primitive_config=m.PrimitiveConfig.NONE,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 60.0, step_num=8,
        forward_convergence_thresh=1e-11,
        backward_convergence_thresh=1e-8, name="sparse-test")


@pytest.fixture(scope="module")
def ops():
    js = jgb.build_scene(ops_cfg(jc))
    ts = tgb.build_scene(ops_cfg(tc))
    jsp = jspo.build_sparse_ops(js, js.stages[0], dtype=jnp.float64)
    tsp = tspo.build_sparse_ops(ts, ts.stages[0], dtype=F64, device="cpu")
    rng = np.random.RandomState(0)
    xs = ts.x_rest[None] + 0.05 * rng.randn(3, ts.n, 3)
    return js, ts, jsp, tsp, xs


def test_incidence_matches_jax(ops):
    js, ts, jsp, tsp, _ = ops
    for rows in (tgb.stretch_rows(ts.triangle), tgb.bend_rows(ts.bending)):
        flat = rows.idx.reshape(-1)
        ji, jw = jspo.build_incidence(flat, rows.w.reshape(-1), ts.n)
        ti, tw = tspo.build_incidence(flat, rows.w.reshape(-1), ts.n)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tw, jw)
    assert tsp.n_rows == jsp.n_rows


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_apply_A_At_AtA_match_jax(ops, batched):
    js, ts, jsp, tsp, xs = ops
    rng = np.random.RandomState(1)
    k = np.stack([K, K * 1.3, K * 0.7]) if batched else K
    for b in range(3):
        x = xs[b]
        ys = jspo.apply_A(jsp, jnp.asarray(x))
        ds = [rng.randn(*y.shape) for y in ys]
        want_At = jspo.apply_At(jsp, jnp.asarray(k[b] if batched else k),
                                *map(jnp.asarray, ds))
        want_AtA = jspo.apply_AtA(jsp, jnp.asarray(k[b] if batched else k),
                                  jnp.asarray(x))
        if batched:
            xt = torch.as_tensor(xs)
            got_y = tspo.apply_A(tsp, xt)
            dt = [torch.as_tensor(np.stack([d] * 3)) for d in ds]
            got_At = tspo.apply_At(tsp, torch.as_tensor(k), *dt)[b]
            got_AtA = tspo.apply_AtA(tsp, torch.as_tensor(k), xt)[b]
            got_y = [y[b] for y in got_y]
        else:
            got_y = tspo.apply_A(tsp, torch.as_tensor(x))
            got_At = tspo.apply_At(tsp, torch.as_tensor(k),
                                   *map(torch.as_tensor, ds))
            got_AtA = tspo.apply_AtA(tsp, torch.as_tensor(k),
                                     torch.as_tensor(x))
        for got, want in zip(got_y, ys):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-12)
        np.testing.assert_allclose(got_At.numpy(), np.asarray(want_At),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(got_AtA.numpy(), np.asarray(want_AtA),
                                   rtol=0, atol=1e-12)


def test_projections_match_jax(ops):
    js, ts, jsp, tsp, xs = ops
    jsd = j_scene_to_device(js, jnp.float64)
    tsd = t_scene_to_device(ts, F64, "cpu")
    xf = np.random.RandomState(2).randn(2, 3)
    got = tspo.projections(tsp, tsd, torch.as_tensor(xs),
                           torch.as_tensor(np.stack([xf] * 3)))
    for b in range(3):
        want = jspo.projections(jsp, jsd, jnp.asarray(xs[b]),
                                jnp.asarray(xf))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=0,
                                       atol=1e-12)


def test_operator_vjps_are_transposes(ops):
    """A's backward is A^T and A^T's is A, as the JAX package registers
    them; the vertex gathers' backward is the unit-weight incidence, equal
    to JAX's (no autograd index_add_ anywhere)."""
    js, ts, jsp, tsp, xs = ops
    rng = np.random.RandomState(3)
    x = torch.as_tensor(xs[:2]).requires_grad_(True)
    for op in (tsp.s, tsp.b, tsp.a):
        d = torch.as_tensor(rng.randn(2, op.rows, 3))
        lhs = torch.sum(op.A(x) * d)
        rhs = torch.sum(x * op.At(d))
        np.testing.assert_allclose(float(lhs.detach()), float(rhs.detach()),
                                   rtol=1e-12)
        g, = torch.autograd.grad(op.A(x), x, d)
        np.testing.assert_allclose(g.numpy(), op.At(d).detach().numpy(),
                                   rtol=0, atol=1e-12)
        dd = d.clone().requires_grad_(True)
        u = torch.as_tensor(rng.randn(2, ts.n, 3))
        g2, = torch.autograd.grad(op.At(dd), dd, u)
        np.testing.assert_allclose(g2.numpy(), op.A(u).numpy(), rtol=0,
                                   atol=1e-12)
    for jg, tg, idx in ((jsp.gather_tri, tsp.gather_tri, ts.triangle.idx),
                        (jsp.gather_bend, tsp.gather_bend, ts.bending.idx)):
        cot = rng.randn(*idx.shape, 3)
        _, vjp = jax.vjp(jg, jnp.asarray(xs[0]))
        want = np.asarray(vjp(jnp.asarray(cot))[0])
        x0 = torch.as_tensor(xs[0]).requires_grad_(True)
        out = tg(x0)
        np.testing.assert_array_equal(out.detach().numpy(), xs[0][idx])
        got, = torch.autograd.grad(out, x0, torch.as_tensor(cot))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# episodes on the sparse path

GRID = 8
STEPS = 5


def folded_cfg(m):
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                              k_stiff_stretching=550, k_stiff_bending=0.01,
                              grid_num_x=GRID, grid_num_y=GRID,
                              density=0.124),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=STEPS, forward_convergence_thresh=1e-11,
        backward_convergence_thresh=1e-8, name="folded_sparse")


WINDS = np.array([[0.5, 0.05, 0.5], [0.2, 0.0, 0.4]])


@pytest.fixture(scope="module")
def sims():
    jscene = jgb.build_scene(folded_cfg(jc))
    tscene = tgb.build_scene(folded_cfg(tc))
    x0 = states.folded_grid(tscene, GRID // 2,
                            1.5 * float(tscene.radii.mean()))
    jsim = JaxSim(jscene, dtype=jnp.float64, self_method="pallas",
                  self_friction_impl="pallas", dense_ops=False,
                  sparse_ops=True)
    tsim = TorchSim(tscene, device="cpu", dtype=F64, dense_ops=False,
                    sparse_ops=True)
    assert jsim.sparse is not None and jsim.dense is None
    assert tsim.sparse is not None and tsim.dense is None
    base = jsim.default_params()._replace(x0=jnp.asarray(x0))
    return jsim, tsim, base, tscene


def to_torch(jparams):
    return sim_params_from_numpy(
        {k: np.asarray(v) for k, v in jparams._asdict().items()}, "cpu", F64)


def batch_of(jparams, winds):
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (len(winds),) + a.shape),
                      jparams)
    return pb._replace(wind=jnp.asarray(winds))


def test_sparse_rollout_matches_jax_and_dense(sims):
    jsim, tsim, base, tscene = sims
    jp = batch_of(base, WINDS)
    tr = tsim.rollout(to_torch(jp)).steps
    assert int(tr.selfcol_pairs.sum()) > 0, "no self-contact"
    assert not tr.selfcol_overflow.any() and tr.converged.all()
    for b in range(len(WINDS)):
        jr = jsim.rollout(jax.tree.map(lambda a: a[b], jp)).steps
        np.testing.assert_allclose(tr.x[b].numpy(), np.asarray(jr.x),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tr.v[b].numpy(), np.asarray(jr.v),
                                   rtol=0, atol=1e-5)
        d_it = np.abs(tr.iters[b].numpy() - np.asarray(jr.iters))
        assert d_it.max() <= 1, d_it
    dense = TorchSim(tscene, device="cpu", dtype=F64).rollout(
        to_torch(jp)).steps
    np.testing.assert_allclose(tr.x.numpy(), dense.x.numpy(), rtol=0,
                               atol=1e-9)
    # batched equals per-episode
    one = tsim.rollout(to_torch(jax.tree.map(lambda a: a[1], jp))).steps
    np.testing.assert_allclose(one.x.numpy(), tr.x[1].numpy(), rtol=1e-9,
                               atol=0)


def test_sparse_episode_gradient_matches_jax(sims):
    jsim, tsim, base, _ = sims
    target = np.array(jsim.rollout(
        base._replace(wind=jnp.asarray(WINDS[0]))).full_x())
    p0 = base._replace(wind=jnp.asarray([0.3, 0.1, 0.6]),
                       wind_freq=jnp.asarray(12.0),
                       wind_phase=jnp.asarray(0.2))
    lf_j = jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                           jl.LossInfo(target_x=jnp.asarray(target)))
    Lj, gj = jsim.episode_value_and_grad(lf_j)(p0)
    lf_t = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                           tl.LossInfo(target_x=torch.as_tensor(target)))
    vg = tsim.episode_value_and_grad(lf_t)
    Lt, gt = vg(to_torch(p0))
    np.testing.assert_allclose(float(Lt), float(Lj), rtol=1e-6)
    gt_np = sim_params_to_numpy(gt)
    for k, want in gj._asdict().items():
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1e-300)
        err = np.abs(gt_np[k] - want).max() / scale
        assert err <= 1e-6, (k, err)
    assert np.abs(gt_np["wind"]).max() > 0
    # batched equals per-episode
    pb = batch_of(p0, np.stack([np.asarray(p0.wind), WINDS[1]]))
    LB, gB = vg(to_torch(pb))
    np.testing.assert_allclose(float(LB[0]), float(Lt), rtol=1e-9)
    for k in ("wind", "k_pertype", "density", "x0"):
        np.testing.assert_allclose(getattr(gB, k)[0].numpy(),
                                   getattr(gt, k).numpy(), rtol=1e-9,
                                   atol=1e-14)
