"""The chunked episode of the port (`ClothSim.rollout_chunked`,
`episode_loss_chunked`, `episode_value_and_grad_chunked`,
`OptimizeHelper(chunked, chunk)`) against the JAX package's
(diffcloth_tpu/core/sim.py:475-775, optim/helper.py:55-76, :253-279), f64 on
the CPU, the JAX package's self-collision pipeline in Pallas interpret mode.

Tolerances: states within 1e-8 of the JAX package's (the self-friction
sweep is f32 in both packages, and its f32 roundings differ by op order:
8e-10 apart on the folded scene here) and losses within rtol 1e-7 (3e-9
apart); gradients within 1e-6 of each parameter class's largest entry,
as the whole-episode parity tests hold them (the adjoint converged to
1e-10, the f32 sweep's roundings leave x0's 5e-7 apart, k_pertype's
1e-8); the port's chunked results against its own
whole-episode ones exactly (states, diagnostics, losses) or, for
gradients, within 1e-12 of each class's largest entry (the chunks change
the order of the sums).  The chunk-size rule equals the JAX package's.
The GMRES cycles' least squares (`lstsq_cuda`) in its plain version
against numpy's gelsd per episode.  Card-only cases are in
tests/test_torch_graphs_cuda.py.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu import losses as jl
from diffcloth_tpu.core.sim import ClothSim as JaxSim
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu.optim import helper as jhelper
from diffcloth_tpu.tasks import setup as jsetup
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.convert import (primitive_set_from_numpy,
                                         sim_params_from_numpy,
                                         sim_params_to_numpy)
from diffcloth_tpu_torch.core import lstsq_cuda as lq
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.core.types import SimParams
from diffcloth_tpu_torch.geometry import builder as tgb
from diffcloth_tpu_torch.geometry import states
from diffcloth_tpu_torch.optim import helper as thelper
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64
GRID = 8
STEPS = 6
CHUNK = 3            # divides STEPS
CHUNK_ODD = 4        # does not: both packages take 3
WINDS = np.array([[0.5, 0.05, 0.5], [0.2, 0.0, 0.4]])


def folded_cfg(m):
    """The flagship stand-in's physics on a GRID x GRID cloth, the adjoint
    converged to 1e-10."""
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                              k_stiff_stretching=550, k_stiff_bending=0.01,
                              grid_num_x=GRID, grid_num_y=GRID,
                              density=0.124),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=STEPS, forward_convergence_thresh=1e-11,
        backward_convergence_thresh=1e-10, name="folded_chunks")


def to_torch(jparams):
    return sim_params_from_numpy(
        {k: np.asarray(v) for k, v in jparams._asdict().items()}, "cpu", F64)


def assert_grads_match(gt, gj, bound):
    """Every class of the port's gradient (SimParams) within `bound` of
    the JAX package's (a NamedTuple) class's largest entry."""
    gt_np = sim_params_to_numpy(gt)
    for k, want in gj._asdict().items():
        want = np.asarray(want)
        if want.size == 0:
            continue
        scale = max(np.abs(want).max(), 1e-300)
        err = np.abs(gt_np[k] - want).max() / scale
        assert err <= bound, (k, err)


def assert_self_match(g1: SimParams, g2: SimParams, bound=1e-12):
    for k, a in g1.items():
        b = getattr(g2, k)
        scale = max(float(a.abs().max()), 1e-300)
        assert float((a - b).abs().max()) / scale <= bound, k


@pytest.fixture(scope="module")
def folded():
    """The folded scene in both packages, its base params (the first
    episode folded), a batch of two (folded and flat, two winds) and the
    MATCH_TRAJECTORY loss of another wind's episode."""
    tscene = tgb.build_scene(folded_cfg(tc))
    jsim = JaxSim(jgb.build_scene(folded_cfg(jc)), dtype=jnp.float64,
                  self_method="pallas", self_friction_impl="pallas")
    tsim = TorchSim(tscene, device="cpu", dtype=F64)
    x0 = states.folded_grid(tscene, GRID // 2,
                            1.5 * float(tscene.radii.mean()))
    base = jsim.default_params()._replace(x0=jnp.asarray(x0),
                                          wind=jnp.asarray(WINDS[0]))
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (2,) + a.shape), base)
    pb = pb._replace(wind=jnp.asarray(WINDS),
                     x0=jnp.asarray(np.stack([x0, tscene.x_rest])))
    target = np.array(jsim.rollout(base._replace(
        wind=jnp.asarray(WINDS[1]))).full_x())
    lf_j = jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                           jl.LossInfo(target_x=jnp.asarray(target)))
    lf_t = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                           tl.LossInfo(target_x=torch.as_tensor(target)))
    return types.SimpleNamespace(jsim=jsim, tsim=tsim, base=base, pb=pb,
                                 lf_j=lf_j, lf_t=lf_t)


def test_chunk_size_rule_matches_jax():
    """The largest divisor of the episode length at most `chunk`."""
    for n_steps in (1, 6, 7, 12, 100, 250, 350):
        for chunk in (1, 2, 3, 4, 5, 25, 50, 400):
            sim = types.SimpleNamespace(n_steps=n_steps)
            got = TorchSim._chunk_size(sim, chunk)
            assert got == JaxSim._chunk_size(sim, chunk), (n_steps, chunk)
            assert n_steps % got == 0 and got <= chunk


@pytest.mark.parametrize("chunk", [CHUNK, CHUNK_ODD])
def test_rollout_chunked_matches_jax(folded, chunk):
    """rollout_chunked of the folded episode (self-contact in every step)
    against the JAX package's: states within 1e-8, the solver's counts
    exactly; f / r zero-filled; equal to the port's own rollout bit for
    bit but f / r."""
    f = folded
    jr = f.jsim.rollout_chunked(f.base, chunk=chunk).steps
    tp = to_torch(f.base)
    tr = f.tsim.rollout_chunked(tp, chunk=chunk).steps
    assert int(tr.selfcol_pairs.sum()) > 0
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(tr.v.numpy(), np.asarray(jr.v), rtol=0,
                               atol=1e-8 / f.tsim.h)
    assert tr.iters.tolist() == np.asarray(jr.iters).tolist()
    assert tr.converged.tolist() == np.asarray(jr.converged).tolist()
    assert float(tr.f.abs().max()) == 0.0 == float(tr.r.abs().max())
    whole = f.tsim.rollout(tp).steps
    for k in ("x", "v", "x_fixed", "iters", "converged", "selfcol_pairs",
              "selfcol_slots", "avg_deformation", "cg_iters"):
        assert torch.equal(getattr(tr, k), getattr(whole, k)), k


def test_loss_and_grad_chunked_single_matches_jax(folded):
    """episode_loss_chunked and episode_value_and_grad_chunked of one
    episode against the JAX package's chunked functions, and against the
    port's whole-episode ones."""
    f = folded
    Lj = float(f.jsim.episode_loss_chunked(f.lf_j, chunk=CHUNK)(f.base))
    Lj2, gj = f.jsim.episode_value_and_grad_chunked(f.lf_j,
                                                    chunk=CHUNK)(f.base)
    tp = to_torch(f.base)
    Lt = f.tsim.episode_loss_chunked(f.lf_t, chunk=CHUNK)(tp)
    Lt2, gt = f.tsim.episode_value_and_grad_chunked(f.lf_t,
                                                    chunk=CHUNK)(tp)
    np.testing.assert_allclose(float(Lt), Lj, rtol=1e-7)
    np.testing.assert_allclose(float(Lt2), float(Lj2), rtol=1e-7)
    assert float(Lt) == float(Lt2)
    assert_grads_match(gt, gj, 1e-6)
    assert float(gt.wind.abs().max()) > 0
    Lw, gw = f.tsim.episode_value_and_grad(f.lf_t)(tp)
    assert float(Lw) == float(Lt2)
    assert float(f.tsim.episode_loss(f.lf_t)(tp)) == float(Lt)
    assert_self_match(gw, gt)


def test_loss_and_grad_chunked_batched_matches_jax(folded):
    """batched=True: a folded and a flat episode of two winds, (B,) losses
    and per-episode gradients against the JAX package's vmapped chunks;
    a batched call of an unbatched function raises."""
    f = folded
    Lj = np.asarray(f.jsim.episode_loss_chunked(
        f.lf_j, chunk=CHUNK, batched=True)(f.pb))
    Lj2, gj = f.jsim.episode_value_and_grad_chunked(
        f.lf_j, chunk=CHUNK, batched=True)(f.pb)
    tp = to_torch(f.pb)
    Lt = f.tsim.episode_loss_chunked(f.lf_t, chunk=CHUNK, batched=True)(tp)
    Lt2, gt = f.tsim.episode_value_and_grad_chunked(
        f.lf_t, chunk=CHUNK, batched=True)(tp)
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=1e-7)
    np.testing.assert_allclose(Lt2.numpy(), np.asarray(Lj2), rtol=1e-7)
    for b in range(2):
        assert_grads_match(gt.sample(b), jax.tree.map(lambda a: a[b], gj),
                           1e-6)
    with pytest.raises(ValueError, match="batched"):
        f.tsim.episode_loss_chunked(f.lf_t, chunk=CHUNK)(tp)


def test_explosion_freeze_across_chunks(folded):
    """tests/test_subsystems.py:260-281 for the port: a wind far too strong
    blows the episode up in its first step; the chunked forward carries the
    freeze across the chunk boundaries, equals the whole episode exactly
    and the JAX package's within 1e-8, and stays finite; the chunked
    gradient of the frozen episode is finite and equals the whole
    episode's."""
    f = folded
    bad_j = f.base._replace(wind=jnp.asarray([1e7, 0.0, 1e7]))
    bad = to_torch(bad_j)
    sim = f.tsim
    cols, starts = sim._chunk_forward(bad.as_batched(), sim.p_inv(bad),
                                      sim.x_fixed_seq(bad)[None], CHUNK)
    assert len(starts) == STEPS // CHUNK and bool(starts[1][2].all())
    recs = sim.rollout_chunked(bad, chunk=CHUNK).steps
    assert torch.equal(recs.x, cols["x"][0])
    assert torch.equal(recs.x, sim.rollout(bad).steps.x)
    assert bool(torch.isfinite(recs.x).all())
    jx = np.asarray(f.jsim.rollout_chunked(bad_j, chunk=CHUNK).steps.x)
    np.testing.assert_allclose(recs.x.numpy(), jx, rtol=0, atol=1e-8)
    L, g = sim.episode_value_and_grad_chunked(f.lf_t, chunk=CHUNK)(bad)
    Lw, gw = sim.episode_value_and_grad(f.lf_t)(bad)
    assert np.isfinite(float(L)) and float(L) == float(Lw)
    assert bool(torch.isfinite(g.wind).all())
    assert_self_match(gw, g)


def sphere_cfg(m):
    """A cloth falling onto a sphere (tests/test_torch_graphs.py)."""
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=2.0, cloth_dim_y=2.0,
                              k_stiff_stretching=250.0,
                              k_stiff_bending=0.05, grid_num_x=6,
                              grid_num_y=6, density=0.3),
        attachment_points=m.AttachmentConfig.NO_ATTACHMENTS,
        trajectory=m.TrajectoryConfig.NO_TRAJECTORY,
        primitive_config=m.PrimitiveConfig.PLANE_AND_SPHERE,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=STEPS, forward_convergence_thresh=1e-11,
        backward_convergence_thresh=1e-10, name="sphere_chunks")


SPHERE = dict(kind=0, center=(0.0, -1.6, 0.0), radius=1.0, mu=0.5)
SPHERE_FLAGS = dict(wind_enabled=True, gradient_clipping=False)


def test_sphere_dl_dmu_chunked_matches_jax():
    """The sphere scene's dL/dmu through the chunked value-and-grad against
    the JAX package's, every sweep in obstacle contact."""
    jprims = jsetup._prim_struct([SPHERE], jnp.float64)
    tprims = primitive_set_from_numpy(
        {k: (v if v is None else np.asarray(v))
         for k, v in jprims._asdict().items()}, F64, "cpu")
    jsim = JaxSim(jgb.build_scene(sphere_cfg(jc)), dtype=jnp.float64,
                  prims=jprims, flags=jc.SimFlags(**SPHERE_FLAGS),
                  self_method="pallas", self_friction_impl="pallas")
    tsim = TorchSim(tgb.build_scene(sphere_cfg(tc)), device="cpu",
                    dtype=F64, prims=tprims,
                    flags=tc.SimFlags(**SPHERE_FLAGS))
    base = jsim.default_params()._replace(
        wind=jnp.asarray([0.3, 0.0, 0.2]))
    target = np.array(jsim.rollout(base._replace(
        mu=jnp.asarray([0.2]))).full_x())
    lf_j = jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                           jl.LossInfo(target_x=jnp.asarray(target)))
    lf_t = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                           tl.LossInfo(target_x=torch.as_tensor(target)))
    Lj, gj = jsim.episode_value_and_grad_chunked(lf_j, chunk=CHUNK)(base)
    tp = to_torch(base)
    Lt, gt = tsim.episode_value_and_grad_chunked(lf_t, chunk=CHUNK)(tp)
    assert int(tsim.rollout_chunked(tp, CHUNK).steps.obstacle_contacts
               .gt(0).sum()) > 0
    np.testing.assert_allclose(float(Lt), float(Lj), rtol=1e-7)
    mu_j = np.asarray(gj.mu)
    assert abs(mu_j).max() > 0
    np.testing.assert_allclose(gt.mu.numpy(), mu_j, rtol=0,
                               atol=1e-6 * abs(mu_j).max())
    assert_grads_match(gt, gj, 1e-6)


def multistage_cfg(m, steps=6):
    """tests/test_torch_multistage.py's two-stage 5 x 5 scene."""
    fab = m.FabricConfig(cloth_dim_x=2.0, cloth_dim_y=2.0,
                         k_stiff_stretching=250.0, k_stiff_bending=0.05,
                         grid_num_x=5, grid_num_y=5, density=0.324)
    return m.SceneConfig(
        fabric=fab, attachment_points=m.AttachmentConfig.CUSTOM_ARRAY,
        custom_attachment_vertex_idx=((0.0, (0, 4)), (0.5, (20, 24))),
        trajectory=m.TrajectoryConfig.NO_TRAJECTORY,
        primitive_config=m.PrimitiveConfig.NONE,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 60.0,
        step_num=steps, forward_convergence_thresh=1e-9,
        name="test_multistage")


def test_multistage_delegates():
    """tests/test_multistage.py:116 for the port: a scene of several stages
    runs the whole-episode functions (their results exactly)."""
    sim = TorchSim(tgb.build_scene(multistage_cfg(tc)), device="cpu",
                   dtype=F64)
    assert sim.n_stages == 2
    p = sim.default_params().replace(
        wind=torch.tensor([0.3, 0.05, 0.3], dtype=F64))

    def loss_fn(recs):
        return (recs.steps.x[-1] ** 2).sum()

    L1, g1 = sim.episode_value_and_grad(loss_fn)(p)
    L2, g2 = sim.episode_value_and_grad_chunked(loss_fn, chunk=4)(p)
    assert float(L1) == float(L2)
    assert torch.equal(g1.wind, g2.wind)
    assert float(sim.episode_loss_chunked(loss_fn, chunk=4)(p)) == float(L1)
    assert torch.equal(sim.rollout_chunked(p, chunk=4).steps.x,
                       sim.rollout(p).steps.x)


def test_optimize_helper_chunked_matches_jax(folded):
    """OptimizeHelper(chunked=True, chunk) against the JAX helper: the
    loss, the value and gradient vector, and the population's
    batched_loss / batched_loss_and_grad (always chunked); the automatic
    choice equals the JAX helper's."""
    f = folded
    mask_t = thelper.GradMask(f_wind=True)
    mask_j = jhelper.GradMask(f_wind=True)
    tp = to_torch(f.base)
    th = thelper.OptimizeHelper(f.tsim, mask_t, f.lf_t, param_base=tp,
                                chunked=True, chunk=CHUNK)
    jh = jhelper.OptimizeHelper(f.jsim, mask_j, f.lf_j, param_base=f.base,
                                chunked=True, chunk=CHUNK)
    auto = thelper.OptimizeHelper(f.tsim, mask_t, f.lf_t, param_base=tp)
    assert auto.chunked is False and th.chunked is True
    assert jhelper.OptimizeHelper(f.jsim, mask_j, f.lf_j,
                                  param_base=f.base).chunked is False
    x = th.params_to_vec(tp)
    np.testing.assert_allclose(x, jh.params_to_vec(f.base), rtol=0,
                               atol=0)
    np.testing.assert_allclose(th.loss(x), jh.loss(x), rtol=1e-7)
    Lt, Gt = th.loss_and_grad(x)
    Lj, Gj = jh.loss_and_grad(x)
    np.testing.assert_allclose(Lt, Lj, rtol=1e-7)
    np.testing.assert_allclose(Gt, Gj, rtol=0,
                               atol=1e-6 * np.abs(Gj).max())
    X = np.stack([x, x * np.array([0.5, 1.0, 1.2, 1.0, 1.0])])
    Lbt, Gbt = th.batched_loss_and_grad(X)
    Lbj, Gbj = jh.batched_loss_and_grad(X)
    np.testing.assert_allclose(Lbt, Lbj, rtol=1e-7)
    np.testing.assert_allclose(Gbt, Gbj, rtol=0,
                               atol=1e-6 * np.abs(Gbj).max())
    np.testing.assert_allclose(th.batched_loss(X), jh.batched_loss(X),
                               rtol=1e-7)
    assert th.last_split is not None


def hessenbergs(rng, B, m):
    """Upper Hessenberg (B, m+1, m) least-squares problems: random, a happy
    breakdown (a zero subdiagonal entry, the block below it zero), columns
    near the cutoff, a non-finite episode."""
    H = np.triu(rng.randn(B, m + 1, m), -1)
    for b in range(1, B, 3):
        j = rng.randint(m)
        H[b, j + 1, j] = 0.0
        H[b, j + 1:, j + 1:] = 0.0
    for b in range(2, B, 3):
        H[b, :, -3:] *= 1e-9
    H[0, 0, 0] = np.nan
    e1 = np.zeros((B, m + 1))
    e1[:, 0] = rng.rand(B) + 0.1
    return H, e1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lstsq_plain_matches_numpy(dtype):
    """The GMRES least squares' plain version (the kernel's reference on
    the card, the CPU route) against numpy's gelsd per episode, with the
    cutoff rcond = eps(dtype) * (m + 1) of jnp.linalg.lstsq: within 1e-10
    of each episode's largest entry (two LAPACK builds: 2e-11 apart on a
    happy breakdown), 1e-6 where columns near the cutoff make the problem
    ill-conditioned; NaN for the non-finite episode."""
    rng = np.random.RandomState(0)
    m = 16
    H, e1 = hessenbergs(rng, 12, m)
    Ht = torch.as_tensor(H, dtype=dtype)
    bt = torch.as_tensor(e1, dtype=dtype)
    rcond = torch.finfo(dtype).eps * (m + 1)
    y = lq.hessenberg_lstsq(Ht, bt, rcond)
    assert y.dtype == dtype and y.shape == (12, m)
    assert bool(torch.isnan(y[0]).all())
    Hd, bd = Ht.double().numpy(), bt.double().numpy()
    for b in range(1, 12):
        want = np.linalg.lstsq(Hd[b], bd[b], rcond=rcond)[0]
        scale = np.abs(want).max()
        tol = 1e-6 if b % 3 == 2 else 1e-10
        tol = max(tol, 4 * torch.finfo(dtype).eps)
        assert np.abs(y[b].double().numpy() - want).max() <= tol * scale, b
