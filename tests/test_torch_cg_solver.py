"""Port parity for the matrix-free Jacobi-PCG global solve (solve_mode
"cg", the large-mesh path): `diffcloth_tpu_torch`'s `step.pcg`,
`solver.gram_diagonals` / `make_host_p_diag_inv_fn` and
`ClothSim(solve_mode="cg")` against the JAX package's, forward and
gradient, single and batched; mirrors tests/test_cg_solver.py on its 6 x 6
grid (no self-contact) and on the flagship stand-in's physics on an 8 x 8
grid started folded (self-contact, sparse operators and the sweep).

Tolerances, with their reasons:
  * the Jacobi diagonal: bit-equal (the same f64 host arithmetic);
  * the cg trajectory (cg_max_iters 200, cg_rtol 1e-12, f64) against JAX's
    cg: |dx| <= 1e-9 (both solve to 1e-12; the sums differ in order), and
    against the port's own dense solve rtol 1e-6, atol 1e-8 (the JAX
    package's test_cg_trajectory_matches_dense bound);
  * gradients against JAX's cg: the loss within rtol 1e-8 and every
    parameter class within 1e-6 of its largest entry (both adjoints run to
    1e-8); against JAX's chunked adjoint the same;
  * the folded scene: |dx| <= 1e-6, |dv| <= 1e-5 as tests/test_torch_sim.py
    (the f32 friction sweep inside the f64 simulation);
  * batched against per-episode: rtol 1e-9, and each episode's CG
    iterations equal (a finished episode is frozen, as a vmapped lane).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu import losses as jl
from diffcloth_tpu.core import solver as jslv
from diffcloth_tpu.core.sim import ClothSim as JaxSim
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.convert import (sim_params_from_numpy,
                                         sim_params_to_numpy)
from diffcloth_tpu_torch.core import solver as tslv
from diffcloth_tpu_torch.core import step as tstep
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.geometry import builder as tgb
from diffcloth_tpu_torch.geometry import states
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64
CG = dict(solve_mode="cg", cg_max_iters=200, cg_rtol=1e-12)


def cg_cfg(m):
    """test_cg_solver.py's scene (6 x 6 grid, 5 steps)."""
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=2, cloth_dim_y=2,
                              k_stiff_stretching=300, k_stiff_bending=0.05,
                              grid_num_x=6, grid_num_y=6, density=0.3),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 60.0,
        step_num=5, name="cgtest")


def to_torch(jparams):
    return sim_params_from_numpy(
        {k: np.asarray(v) for k, v in jparams._asdict().items()}, "cpu", F64)


@pytest.fixture(scope="module")
def cg_pair():
    jscene = jgb.build_scene(cg_cfg(jc))
    tscene = tgb.build_scene(cg_cfg(tc))
    jsim = JaxSim(jscene, dtype=jnp.float64, **CG)
    tsim = TorchSim(tscene, device="cpu", dtype=F64, **CG)
    assert jsim.solve_mode == tsim.solve_mode == "cg"
    p = jsim.default_params()._replace(
        wind=jnp.array([0.2, 0.05, 0.1], jnp.float64))
    return jsim, tsim, p, tscene


def test_jacobi_diagonal_matches_jax(cg_pair):
    jsim, tsim, p, tscene = cg_pair
    jscene = jsim.scene_host
    for a, b in zip(jslv.gram_diagonals(jscene), tslv.gram_diagonals(tscene)):
        np.testing.assert_array_equal(b, a)
    d = tsim.p_inv(to_torch(p))
    assert tuple(d.shape) == (tsim.n,)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jsim.p_inv(p)))


def test_pcg_masks_finished_episodes():
    """Batched PCG equals per-episode PCG, iteration counts included: an
    episode whose residual is below rtol stops changing while another goes
    on (its lane of the JAX package's vmapped while_loop stops there)."""
    rng = np.random.RandomState(4)
    n = 30
    M = rng.randn(n, n) * 0.3
    A = torch.as_tensor(M @ M.T + np.eye(n) * 2.0)
    diag_inv = 1.0 / torch.diagonal(A)
    b = torch.as_tensor(rng.randn(2, n, 3))
    b[1] *= 1e-3

    def op(u):
        return torch.einsum("ij,bjk->bik", A, u)

    x, it = tstep.pcg(op, b, diag_inv, 100, 1e-10)
    for k in range(2):
        x1, it1 = tstep.pcg(op, b[k:k + 1], diag_inv, 100, 1e-10)
        np.testing.assert_allclose(x[k].numpy(), x1[0].numpy(), rtol=1e-9,
                                   atol=0)
        assert int(it[k]) == int(it1[0])
    res = torch.linalg.vector_norm(op(x) - b, dim=(1, 2))
    assert (res <= 1e-10 * torch.linalg.vector_norm(b, dim=(1, 2))).all()
    # a cap that stops both before convergence
    _, it_cap = tstep.pcg(op, b, diag_inv, 3, 1e-14)
    assert it_cap.tolist() == [3, 3]


def test_cg_trajectory_matches_jax_and_dense(cg_pair):
    jsim, tsim, p, tscene = cg_pair
    jr = jsim.rollout(p).steps
    tr = tsim.rollout(to_torch(p)).steps
    assert tr.converged.all() and int(tr.cg_iters.sum()) > 0
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(tr.iters.numpy(), np.asarray(jr.iters))
    dense = TorchSim(tscene, device="cpu", dtype=F64).rollout(
        to_torch(p)).steps
    assert int(dense.cg_iters.sum()) == 0
    np.testing.assert_allclose(tr.x.numpy(), dense.x.numpy(), rtol=1e-6,
                               atol=1e-8)


def assert_grads_match(gt, gj, bound=1e-6):
    gt_np = sim_params_to_numpy(gt)
    for k, want in gj._asdict().items():
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1e-300)
        err = np.abs(gt_np[k] - want).max() / scale
        assert err <= bound, (k, err)


def test_cg_gradients_match_jax_and_its_chunked_adjoint(cg_pair):
    jsim, tsim, p, _ = cg_pair
    target = np.zeros((tsim.n_steps + 1, tsim.n, 3))
    lf_j = jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                           jl.LossInfo(target_x=jnp.asarray(target)))
    lf_t = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                           tl.LossInfo(target_x=torch.as_tensor(target)))
    Lj, gj = jsim.episode_value_and_grad(lf_j)(p)
    Lc, gc = jsim.episode_value_and_grad_chunked(lf_j, chunk=1)(p)
    tsim.bwd_stats.reset()
    Lt, gt = tsim.episode_value_and_grad(lf_t)(to_torch(p))
    st = tsim.bwd_stats.summary()
    assert st["cg_solves"] > 0 and st["cg_iters"] > 0
    for L, g in ((Lj, gj), (Lc, gc)):
        np.testing.assert_allclose(float(Lt), float(L), rtol=1e-8)
        assert_grads_match(gt, g)


# ---------------------------------------------------------------------------
# the large-mesh path whole: cg, sparse operators and the sweep, folded

GRID = 8


def folded_cfg(m):
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                              k_stiff_stretching=550, k_stiff_bending=0.01,
                              grid_num_x=GRID, grid_num_y=GRID,
                              density=0.124),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=4, forward_convergence_thresh=1e-11,
        backward_convergence_thresh=1e-8, name="folded_large_path")


LARGE = dict(CG, dense_ops=False, sparse_ops=True, self_method="sweep")


def test_large_mesh_path_matches_jax_batched(tmp_path):
    jscene = jgb.build_scene(folded_cfg(jc))
    tscene = tgb.build_scene(folded_cfg(tc))
    x0 = states.folded_grid(tscene, GRID // 2,
                            1.5 * float(tscene.radii.mean()))
    jsim = JaxSim(jscene, dtype=jnp.float64, self_friction_impl="pallas",
                  **LARGE)
    tsim = TorchSim(tscene, device="cpu", dtype=F64, **LARGE)
    assert (tsim.solve_mode, tsim.self_cfg.method) == ("cg", "sweep")
    base = jsim.default_params()._replace(x0=jnp.asarray(x0))
    winds = np.array([[0.5, 0.05, 0.5], [0.2, 0.0, 0.4]])
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (2,) + a.shape), base)
    pb = pb._replace(wind=jnp.asarray(winds))
    tr = tsim.rollout(to_torch(pb)).steps
    assert int(tr.selfcol_pairs.sum()) > 0 and not tr.selfcol_overflow.any()
    for b in range(2):
        jr = jsim.rollout(jax.tree.map(lambda a: a[b], pb)).steps
        np.testing.assert_allclose(tr.x[b].numpy(), np.asarray(jr.x),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tr.v[b].numpy(), np.asarray(jr.v),
                                   rtol=0, atol=1e-5)
        assert np.abs(tr.iters[b].numpy() - np.asarray(jr.iters)).max() <= 1
        one = tsim.rollout(to_torch(jax.tree.map(lambda a: a[b], pb))).steps
        np.testing.assert_allclose(one.x.numpy(), tr.x[b].numpy(),
                                   rtol=1e-9, atol=0)
        np.testing.assert_array_equal(one.cg_iters.numpy(),
                                      tr.cg_iters[b].numpy())
    # the gradient of the whole path
    target = np.array(jsim.rollout(
        base._replace(wind=jnp.asarray(winds[0]))).full_x())
    p0 = base._replace(wind=jnp.asarray([0.3, 0.1, 0.6]))
    lf_j = jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                           jl.LossInfo(target_x=jnp.asarray(target)))
    lf_t = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                           tl.LossInfo(target_x=torch.as_tensor(target)))
    Lj, gj = jsim.episode_value_and_grad(lf_j)(p0)
    Lt, gt = tsim.episode_value_and_grad(lf_t)(to_torch(p0))
    np.testing.assert_allclose(float(Lt), float(Lj), rtol=1e-6)
    assert_grads_match(gt, gj)
