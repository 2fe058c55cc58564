"""Port parity for the sort-based sweep self-collision pipeline (the
large-mesh path): `diffcloth_tpu_torch.core.selfcol`'s
`detect_self_collisions_sweep`, `assign_layers`, `build_layer_tables` and
`empty_self_contacts` against the JAX package's, and
`ClothSim(self_method="sweep")` against the JAX ClothSim's sweep on its
Pallas friction kernels (interpret mode); mirrors
tests/test_selfcol_sweep.py.

Tolerances, with their reasons: pair sets, layers, partner tables,
overflow flags and compacted slots exactly (f64 inputs; the same
comparisons on the same values); normals 1e-12 (f64, one division); the
folded episode |dx| <= 1e-6, |dv| <= 1e-5 as tests/test_torch_sim.py,
and its gradient within 5e-6 of each class's largest entry (the f32
friction sweep inside the f64 simulation; on this scene the port's kernel
path shows the same 2.1e-6 gap in x0, and the sweep path's gradient equals
it exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu import losses as jl
from diffcloth_tpu.core import selfcol as jsc
from diffcloth_tpu.core.sim import ClothSim as JaxSim
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.convert import (sim_params_from_numpy,
                                         sim_params_to_numpy)
from diffcloth_tpu_torch.core import selfcol as tsc
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.geometry import builder as tgb
from diffcloth_tpu_torch.geometry import states
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64


def random_config(seed, n=200, n_adj=300):
    """test_selfcol_sweep.py's random cloud: positions, velocities, radii
    and a random adjacency table."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3) * 0.5
    v = rng.randn(n, 3) * 0.3
    radii = np.abs(rng.rand(n)) * 0.05 + 0.02
    conn = np.zeros((n, n), bool)
    for _ in range(n_adj):
        a, b = rng.randint(0, n, 2)
        conn[a, b] = conn[b, a] = True
    np.fill_diagonal(conn, False)
    return x, v, radii, conn


def t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def pairset(cs):
    m = np.asarray(cs.mask)
    pi, pj = np.asarray(cs.pair_i)[m], np.asarray(cs.pair_j)[m]
    return set(map(tuple, np.sort(np.stack([pi, pj], 1), axis=1)))


def sweep_both(x, v, radii, conn, h, window, cap):
    n = x.shape[-2]
    allowed = ~conn & ~np.eye(n, dtype=bool)
    tcs = tsc.detect_self_collisions_sweep(t(allowed, torch.bool), t(radii),
                                           t(x), t(v), h, window, cap)
    return allowed, tcs


@pytest.mark.parametrize("seed", range(4))
def test_sweep_matches_jax_and_the_all_pairs_oracle(seed):
    h = 0.02
    x, v, radii, conn = random_config(seed)
    allowed, tcs = sweep_both(x, v, radii, conn, h, 64, 512)
    cand = jnp.asarray(jsc.build_candidate_pairs(conn), jnp.int32)
    oracle = jsc.detect_self_collisions(cand, jnp.asarray(radii),
                                        jnp.asarray(x), jnp.asarray(v), h,
                                        cap_pairs=512)
    jcs = jsc.detect_self_collisions_sweep(
        jnp.asarray(allowed), jnp.asarray(radii), jnp.asarray(x),
        jnp.asarray(v), h, window=64, cap_pairs=512)
    assert pairset(tcs) == pairset(oracle) and len(pairset(tcs)) > 0
    assert not bool(tcs.overflow) and not bool(jcs.overflow)
    # slot for slot as the JAX sweep compacts them
    for f in ("pair_i", "pair_j", "mask", "layer"):
        np.testing.assert_array_equal(getattr(tcs, f).numpy(),
                                      np.asarray(getattr(jcs, f)), f)
    np.testing.assert_allclose(tcs.normal.numpy(), np.asarray(jcs.normal),
                               rtol=0, atol=1e-12)


def test_sweep_window_miss_flags_overflow():
    x, v, radii, conn = random_config(0)
    _, full = sweep_both(x, v, radii, conn, 0.02, 64, 512)
    allowed, tiny = sweep_both(x, v, radii, conn, 0.02, 4, 512)
    jtiny = jsc.detect_self_collisions_sweep(
        jnp.asarray(allowed), jnp.asarray(radii), jnp.asarray(x),
        jnp.asarray(v), 0.02, window=4, cap_pairs=512)
    # the tiny window misses pairs, and says so, as the JAX sweep does
    assert pairset(tiny) != pairset(full)
    assert bool(tiny.overflow) and bool(jtiny.overflow)
    assert pairset(tiny) == pairset(jtiny)
    # the capacity overflows too: the first `cap` hits in candidate order
    _, capped = sweep_both(x, v, radii, conn, 0.02, 64, 8)
    assert bool(capped.overflow) and int(capped.mask.sum()) == 8


def test_sweep_batched_equals_per_sample():
    xs, vs = [], []
    for seed in range(3):
        x, v, radii, conn = random_config(5, n=96, n_adj=60)
        xs.append(x * (1.0 + 0.3 * seed))
        vs.append(v)
    xs[2][:20] = xs[2][0]     # a pile: more hits than the capacity
    allowed, batched = sweep_both(np.stack(xs), np.stack(vs), radii, conn,
                                  0.02, 32, 64)
    for b in range(3):
        _, one = sweep_both(xs[b], vs[b], radii, conn, 0.02, 32, 64)
        for f in ("pair_i", "pair_j", "mask", "normal", "overflow"):
            assert torch.equal(getattr(batched, f)[b], getattr(one, f)), f
    assert bool(batched.overflow[2]) and not bool(batched.overflow[0])


def test_layering_matches_jax_and_is_candidate_order_independent():
    """assign_layers orders the matching by the canonical pair id i n + j,
    so shuffled candidates give the same (pair -> layer) map, equal to the
    JAX package's."""
    x, v, radii, conn = random_config(1, n=100, n_adj=50)
    # larger radii, so that particles have several partners (JAX's
    # test_table_friction_matches_pairlist contact density)
    radii = np.abs(np.random.RandomState(1).rand(100)) * 0.15 + 0.05
    n = 100
    cand = jsc.build_candidate_pairs(conn)
    shuf = cand[np.random.RandomState(7).permutation(len(cand))]

    def layer_map(cs):
        m = np.asarray(cs.mask)
        return {(int(i), int(j)): int(lay) for i, j, lay in zip(
            np.asarray(cs.pair_i)[m], np.asarray(cs.pair_j)[m],
            np.asarray(cs.layer)[m])}

    maps = []
    for c in (cand, shuf):
        ones = torch.ones((1, len(c)), dtype=torch.bool)
        cs = tsc._narrow_phase(t(c[None, :, 1], torch.int64),
                               t(c[None, :, 0], torch.int64), ones,
                               t(radii), t(x[None]), t(v[None]), 0.05, 1024)
        maps.append(layer_map(tsc.assign_layers(cs.first(), n, 16)))
    jcs = jsc.assign_layers(jsc.detect_self_collisions(
        jnp.asarray(cand, jnp.int32), jnp.asarray(radii), jnp.asarray(x),
        jnp.asarray(v), 0.05, cap_pairs=1024), n, max_layers=16)
    assert maps[0] and maps[0] == maps[1] == layer_map(jcs)
    assert max(maps[0].values()) >= 1, "a single layer tests no ordering"


def test_layer_tables_match_jax():
    x, v, radii, conn = random_config(3, n=80, n_adj=40)
    radii = np.abs(np.random.RandomState(3).rand(80)) * 0.15 + 0.05
    n, L = 80, 16
    allowed, tcs = sweep_both(x, v, radii, conn, 0.05, 79, 1024)
    jcs = jsc.detect_self_collisions_sweep(
        jnp.asarray(allowed), jnp.asarray(radii), jnp.asarray(x),
        jnp.asarray(v), 0.05, window=79, cap_pairs=1024)
    tcs = tsc.assign_layers(tcs, n, L)
    jcs = jsc.assign_layers(jcs, n, L)
    np.testing.assert_array_equal(tcs.layer.numpy(), np.asarray(jcs.layer))
    tt = tsc.build_layer_tables(tcs, n, L)
    jt = jsc.build_layer_tables(jcs, n, L)
    assert int(tt.n_layers) == int(jt.n_layers) >= 2
    np.testing.assert_array_equal(tt.partner.numpy(), np.asarray(jt.partner))
    # a layer is a matching: each particle at most once per layer
    for lay in tt.partner.numpy():
        has = lay >= 0
        np.testing.assert_array_equal(lay[lay[has]], np.nonzero(has)[0])
    empty = tsc.empty_self_contacts(32)
    et = tsc.build_layer_tables(tsc.assign_layers(empty, n, L), n, L)
    assert int(et.n_layers) == 0 and bool((et.partner == -1).all())


# ---------------------------------------------------------------------------
# the sweep pipeline in the step: layer tables -> slot geometry -> friction

GRID = 10
STEPS = 4


def folded_cfg(m):
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                              k_stiff_stretching=550, k_stiff_bending=0.01,
                              grid_num_x=GRID, grid_num_y=GRID,
                              density=0.124),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=STEPS, forward_convergence_thresh=1e-11,
        backward_convergence_thresh=1e-8, name="folded_sweep")


def to_torch(jparams):
    return sim_params_from_numpy(
        {k: np.asarray(v) for k, v in jparams._asdict().items()}, "cpu", F64)


@pytest.fixture(scope="module")
def sweep_sims():
    jscene = jgb.build_scene(folded_cfg(jc))
    tscene = tgb.build_scene(folded_cfg(tc))
    x0 = states.folded_grid(tscene, GRID // 2,
                            1.5 * float(tscene.radii.mean()))
    jsim = JaxSim(jscene, dtype=jnp.float64, self_method="sweep",
                  self_friction_impl="pallas")
    tsim = TorchSim(tscene, device="cpu", dtype=F64, self_method="sweep")
    kern = TorchSim(tscene, device="cpu", dtype=F64)
    assert tsim.self_cfg.method == "sweep" and kern.self_cfg.method == "kernel"
    assert tsim.self_cfg.window == 48 and tsim.self_cfg.cap_pairs == 128
    base = jsim.default_params()._replace(x0=jnp.asarray(x0))
    return jsim, tsim, kern, base


def test_sweep_episode_matches_jax_and_the_kernel_path(sweep_sims):
    jsim, tsim, kern, base = sweep_sims
    winds = np.array([[0.5, 0.05, 0.5], [0.2, 0.0, 0.4]])
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (2,) + a.shape), base)
    pb = pb._replace(wind=jnp.asarray(winds))
    tr = tsim.rollout(to_torch(pb)).steps
    assert int(tr.selfcol_pairs[0].sum()) > 0
    assert not tr.selfcol_overflow.any(), "parity holds without overflow"
    assert np.abs(tr.r.numpy()).max() > 0, "friction never acted"
    for b in range(2):
        jr = jsim.rollout(jax.tree.map(lambda a: a[b], pb)).steps
        np.testing.assert_allclose(tr.x[b].numpy(), np.asarray(jr.x),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tr.v[b].numpy(), np.asarray(jr.v),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(tr.r[b].numpy(), np.asarray(jr.r),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tr.selfcol_overflow[b].numpy(),
                                      np.asarray(jr.selfcol_overflow))
        one = tsim.rollout(to_torch(jax.tree.map(lambda a: a[b], pb))).steps
        assert torch.equal(one.x, tr.x[b])
    # both detections find the same pairs, so the episodes agree exactly
    kr = kern.rollout(to_torch(pb)).steps
    assert torch.equal(kr.selfcol_pairs, tr.selfcol_pairs)
    assert torch.equal(kr.x, tr.x)


def test_sweep_episode_gradient_matches_jax(sweep_sims):
    """Against the JAX sweep within 5e-6 of each class's largest entry: on
    this scene the port's kernel path differs from the JAX package's (whose
    sweep and Pallas paths agree exactly) by 2.1e-6 in x0, the f32
    friction sweep summed in another order inside the f64 simulation."""
    jsim, tsim, kern, base = sweep_sims
    target = np.array(jsim.rollout(
        base._replace(wind=jnp.asarray([0.5, 0.05, 0.5]))).full_x())
    p0 = base._replace(wind=jnp.asarray([0.3, 0.1, 0.6]))
    lf_j = jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                           jl.LossInfo(target_x=jnp.asarray(target)))
    lf_t = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                           tl.LossInfo(target_x=torch.as_tensor(target)))
    Lj, gj = jsim.episode_value_and_grad(lf_j)(p0)
    Lt, gt = tsim.episode_value_and_grad(lf_t)(to_torch(p0))
    np.testing.assert_allclose(float(Lt), float(Lj), rtol=1e-6)
    gt_np = sim_params_to_numpy(gt)
    for k, want in gj._asdict().items():
        want = np.asarray(want)
        err = np.abs(gt_np[k] - want).max() / max(np.abs(want).max(), 1e-300)
        assert err <= 5e-6, (k, err)
    # the sweep finds the kernel's pairs, so its gradient is the kernel
    # path's, exactly
    _, gk = kern.episode_value_and_grad(lf_t)(to_torch(p0))
    for k, g in gk.items():
        assert torch.equal(getattr(gt, k), g), k


def test_jax_method_names_raise():
    scene = tgb.build_scene(folded_cfg(tc))
    for name in ("matrix", "pallas"):
        with pytest.raises(ValueError, match="kernel"):
            TorchSim(scene, device="cpu", dtype=F64, self_method=name)
