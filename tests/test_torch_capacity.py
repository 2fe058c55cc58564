"""Port parity for the self-collision capacity options of `ClothSim`
(`self_k_partners`, `self_max_layers`, `self_compact_layers`,
`self_compact_budgets`, `self_ablate`) against the JAX ClothSim on its
Pallas pipeline (self_method="pallas", self_friction_impl="pallas", the
kernels in interpret mode), on the same numpy inputs.

The scene: the flagship stand-in's physics on an 8 x 8 grid started folded
half over half (self-contact from the first step), f64, B = 2 episodes
(two winds), 3 steps, the forward converged to 1e-11 and the adjoint to
1e-8.  The JAX side of (a) and (b) is one compiled value-and-grad per
capacity setting whose auxiliary output is the episode's records (the
JAX package's compiles of its interpret-mode kernels take most of this
file's time).  Cases:
  (a) tight budgets (8, 4) over two compact layers, which drop contacts
      every step: the states, the overflow flags, the loss and every
      gradient class equal the JAX package's, so the drops are its drops;
  (b) drop-free capacity, budgets (n,) * 16 over 16 compact layers: the
      same, with no overflow;
  (c) the ablations "nofric" and "detect_only": the forward states and
      flags against the JAX package's ablated step;
  (d) `friction_cuda.sweep_operands` picks the streamed-slot route for
      slot rows past shared memory instead of raising (pure Python on
      shapes; the CPU wrappers run the plain versions on those operands),
      and sizes its force buffers to fit shared memory;
  (e) detection at K = 64 through the wrapper's plain version against the
      JAX kernel in interpret mode, overflow rows included;
and the options' validation.

Tolerances, as tests/test_torch_gradients.py's: states |dx| <= 1e-6 and
|dv| <= 1e-5 (the f32 sweep inside the f64 simulation, summed in another
order), PD iteration counts within 1, flags exactly; the loss rtol 1e-6,
every gradient class within 1e-6 of its largest entry; detection exact.
"""
import dataclasses

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
from diffcloth_tpu_torch.core import friction_cuda as fc
from diffcloth_tpu_torch.core.selfcol import SelfContactTables
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.geometry import builder as tgb
from diffcloth_tpu_torch.geometry import states
from test_torch_selfcol import jax_table, torch_table
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64
GRID = 8
N = GRID * GRID
STEPS = 3
WINDS = np.array([[0.3, 0.1, 0.6], [0.5, 0.05, 0.4]])
TIGHT = dict(self_compact_layers=2, self_compact_budgets=(8, 4))
DROP_FREE = dict(self_compact_layers=16, self_compact_budgets=(N,) * 16)


def folded_cfg(m):
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                              k_stiff_stretching=550, k_stiff_bending=0.01,
                              grid_num_x=GRID, grid_num_y=GRID,
                              density=0.124),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=STEPS, forward_convergence_thresh=1e-11,
        backward_convergence_thresh=1e-8, name="folded_capacity")


@pytest.fixture(scope="module")
def scenes():
    jscene = jgb.build_scene(folded_cfg(jc))
    tscene = tgb.build_scene(folded_cfg(tc))
    x0 = states.folded_grid(tscene, GRID // 2,
                            1.5 * float(tscene.radii.mean()))
    return jscene, tscene, x0


def port_sim(scenes, **options):
    return TorchSim(scenes[1], device="cpu", dtype=F64, **options)


def make_pair(scenes, **options):
    """The JAX and the port's sims with the same capacity options, the JAX
    episodes' params (one per wind) and the port's batch of them."""
    jscene, tscene, x0 = scenes
    jsim = JaxSim(jscene, dtype=jnp.float64, self_method="pallas",
                  self_friction_impl="pallas", **options)
    tsim = port_sim(scenes, **options)
    base = jsim.default_params()._replace(x0=jnp.asarray(x0))
    jps = [base._replace(wind=jnp.asarray(w)) for w in WINDS]
    tps = [sim_params_from_numpy({k: np.asarray(v) for k, v in
                                  p._asdict().items()}, "cpu", F64)
           for p in jps]
    tpb = tps[0].expand(len(WINDS)).replace(
        wind=torch.as_tensor(WINDS, dtype=F64))
    return jsim, tsim, jps, tpb


def assert_steps_match(jsteps_list, tsteps):
    for b, js in enumerate(jsteps_list):
        np.testing.assert_allclose(tsteps.x[b].numpy(), np.asarray(js.x),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tsteps.v[b].numpy(), np.asarray(js.v),
                                   rtol=0, atol=1e-5)
        d_it = np.abs(tsteps.iters[b].numpy().astype(np.int64)
                      - np.asarray(js.iters).astype(np.int64))
        assert d_it.max() <= 1, d_it
        np.testing.assert_array_equal(tsteps.selfcol_overflow[b].numpy(),
                                      np.asarray(js.selfcol_overflow))


def target_of(tsim, tpb):
    """MATCH_TRAJECTORY target: the port's rollout at another wind."""
    p = tpb.sample(0).replace(wind=torch.tensor([0.5, 0.05, 0.5],
                                                dtype=F64))
    return tsim.rollout(p).full_x().numpy()


def jax_records_value_and_grad(jsim, loss_fn):
    """jp -> (loss, records, gradient) of the JAX episode, one compile for
    the records and the value-and-grad."""
    def value(p, p_inv):
        recs = jsim.simulate(p, p_inv, jsim.x_fixed_seq(p))
        return loss_fn(recs), recs.steps
    vg = jax.jit(jax.value_and_grad(value, has_aux=True))

    def run(jp):
        (L, steps), g = vg(jp, jsim.p_inv(jp))
        return L, steps, g
    return run


@pytest.mark.parametrize("capacity", ["tight", "drop_free"])
def test_capacity_matches_jax(scenes, capacity):
    """(a), (b): states, flags, loss and every gradient class."""
    options = TIGHT if capacity == "tight" else DROP_FREE
    jsim, tsim, jps, tpb = make_pair(scenes, **options)
    budgets = options["self_compact_budgets"]
    assert tsim.self_cfg.budgets == tuple(min(c, N) for c in budgets)
    target = target_of(tsim, tpb)
    lf_j = jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                           jl.LossInfo(target_x=jnp.asarray(target)))
    lf_t = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                           tl.LossInfo(target_x=torch.as_tensor(target)))
    vg = jax_records_value_and_grad(jsim, lf_j)
    jax_out = [vg(jp) for jp in jps]
    recs = tsim.rollout(tpb).steps
    assert_steps_match([steps for _, steps, _ in jax_out], recs)
    assert (recs.selfcol_pairs > 0).all(), "a step lacks self-contact"
    overflow = recs.selfcol_overflow
    if capacity == "tight":
        assert overflow.all(), "the tight budgets dropped nothing"
    else:
        assert not overflow.any()
        # every layer's contacts hold a slot: the slots are the pairs' rows
        assert torch.equal(recs.selfcol_slots.long(),
                           2 * recs.selfcol_pairs)
    L_t, g_t = tsim.episode_value_and_grad(lf_t)(tpb)
    g_t = sim_params_to_numpy(g_t)
    for b, (L_j, _, g_j) in enumerate(jax_out):
        np.testing.assert_allclose(float(L_t[b]), float(L_j), rtol=1e-6)
        for name, a in g_t.items():
            ref = np.asarray(getattr(g_j, name))
            assert np.abs(a[b] - ref).max() <= 1e-6 * max(
                np.abs(ref).max(), 1e-300), (name, b)
    for name in ("wind", "density", "k_pertype", "x0", "v0"):
        assert np.abs(g_t[name]).max() > 0, name


def test_drop_free_capacity_moves_the_episode(scenes):
    """The tight budgets' drops are real: their episode departs from the
    drop-free one's."""
    _, _, _, tpb = make_pair(scenes)
    tight, free = port_sim(scenes, **TIGHT), port_sim(scenes, **DROP_FREE)
    x_tight = tight.rollout(tpb).steps.x
    x_free = free.rollout(tpb).steps.x
    assert float((x_tight - x_free).abs().max()) > 1e-6


@pytest.mark.parametrize("ablate", ["nofric", "detect_only"])
def test_ablations_match_jax(scenes, ablate):
    """(c): the ablated forward against the JAX package's ablated step."""
    jsim, tsim, jps, tpb = make_pair(scenes, self_ablate=ablate)
    recs = tsim.rollout(tpb).steps
    assert_steps_match([jsim.rollout(p).steps for p in jps], recs)
    if ablate == "nofric":
        assert (recs.selfcol_pairs > 0).all()
    else:
        assert not recs.selfcol_pairs.any() and not recs.selfcol_slots.any()
    # self-friction never acts: the ablations give one trajectory
    other = "detect_only" if ablate == "nofric" else "nofric"
    tsim_o = port_sim(scenes, self_ablate=other)
    torch.testing.assert_close(tsim_o.rollout(tpb).steps.x, recs.x,
                               rtol=0, atol=0)


def test_ablated_gradient_runs_without_sweeps(scenes):
    """The ablated steps' adjoint runs without self-friction: finite
    gradients, no active slot counted by the adjoint."""
    for ablate in ("nofric", "detect_only"):
        _, _, _, tpb = make_pair(scenes)
        tsim = port_sim(scenes, self_ablate=ablate)
        target = torch.zeros((STEPS + 1, N, 3), dtype=F64)
        lf = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                             tl.LossInfo(target_x=target))
        tsim.bwd_stats.reset()
        L, g = tsim.episode_value_and_grad(lf)(tpb)
        assert torch.isfinite(L).all() and torch.isfinite(g.wind).all()
        assert tsim.bwd_stats.summary()["slot_launches"] == 0


def slot_geometry(n, B, budgets, pairs=(400, 300, 150, 70), seed=0):
    """Slot geometry of random matchings (one per layer) on CPU tensors."""
    rng = np.random.RandomState(seed)
    partner = np.full((B, 16, n), -1, np.int64)
    for b in range(B):
        for lay, count in enumerate(pairs):
            perm = rng.permutation(n)[:2 * count]
            partner[b, lay, perm[:count]] = perm[count:]
            partner[b, lay, perm[count:]] = perm[:count]
    tables = SelfContactTables(partner=torch.as_tensor(partner),
                               n_layers=torch.full((B,), len(pairs)))
    x = torch.as_tensor(rng.randn(B, n, 3), dtype=torch.float32)
    geom = fc.build_kernel_geom(tables, torch.ones(n), n, budgets, x=x)
    return geom, fc.slot_masses(geom, torch.full((B,), 0.3)), rng


ROUTE_CASES = {
    # n, budgets, (state, slots) taken
    "flagship_default": (1024, (256, 128, 64, 64), ("shared", "shared")),
    "flagship_drop_free": (1024, (1024,) * 16, ("shared", "stream")),
    "dress_drop_free": (7056, (7056,) * 16, ("shared", "stream")),
    "large_default": (16384, (256, 128, 64, 64), ("global", "shared")),
    "large_raised": (16384, (4096,) * 4, ("shared", "stream")),
    "past_shared_state": (20001, (4096,) * 4, ("global", "stream")),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_sweep_operands_stream_slots_past_shared_memory(case):
    """(d): the first route whose blocks fit is taken; slot rows past
    shared memory are streamed, not refused; the CPU wrappers still run
    the plain versions on those operands."""
    n, budgets, route = ROUTE_CASES[case]
    geom, masses, rng = slot_geometry(n, 1, budgets)
    ops = fc.sweep_operands(geom, masses, budgets, n)
    assert (ops.route, ops.slots) == route
    if route[1] == "stream":
        # the staged slot rows would not fit beside any state
        _, TC = fc.layer_specs(budgets)
        assert fc._smem_bytes(0, TC, ops.max_c_pad, len(budgets),
                              *fc.BWD_SMEM_ROWS) > fc.SMEM_LIMIT
    if case != "flagship_drop_free":
        return
    f = torch.as_tensor(rng.randn(1, n, 3), dtype=torch.float32)
    out, vals = fc.friction_sweep(f, ops)
    out_p, vals_p = fc.friction_sweep_plain(f, geom, *masses, budgets)
    assert torch.equal(out, out_p) and torch.equal(vals, vals_p)
    assert float((out - f).abs().max()) > 0


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_streamed_ring_fits_shared_memory(case):
    """(d): on the streamed-slot route each kernel's force buffer is whole
    128-slot chunks, no wider than the widest layer, its block
    (`friction::stream_layout`: the state where it is shared, the buffer)
    fits SMEM_LIMIT, and the kernels' argument struct carries it; the
    other routes have no force buffer."""
    n, budgets, route = ROUTE_CASES[case]
    geom, masses, _ = slot_geometry(n, 1, budgets)
    ops = fc.sweep_operands(geom, masses, budgets, n)
    assert (ops.route, ops.slots) == route
    args = ops.args.contents
    if route[1] == "shared":
        assert ops.bufs is None
        assert (args.fwd_buf, args.bwd_buf) == (0, 0)
        return
    _, TC = fc.layer_specs(budgets)
    n_state = n if route[0] == "shared" else 0
    for k, fbytes in fc.STREAM_FORCE_BYTES.items():
        buf = ops.bufs[k]
        assert 0 <= buf <= ops.max_c_pad and buf % fc.CHUNK == 0
        assert fc._smem_bytes(n_state, TC, ops.max_c_pad, len(budgets), 0,
                              0, 0, fbytes * buf) <= fc.SMEM_LIMIT
        assert getattr(args, k + "_buf") == buf


def test_flagship_force_buffer_holds_the_widest_layer():
    """(d): at the flagship's drop-free budgets (c_pad 1024) both kernels
    keep every layer's forces in shared memory: no scratch is
    allocated."""
    n, budgets, _ = ROUTE_CASES["flagship_drop_free"]
    geom, masses, _ = slot_geometry(n, 1, budgets)
    ops = fc.sweep_operands(geom, masses, budgets, n)
    assert ops.max_c_pad == 1024
    for k in ("fwd", "bwd"):
        assert ops.bufs[k] >= 1024
        assert fc.stream_scratch(ops, k) is None


def test_scratch_holds_only_slots_past_the_force_buffer():
    """(d): beside a state of n = 16 384 in shared memory the force buffers
    are narrower than the raised budgets' 4096-slot layers: each kernel's
    scratch holds just the slots past its buffer (the backward's row and
    partner adds apart)."""
    n, budgets, _ = ROUTE_CASES["large_raised"]
    geom, masses, _ = slot_geometry(n, 2, budgets)
    ops = fc.sweep_operands(geom, masses, budgets, n)
    fbuf, bbuf = ops.bufs["fwd"], ops.bufs["bwd"]
    assert 0 < bbuf < fbuf < 4096
    assert fc.stream_scratch(ops, "fwd") == (2, 4096 - fbuf, 4)
    assert fc.stream_scratch(ops, "bwd") == (2, 2, 4096 - bbuf, 4)


def empty_geometry(L):
    """Slot geometry of L one-slot layers with no contact, one sample."""
    _, TC = fc.layer_specs((1,) * L)
    geom = fc.KernelGeom(
        idx_row=torch.full((1, TC), -1, dtype=torch.int32),
        idx_part=torch.full((1, TC), -1, dtype=torch.int32),
        normalT=torch.zeros((1, 3, TC)), area_row=torch.zeros((1, TC)),
        area_part=torch.zeros((1, TC)),
        counts=torch.zeros((1, L), dtype=torch.int32),
        overflow=torch.zeros(1, dtype=torch.bool))
    return geom, fc.slot_masses(geom, torch.full((1,), 0.3)), (1,) * L


def test_sweep_operands_refuse_a_route_that_does_not_fit():
    """Past the last route, (global, stream), only each layer's count and
    start stay in shared memory (the force buffers shrink to none, the
    scratch taking every slot): the longest layer chain they fit takes
    that route at a state past shared memory, one layer more raises."""
    last = max(L for L in range(20000, 40000)
               if fc._smem_bytes(0, 128 * L, 128, L, 0, 0, 0)
               <= fc.SMEM_LIMIT)
    ops = fc.sweep_operands(*empty_geometry(last), 20001)
    assert (ops.route, ops.slots) == ("global", "stream")
    with pytest.raises(ValueError):
        fc.sweep_operands(*empty_geometry(last + 1), 20001)


def pile_config(n=600, pile=150, seed=3):
    """A random cloud of n (two 512-column segments) with `pile` particles
    stacked on one point: rows with more than 64 hits, in both segments."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, 3) * 2.0).astype(np.float32)
    idx = np.arange(0, n, n // pile)[:pile]
    x[idx] = x[idx[0]]
    allowed = ~np.eye(n, dtype=bool)
    return (x, np.zeros_like(x), np.full((n,), 0.05, np.float32), allowed)


def test_detection_at_k64_matches_pallas_exactly():
    """(e): K = 64 (past the 32 of the CUDA kernel's first instantiation)."""
    x, v, radii, allowed = pile_config()
    xb = np.stack([x, (x * 0.9).astype(np.float32)])
    vb = np.stack([v, v])
    jgeom, jtab = jax_table(xb, vb, radii, allowed, 64)
    tgeom, ttab = torch_table(xb, vb, radii, allowed, 64)
    np.testing.assert_array_equal(tgeom, jgeom)
    np.testing.assert_array_equal(ttab, jtab[..., :65])
    n = x.shape[0]
    assert (ttab[:, :n, 64] > 64).any(), "case has no overflow row"
    assert (ttab[:, :n, 40:64] >= 0).any(), "no row fills slots past 32"


def test_clothsim_capacity_options():
    """Defaults as before (and as the JAX ClothSim's); the options and
    their validation."""
    scene = tgb.build_scene(folded_cfg(tc))
    sim = TorchSim(scene, device="cpu", dtype=F64)
    cfg = sim.self_cfg
    assert (cfg.k_partners, cfg.max_layers, cfg.budgets, cfg.ablate) == (
        8, 16, (N, N, N, N), "")
    cfg24 = folded_cfg(tc)
    big = tgb.build_scene(dataclasses.replace(cfg24, fabric=dataclasses.replace(
        cfg24.fabric, grid_num_x=24, grid_num_y=24)))
    assert TorchSim(big, device="cpu").self_cfg.budgets == (256, 128, 64, 64)
    sim = TorchSim(scene, device="cpu", self_k_partners=64,
                   self_max_layers=3, self_compact_layers=5)
    assert (sim.self_cfg.k_partners, sim.self_cfg.budgets) == (64, (N, N, N))
    for bad in (dict(self_k_partners=0), dict(self_k_partners=128),
                dict(self_max_layers=0), dict(self_compact_budgets=(8, -1)),
                dict(self_max_layers=2, self_compact_budgets=(8, 8, 8)),
                dict(self_ablate="nofriction")):
        with pytest.raises(ValueError):
            TorchSim(scene, device="cpu", **bad)
