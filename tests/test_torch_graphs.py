"""The block-structured step: `diffcloth_tpu_torch/core/step.py` runs its
three loops (the PD sweeps, the adjoint's fixed-point trips, Jacobi-PCG)
as blocks of CHECK_EVERY masked iterations with the host's any-active
check between blocks, captured as CUDA graphs on the card
(`core/graphs.py`) and called directly on the CPU.  Here, on the CPU in
f64, each loop's counts are held EXACTLY to the JAX package's
`lax.while_loop`s on the same scene, and states and gradients to its
results:

  * PD sweeps per step (`StepAux.iters`), CG iterations per step
    (`StepAux.cg_iters`), fixed-point trips and GMRES fallbacks per
    episode (`BackwardStats.lane_trips`, `fallback_lanes`) and the
    adjoint's CG iterations (`BackwardStats.cg_iters`), against the trip
    counts of the JAX package's own while_loops (`LoopCounts`: each
    `jax.lax.while_loop` of `diffcloth_tpu/core/step.py` runs with a
    counter beside its carry, reported by an ordered debug callback; the
    package itself is not changed);
  * scenes: a small folded grid with the flagship stand-in's physics
    (self-contact), forward and value-and-grad; the contact-stiff sphere
    scene of tests/test_torch_obstacle_sim.py; the large-mesh path forced
    on a small folded grid (solve_mode "cg", sparse operators, the sweep);
    and the CG scene with every cap (forward sweeps, CG iterations,
    fixed-point trips) not a multiple of CHECK_EVERY.

Tolerances, with their reasons: states as tests/test_torch_sim.py and
tests/test_torch_cg_solver.py hold them (|dx| <= 1e-6, |dv| <= 1e-5 where
the f32 friction sweep runs inside the f64 simulation; 1e-9 without
contact); losses within rtol 1e-6 and every gradient class within 1e-6 of
its largest entry (both adjoints to eps_backward 1e-8, the friction VJP
in f32), as tests/test_torch_step_bwd.py.

Also: the `cuda_graphs` switch and its rules (True needs a card and no
solve_fn; a step given solve_fn runs uncaptured) and the static buffers
`BlockGraphs.bind` keeps.  tests/test_torch_graphs_cuda.py (no JAX, marker
`cuda`) holds graphed against `cuda_graphs=False` bit for bit on the card.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu import losses as jl
from diffcloth_tpu.core import step as jstep
from diffcloth_tpu.core.sim import ClothSim as JaxSim
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu.tasks import setup as jsetup
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.convert import (primitive_set_from_numpy,
                                         sim_params_from_numpy,
                                         sim_params_to_numpy)
from diffcloth_tpu_torch.core import graphs as gr
from diffcloth_tpu_torch.core import step as tstep
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.geometry import builder as tgb
from diffcloth_tpu_torch.geometry import states
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64
GRID = 8


class LoopCounts:
    """Trip counts of the JAX package's while_loops, in program order:
    `records` holds (loop, trips) with loop "pd" (the PD loop), "pcg" (a
    CG solve), "fp" (the adjoint's fixed point), "fb" (its GMRES
    fallback) or "gm" (the GMRES adjoint mode)."""

    def __init__(self):
        self.records = []
        self._orig = jax.lax.while_loop

    def while_loop(self, cond_fun, body_fun, init_val):
        caller = sys._getframe(1).f_code
        if caller.co_filename != jstep.__file__:
            return self._orig(cond_fun, body_fun, init_val)
        loop = {"_pcg": "pcg", "pd_forward": "pd"}.get(
            caller.co_name, cond_fun.__name__[:2])
        out, trips = self._orig(
            lambda c: cond_fun(c[0]),
            lambda c: (body_fun(c[0]), c[1] + 1),
            (init_val, jnp.asarray(0, jnp.int32)))
        jax.debug.callback(
            lambda k: self.records.append((loop, int(k))), trips,
            ordered=True)
        return out

    def take(self):
        out, self.records = self.records, []
        return out


@pytest.fixture(scope="module")
def counts():
    lc = LoopCounts()
    jax.lax.while_loop = lc.while_loop
    yield lc
    jax.lax.while_loop = lc._orig


def steps_of(records):
    """Per step of a forward episode: (PD sweeps, CG iterations summed over
    its sweeps), from the records of one JAX rollout."""
    out, cg = [], 0
    for loop, k in records:
        if loop == "pcg":
            cg += k
        elif loop == "pd":
            out.append((k, cg))
            cg = 0
    return out


def adjoint_of(records):
    """(fixed-point trips, steps that fell to the GMRES fallback, CG
    iterations) of a JAX value-and-grad's backward: the records after the
    forward's last PD loop."""
    last_pd = max(i for i, (loop, _) in enumerate(records) if loop == "pd")
    bwd = records[last_pd + 1:]
    return (sum(k for loop, k in bwd if loop == "fp"),
            sum(1 for loop, k in bwd if loop == "fb" and k > 0),
            sum(k for loop, k in bwd if loop == "pcg"))


def to_torch(jparams):
    return sim_params_from_numpy(
        {k: np.asarray(v) for k, v in jparams._asdict().items()}, "cpu", F64)


def assert_grads_match(gt, gj, bound=1e-6):
    gt_np = sim_params_to_numpy(gt)
    for k, want in gj._asdict().items():
        want = np.asarray(want)
        if want.size == 0:
            continue
        scale = max(np.abs(want).max(), 1e-300)
        err = np.abs(gt_np[k] - want).max() / scale
        assert err <= bound, (k, err)


def batched(jp, **fields):
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (2,) + a.shape), jp)
    return pb._replace(**{k: jnp.asarray(v) for k, v in fields.items()})


def check_forward(counts, jsim, tsim, pb, tol):
    """The port's batched episode against the JAX package's episodes one
    by one: sweeps and CG iterations per step exactly, states within
    `tol`."""
    tr = tsim.rollout(to_torch(pb)).steps
    assert bool(tr.converged.all())
    B = pb.x0.shape[0]
    for b in range(B):
        counts.take()
        jr = jsim.rollout(jax.tree.map(lambda a: a[b], pb)).steps
        loops = steps_of(counts.take())
        assert [k for k, _ in loops] == np.asarray(jr.iters).tolist()
        assert tr.iters[b].tolist() == [k for k, _ in loops]
        assert tr.cg_iters[b].tolist() == [c for _, c in loops]
        np.testing.assert_allclose(tr.x[b].numpy(), np.asarray(jr.x),
                                   rtol=0, atol=tol[0])
        np.testing.assert_allclose(tr.v[b].numpy(), np.asarray(jr.v),
                                   rtol=0, atol=tol[1])
    return tr


def check_gradient(counts, jsim, tsim, jp, target):
    """One episode's value-and-grad against the JAX package's: the loss and
    every gradient class, and the adjoint's trips, GMRES fallbacks and CG
    iterations exactly."""
    lf_j = jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                           jl.LossInfo(target_x=jnp.asarray(target)))
    lf_t = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                           tl.LossInfo(target_x=torch.as_tensor(target)))
    counts.take()
    Lj, gj = jsim.episode_value_and_grad(lf_j)(jp)
    trips, fallbacks, cg = adjoint_of(counts.take())
    tsim.bwd_stats.reset()
    Lt, gt = tsim.episode_value_and_grad(lf_t)(to_torch(jp))
    st = tsim.bwd_stats.summary()
    np.testing.assert_allclose(float(Lt), float(Lj), rtol=1e-6)
    assert_grads_match(gt, gj)
    assert st["lane_steps"] == tsim.n_steps
    assert (st["lane_trips"], st["fallback_lanes"], st["cg_iters"]) == (
        trips, fallbacks, cg)
    assert trips > 0
    return st


# ---------------------------------------------------------------------------
# scenes

def folded_cfg(m, steps=3):
    """The flagship stand-in's physics (tests/test_torch_step_bwd.py) on a
    GRID x GRID cloth."""
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                              k_stiff_stretching=550, k_stiff_bending=0.01,
                              grid_num_x=GRID, grid_num_y=GRID,
                              density=0.124),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=steps, forward_convergence_thresh=1e-11,
        backward_convergence_thresh=1e-8, name="folded_blocks")


def folded_x0(tscene):
    return states.folded_grid(tscene, GRID // 2,
                              1.5 * float(tscene.radii.mean()))


WINDS = np.array([[0.5, 0.05, 0.5], [0.2, 0.0, 0.4]])


def test_flagship_physics_blocks_match_jax(counts):
    """Folded and flat episodes (self-contact in the folded one): the PD
    blocks' sweeps per step, then one episode's value-and-grad and its
    fixed-point trips, against the JAX package's while_loops."""
    tscene = tgb.build_scene(folded_cfg(tc))
    jsim = JaxSim(jgb.build_scene(folded_cfg(jc)), dtype=jnp.float64,
                  self_method="pallas", self_friction_impl="pallas")
    tsim = TorchSim(tscene, device="cpu", dtype=F64)
    assert not tsim.cuda_graphs and not tsim.graphs[0].enabled
    x0 = folded_x0(tscene)
    base = jsim.default_params()._replace(x0=jnp.asarray(x0))
    pb = batched(base, wind=WINDS,
                 x0=np.stack([x0, np.asarray(tscene.x_rest)]))
    tr = check_forward(counts, jsim, tsim, pb, (1e-6, 1e-5))
    assert int(tr.selfcol_pairs[0].sum()) > 0
    assert int(tr.selfcol_overflow.sum()) == 0
    target = np.array(jsim.rollout(base._replace(
        wind=jnp.asarray(WINDS[1]))).full_x())
    check_gradient(counts, jsim, tsim,
                   base._replace(wind=jnp.asarray(WINDS[0])), target)


def sphere_cfg(m):
    """tests/test_torch_obstacle_sim.py capcheck_cfg, cut to 6 steps."""
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=2.0, cloth_dim_y=2.0,
                              k_stiff_stretching=250.0,
                              k_stiff_bending=0.05, grid_num_x=6,
                              grid_num_y=6, density=0.3),
        attachment_points=m.AttachmentConfig.NO_ATTACHMENTS,
        trajectory=m.TrajectoryConfig.NO_TRAJECTORY,
        primitive_config=m.PrimitiveConfig.PLANE_AND_SPHERE,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=6, forward_convergence_thresh=1e-11,
        backward_convergence_thresh=1e-8, name="sphere_blocks")


SPHERE = dict(kind=0, center=(0.0, -1.6, 0.0), radius=1.0, mu=0.5)
SPHERE_FLAGS = dict(wind_enabled=True, gradient_clipping=False)


def test_sphere_contact_blocks_match_jax(counts):
    """A cloth falling onto a sphere (obstacle friction in every sweep,
    self-collision on), two friction coefficients: the PD blocks' sweeps,
    then the episode gradient's trips, against the JAX package's."""
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
    pb = batched(base, mu=np.array([[0.5], [0.1]]))
    tr = check_forward(counts, jsim, tsim, pb, (1e-6, 1e-5))
    assert (tr.obstacle_contacts > 0).float().mean() > 0.5
    target = np.array(jsim.rollout(base._replace(
        mu=jnp.asarray([0.2]))).full_x())
    check_gradient(counts, jsim, tsim, base, target)


LARGE = dict(solve_mode="cg", cg_max_iters=200, cg_rtol=1e-12,
             dense_ops=False, sparse_ops=True, self_method="sweep")


def test_cg_sparse_sweep_blocks_match_jax(counts):
    """The large-mesh path forced on a folded grid: CG iterations per step
    of the PD blocks' solves and of the adjoint's, against the JAX
    package's CG while_loop."""
    tscene = tgb.build_scene(folded_cfg(tc))
    jsim = JaxSim(jgb.build_scene(folded_cfg(jc)), dtype=jnp.float64,
                  self_friction_impl="pallas", **LARGE)
    tsim = TorchSim(tscene, device="cpu", dtype=F64, **LARGE)
    assert (tsim.solve_mode, tsim.self_cfg.method) == ("cg", "sweep")
    x0 = folded_x0(tscene)
    base = jsim.default_params()._replace(x0=jnp.asarray(x0))
    pb = batched(base, wind=WINDS)
    tr = check_forward(counts, jsim, tsim, pb, (1e-6, 1e-5))
    assert int(tr.cg_iters.sum()) > 0 and int(tr.selfcol_pairs.sum()) > 0
    target = np.array(jsim.rollout(base._replace(
        wind=jnp.asarray(WINDS[1]))).full_x())
    st = check_gradient(counts, jsim, tsim,
                        base._replace(wind=jnp.asarray(WINDS[0])), target)
    assert st["cg_iters"] > 0


def caps_cfg(m):
    """tests/test_torch_cg_solver.py's 6 x 6 scene, 4 steps."""
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=2, cloth_dim_y=2,
                              k_stiff_stretching=300, k_stiff_bending=0.05,
                              grid_num_x=6, grid_num_y=6, density=0.3),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 60.0,
        step_num=4, name="caps")


def test_caps_not_multiples_of_check_every(counts):
    """Every cap a block boundary misses: 10 CG iterations (the solves do
    not reach rtol 1e-14 in 10), 30 PD sweeps, 6 fixed-point trips
    (max_backward_iters 7) against an adjoint tolerance it cannot meet, so
    every step falls to the GMRES fallback.  The short last blocks stop
    each loop where the JAX package's while_loops stop."""
    caps = dict(cg_max_iters=10, max_forward_iters=30,
                max_backward_iters=7)
    assert all(c % tstep.CHECK_EVERY for c in (
        caps["cg_max_iters"], caps["max_forward_iters"],
        caps["max_backward_iters"] - 1))
    kw = dict(solve_mode="cg", cg_max_iters=caps["cg_max_iters"],
              cg_rtol=1e-14, max_forward_iters=caps["max_forward_iters"],
              eps_forward=1e-14, eps_backward=1e-14)
    jsim = JaxSim(jgb.build_scene(caps_cfg(jc)), dtype=jnp.float64,
                  flags=jc.SimFlags(wind_enabled=True, max_backward_iters=7),
                  **kw)
    tsim = TorchSim(tgb.build_scene(caps_cfg(tc)), device="cpu", dtype=F64,
                    flags=tc.SimFlags(wind_enabled=True,
                                      max_backward_iters=7), **kw)
    base = jsim.default_params()._replace(
        wind=jnp.asarray([0.2, 0.05, 0.1]))
    pb = batched(base, wind=WINDS)
    tr = tsim.rollout(to_torch(pb)).steps
    for b in range(2):
        counts.take()
        jr = jsim.rollout(jax.tree.map(lambda a: a[b], pb)).steps
        loops = steps_of(counts.take())
        assert tr.iters[b].tolist() == [k for k, _ in loops] == np.asarray(
            jr.iters).tolist()
        assert tr.cg_iters[b].tolist() == [c for _, c in loops]
        np.testing.assert_allclose(tr.x[b].numpy(), np.asarray(jr.x),
                                   rtol=0, atol=1e-9)
    # the caps bind: CG stops at 10 in every solve, the PD loop at 30 in
    # some step
    assert int(tr.iters.max()) == 30
    assert (tr.cg_iters == 10 * tr.iters).all()
    target = np.zeros((tsim.n_steps + 1, tsim.n, 3))
    st = check_gradient(counts, jsim, tsim, base, target)
    assert st["lane_trips"] == 6 * tsim.n_steps
    assert st["fallback_lanes"] == tsim.n_steps


# ---------------------------------------------------------------------------
# the switch, its rules and the static buffers

def test_cuda_graphs_switch_and_its_rules():
    """None: graphs on a card without solve_fn, uncaptured otherwise;
    True raises where there can be none; False is uncaptured."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def solve_fn(p_inv, rhs):
        return rhs

    assert gr.resolve(None, cuda) is True
    assert gr.resolve(None, cuda, solve_fn) is False
    assert gr.resolve(False, cuda) is False
    assert gr.resolve(None, cpu) is False
    with pytest.raises(ValueError, match="CUDA device"):
        gr.resolve(True, cpu)
    with pytest.raises(ValueError, match="solve_fn"):
        gr.resolve(True, cuda, solve_fn)
    scene = tgb.build_scene(caps_cfg(tc))
    with pytest.raises(ValueError, match="CUDA device"):
        TorchSim(scene, device="cpu", dtype=F64, cuda_graphs=True)


def test_step_given_solve_fn_runs_uncaptured():
    """A step given solve_fn runs the uncaptured blocks (a rule on the
    arguments: the caller's solve may hold collectives), with the same
    result as the built-in dense solve it stands in for."""
    scene = tgb.build_scene(caps_cfg(tc))
    calls = []

    def solve_fn(p_inv, rhs):
        calls.append(rhs.shape)
        return torch.einsum("ij,bjk->bik", p_inv, rhs)

    sim = TorchSim(scene, device="cpu", dtype=F64, solve_fn=solve_fn)
    ref = TorchSim(scene, device="cpu", dtype=F64)
    assert sim.cuda_graphs is False and not sim.graphs[0].enabled
    p = sim.default_params()
    a, b = sim.rollout(p).steps, ref.rollout(p).steps
    # one call per sweep the blocks ran, masked ones included
    ce = tstep.CHECK_EVERY
    assert len(calls) == sum(-(-k // ce) * ce for k in a.iters.tolist())
    np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), rtol=0, atol=1e-12)
    assert a.iters.tolist() == b.iters.tolist()
    assert sim.graphs[0].summary() == {}


def test_tp_solve_runs_uncaptured(tmp_path):
    """The tensor-parallel solve is the one solve_fn a step runs captured
    (its all-gather is a kernel pair, `parallel/exchange.py`): on a card by
    default and with `cuda_graphs=True`, even on a group of one rank; it
    runs uncaptured on the CPU and with `cuda_graphs=False`, and any other
    solve_fn still runs uncaptured and refuses `cuda_graphs=True`."""
    import torch.distributed as dist
    from diffcloth_tpu_torch.parallel import mesh as pmesh
    pmesh.initialize_distributed("gloo", f"file://{tmp_path}/init", 1, 0)
    try:
        solve = pmesh.make_tp_solve()
    finally:
        dist.destroy_process_group()
    cuda = torch.device("cuda")
    assert gr.resolve(None, cuda, solve) is True
    assert gr.resolve(True, cuda, solve) is True
    assert gr.resolve(False, cuda, solve) is False
    assert gr.resolve(None, torch.device("cpu"), solve) is False

    def other(p_inv, rhs):
        return rhs

    assert gr.resolve(None, cuda, other) is False
    with pytest.raises(ValueError, match="solve_fn"):
        gr.resolve(True, cuda, other)


def test_tp_step_of_one_gloo_rank_equals_dense(tmp_path):
    """On one gloo rank the tp solve's row block is all of P^{-1} and its
    all-gather (the exchange's plain version on the CPU) a copy: an
    episode's states, iteration counts and value-and-grad equal the dense
    step's bit for bit."""
    import torch.distributed as dist
    from diffcloth_tpu_torch.parallel import mesh as pmesh
    scene = tgb.build_scene(caps_cfg(tc))
    pmesh.initialize_distributed("gloo", f"file://{tmp_path}/init", 1, 0)
    try:
        mesh = pmesh.make_mesh(1, 1)
        sim = TorchSim(scene, device="cpu", dtype=F64,
                       solve_fn=pmesh.make_tp_solve(mesh.tp_group))
        ref = TorchSim(scene, device="cpu", dtype=F64)
        p = sim.default_params()
        a = sim.rollout(p).steps
        b = ref.rollout(p).steps
        target = torch.zeros((sim.n_steps + 1, sim.n, 3), dtype=F64)
        loss_fn = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                                  tl.LossInfo(target_x=target))
        pb = p.expand(2).replace(wind=p.wind + torch.tensor(
            [[0.0, 0.0, 0.0], [0.1, 0.0, 0.05]], dtype=F64))
        La, ga = pmesh.batched_value_and_grad(
            sim, loss_fn, mesh, p_inv_spec="tp")(pb, ref.p_inv(p))
        Lb, gb_ = ref.episode_value_and_grad(loss_fn)(pb)
    finally:
        dist.destroy_process_group()
    assert torch.equal(a.x, b.x) and a.iters.tolist() == b.iters.tolist()
    assert torch.equal(La, Lb)
    assert torch.equal(ga.wind, gb_.wind.mean(dim=0))


def test_tp_chunked_objective_of_one_gloo_rank_equals_dense(tmp_path):
    """`batched_value_and_grad(..., chunk=2)` on one gloo rank with the tp
    solve equals the dense sim's chunked value-and-grad bit for bit, every
    episode's gradient; the solves of one group share one gather (its
    regions on a card made once)."""
    import torch.distributed as dist
    from diffcloth_tpu_torch.parallel import exchange
    from diffcloth_tpu_torch.parallel import mesh as pmesh
    scene = tgb.build_scene(caps_cfg(tc))
    pmesh.initialize_distributed("gloo", f"file://{tmp_path}/init", 1, 0)
    try:
        mesh = pmesh.make_mesh(1, 1)
        assert exchange.row_gather(mesh.tp_group) \
            is exchange.row_gather(mesh.tp_group)
        assert exchange.row_gather() is exchange.row_gather(None)
        sim = TorchSim(scene, device="cpu", dtype=F64,
                       solve_fn=pmesh.make_tp_solve(mesh.tp_group))
        ref = TorchSim(scene, device="cpu", dtype=F64)
        p = sim.default_params()
        target = torch.zeros((sim.n_steps + 1, sim.n, 3), dtype=F64)
        loss_fn = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                                  tl.LossInfo(target_x=target))
        pb = p.expand(2).replace(wind=p.wind + torch.tensor(
            [[0.0, 0.0, 0.0], [0.1, 0.0, 0.05]], dtype=F64))
        La, ga = pmesh.batched_value_and_grad(
            sim, loss_fn, mesh, reduce_grads=False, p_inv_spec="tp",
            chunk=2)(pb, ref.p_inv(p))
        Lb, gb_ = ref.episode_value_and_grad_chunked(loss_fn, 2,
                                                     batched=True)(pb)
    finally:
        dist.destroy_process_group()
    assert torch.equal(La, Lb)
    for k, v in gb_.items():
        assert torch.equal(getattr(ga, k), v), k
    assert float(ga.wind.abs().max()) > 0


def test_bind_keeps_static_buffers():
    """Captured, a block's dict holds static buffers: the first bind
    copies, later binds copy in place (same storage), a `once` entry is
    copied only when its source changes (another tensor, or the same one
    written in place), and a shape change raises.  Uncaptured, the dict
    holds the given tensors."""
    g = gr.BlockGraphs(enabled=True)
    a, p = torch.arange(6.0).reshape(2, 3), torch.eye(3)
    st = g.bind("blk", dict(a=a, p=p, none=None), once=("p",))
    buf_a, buf_p = st["a"], st["p"]
    assert buf_a is not a and buf_p is not p and st["none"] is None
    st = g.bind("blk", dict(a=a + 1, p=p), once=("p",))
    assert st["a"] is buf_a and torch.equal(buf_a, a + 1)
    assert st["p"] is buf_p and torch.equal(buf_p, p)
    other = g.bind("other", dict(p=p), once=("p",))
    assert other["p"] is buf_p          # shared across blocks
    buf_p.fill_(0.0)                    # not copied again: same source
    g.bind("blk", dict(p=p), once=("p",))
    assert torch.equal(buf_p, torch.zeros(3, 3))
    p.mul_(2.0)                         # the source written in place
    g.bind("blk", dict(p=p), once=("p",))
    assert torch.equal(buf_p, 2.0 * torch.eye(3))
    q = torch.eye(3) * 3.0              # another source
    g.bind("blk", dict(p=q), once=("p",))
    assert torch.equal(buf_p, q)
    with pytest.raises(ValueError, match="buffer"):
        g.bind("blk", dict(a=torch.zeros(3, 3)))
    u = gr.BlockGraphs(enabled=False)
    st = u.bind("blk", dict(a=a))
    assert st["a"] is a
