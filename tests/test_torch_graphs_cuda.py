"""The compiled step on the card: each step's forward and adjoint as
captured device programs whose loops end on the device (`cuda_graphs=None`)
against the same segments uncaptured (`cuda_graphs=False`), bit for bit,
the programs' bookkeeping, the chunked episode, and the GMRES least
squares kernel against its plain version.

These tests need an NVIDIA GPU and skip without one; run them there with

    python -m pytest --noconftest -q tests/test_torch_graphs_cuda.py

No tolerance between the two routes: a program launches the kernels the
uncaptured segments launch, on the same buffers' layouts, so states,
iteration counts, losses and gradients are equal exactly, and so are the
kernels' launch counts (each kernel counts its own launches on the
device).  Each route also repeats itself bit for bit on fresh sims (which
drops the earlier sims' programs: none may be destroyed inside a capture).
tests/test_torch_graphs.py and tests/test_torch_chunked.py hold the same
segments to the JAX package on the CPU.  The least squares kernel (f64 inside) within 1e-10 of its plain
version (gelsd) relative to each episode's largest entry in f64, 1e-6 in
f32 (its output's rounding), 1e-6 where columns near the cutoff make the
problem ill-conditioned.
"""
import numpy as np
import pytest
import torch

from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.core import friction_cuda as fc
from diffcloth_tpu_torch.core import graphs as gr
from diffcloth_tpu_torch.core import launch_count as lc
from diffcloth_tpu_torch.core import lstsq_cuda as lq
from diffcloth_tpu_torch.core import step as tstep
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.geometry import states
from diffcloth_tpu_torch.optim.helper import GradMask, OptimizeHelper
from diffcloth_tpu_torch.tasks.setup import _prim_struct
from diffcloth_tpu_torch.utils import timing as tm

pytestmark = pytest.mark.cuda
GRID = 8
WINDS = np.array([[0.5, 0.05, 0.5], [0.2, 0.0, 0.4]])
LARGE = dict(solve_mode="cg", dense_ops=False, sparse_ops=True,
             self_method="sweep")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs of the step")
    return torch.device("cuda")


def folded_scene(steps=4):
    """The flagship stand-in's physics on a GRID x GRID cloth."""
    return gb.build_scene(tc.SceneConfig(
        fabric=tc.FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                               k_stiff_stretching=550, k_stiff_bending=0.01,
                               grid_num_x=GRID, grid_num_y=GRID,
                               density=0.124),
        attachment_points=tc.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=tc.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=steps, name="folded_graphs"))


def episode(scene, card, graphs, chunk=None, **kw):
    """A folded and a flat episode, then their value-and-grad against a
    zero target (chunked when `chunk` is given); the outputs, the kernels'
    counters and the graphs."""
    sim = ClothSim(scene, device=card, dtype=torch.float32,
                   cuda_graphs=graphs, **kw)
    x0 = states.folded_grid(scene, GRID // 2,
                            1.5 * float(scene.radii.mean()))
    p = sim.default_params().expand(2)
    p = p.replace(
        x0=torch.as_tensor(np.stack([x0, scene.x_rest]),
                           dtype=torch.float32, device=card),
        wind=torch.as_tensor(WINDS, dtype=torch.float32, device=card))
    lc.zero()
    target = torch.zeros((sim.n_steps + 1, sim.n, 3), device=card)
    lf = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                         tl.LossInfo(target_x=target))
    sim.bwd_stats.reset()
    if chunk is None:
        recs = sim.rollout(p).steps
        L, g = sim.episode_value_and_grad(lf)(p)
    else:
        recs = sim.rollout_chunked(p, chunk).steps
        L, g = sim.episode_value_and_grad_chunked(lf, chunk,
                                                  batched=True)(p)
    torch.cuda.synchronize()
    return (sim, recs, L, g, sim.bwd_stats.summary(),
            (fc.friction_sweep.launches, fc.friction_sweep_bwd.launches))


RECORDS = ("x", "v", "f", "r", "iters", "cg_iters", "converged",
           "selfcol_pairs", "selfcol_slots")


def assert_same_episode(a, b, what):
    """Two `episode` results equal bit for bit; a failure names the first
    output that differs, by how much, in how many entries and where."""
    _, ra, La, ga, sta, ka = a
    _, rb, Lb, gb_, stb, kb = b
    pairs = [(f"records.{k}", getattr(ra, k), getattr(rb, k))
             for k in RECORDS]
    pairs.append(("loss", La, Lb))
    pairs += [(f"grad.{k}", v, getattr(gb_, k)) for k, v in ga.items()]
    for name, x, y in pairs:
        if torch.equal(x, y):
            continue
        d = (x.double() - y.double()).abs()
        d = torch.where(torch.isnan(d), torch.inf, d)
        first = np.unravel_index(int(d.flatten().argmax()), tuple(d.shape))
        pytest.fail(f"{what}: {name} {tuple(x.shape)} differs in "
                    f"{int((d != 0).sum())} entries, max |diff| "
                    f"{float(d.max()):.3e} at {first}: {x[first].item()!r} "
                    f"vs {y[first].item()!r}")
    assert sta == stb, f"{what}: adjoint counts {sta} vs {stb}"
    assert ka == kb, f"{what}: (friction_fwd, friction_bwd) launches {ka} " \
                     f"vs {kb}"


@pytest.mark.parametrize("path", ["dense", "cg_sparse_sweep", "chunked"])
def test_graphed_equals_uncaptured(card, path):
    scene = folded_scene()
    kw = LARGE if path == "cg_sparse_sweep" else {}
    chunk = 2 if path == "chunked" else None
    a = episode(scene, card, None, chunk, **kw)
    b = episode(scene, card, False, chunk, **kw)
    sa, sb = a[0], b[0]
    assert sa.cuda_graphs and not sb.cuda_graphs
    assert_same_episode(a, b, "graphed against uncaptured")
    summary = sa.graphs[0].summary()
    assert sb.graphs[0].summary() == {}
    assert sum(b["launches"] for b in summary.values()) > 0
    # every PD body holds one forward sweep per sweep, every trip body one
    # forward and one backward sweep per trip
    for key, b in summary.items():
        for loop in b["loops"]:
            k = loop["every"]
            want = {"pd": {"friction_fwd": k},
                    "trips": {"friction_fwd": k, "friction_bwd": k}}
            if loop["name"] in want:
                assert {n: c for n, c in loop["kernels"].items()
                        if not n.endswith("_global")} == want[
                            loop["name"]], (key, b)


@pytest.mark.parametrize("graphs", [None, False],
                         ids=["graphed", "uncaptured"])
def test_route_repeats_bit_for_bit(card, graphs):
    """Each route alone repeats itself: the chunked episode and its
    value-and-grad on four fresh sims, every output equal to the first
    one's bit for bit."""
    scene = folded_scene()
    first = episode(scene, card, graphs, 2)
    for i in range(1, 4):
        assert_same_episode(first, episode(scene, card, graphs, 2),
                            f"run {i} against run 0")


def test_traced_window_times_the_loops(card):
    """The tracer over two captured population evaluations of a cloth
    falling onto a sphere (chunks of 2): every loop that ran has device
    time, at most its program kind's event seconds; the trip loops'
    iterations are BackwardStats' trips exactly; the idle seconds by host
    span are the window less the launches; the launches carry their
    spans."""
    scene = gb.build_scene(tc.SceneConfig(
        fabric=tc.FabricConfig(cloth_dim_x=2.0, cloth_dim_y=2.0,
                               k_stiff_stretching=250.0,
                               k_stiff_bending=0.05, grid_num_x=GRID,
                               grid_num_y=GRID, density=0.3),
        attachment_points=tc.AttachmentConfig.NO_ATTACHMENTS,
        trajectory=tc.TrajectoryConfig.NO_TRAJECTORY,
        primitive_config=tc.PrimitiveConfig.PLANE_AND_SPHERE,
        wind_config=tc.WindConfig.NO_WIND, time_step=1.0 / 90.0,
        step_num=8, name="trace_sphere"))
    sphere = dict(kind=0, center=(0.0, -1.6, 0.0), radius=1.0, mu=0.5)
    sim = ClothSim(scene, prims=_prim_struct([sphere], torch.float32, card),
                   device=card, dtype=torch.float32)
    target = torch.zeros((sim.n_steps + 1, sim.n, 3), device=card)
    lf = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                         tl.LossInfo(target_x=target))
    helper = OptimizeHelper(sim, GradMask(mu_primitives=(0,)), lf, chunk=2)
    X = np.array([[0.5], [0.1]])
    for _ in range(2):      # the warm-ups, then the captures
        helper.batched_loss_and_grad(X)
    torch.cuda.synchronize()
    sim.bwd_stats.reset()
    for g in sim.graphs:
        g.reset()
    gr.TIMING = timing = []
    try:
        for _ in range(2):
            helper.batched_loss_and_grad(X)
        torch.cuda.synchronize()
    finally:
        gr.TIMING = None
    r = tm.last_report()
    assert r["evaluations"] == 2 and len(timing) == sum(
        r["launches"].values()) == 2 * 3 * sim.n_steps
    assert set(r["launch_s"]["pd"]) == {"chunk", "recompute"}
    assert set(r["launch_s"]["adj"]) == {"vjp"}
    assert r["busy_s"] == pytest.approx(sum(
        a.elapsed_time(b) for a, b in timing) / 1e3, rel=1e-9)
    assert sum(r["idle_s"].values()) == pytest.approx(
        r["wall_s"] - r["busy_s"], abs=1e-3 * r["wall_s"])
    assert r["loops"]["adj"]["trips"]["iters"] == \
        sim.bwd_stats.summary()["trips"] > 0
    for kind, loops in r["loops"].items():
        for name, lp in loops.items():
            if lp["runs"]:
                assert 0 < lp["device_s"] <= r["kind_s"][kind], (kind, name)
            else:
                assert lp["device_s"] == 0, (kind, name)
    # the programs' own summaries read the same counters
    for key, b in sim.graphs[0].summary().items():
        for lp in b["loops"]:
            assert (lp["device_s"] > 0) == (lp["runs"] > 0), (key, lp)


def cg_problem(card):
    rng = np.random.RandomState(4)
    n = 30
    M = rng.randn(n, n) * 0.3
    A = torch.as_tensor(M @ M.T + np.eye(n) * 2.0, dtype=torch.float32,
                        device=card)
    diag_inv = 1.0 / torch.diagonal(A)
    b = torch.as_tensor(rng.randn(2, n, 3), dtype=torch.float32,
                        device=card)
    return (lambda u: torch.einsum("ij,bjk->bik", A, u)), b, diag_inv


def test_cg_block_replays_match_pcg(card):
    """Jacobi-PCG as a program (a start segment, then a loop of CG blocks
    that ends on the device) against `step.pcg` called directly: the same
    iterates and counts; the loop's body runs counted on the device."""
    op, b, diag_inv = cg_problem(card)
    x_ref, it_ref = tstep.pcg(op, b, diag_inv, 22, 1e-6)
    g = gr.BlockGraphs(enabled=True)
    st = g.bind("cg", dict(b=b))

    def start(s):
        g.store(s, tstep._cg_start(op, s["b"], diag_inv, 1e-6))
        g.store(s, dict(go=s["active"].clone()))

    def block(s, k):
        tstep._cg_block(op, s, k, 22)
        s["go"].copy_(s["active"])

    for _ in range(3):      # warm-up, capture and launch, launch
        g.program("cg", (start, gr.Loop(block, 22, tstep.CHECK_EVERY)), st)
        assert torch.equal(st["x"], x_ref) and torch.equal(st["it"], it_ref)
    summary = g.summary()["cg"]
    assert summary["launches"] == 2
    runs = sum(lp["runs"] for lp in summary["loops"])
    assert runs == 2 * -(-int(it_ref.max()) // tstep.CHECK_EVERY)


def test_failed_capture_raises(card):
    """A segment that reads a value on the host cannot be captured: its
    capture (the program's second run) raises instead of running it
    uncaptured."""
    g = gr.BlockGraphs(enabled=True)
    st = g.bind("blk", dict(x=torch.ones(4, device=card)))

    def segment(s):
        if float(s["x"].sum()) > 0:      # a host read
            s["x"].mul_(2.0)

    g.program("blk", (segment,), st)       # the warm-up runs eagerly
    with pytest.raises(RuntimeError):
        g.program("blk", (segment,), st)
    # the card is usable after it
    torch.cuda.synchronize()
    assert float(torch.ones(2, device=card).sum()) == 2.0


def test_chunk_forward_holds_no_host_sync(card):
    """Once its programs are built, a chunk's forward makes no
    synchronizing call (PyTorch's sync debug mode raises on one)."""
    scene = folded_scene()
    sim = ClothSim(scene, device=card, dtype=torch.float32)
    p = sim.default_params().expand(2)
    xfs = sim.x_fixed_seq(p)
    p_inv = sim.p_inv(p)
    for _ in range(2):     # warm-up and capture
        sim._chunk_forward(p, p_inv, xfs, 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cols, _ = sim._chunk_forward(p, p_inv, xfs, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = sim.rollout(p).steps
    assert torch.equal(cols["x"], ref.x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lstsq_kernel_matches_plain(card, dtype):
    """The GMRES least squares kernel against its plain version on random,
    happy-breakdown and near-cutoff Hessenbergs, and a non-finite one."""
    rng = np.random.RandomState(0)
    m, B = 16, 64
    H = np.triu(rng.randn(B, m + 1, m), -1)
    for i in range(1, B, 3):
        j = rng.randint(m)
        H[i, j + 1, j] = 0.0
        H[i, j + 1:, j + 1:] = 0.0
    for i in range(2, B, 3):
        H[i, :, -3:] *= 1e-9
    H[0, 0, 0] = np.nan
    e1 = np.zeros((B, m + 1))
    e1[:, 0] = rng.rand(B) + 0.1
    Ht = torch.as_tensor(H, dtype=dtype, device=card)
    bt = torch.as_tensor(e1, dtype=dtype, device=card)
    rcond = torch.finfo(dtype).eps * (m + 1)
    before = lq.hessenberg_lstsq.launches
    y = lq.hessenberg_lstsq(Ht, bt, rcond)
    assert lq.hessenberg_lstsq.launches == before + 1
    ref = lq.hessenberg_lstsq_plain(Ht.cpu(), bt.cpu(), rcond)
    assert bool(torch.isnan(y[0]).all()) and bool(torch.isnan(ref[0]).all())
    y, ref = y[1:].double().cpu(), ref[1:].double()
    err = (y - ref).abs().amax(1) / ref.abs().amax(1)
    tol = torch.full_like(err, 1e-10 if dtype == torch.float64 else 1e-6)
    tol[1::3] = 1e-6      # near-cutoff columns (rows 2, 5, ... of H)
    assert bool((err <= tol).all()), err.max()
