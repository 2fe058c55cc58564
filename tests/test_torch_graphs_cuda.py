"""The compiled step on the card: each step's loop blocks captured as CUDA
graphs (`cuda_graphs=None`) against the same blocks uncaptured
(`cuda_graphs=False`), bit for bit, and the graphs' bookkeeping.

These tests need an NVIDIA GPU and skip without one; run them there with

    python -m pytest --noconftest -q tests/test_torch_graphs_cuda.py

No tolerance: a graph replays the kernels the uncaptured block launches,
on the same buffers' layouts, so states, iteration counts, losses and
gradients are equal exactly, and so are the kernels' launch counters
(each replay adds its kernels).  tests/test_torch_graphs.py holds the
same blocks to the JAX package on the CPU.
"""
import numpy as np
import pytest
import torch

from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.core import friction_cuda as fc
from diffcloth_tpu_torch.core import graphs as gr
from diffcloth_tpu_torch.core import step as tstep
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.geometry import states

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


def episode(scene, card, graphs, **kw):
    """A folded and a flat episode, then their value-and-grad against a
    zero target; the outputs, the kernels' counters and the graphs."""
    sim = ClothSim(scene, device=card, dtype=torch.float32,
                   cuda_graphs=graphs, **kw)
    x0 = states.folded_grid(scene, GRID // 2,
                            1.5 * float(scene.radii.mean()))
    p = sim.default_params().expand(2)
    p = p.replace(
        x0=torch.as_tensor(np.stack([x0, scene.x_rest]),
                           dtype=torch.float32, device=card),
        wind=torch.as_tensor(WINDS, dtype=torch.float32, device=card))
    fc.friction_sweep.launches = fc.friction_sweep_bwd.launches = 0
    recs = sim.rollout(p).steps
    target = torch.zeros((sim.n_steps + 1, sim.n, 3), device=card)
    lf = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                         tl.LossInfo(target_x=target))
    sim.bwd_stats.reset()
    L, g = sim.episode_value_and_grad(lf)(p)
    torch.cuda.synchronize()
    return (sim, recs, L, g, sim.bwd_stats.summary(),
            (fc.friction_sweep.launches, fc.friction_sweep_bwd.launches))


@pytest.mark.parametrize("path", ["dense", "cg_sparse_sweep"])
def test_graphed_equals_uncaptured(card, path):
    scene = folded_scene()
    kw = LARGE if path == "cg_sparse_sweep" else {}
    sa, ra, La, ga, sta, ka = episode(scene, card, None, **kw)
    sb, rb, Lb, gb_, stb, kb = episode(scene, card, False, **kw)
    assert sa.cuda_graphs and not sb.cuda_graphs
    for k in ("x", "v", "f", "r", "iters", "cg_iters", "converged",
              "selfcol_pairs", "selfcol_slots"):
        assert torch.equal(getattr(ra, k), getattr(rb, k)), k
    assert torch.equal(La, Lb)
    for k, v in ga.items():
        assert torch.equal(v, getattr(gb_, k)), k
    assert sta == stb and ka == kb
    summary = sa.graphs[0].summary()
    assert sb.graphs[0].summary() == {}
    assert sum(b["replays"] for b in summary.values()) > 0
    # every PD block holds one forward sweep per sweep, every trip block
    # one forward and one backward sweep per trip
    for key, b in summary.items():
        if b["replays"] and key[0] in ("pd", "adj"):
            k = key[-1]
            want = {"friction_fwd": k}
            if key[0] == "adj":
                want["friction_bwd"] = k
            assert {n: c for n, c in b["kernels"].items()
                    if not n.endswith("_global")} == want, (key, b)


def test_cg_block_replays_match_pcg(card):
    """The standalone CG blocks (the adjoint's first solve) replayed
    against `step.pcg` called directly: the same iterates and counts."""
    rng = np.random.RandomState(4)
    n = 30
    M = rng.randn(n, n) * 0.3
    A = torch.as_tensor(M @ M.T + np.eye(n) * 2.0, dtype=torch.float32,
                        device=card)
    diag_inv = 1.0 / torch.diagonal(A)
    b = torch.as_tensor(rng.randn(2, n, 3), dtype=torch.float32,
                        device=card)

    def op(u):
        return torch.einsum("ij,bjk->bik", A, u)

    x_ref, it_ref = tstep.pcg(op, b, diag_inv, 22, 1e-6)
    g = gr.BlockGraphs(enabled=True)
    st = g.bind("cg", tstep._cg_start(op, b, diag_inv, 1e-6))
    for _ in range(3):      # warm-up, capture, replays
        st = g.bind("cg", tstep._cg_start(op, b, diag_inv, 1e-6))
        tstep._run_blocks(22, lambda k: g.run(
            ("cg", k), lambda s: tstep._cg_block(op, s, k, 22), st),
            lambda: st["active"])
        assert torch.equal(st["x"], x_ref) and torch.equal(st["it"], it_ref)
    assert sum(b["replays"] for b in g.summary().values()) > 0


def test_failed_capture_raises(card):
    """A block that reads a value on the host cannot be captured: its
    capture (the block's second run) raises instead of running it
    uncaptured."""
    g = gr.BlockGraphs(enabled=True)
    st = g.bind("blk", dict(x=torch.ones(4, device=card)))

    def block(s):
        if float(s["x"].sum()) > 0:      # a host read
            s["x"].mul_(2.0)

    g.run(("blk", 1), block, st)           # the warm-up runs eagerly
    with pytest.raises(RuntimeError):
        g.run(("blk", 1), block, st)
    # the card is usable after it
    torch.cuda.synchronize()
    assert float(torch.ones(2, device=card).sum()) == 2.0
