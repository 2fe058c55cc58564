"""The tracer of the step's device programs (`diffcloth_tpu_torch/utils/
timing.py`) on the CPU: the host span tree of one batched chunked
value-and-grad through `OptimizeHelper`, windows opened and kept by the
`graphs.TIMING` switch, nothing recorded and nothing changed with tracing
off, the idle time given to the innermost span on hand-made intervals, and
the benchmark's readers of the tracer's report on a hand-made one.  The
launches, their events and the loops' device time need the card:
tests/test_torch_graphs_cuda.py::test_traced_window_times_the_loops."""
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.core import graphs as gr
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.optim.helper import GradMask, OptimizeHelper
from diffcloth_tpu_torch.tasks.setup import _prim_struct
from diffcloth_tpu_torch.utils import timing as tm

F64 = torch.float64
CHUNK = 2
STEPS = 6
SPHERE = dict(kind=0, center=(0.0, -1.6, 0.0), radius=1.0, mu=0.5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def tracer_off(monkeypatch):
    """Every test starts and ends with tracing off and no window kept."""
    monkeypatch.setattr(gr, "TIMING", None)
    monkeypatch.setattr(tm, "_last", None)


@pytest.fixture(scope="module")
def helper():
    """A 4 x 4 cloth falling onto a sphere for 6 steps, two friction
    candidates a population evaluation, chunks of 2."""
    scene = gb.build_scene(tc.SceneConfig(
        fabric=tc.FabricConfig(cloth_dim_x=2.0, cloth_dim_y=2.0,
                               k_stiff_stretching=250.0,
                               k_stiff_bending=0.05, grid_num_x=4,
                               grid_num_y=4, density=0.3),
        attachment_points=tc.AttachmentConfig.NO_ATTACHMENTS,
        trajectory=tc.TrajectoryConfig.NO_TRAJECTORY,
        primitive_config=tc.PrimitiveConfig.PLANE_AND_SPHERE,
        wind_config=tc.WindConfig.NO_WIND, time_step=1.0 / 90.0,
        step_num=STEPS, name="trace_sphere"))
    sim = ClothSim(scene, prims=_prim_struct([SPHERE], F64, "cpu"),
                   device="cpu", dtype=F64)
    target = torch.zeros((STEPS + 1, sim.n, 3), dtype=F64)
    lf = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                         tl.LossInfo(target_x=target))
    return OptimizeHelper(sim, GradMask(mu_primitives=(0,)), lf,
                          chunk=CHUNK)


X = np.array([[0.5], [0.1]])


def traced(helper):
    gr.TIMING = []
    try:
        return helper.batched_loss_and_grad(X)
    finally:
        gr.TIMING = None


def test_span_tree_of_a_batched_chunked_evaluation(helper):
    traced(helper)
    w = tm.last_window()
    got = [(s.name, s.parent) for s in w.spans]
    chunks = STEPS // CHUNK
    want = ([("evaluate", -1), ("pack", 0), ("value_and_grad", 0),
             ("p_inv", 2), ("forward", 2)] + [("chunk", 4)] * chunks
            + [("loss", 2), ("backward", 2)])
    back = len(want) - 1
    want += [("recompute", back), ("vjp", back)] * chunks
    want += [("spline_grads", 2), ("unpack", 0)]
    assert got == want
    assert {s.evaluation for s in w.spans} == {0}
    assert w.evaluations == 1 and not w.stack and not w.launches
    for s in w.spans:
        assert s.start <= s.end
        if s.parent >= 0:
            p = w.spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    # siblings follow one another
    for a, b in zip(w.spans, w.spans[1:]):
        if a.parent == b.parent:
            assert a.end <= b.start


def test_tracing_off_records_nothing_and_changes_nothing(helper):
    L_on, G_on = traced(helper)
    kept = tm.last_window()
    n_spans = len(kept.spans)
    L_off, G_off = helper.batched_loss_and_grad(X)
    assert tm.last_window() is kept and len(kept.spans) == n_spans
    assert np.array_equal(L_on, L_off) and np.array_equal(G_on, G_off)
    assert tm.span("evaluate") is tm.span("chunk")


def test_a_new_timing_list_opens_a_new_window():
    assert tm.last_window() is None and tm.last_report() is None
    gr.TIMING = first = []
    with tm.span("evaluate"):
        with tm.span("forward"):
            pass
    w1 = tm.last_window()
    assert w1.timing is first and [s.name for s in w1.spans] == [
        "evaluate", "forward"]
    gr.TIMING = None
    with tm.span("evaluate"):
        pass
    assert tm.last_window() is w1 and len(w1.spans) == 2
    gr.TIMING = []
    with tm.span("evaluate"):
        pass
    w2 = tm.last_window()
    assert w2 is not w1 and len(w2.spans) == 1 and len(w1.spans) == 2
    gr.TIMING = None
    assert tm.last_window() is w2


def test_spans_outside_an_evaluation_have_none():
    gr.TIMING = []
    with tm.span("forward"):
        with tm.span("chunk"):
            pass
    with tm.span("evaluate"):
        with tm.span("pack"):
            pass
    with tm.span("evaluate"):
        pass
    gr.TIMING = None
    w = tm.last_window()
    assert [(s.name, s.parent, s.evaluation) for s in w.spans] == [
        ("forward", -1, -1), ("chunk", 0, -1), ("evaluate", -1, 0),
        ("pack", 2, 0), ("evaluate", -1, 1)]


def test_idle_intervals_complement_the_launches():
    busy = [(2.0, 3.0), (1.0, 1.5), (2.5, 4.0), (9.5, 12.0)]
    assert tm.idle_intervals(busy, 0.0, 10.0) == [
        (0.0, 1.0), (1.5, 2.0), (4.0, 9.5)]
    assert tm.idle_intervals([], 1.0, 2.0) == [(1.0, 2.0)]
    assert tm.idle_intervals([(0.0, 5.0)], 1.0, 2.0) == []


def test_idle_goes_to_the_innermost_span():
    """Two evaluations' spans over [0, 20] and idle intervals inside a
    leaf, across a parent and its child, outside every span and across an
    evaluation's end."""
    S = tm.Span
    spans = [S("evaluate", -1, 0, 1.0, 9.0),
             S("forward", 0, 0, 2.0, 5.0),
             S("chunk", 1, 0, 2.5, 4.0),
             S("backward", 0, 0, 5.0, 8.5),
             S("recompute", 3, 0, 5.5, 6.0),
             S("evaluate", -1, 1, 10.0, math.nan),   # left open,
             S("vjp", 5, 1, 12.0, math.nan)]         # as its child
    idle = [(0.0, 0.5),      # outside every span
            (2.2, 3.0),      # forward 0.3, chunk 0.5
            (5.8, 6.5),      # recompute 0.2, backward 0.5
            (8.8, 10.5),     # evaluate 0.2, between 1.0, evaluate 0.5
            (15.0, 16.0),    # vjp
            (19.5, 20.0)]    # vjp, open to the window's end
    got = tm.attribute_idle(idle, spans, 0.0, 20.0)
    want = {tm.BETWEEN: 1.5, "evaluate": 0.7, "forward": 0.3,
            "chunk": 0.5, "backward": 0.5, "recompute": 0.2, "vjp": 1.5}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12), k
    assert sum(got.values()) == pytest.approx(
        sum(b - a for a, b in idle), abs=1e-12)


def test_report_of_a_window_without_launches(helper):
    """On the CPU nothing is launched: the whole window is idle, given to
    the spans of the evaluation."""
    traced(helper)
    r = tm.last_report()
    assert r["busy_s"] == 0.0 and r["launches"] == {} and r["loops"] == {}
    assert r["evaluations"] == 1 and r["wall_s"] > 0
    assert sum(r["idle_s"].values()) == pytest.approx(r["wall_s"],
                                                      rel=1e-9)
    assert r["idle_s"][tm.BETWEEN] == pytest.approx(0.0, abs=1e-9)
    assert {"chunk", "recompute", "vjp", "loss"} <= set(r["idle_s"])


REPORT = dict(
    wall_s=10.0, busy_s=9.0, evaluations=1,
    launches={"pd": 700, "adj": 350},
    kind_s={"pd": 2.0, "adj": 7.0},
    launch_s={"pd": {"chunk": 1.2, "recompute": 0.8}, "adj": {"vjp": 7.0}},
    idle_s={"chunk": 0.15, "recompute": 0.1, "vjp": 0.5, "loss": 0.05,
            tm.BETWEEN: 0.2},
    loops={"pd": {"pd": dict(runs=700, iters=2800, device_s=1.4)},
           "adj": {"trips": dict(runs=2000, iters=8000, device_s=6.0),
                   "fallback": dict(runs=0, iters=0, device_s=0.0)}})
READ = {"recompute_share_pct": 8.0, "adjoint_share_pct": 70.0,
        "sweep_us": 500.0, "trip_us": 750.0, "pd_outside_loop_pct": 30.0,
        "adj_outside_loop_pct": 100.0 / 7.0, "step_loop_idle_pct": 2.5}


def reader(stem: str):
    path = os.path.join(ROOT, "benchmark", "metrics", stem + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("stem", sorted(READ))
def test_benchmark_reader_of_the_report(stem, monkeypatch):
    """Each reader of the tracer's report on a hand-made one; None where
    the window is empty or the program has no tracer."""
    read = reader(stem)
    monkeypatch.setattr(tm, "last_report", lambda: REPORT)
    assert read({"window_s": 10.0}) == pytest.approx(READ[stem], rel=1e-12)
    monkeypatch.setattr(tm, "last_report", lambda: None)
    assert read({"window_s": 10.0}) is None
    monkeypatch.delattr(tm, "last_report")
    assert read({"window_s": 10.0}) is None
