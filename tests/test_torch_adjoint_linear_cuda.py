"""The adjoint's linearized K map on the card: its kernels
(`core/adjoint_linear.py`, `csrc/adjoint_linear.cu`) against their plain
versions, the captured adjoint against the uncaptured one, and the fence
that keeps the forward untouched by the adjoint.

These tests need an NVIDIA GPU and skip without one; run them there with

    python -m pytest --noconftest -q tests/test_torch_adjoint_linear_cuda.py

Tolerances: the linearization, `kdv_pre` and `kdv_rows` are exact in f32
(rtol 0, atol 0): each computes its products and sums op for op in the
plain version's order (--fmad=false), and division and square root round
correctly on both.  The linearization's plain version runs on the card's
tensors (PyTorch's CUDA operators, one rounding each): the host's
vectorized f32 square root of PyTorch rounds about 0.4 % of the hinge
norms here one unit in the last place off the correctly rounded one,
where the kernel and numpy agree.  The trip update's sums run in another
order, so its lambda is a copy (exact) and its flags are held where the
deltas sit far from eps.  The linearized product on the card against the autograd one
(`vjp_k`), both f32: within 1e-4 of the largest entry (two orders of
f32 operations through the same derivatives).  The captured adjoint and
the fence: bit for bit.

Shapes: the sphere's (B = 16, n = 625, its state after a few steps of
the demo, in contact with the sphere and with itself), on the sweeps'
shared-slot route and on the streamed-slot route (its drop-free budgets,
(n,) * 16 slots).
"""
import dataclasses

import numpy as np
import pytest
import torch

from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.core import adjoint_linear as al
from diffcloth_tpu_torch.core import friction_cuda as fc
from diffcloth_tpu_torch.core import launch_count as lc
from diffcloth_tpu_torch.optim.helper import GradMask, OptimizeHelper
from diffcloth_tpu_torch.tasks import registry
from diffcloth_tpu_torch.tasks.setup import build_task

from adjoint_entries import adjoint_entries

pytestmark = pytest.mark.cuda
B = 16
# the state the products are taken at: the cloth meets itself by then
STEPS = 300
ROUTES = {"shared": {}, "stream": dict(self_compact_layers=16,
                                       self_compact_budgets=(625,) * 16)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the adjoint's CUDA kernels")
    return torch.device("cuda")


def sphere_task(card, steps, **kw):
    """The sphere demo at its shapes, cut to `steps` steps."""
    scene = dataclasses.replace(registry.DEMOS["sphere"].scene,
                                step_num=steps)
    return build_task("sphere", device=card, scene=scene, **kw)


def candidates():
    return np.linspace(0.05, 0.9, B)[:, None]


def with_mu(params, X):
    """params (B episodes) with the sphere's coefficient from X (B, 1)."""
    mu = params.mu.clone()
    mu[:, 0] = torch.as_tensor(X[:, 0], dtype=mu.dtype, device=mu.device)
    return params.replace(mu=mu)


def cpu(t):
    return None if t is None else t.detach().cpu()


def mismatch(got, want) -> dict:
    """Where two tensors differ: how many entries, the largest difference
    and the first one's value on either side."""
    diff = got != want
    if not bool(diff.any()):
        return {}
    i = int(diff.flatten().nonzero()[0])
    return dict(entries=int(diff.sum()),
                largest=float((got - want).abs().nan_to_num(1e30).max()),
                first=(i, float(got.flatten()[i]), float(want.flatten()[i])))


@pytest.fixture(params=list(ROUTES))
def sphere_step(card, request):
    """(sim, params, the entries of the adjoint program of step STEPS + 1
    of B episodes of the sphere demo, that step's last PD sweep's f): the
    cloth draped and folded on the sphere, the programs uncaptured."""
    task = sphere_task(card, STEPS, cuda_graphs=False,
                       **ROUTES[request.param])
    sim = task.sim
    p = with_mu(task.param_base.expand(B), candidates())
    recs = sim.rollout(p).steps
    x, v = recs.x[:, -1], recs.v[:, -1]
    t = torch.tensor(STEPS * sim.h, dtype=torch.float32, device=card)
    xf = sim.x_fixed_seq(p)[:, -1]
    p_inv = sim.p_inv(p)
    _, _, aux = sim.step(x, v, p, xf, p_inv, t, STEPS + 1)
    st = adjoint_entries(sim, x, v, p, xf, p_inv, t, STEPS + 1)
    assert (st["ops"].slots == "stream") == (request.param == "stream")
    assert int(st["c_mask"].sum()) > 0
    assert int(st["counts"].sum()) > 0
    return sim, p, st, aux.f


def test_linearize_equals_plain(sphere_step):
    sim, p, st, f = sphere_step
    lin = sim.step.lin
    assert lin.split
    y = lin.rows_at(st["x_n"] + sim.h * st["v_new"])
    counts, consts = lin.counts, lin.consts
    obs = (f, st["m"], st["c_normal"], st["c_v_out"], st["c_mask"],
           st["c_prim"], st["mu"])
    before = al.linearize.launches
    jac, jobs = al.linearize(y, *consts, counts, True, obs)
    assert al.linearize.launches == before + 1
    want_jac, want_jobs = map(cpu, al.linearize_plain(
        y, *consts, counts, True, obs))
    T, Bn = counts[:2]
    parts = {"stretch": slice(0, 36 * T),
             "bend": slice(36 * T, 36 * T + 4 * Bn),
             "spring": slice(36 * T + 4 * Bn, None)}
    assert torch.equal(cpu(jac), want_jac), {
        k: mismatch(cpu(jac)[:, sl], want_jac[:, sl])
        for k, sl in parts.items()}
    assert torch.equal(cpu(jobs), want_jobs), mismatch(cpu(jobs), want_jobs)
    # every obstacle case is on the path
    J = want_jobs.reshape(B, -1, 3, 3)
    on = cpu(st["c_mask"])
    zero = (J == 0).all(-1).all(-1)
    stick = (J == -torch.eye(3)).all(-1).all(-1)
    assert int((on & ~zero & ~stick).sum()) > 0 and int(stick.sum()) > 0


def test_trip_kernels_equal_plain(sphere_step):
    sim, p, st, _ = sphere_step
    n = sim.n
    rng = np.random.RandomState(3)
    u = torch.as_tensor(rng.randn(B, n, 3), dtype=torch.float32,
                        device=st["x_n"].device)
    s = fc.friction_sweep_bwd(u, st["kdv_vals"], st["ops"])[0]
    jobs = st["kdv_jobs"]
    for node_major in (True, False):
        zg = al.kdv_pre(u, s, jobs, 2, node_major)
        want = torch.empty((2, B, n, 3))
        al.kdv_pre_plain(cpu(u), cpu(s), cpu(jobs), want)
        assert torch.equal(cpu(zg), want)
    counts = sim.step.lin.counts
    R = 2 * counts[0] + sum(counts[1:])
    rows = torch.as_tensor(rng.randn(R, 2, B, 3), dtype=torch.float32,
                           device=u.device).permute(1, 2, 0, 3)
    h2 = sim.h * sim.h
    for row_major in (True, False):
        q = al.kdv_rows(rows, st["kdv_jac"], st["k_pertype"], h2, counts,
                        True, row_major)
        want = torch.empty((B, R, 3))
        al.kdv_rows_plain(cpu(rows), cpu(st["kdv_jac"]),
                          cpu(st["k_pertype"]), h2, want, counts, True)
        assert torch.equal(cpu(q), want)
    # the product against autograd's, both f32 on the card
    a, b = sim.step.kdv(st, u), sim.step.vjp_k(st, u)
    assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_trip_update_equals_plain(card):
    rng = np.random.RandomState(5)
    n = 625
    lam = torch.as_tensor(rng.randn(B, n, 3), dtype=torch.float32)
    # deltas 1e-3 or 1e-7 per episode against eps 1e-5; one blows up
    step = np.where(rng.rand(B) < 0.5, 1e-3, 1e-7)[:, None, None]
    nxt = lam + torch.as_tensor(step * rng.randn(B, n, 3) * n * 0.01 / 43,
                                dtype=torch.float32)
    nxt[3] = 1e12
    w_norm = torch.ones(B)
    it = torch.as_tensor(rng.randint(1, 5, B), dtype=torch.int32)
    done = torch.as_tensor(rng.rand(B) < 0.25)
    done[3] = False
    bad = torch.zeros(B, dtype=torch.bool)
    bad[7] = True
    args = [lam, nxt, w_norm, it, done, bad,
            torch.zeros(B, dtype=torch.bool)]
    want = [a.clone() for a in args]
    al.trip_update_plain(*want, 1e-5, n / 180.0)
    got = [a.to(card) for a in args]
    # the next iterate as the solve leaves it: node-major in memory
    got[1] = got[1].transpose(0, 1).contiguous().transpose(0, 1)
    al.trip_update(*got, 1e-5, n / 180.0)
    for name, a, b in zip(("lam", "nxt", "w_norm", "it", "done", "bad",
                           "go"), got, want):
        assert torch.equal(cpu(a), b), name
    assert bool(want[5][3]) and not bool(want[4].all())


def value_and_grad(card, graphs, X, steps=6, chunk=3):
    """One sphere value-and-grad of B candidates after a warm-up and a
    capture: (loss, grad, BackwardStats, the kernels' launches)."""
    task = sphere_task(card, steps, cuda_graphs=graphs)
    lf = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                         tl.LossInfo(target_x=task.loss_info.target_x))
    helper = OptimizeHelper(task.sim, GradMask(mu_primitives=(0,)), lf,
                            param_base=task.param_base.expand(B),
                            chunk=chunk)
    for _ in range(2):
        helper.batched_loss_and_grad(X)
    torch.cuda.synchronize()
    task.sim.bwd_stats.reset()
    lc.zero()
    L, G = helper.batched_loss_and_grad(X)
    torch.cuda.synchronize()
    return L, G, task.sim.bwd_stats.summary(), lc.read_all()


def test_captured_adjoint_equals_uncaptured(card):
    X = candidates()
    a = value_and_grad(card, None, X)
    b = value_and_grad(card, False, X)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2] and a[3] == b[3]
    st = a[2]
    assert st["linear_products"] == st["trips"] + st["gmres_matvecs"] > 0
    # the adjoint sweeps forward twice a program, backward once a product
    # and residual VJP
    assert a[3]["kdv_linearize"] == st["residual_vjps"]
    assert a[3]["friction_bwd"] >= st["launches"]


def test_forward_untouched_by_the_adjoint(card):
    """The fence: the forward records of a second value-and-grad (its
    programs captured, the adjoint's programs run before it) equal a fresh
    sim's forward-only chunked rollout of the same candidates bit for
    bit."""
    steps, chunk = 8, 4
    task = sphere_task(card, steps)
    kept = []

    def lf(recs):
        kept.append({k: getattr(recs.steps, k).detach().clone()
                     for k in ("x", "v", "iters")})
        return tl.make_loss_fn(
            tc.LossType.MATCH_TRAJECTORY,
            tl.LossInfo(target_x=task.loss_info.target_x))(recs)

    base = task.param_base.expand(B)
    helper = OptimizeHelper(task.sim, GradMask(mu_primitives=(0,)), lf,
                            param_base=base, chunk=chunk)
    helper.batched_loss_and_grad(candidates())
    X = candidates()[::-1] * 0.9 + 0.02
    kept.clear()
    helper.batched_loss_and_grad(X)
    torch.cuda.synchronize()
    fresh = sphere_task(card, steps).sim
    p = with_mu(base, X)
    recs = fresh.rollout_chunked(p, chunk).steps
    for k, v in kept[0].items():
        assert torch.equal(v, getattr(recs, k)), k
