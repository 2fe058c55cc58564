"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and `nvcc` (the kernels build at first use)
and skip without a card.  The repository's tests/conftest.py imports JAX,
which the machine with the card may lack, so run them there with

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances: detection tables are exact (the kernel computes d^2 in the
plain version's order without contraction); its cases cover the main
path's shape, K = 32 with rows whose hits outgrow the kernel's per-row
list, exact ties across lanes on a lattice, NaN and inf positions, one
sample, overflow in both of two segments, and three segments.  The
friction sweeps, forward
and backward, are exact too (rtol 0, atol 0): both compute every slot op
for op (--fmad=false), and a layer is a matching, so each row and each
partner receives a single add per layer, in the plain version's order; the
cases cover states whose rows are not 16-byte aligned (n % 4 != 0, the
kernels' plain-load path beside the bulk copies), two-layer budgets, one
sample, and a batch without contact; the global-state route (a state past
shared memory, n > 15 226) at n = 15 227 (rows not 16-byte aligned),
16 384 and 20 001, and the last shared-route width; the streamed-slot
routes (slot rows past shared memory, state shared or global) at the
flagship's drop-free budgets (n,) * 16 and at n = 16 384 and 20 001 with
raised budgets, contact in four layers: narrow and wide layers, counts
of whole 128-slot chunks and counts that are not multiples of 4, empty
layers between full ones, layers past the force buffer; and detection at K = 40
and 64 (the kernel's second instantiation) with overflow rows.  The f64 card episode
is held within
1e-6 of the CPU one, the f32 friction sweep inside the f64 simulation
being the only inexact step.
"""
import dataclasses

import numpy as np
import pytest
import torch

from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch.core import friction_cuda as fc
from diffcloth_tpu_torch.core import selfcol_cuda as scd
from diffcloth_tpu_torch.core.selfcol import (SelfContactTables,
                                              compact_slot_budgets)
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.geometry import states

pytestmark = pytest.mark.cuda
H = 0.05


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def cloud(seed, n, B, pile=0):
    """B random clouds of n particles with large radii (many contacts over
    several layers); `pile` far-apart particles of sample 0 stacked on one
    point make overflow rows."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, n, 3) * 0.5
    if pile:
        idx = np.arange(0, n, n // pile)[:pile]
        x[0, idx] = x[0, idx[0]]
    v = rng.randn(B, n, 3) * 0.3
    radii = rng.rand(n) * 0.1 + 0.05
    conn = np.zeros((n, n), bool)
    for a, b in rng.randint(0, n, (n // 2, 2)):
        conn[a, b] = conn[b, a] = True
    allowed = ~conn & ~np.eye(n, dtype=bool)
    area = rng.rand(n) + 0.2
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    return f32(x), f32(v), f32(radii), allowed, f32(area)


def lattice(n, B):
    """Two layers of a 32-wide square lattice, spacing and layer gap 0.25,
    radii 0.3, at rest: every d^2 is exact in f32, so a row's hits tie in
    groups (up to 20 in its layer, 13 in the other) at columns that fall to
    different lanes of the kernel.  Sample b is shifted by 0.5 b in x
    (exact)."""
    half = (n + 1) // 2
    i = np.arange(n)
    j = i % half
    x = np.stack([(j % 32) * 0.25, (j // 32) * 0.25, (i // half) * 0.25], -1)
    x = x[None] + np.array([0.5, 0.0, 0.0]) * np.arange(B)[:, None, None]
    rng = np.random.RandomState(2)
    conn = np.zeros((n, n), bool)
    for a, b in rng.randint(0, n, (n // 2, 2)):
        conn[a, b] = conn[b, a] = True
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    return (f32(x), f32(np.zeros((B, n, 3))), f32(np.full(n, 0.3)),
            ~conn & ~np.eye(n, dtype=bool))


def nonfinite(n, B):
    """Random clouds whose sample 0 has NaN, +inf and -inf positions and
    NaN velocities beside finite ones."""
    x, v, radii, allowed, _ = cloud(1, n, B, 20)
    x[0, 0:5] = float("nan")
    x[0, 5:10, 0] = float("inf")
    x[0, 10:15, 1] = -float("inf")
    v[0, 15:20] = float("nan")
    return x, v, radii, allowed


def segment_hits(geom, allowed):
    """(B, n_pad, segments) hit counts, in the plain version's f32
    arithmetic."""
    def d2(row0):
        out = None
        for c in range(row0, row0 + 3):
            diff = geom[:, c, :, None] - geom[:, c, None, :]
            out = diff * diff if out is None else out + diff * diff
        return out
    reach = geom[:, 6, :, None] + geom[:, 6, None, :]
    hit = (torch.minimum(d2(0), d2(3)) < reach * reach) & (allowed[None] > 0)
    B, n_pad, _ = hit.shape
    return hit.reshape(B, n_pad, -1, scd.SEGMENT).sum(-1)


DETECT_CASES = {
    # inputs, n, B, K, overflow pile
    "flagship_width": ("cloud", 1024, 8, 8, 20),
    "straddle": ("cloud", 600, 3, 4, 0),
    "small_overflow": ("cloud", 130, 2, 3, 12),
    # the main path's shape
    "main_path": ("cloud", 1024, 32, 8, 20),
    # 200 piled particles: about 100 hits per segment, more than a row's
    # list in the kernel holds (64)
    "max_k": ("cloud", 1024, 4, 32, 200),
    "lattice_ties": ("lattice", 1024, 4, 8, 0),
    "nan_inf": ("nonfinite", 1024, 3, 8, 0),
    "n512_B1": ("cloud", 512, 1, 8, 20),
    # rows with more than K hits in both segments, tied
    "overflow_both_segments": ("lattice", 600, 3, 4, 0),
    # three segments: each geometry buffer is staged twice
    "three_segments": ("cloud", 1300, 2, 8, 30),
    # K past 32: the kMaxK = 128 instantiation, rows past K and past 64
    "k64_pile": ("cloud", 1024, 4, 64, 200),
    # K = 127, the JAX kernel's bound: 400 piled particles, about 200 hits
    # per segment, more than a row's list holds at that K (160)
    "k127_pile": ("cloud", 1024, 4, scd.MAX_K, 400),
    "k40_three_segments": ("cloud", 1300, 2, 40, 120),
}


@pytest.mark.parametrize("case", sorted(DETECT_CASES))
def test_detection_kernel_equals_plain(dev, case):
    kind, n, B, K, pile = DETECT_CASES[case]
    if kind == "cloud":
        x, v, radii, allowed, _ = cloud(1, n, B, pile)
    else:
        x, v, radii, allowed = {"lattice": lattice,
                                "nonfinite": nonfinite}[kind](n, B)
    n_pad = scd.round_up(n, scd.SEGMENT)
    allowed_d = torch.as_tensor(scd.pack_allowed(allowed), device=dev)
    geom = scd.build_geom(x.to(dev), v.to(dev), radii.to(dev), H, n_pad)
    before = scd.detect_partners.launches
    tab_k = scd.detect_partners(geom, allowed_d, K)
    assert scd.detect_partners.launches == before + 1
    tab_p = scd.detect_partners_plain(geom, allowed_d, K)
    torch.cuda.synchronize()
    assert torch.equal(tab_k, tab_p)
    assert (tab_k[:, :n, :K] >= 0).any()
    seg_hits = segment_hits(geom, allowed_d)
    assert torch.equal(seg_hits.sum(-1) > 0, tab_k[..., K] > 0)
    if pile or kind == "lattice":
        assert (tab_k[:, :n, K] > K).any(), "case has no overflow row"
    if case in ("max_k", "k127_pile"):
        assert (seg_hits > K + 32).any(), "no row outgrows the kernel's list"
    if case == "overflow_both_segments":
        assert ((seg_hits > K).all(-1)).any(), "no row overflows twice"
    if kind == "nonfinite":
        assert (tab_k[0, :20, K] == 0).all()
    one = scd.detect_partners(geom[0].contiguous(), allowed_d, K)
    assert torch.equal(one, tab_k[0])


@pytest.mark.parametrize("budgets", ["default", "drop"])
@pytest.mark.parametrize("B", [1, 5])
def test_friction_kernel_matches_plain(dev, budgets, B):
    n = 200
    x, v, radii, allowed, area = cloud(2, n, B)
    bud = (tuple(min(c, n) for c in compact_slot_budgets(4))
           if budgets == "default" else (8, 4))
    allowed_d = torch.as_tensor(scd.pack_allowed(allowed), device=dev)
    xd = x.to(dev)
    tables, _ = scd.detect_tables(allowed_d, radii.to(dev), xd, v.to(dev),
                                  H, 8, 16)
    kg = fc.build_kernel_geom(tables, area.to(dev), n, bud, x=xd)
    assert int(kg.counts.sum()) > 0
    if budgets == "drop":
        assert bool(kg.overflow.any()), "forced budgets dropped nothing"
    rho = torch.full((B,), 0.3, device=dev)
    kred, imr, imp = fc.slot_masses(kg, rho)
    f = torch.as_tensor(np.random.RandomState(3).randn(B, n, 3) * 0.1,
                        dtype=torch.float32, device=dev)
    ops = fc.sweep_operands(kg, (kred, imr, imp), bud, n)
    before = fc.friction_sweep.launches
    out_k, vals_k = fc.friction_sweep(f, ops)
    assert fc.friction_sweep.launches == before + 1
    out_p, vals_p = fc.friction_sweep_plain(f, kg, kred, imr, imp, bud)
    torch.cuda.synchronize()
    assert float((out_p - f).abs().max()) > 0, "friction never acted"
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=0)
    torch.testing.assert_close(vals_k, vals_p, rtol=0, atol=0)


def sweep_inputs(dev, n, B, bud, pile=0):
    """Slot geometry, masses and a forward force state on the card."""
    x, v, radii, allowed, area = cloud(2, n, B, pile)
    allowed_d = torch.as_tensor(scd.pack_allowed(allowed), device=dev)
    xd = x.to(dev)
    tables, _ = scd.detect_tables(allowed_d, radii.to(dev), xd, v.to(dev),
                                  H, 8, 16)
    kg = fc.build_kernel_geom(tables, area.to(dev), n, bud, x=xd)
    rho = torch.full((B,), 0.3, device=dev)
    f = torch.as_tensor(np.random.RandomState(3).randn(B, n, 3) * 0.1,
                        dtype=torch.float32, device=dev)
    return kg, fc.slot_masses(kg, rho), f


@pytest.mark.parametrize("budgets", ["default", "drop"])
@pytest.mark.parametrize("B", [1, 5])
def test_friction_bwd_kernel_matches_plain(dev, budgets, B):
    n = 200
    bud = (tuple(min(c, n) for c in compact_slot_budgets(4))
           if budgets == "default" else (8, 4))
    kg, (kred, imr, imp), f = sweep_inputs(dev, n, B, bud, pile=20)
    assert int(kg.counts.sum()) > 0
    if budgets == "drop":
        assert bool(kg.overflow.any()), "forced budgets dropped nothing"
    _, vals = fc.friction_sweep_plain(f, kg, kred, imr, imp, bud)
    g = torch.as_tensor(np.random.RandomState(4).randn(B, n, 3),
                        dtype=torch.float32, device=dev)
    ops = fc.sweep_operands(kg, (kred, imr, imp), bud, n)
    before = fc.friction_sweep_bwd.launches
    out_k = fc.friction_sweep_bwd(g, vals, ops)
    assert fc.friction_sweep_bwd.launches == before + 1
    out_p = fc.friction_sweep_bwd_plain(g, kg, kred, imr, imp, vals, bud)
    torch.cuda.synchronize()
    assert float((out_p[0] - g).abs().max()) > 0, "friction never acted"
    for a, b in zip(out_k, out_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


SWEEP_CASES = {
    # n, B, budgets, every count zeroed
    "n201_B3_default": (201, 3, "default", False),
    "n625_B4_default": (625, 4, "default", False),
    "n201_B3_two_layers": (201, 3, (128, 64), False),
    "n625_B1_two_layers": (625, 1, (128, 64), False),
    "n200_B5_no_contact": (200, 5, "default", True),
    "n625_B2_no_contact": (625, 2, (128, 64), True),
}


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_friction_kernels_equal_plain_at_any_width(dev, case):
    """Both sweeps, forward then backward at the forward's selects, equal
    their plain versions exactly: unaligned sample bases (n % 4 != 0, B >
    1), two-layer budgets, one sample, and every count zero (each block
    only carries its state through and writes zero slot rows)."""
    n, B, bud, empty = SWEEP_CASES[case]
    if bud == "default":
        bud = tuple(min(c, n) for c in compact_slot_budgets(4))
    kg, masses, f = sweep_inputs(dev, n, B, bud)
    if empty:
        kg = dataclasses.replace(kg, counts=torch.zeros_like(kg.counts))
    else:
        assert int(kg.counts.sum()) > 0
    ops = fc.sweep_operands(kg, masses, bud, n)
    launches = fc.friction_sweep.launches, fc.friction_sweep_bwd.launches
    out_k, vals_k = fc.friction_sweep(f, ops)
    g = torch.as_tensor(np.random.RandomState(6).randn(B, n, 3),
                        dtype=torch.float32, device=dev)
    bwd_k = fc.friction_sweep_bwd(g, vals_k, ops)
    assert (fc.friction_sweep.launches, fc.friction_sweep_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    out_p, vals_p = fc.friction_sweep_plain(f, kg, *masses, bud)
    bwd_p = fc.friction_sweep_bwd_plain(g, kg, *masses, vals_p, bud)
    torch.cuda.synchronize()
    for a, b in zip((out_k, vals_k) + bwd_k, (out_p, vals_p) + bwd_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if empty:
        assert torch.equal(out_k, f) and torch.equal(bwd_k[0], g)
        assert not any(bool(t.any()) for t in (vals_k,) + bwd_k[1:])
    else:
        assert float((out_p - f).abs().max()) > 0, "friction never acted"


def matching_tables(n, B, seed, pairs=(400, 150, 70, 40), layers=None):
    """Layers of random matchings of `pairs` pairs each (by default four,
    each over its default slot budget), in `layers` (by default the
    first)."""
    rng = np.random.RandomState(seed)
    partner = np.full((B, 16, n), -1, np.int64)
    for b in range(B):
        for lay, count in zip(layers or range(len(pairs)), pairs):
            perm = rng.permutation(n)[:2 * count]
            i, j = perm[:count], perm[count:]
            partner[b, lay, i] = j
            partner[b, lay, j] = i
    return SelfContactTables(partner=torch.as_tensor(partner),
                             n_layers=torch.full((B,), len(pairs)))


GLOBAL_CASES = {
    # n, B, every count zeroed, the route sweep_operands must pick
    "n15226_B2_shared": (15226, 2, False, "shared"),
    "n15227_B3_global_unaligned": (15227, 3, False, "global"),
    "n16384_B2_global": (16384, 2, False, "global"),
    "n20001_B1_global_no_contact": (20001, 1, True, "global"),
}


@pytest.mark.parametrize("case", sorted(GLOBAL_CASES))
def test_friction_kernels_equal_plain_past_shared_memory(dev, case):
    """Both sweeps on the route sweep_operands picks for the width, equal to
    their plain versions exactly; the global-state route counts its
    launches."""
    n, B, empty, route = GLOBAL_CASES[case]
    bud = tuple(min(c, n) for c in compact_slot_budgets(4))
    rng = np.random.RandomState(n)
    x = torch.as_tensor(rng.randn(B, n, 3), dtype=torch.float32, device=dev)
    tables = matching_tables(n, B, n)
    tables = SelfContactTables(partner=tables.partner.to(dev),
                               n_layers=tables.n_layers.to(dev))
    area = torch.as_tensor(rng.rand(n) + 0.2, dtype=torch.float32,
                           device=dev)
    kg = fc.build_kernel_geom(tables, area, n, bud, x=x)
    if empty:
        kg = dataclasses.replace(kg, counts=torch.zeros_like(kg.counts))
    masses = fc.slot_masses(kg, torch.full((B,), 0.3, device=dev))
    f = torch.as_tensor(rng.randn(B, n, 3) * 0.1, dtype=torch.float32,
                        device=dev)
    g = torch.as_tensor(rng.randn(B, n, 3), dtype=torch.float32, device=dev)
    ops = fc.sweep_operands(kg, masses, bud, n)
    assert ops.route == route
    before = fc.friction_sweep.global_launches, \
        fc.friction_sweep_bwd.global_launches
    out_k, vals_k = fc.friction_sweep(f, ops)
    bwd_k = fc.friction_sweep_bwd(g, vals_k, ops)
    step = int(route == "global")
    assert (fc.friction_sweep.global_launches,
            fc.friction_sweep_bwd.global_launches) == (before[0] + step,
                                                       before[1] + step)
    out_p, vals_p = fc.friction_sweep_plain(f, kg, *masses, bud)
    bwd_p = fc.friction_sweep_bwd_plain(g, kg, *masses, vals_p, bud)
    torch.cuda.synchronize()
    for a, b in zip((out_k, vals_k) + bwd_k, (out_p, vals_p) + bwd_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if empty:
        assert torch.equal(out_k, f) and torch.equal(bwd_k[0], g)
    else:
        assert float((out_p - f).abs().max()) > 0, "friction never acted"
        assert float((bwd_p[0] - g).abs().max()) > 0


def test_friction_sweep_autograd_on_card(dev):
    """FrictionSweep's backward (the kernel) against autograd of the plain
    forward on the same card tensors."""
    n, B = 200, 3
    bud = tuple(min(c, n) for c in compact_slot_budgets(4))
    kg, masses, f = sweep_inputs(dev, n, B, bud)
    g = torch.as_tensor(np.random.RandomState(5).randn(B, n, 3),
                        dtype=torch.float32, device=dev)
    fk = f.clone().requires_grad_(True)
    fp = f.clone().requires_grad_(True)
    mk = [m.clone().requires_grad_(True) for m in masses]
    mp = [m.clone().requires_grad_(True) for m in masses]
    ops = fc.sweep_operands(kg, mk, bud, n)
    out_k = fc.FrictionSweep.apply(fk, *ops.masses, ops)
    out_p, _ = fc.friction_sweep_plain(fp, kg, *mp, bud)
    gk = torch.autograd.grad(out_k, [fk] + mk, g)
    gp = torch.autograd.grad(out_p, [fp] + mp, g)
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    n = 64
    x, v, radii, allowed, area = cloud(4, n, 2)
    allowed_d = torch.as_tensor(scd.pack_allowed(allowed), device=dev)
    geom = scd.build_geom(x.to(dev), v.to(dev), radii.to(dev), H, 512)
    with pytest.raises(ValueError):
        scd.detect_partners(geom[..., :256].contiguous(),
                            allowed_d[:256, :256].contiguous(), 8)
    with pytest.raises(ValueError):
        scd.detect_partners(geom.double(), allowed_d, 8)
    with pytest.raises(ValueError):
        scd.detect_partners(geom, allowed_d, scd.MAX_K + 1)
    # the kernel stages geometry by TMA: a base off 16 bytes is refused
    shifted = torch.empty(geom.numel() + 1, device=dev)[1:].view_as(geom)
    with pytest.raises(ValueError):
        scd.detect_partners(shifted.copy_(geom), allowed_d, 8)
    tables, _ = scd.detect_tables(allowed_d, radii.to(dev), x.to(dev),
                                  v.to(dev), H, 8, 16)
    bud = (64, 64)
    kg = fc.build_kernel_geom(tables, area.to(dev), n, bud, x=x.to(dev))
    kred, imr, imp = fc.slot_masses(kg, torch.full((2,), 0.3, device=dev))
    with pytest.raises(ValueError):
        fc.sweep_operands(kg, (kred.double(), imr, imp), bud, n)
    with pytest.raises(ValueError):
        fc.sweep_operands(kg, (kred.cpu(), imr, imp), bud, n)
    ops = fc.sweep_operands(kg, (kred, imr, imp), bud, n)
    f = torch.zeros((2, n, 3), device=dev)
    with pytest.raises(ValueError):
        fc.friction_sweep(f.double(), ops)
    with pytest.raises(ValueError):
        fc.friction_sweep(f.transpose(0, 1).contiguous().transpose(0, 1),
                          ops)
    with pytest.raises(ValueError):
        fc.friction_sweep(f.cpu(), ops)
    vals = torch.zeros((2, 6, kg.idx_row.shape[1]), device=dev)
    with pytest.raises(ValueError):
        fc.friction_sweep_bwd(f, vals[:, :3], ops)
    with pytest.raises(ValueError):
        fc.friction_sweep_bwd(f.double(), vals, ops)


def test_folded_episode_on_card_matches_cpu(dev):
    cfg = tc.SceneConfig(
        fabric=tc.FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                               k_stiff_stretching=550, k_stiff_bending=0.01,
                               grid_num_x=10, grid_num_y=10, density=0.124),
        attachment_points=tc.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=tc.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=6, name="folded_wind_grid")
    scene = gb.build_scene(cfg)
    x0 = states.folded_grid(scene, 5, 1.5 * float(scene.radii.mean()))
    out = {}
    for d in ("cuda", "cpu"):
        sim = ClothSim(scene, device=d, dtype=torch.float64)
        p = sim.default_params().expand(2)
        p = p.replace(x0=torch.as_tensor(np.stack([x0, scene.x_rest]),
                                         dtype=torch.float64,
                                         device=sim.device),
                      wind=torch.tensor([[0.5, 0.05, 0.5], [0.2, 0.0, 0.4]],
                                        dtype=torch.float64,
                                        device=sim.device))
        out[d] = sim.rollout(p).steps
    g, c = out["cuda"], out["cpu"]
    assert int(c.selfcol_pairs[0, 0]) > 0
    for f in dataclasses.fields(c):
        a, b = getattr(g, f.name).cpu(), getattr(c, f.name)
        if f.name == "iters":
            assert int((a - b).abs().max()) <= 1
        elif a.dtype == torch.bool or not a.is_floating_point():
            assert torch.equal(a, b), f.name
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


STREAM_PAIRS = (400, 300, 150, 70)
STREAM_CASES = {
    # n, B, budgets, route taken (state, slots), every count zeroed; then
    # pairs per layer and their layers where they are not STREAM_PAIRS in
    # layers 0-3
    "n1024_B4_dropfree": (1024, 4, (1024,) * 16, ("shared", "stream"),
                          False),
    "n1023_B3_dropfree_unaligned": (1023, 3, (1023,) * 16,
                                    ("shared", "stream"), False),
    "n1024_B2_dropfree_no_contact": (1024, 2, (1024,) * 16,
                                     ("shared", "stream"), True),
    "n16384_B2_raised": (16384, 2, (4096,) * 4, ("shared", "stream"),
                         False),
    "n20001_B1_raised": (20001, 1, (4096,) * 4, ("global", "stream"),
                         False),
    "n20001_B3_raised": (20001, 3, (4096,) * 4, ("global", "stream"),
                         False),
    "n19500_B2_dropfree": (19500, 2, (19500,) * 16, ("global", "stream"),
                           False),
    # counts 402, 194, 302, 126 (none a multiple of 4 or 128) with empty
    # layers between them
    "n1024_B2_dropfree_gaps_odd_counts": (
        1024, 2, (1024,) * 16, ("shared", "stream"), False,
        (201, 97, 151, 63), (0, 3, 7, 15)),
    # counts of whole 128-slot chunks (768, 384, 128) and a narrow layer
    "n1024_B3_dropfree_whole_pieces": (
        1024, 3, (1024,) * 16, ("shared", "stream"), False,
        (384, 192, 64, 30)),
    # a layer of 4002 slots past both force buffers (the scratch)
    "n16384_B2_raised_scratch": (16384, 2, (4096,) * 4,
                                 ("shared", "stream"), False,
                                 (2001, 700, 150, 33)),
    # the global-state route with 7400 slots past the backward's buffer
    "n19500_B1_dropfree_scratch": (19500, 1, (19500,) * 16,
                                   ("global", "stream"), False,
                                   (3700, 301, 40, 7), (0, 5, 6, 15)),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_friction_kernels_equal_plain_with_streamed_slots(dev, case):
    """Slot rows past shared memory: sweep_operands streams them, each
    kernel's forces in a shared-memory buffer (the state in shared memory
    where it fits, else in global memory), and both sweeps equal
    their plain versions exactly, with contact in four layers; each counts
    its launch on the streamed route (and the global-state one where the
    state is global)."""
    n, B, bud, route, empty, *layout = STREAM_CASES[case]
    pairs, layers = (tuple(layout) + (None,))[:2] if layout else (
        STREAM_PAIRS, None)
    rng = np.random.RandomState(n + B)
    x = torch.as_tensor(rng.randn(B, n, 3), dtype=torch.float32, device=dev)
    tables = matching_tables(n, B, n, pairs=pairs, layers=layers)
    tables = SelfContactTables(partner=tables.partner.to(dev),
                               n_layers=tables.n_layers.to(dev))
    area = torch.as_tensor(rng.rand(n) + 0.2, dtype=torch.float32,
                           device=dev)
    kg = fc.build_kernel_geom(tables, area, n, bud, x=x)
    assert not bool(kg.overflow.any())
    if empty:
        kg = dataclasses.replace(kg, counts=torch.zeros_like(kg.counts))
    masses = fc.slot_masses(kg, torch.full((B,), 0.3, device=dev))
    f = torch.as_tensor(rng.randn(B, n, 3) * 0.1, dtype=torch.float32,
                        device=dev)
    g = torch.as_tensor(rng.randn(B, n, 3), dtype=torch.float32, device=dev)
    ops = fc.sweep_operands(kg, masses, bud, n)
    assert (ops.route, ops.slots) == route
    widest = 2 * max(pairs)
    if case.endswith("_scratch"):
        assert widest > ops.bufs["bwd"]
        assert fc.stream_scratch(ops, "bwd") is not None
    if case.endswith("_whole_pieces"):
        assert widest % fc.CHUNK == 0 and widest <= ops.bufs["bwd"]
    counters = (fc.friction_sweep, fc.friction_sweep_bwd)
    before = [(c.launches, c.stream_launches, c.global_launches)
              for c in counters]
    out_k, vals_k = fc.friction_sweep(f, ops)
    bwd_k = fc.friction_sweep_bwd(g, vals_k, ops)
    glob = int(route[0] == "global")
    assert [(c.launches, c.stream_launches, c.global_launches)
            for c in counters] == [(a + 1, s + 1, gl + glob)
                                   for a, s, gl in before]
    out_p, vals_p = fc.friction_sweep_plain(f, kg, *masses, bud)
    bwd_p = fc.friction_sweep_bwd_plain(g, kg, *masses, vals_p, bud)
    torch.cuda.synchronize()
    for a, b in zip((out_k, vals_k) + bwd_k, (out_p, vals_p) + bwd_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if empty:
        assert torch.equal(out_k, f) and torch.equal(bwd_k[0], g)
        assert not any(bool(t.any()) for t in (vals_k,) + bwd_k[1:])
    else:
        assert (kg.counts > 0).sum(-1).min() == 4
        assert float((out_p - f).abs().max()) > 0, "friction never acted"
        assert float((bwd_p[0] - g).abs().max()) > 0
