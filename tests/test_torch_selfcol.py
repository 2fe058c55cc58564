"""Port parity: self-collision detection and layering
(diffcloth_tpu_torch.core.selfcol_cuda / selfcol) against the JAX package's
Pallas pipeline (diffcloth_tpu.core.selfcol_pallas, interpret mode) on the
same numpy inputs.  Partner tables, count columns and layer tables must be
EXACTLY equal, overflow rows included."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu.core import selfcol as jsc
from diffcloth_tpu.core import selfcol_pallas as scp
from diffcloth_tpu_torch.core import selfcol as tsc
from diffcloth_tpu_torch.core import selfcol_cuda as tscd
from diffcloth_tpu_torch.geometry import builder as tgb
from diffcloth_tpu_torch.geometry import states
from diffcloth_tpu_torch.tasks import registry as treg

H = 0.02


def random_config(seed, n=200, n_adj=300, radius=(0.02, 0.05)):
    """test_selfcol_sweep.random_config in f32, plus the symmetric
    admissibility table the kernel path uses."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, 3) * 0.5).astype(np.float32)
    v = (rng.randn(n, 3) * 0.3).astype(np.float32)
    radii = (np.abs(rng.rand(n)) * radius[1] + radius[0]).astype(np.float32)
    conn = np.zeros((n, n), bool)
    for _ in range(n_adj):
        a, b = rng.randint(0, n, 2)
        conn[a, b] = conn[b, a] = True
    np.fill_diagonal(conn, False)
    return x, v, radii, ~conn & ~np.eye(n, dtype=bool)


def folded_config():
    """A 16x16 grid of the flagship stand-in folded over its bottom half,
    with small random velocities."""
    cfg = dataclasses.replace(
        treg.TSHIRT_GRID_STANDIN, fabric=dataclasses.replace(
            treg.TSHIRT_GRID_STANDIN.fabric, grid_num_x=16, grid_num_y=16))
    scene = tgb.build_scene(cfg)
    x = states.folded_grid(scene, 8, 1.5 * float(scene.radii.mean()))
    v = np.random.RandomState(4).randn(scene.n, 3) * 0.2
    allowed = ~scene.conn_table & ~np.eye(scene.n, dtype=bool)
    return (x.astype(np.float32), v.astype(np.float32),
            scene.radii.astype(np.float32), allowed)


def collapsed_config(n=8):
    """Every particle on one point: each row has n-1 > K partners."""
    x = np.zeros((n, 3), np.float32)
    return x, x.copy(), np.full((n,), 0.2, np.float32), \
        ~np.eye(n, dtype=bool)


def straddle_config():
    """n = 600 (two 512-column segments) with large radii: rows collect
    hits in both segments, exercising the in-order segment merge and the
    count column across segments."""
    return random_config(11, n=600, n_adj=400, radius=(0.06, 0.06))


def lattice_config(n=600, width=20):
    """Two layers of a square lattice (spacing and layer gap 0.25, radii
    0.29) at rest, n = 600 (two 512-column segments).  Every d^2 is exact
    in f32, so a row's hits tie in groups at columns that lie apart (in
    the CUDA kernel, in different lanes), and rows whose other-layer
    partners lie past column 511 hold more than K = 4 hits in both
    segments.  No lattice distance, here or in the test's copy contracted
    by 0.8, lies on the reach (0.58^2), where XLA's and PyTorch's f32
    arithmetic may round apart."""
    half = n // 2
    i = np.arange(n)
    j = i % half
    x = np.stack([(j % width) * 0.25, (j // width) * 0.25,
                  (i // half) * 0.25], -1).astype(np.float32)
    rng = np.random.RandomState(5)
    conn = np.zeros((n, n), bool)
    for a, b in rng.randint(0, n, (n // 2, 2)):
        conn[a, b] = conn[b, a] = True
    return (x, np.zeros_like(x), np.full((n,), 0.29, np.float32),
            ~conn & ~np.eye(n, dtype=bool))


CASES = {
    "random0": lambda: random_config(0),
    "random1": lambda: random_config(1),
    "random2": lambda: random_config(2),
    "folded": folded_config,
    "overflow_k3": collapsed_config,
    "straddle": straddle_config,
    "overflow_ties": lattice_config,
}
K_OF = {"overflow_k3": 3, "straddle": 4, "overflow_ties": 4}


def jax_table(x, v, radii, allowed, k):
    """The Pallas kernel in symmetric mode, batched over x's leading dim."""
    n_pad = scp._round_up(x.shape[-2], scp.BJ)
    geom = jax.vmap(lambda xb, vb: scp.build_geom(
        jnp.asarray(xb), jnp.asarray(vb), jnp.asarray(radii), H, n_pad))(
            x, v)
    allowed_p = jnp.asarray(scp.pack_allowed(allowed))
    table = scp._detect_partners_grid(geom, allowed_p, k, interpret=True,
                                      triu_only=False)
    return np.asarray(geom), np.asarray(table)


def torch_table(x, v, radii, allowed, k):
    n_pad = tscd.round_up(x.shape[-2], tscd.SEGMENT)
    geom = tscd.build_geom(torch.as_tensor(x), torch.as_tensor(v),
                           torch.as_tensor(radii), H, n_pad)
    allowed_p = torch.as_tensor(tscd.pack_allowed(allowed))
    return geom.numpy(), tscd.detect_partners(geom, allowed_p, k).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_detect_partners_matches_pallas_exactly(case):
    x, v, radii, allowed = CASES[case]()
    k = K_OF.get(case, 8)
    # batch of two: the state itself and a contracted copy
    xb = np.stack([x, (x * 0.8).astype(np.float32)])
    vb = np.stack([v, v])
    jgeom, jtab = jax_table(xb, vb, radii, allowed, k)
    tgeom, ttab = torch_table(xb, vb, radii, allowed, k)
    np.testing.assert_array_equal(tgeom, jgeom)
    np.testing.assert_array_equal(ttab, jtab[..., :k + 1])
    n = x.shape[0]
    assert (ttab[:, :n, :k] >= 0).any(), "case has no contacts"
    if case in ("overflow_k3", "straddle", "overflow_ties"):
        assert (ttab[:, :n, k] > k).any(), "case has no overflow row"
    if case == "overflow_ties":
        # d^2 is exact on the lattice, so float64 counts the same hits
        d2 = ((x[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
        hit = (d2 < (radii[:, None] + radii[None]).astype(np.float64) ** 2
               ) & allowed
        per_seg = np.stack([hit[:, :tscd.SEGMENT].sum(1),
                            hit[:, tscd.SEGMENT:].sum(1)], 1)
        assert (per_seg > k).all(1).any(), "no row overflows both segments"
        assert any(len(np.unique(d2[i][hit[i]])) < hit[i].sum()
                   for i in range(n)), "no tied hits"
    # the single-sample call is the batched one's first row
    _, t1 = torch_table(x, v, radii, allowed, k)
    np.testing.assert_array_equal(t1, ttab[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_tables_match_jax_exactly(case):
    x, v, radii, allowed = CASES[case]()
    k = K_OF.get(case, 8)
    n = x.shape[0]
    _, jtab = jax_table(x[None], v[None], radii, allowed, k)
    partners = np.array(jtab[0, :n, :k])
    L = 16
    jt = jsc.layer_tables_from_partners(jnp.asarray(partners),
                                        jnp.asarray(x), L,
                                        with_normals=False)
    tt = tsc.layer_tables_from_partners(torch.as_tensor(partners), L)
    np.testing.assert_array_equal(tt.partner.numpy(), np.asarray(jt.partner))
    assert int(tt.n_layers) == int(jt.n_layers)
    # batched call: per-sample tables equal the single ones
    tb = tsc.layer_tables_from_partners(
        torch.as_tensor(np.stack([partners, np.full_like(partners, -1)])), L)
    np.testing.assert_array_equal(tb.partner[0].numpy(),
                                  np.asarray(jt.partner))
    assert (tb.partner[1] == -1).all() and int(tb.n_layers[1]) == 0


@pytest.mark.parametrize("case", ["folded", "random0", "overflow_k3",
                                  "overflow_ties"])
def test_detect_tables_matches_pallas_pipeline(case):
    x, v, radii, allowed = CASES[case]()
    k = K_OF.get(case, 8)
    allowed_p = scp.pack_allowed(allowed)
    jt, jovf = scp.detect_tables_pallas(
        jnp.asarray(allowed_p), jnp.asarray(radii), jnp.asarray(x),
        jnp.asarray(v), H, k, 16, interpret=True, with_normals=False)
    tt, tovf = tscd.detect_tables(
        torch.as_tensor(allowed_p), torch.as_tensor(radii),
        torch.as_tensor(x), torch.as_tensor(v), H, k, 16)
    np.testing.assert_array_equal(tt.partner.numpy(), np.asarray(jt.partner))
    assert int(tt.n_layers) == int(jt.n_layers)
    assert bool(tovf) == bool(jovf)


def test_compact_slot_budgets_match():
    for L in range(1, 7):
        assert tsc.compact_slot_budgets(L) == jsc.compact_slot_budgets(L)
