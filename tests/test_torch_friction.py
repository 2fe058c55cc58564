"""Port parity: friction slot geometry and the layered self-friction sweep
(diffcloth_tpu_torch.core.friction_cuda, plain versions on the CPU) against
the JAX package's `friction_pallas` (Pallas kernel in interpret mode) on the
same numpy inputs and the same layer tables.

Tolerances: indices, areas, counts and overflow flags are exact; normals
agree to f32 rounding (the two packages sum |d|^2 in their own order);
friction forces within rtol 2e-5 / atol 1e-6, the bound the JAX package
holds its own kernel to against its compact path (test_selfcol_sweep.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu.core import friction_pallas as fp
from diffcloth_tpu.core import selfcol as jsc
from diffcloth_tpu.core import selfcol_pallas as scp
from diffcloth_tpu_torch.core import friction_cuda as tfc
from diffcloth_tpu_torch.core import selfcol as tsc

H = 0.05
N = 120
K = 8
MAX_LAYERS = 16
BUDGETS = {
    # the production taper, capped at n as ClothSim caps it
    "default": tuple(min(c, N) for c in jsc.compact_slot_budgets(4)),
    # tiny budgets that force drops in both layers (test_selfcol_sweep.py
    # test_kernel_budget_drop_matches_compact)
    "drop": (8, 4),
}


def contact_state(seed):
    """A dense random cloud of N particles with large radii (many contacts,
    several layers), its symmetric admissibility table and lumped areas."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, 3) * 0.5).astype(np.float32)
    v = (rng.randn(N, 3) * 0.3).astype(np.float32)
    radii = (rng.rand(N) * 0.12 + 0.05).astype(np.float32)
    conn = np.zeros((N, N), bool)
    for _ in range(60):
        a, b = rng.randint(0, N, 2)
        conn[a, b] = conn[b, a] = True
    np.fill_diagonal(conn, False)
    allowed = ~conn & ~np.eye(N, dtype=bool)
    area = (rng.rand(N) + 0.2).astype(np.float32)
    return x, v, radii, allowed, area


def jax_tables(x, v, radii, allowed):
    tables, _ = scp.detect_tables_pallas(
        jnp.asarray(scp.pack_allowed(allowed)), jnp.asarray(radii),
        jnp.asarray(x), jnp.asarray(v), H, K, MAX_LAYERS, interpret=True,
        with_normals=False)
    return tables


def torch_tables(jt_list):
    """The port's tables holding exactly the JAX tables (stacked when given
    a list): both packages' geometry builders then see the same input."""
    part = np.stack([np.asarray(t.partner) for t in jt_list])
    nl = np.stack([np.asarray(t.n_layers) for t in jt_list])
    return tsc.SelfContactTables(partner=torch.as_tensor(part).long(),
                                 n_layers=torch.as_tensor(nl).long())


def geoms(seeds, budgets):
    """Per-seed JAX KernelGeoms and the port's batched KernelGeom."""
    states = [contact_state(s) for s in seeds]
    area = states[0][4]
    jt = [jax_tables(*st[:4]) for st in states]
    assert min(int(t.n_layers) for t in jt) >= 2
    jg = [fp.build_kernel_geom(t, jnp.asarray(area), N, budgets,
                               x=jnp.asarray(st[0]))
          for t, st in zip(jt, states)]
    xs = torch.as_tensor(np.stack([st[0] for st in states]))
    tg = tfc.build_kernel_geom(torch_tables(jt), torch.as_tensor(area), N,
                               budgets, x=xs)
    return jg, tg, (jt, xs, area)


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_build_kernel_geom_matches_jax(budget):
    budgets = BUDGETS[budget]
    jg, tg, (jt, xs, area) = geoms([0, 1], budgets)
    for b, g in enumerate(jg):
        np.testing.assert_array_equal(tg.idx_row[b].numpy(),
                                      np.asarray(g.idx_row).astype(np.int32))
        np.testing.assert_array_equal(tg.idx_part[b].numpy(),
                                      np.asarray(g.idx_part).astype(np.int32))
        np.testing.assert_array_equal(tg.area_row[b].numpy(),
                                      np.asarray(g.area_row))
        np.testing.assert_array_equal(tg.area_part[b].numpy(),
                                      np.asarray(g.area_part))
        np.testing.assert_array_equal(tg.counts[b].numpy(),
                                      np.asarray(g.counts).astype(np.int32))
        assert bool(tg.overflow[b]) == bool(g.overflow)
        np.testing.assert_allclose(tg.normalT[b].numpy(),
                                   np.asarray(g.normalT), rtol=1e-6,
                                   atol=1e-7)
    assert bool(tg.overflow.any()) == (budget == "drop")
    # the single-sample call is the batched one's first row
    one = torch_tables(jt[:1])
    t1 = tfc.build_kernel_geom(
        tsc.SelfContactTables(partner=one.partner[0],
                              n_layers=one.n_layers[0]),
        torch.as_tensor(area), N, budgets, x=xs[0])
    for name in tg.__dataclass_fields__:
        assert torch.equal(getattr(t1, name), getattr(tg, name)[0]), name


def forces(seeds):
    rng = np.random.RandomState(100 + sum(seeds))
    B = len(seeds)
    f = (rng.randn(B, N, 3)).astype(np.float32)
    r0 = (rng.randn(B, N, 3) * 0.1).astype(np.float32)
    rho = (1.7 - 0.6 * np.arange(B)).astype(np.float32)
    return f, r0, rho


@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_self_friction_matches_pallas_kernel(budget, batched):
    budgets = BUDGETS[budget]
    seeds = [2, 3] if batched else [2]
    jg, tg, _ = geoms(seeds, budgets)
    f, r0, rho = forces(seeds)
    if batched:
        gstack = jax.tree.map(lambda *a: jnp.stack(a), *jg)
        r_j = jax.vmap(lambda g, fb, d, rb: fp.self_friction_kernel(
            fb, g, d, rb, budgets, interpret=True))(
                gstack, jnp.asarray(f), jnp.asarray(rho), jnp.asarray(r0))
        ops = tfc.sweep_operands(
            tg, tfc.slot_masses(tg, torch.as_tensor(rho)), budgets, N)
        r_t = tfc.self_friction(torch.as_tensor(f), ops, torch.as_tensor(r0))
    else:
        r_j = fp.self_friction_kernel(jnp.asarray(f[0]), jg[0],
                                      jnp.asarray(rho[0]),
                                      jnp.asarray(r0[0]), budgets,
                                      interpret=True)
        single = tfc.KernelGeom(**{k: getattr(tg, k)[0]
                                   for k in tg.__dataclass_fields__})
        ops = tfc.sweep_operands(
            single, tfc.slot_masses(single, float(rho[0])), budgets, N)
        r_t = tfc.self_friction(torch.as_tensor(f[0]), ops,
                                torch.as_tensor(r0[0]))
    r_j = np.asarray(r_j)
    assert np.abs(r_j - np.asarray(r0 if batched else r0[0])).max() > 1e-3, \
        "no friction was applied"
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=2e-5, atol=1e-6)


def test_sweep_vals_match_pallas_kernel():
    """The sweep's saved selects (q, p per slot; the backward kernel's
    input) and its output state against the TPU kernel's own outputs."""
    budgets = BUDGETS["default"]
    jg, tg, _ = geoms([4], budgets)
    g = jg[0]
    f, r0, rho = forces([4])
    specs, TC = fp.layer_specs(budgets)
    k_red, imr, imp = fp.slot_masses(g, jnp.asarray(rho[0]))
    n_pad = fp._round_up(N, fp.CHUNK)
    fr = f[0] + r0[0]
    frT = np.zeros((8, n_pad), np.float32)
    frT[:3, :N] = fr.T
    out_j, vals_j = fp._grid_call(
        fp._fwd_kernel, [(8, TC)], g.counts[None], jnp.asarray(frT)[None],
        g.idx_row[None], g.idx_part[None], g.normalT[None], k_red[None],
        imr[None], imp[None], specs=specs, interpret=True)
    kt = tfc.slot_masses(tg, torch.as_tensor(rho))
    out_t, vals_t = tfc.friction_sweep_plain(torch.as_tensor(fr)[None], tg,
                                             *kt, budgets)
    np.testing.assert_allclose(out_t[0].numpy(),
                               np.asarray(out_j)[0, :3, :N].T, rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(vals_t[0].numpy(), np.asarray(vals_j)[0, :6],
                               rtol=2e-5, atol=1e-6)
    assert np.abs(vals_t.numpy()).max() > 0


def test_dry_friction_force_matches_jax():
    """contact.dry_friction_force (take-off / stick / slide) against the JAX
    package's in f64, on states of all three cases; the sweep's per-slot
    form (mu = 0.1, sums written out) is the same function."""
    from diffcloth_tpu.core import contact as jct
    from diffcloth_tpu_torch.core import contact as tct
    rng = np.random.RandomState(7)
    n = rng.randn(300, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.randn(300, 3)
    d[:10] = n[:10] * -2.0       # pure push into the surface: stick
    d[10:20] = 0.0               # degenerate tangent (safe-norm guard)
    mu = rng.rand(300) * 0.6
    r_j = np.asarray(jct.dry_friction_force(jnp.asarray(n), jnp.asarray(d),
                                            jnp.asarray(mu)))
    r_t = tct.dry_friction_force(torch.as_tensor(n), torch.as_tensor(d),
                                 torch.as_tensor(mu)).numpy()
    np.testing.assert_allclose(r_t, r_j, rtol=1e-12, atol=1e-12)
    sd = np.sum(d * n, axis=-1)
    tang = np.linalg.norm(d - sd[:, None] * n, axis=-1)
    cases = {"take-off": sd >= 0, "stick": (sd < 0) & (tang <= mu * -sd),
             "slide": (sd < 0) & (tang > mu * -sd)}
    assert all(c.sum() >= 5 for c in cases.values()), \
        {k: int(c.sum()) for k, c in cases.items()}
    r_slot = tfc.dry_friction_slots(torch.as_tensor(n), torch.as_tensor(d))
    r_mu = tct.dry_friction_force(torch.as_tensor(n), torch.as_tensor(d),
                                  torch.full((300,), tfc.MU_CLOTH,
                                             dtype=torch.float64))
    np.testing.assert_allclose(r_slot.numpy(), r_mu.numpy(), rtol=1e-12,
                               atol=1e-12)
