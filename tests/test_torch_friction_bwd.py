"""Port parity for the backward friction sweep: the plain PyTorch version of
the transposed linearization (`friction_cuda.friction_sweep_bwd_plain`,
the CPU counterpart of csrc/friction_bwd.cu) and the `FrictionSweep`
autograd Function against the JAX package's `friction_pallas` (the
`_bwd_kernel` in interpret mode, through `jax.vjp` of
`self_friction_kernel`), on the same numpy inputs and layer tables, single
and batched, at the production budgets and at forced drops (8, 4).  A
second oracle is torch autograd of the plain forward sweep.

Tolerances, with their reasons:
  * VJPs of self_friction for f, r0 and the three slot masses:
    max |d| / max(|ref|, 1e-3) < 5e-4, the bound test_selfcol_sweep.py:426
    holds the TPU kernel to.  The density gradient is f32 noise on both
    sides (self-friction is analytically density-independent: k_red ~ rho
    cancels d ~ 1/rho), so it is held to one f32 rounding of the terms
    that cancel in it.
  * the kernel-level outputs (g', slot cotangents) against the Pallas
    `_bwd_kernel`: rtol 2e-5 / atol 1e-6, as the forward sweep's test holds
    its outputs; both are exact f32 (interpret mode has no bf16 selects)
    and differ only in summation order.
  * against autograd of the plain sweep: rtol 1e-5 / atol 1e-6 (the same
    arithmetic, reassociated by autograd).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu.core import friction_pallas as fp
from diffcloth_tpu_torch.core import friction_cuda as tfc
from test_torch_friction import BUDGETS, N, forces, geoms
from torch_cpu import one_intra_op_thread  # noqa: F401


def smooth_loss_j(out):
    return jnp.sum(jnp.sin(out * 1.7) * jnp.cos(out * 0.3))


def smooth_loss_t(out):
    return torch.sum(torch.sin(out * 1.7) * torch.cos(out * 0.3))


def assert_rel(a, b, name, bound=5e-4, floor=1e-3):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(a).max(), floor)
    assert err < bound, (name, err)


def jax_friction(f, geom, masses, r0, budgets):
    """friction_pallas.self_friction_kernel with the slot masses as inputs
    (its lines :505-516), so that jax.vjp also gives their cotangents."""
    n_pad = fp._round_up(N, fp.CHUNK)
    fr = (f + r0).astype(jnp.float32)
    frT = jnp.zeros((8, n_pad), jnp.float32).at[0:3, 0:N].set(fr.T)
    out = fp._fric_fns(budgets, True)(frT, geom.idx_row, geom.idx_part,
                                      geom.normalT, *masses, geom.counts)
    return r0 + (out[0:3, 0:N].T - fr).astype(f.dtype)


@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_self_friction_vjp_matches_pallas_kernel(budget, batched):
    budgets = BUDGETS[budget]
    seeds = [5, 6] if batched else [5]
    jg, tg, _ = geoms(seeds, budgets)
    f, r0, rho = forces(seeds)
    gstack = jax.tree.map(lambda *a: jnp.stack(a), *jg)
    if not batched:
        tg = tfc.KernelGeom(**{k: getattr(tg, k)[0]
                               for k in tg.__dataclass_fields__})
        gstack = jg[0]
        f, r0, rho = f[0], r0[0], rho[0]

    def loss_j(f_, rho_, r_):
        def one(g, fb, d, rb):
            return fp.self_friction_kernel(fb, g, d, rb, budgets,
                                           interpret=True)
        out = (jax.vmap(one) if batched else one)(gstack, f_, rho_, r_)
        return smooth_loss_j(out)

    def loss_jm(f_, masses, r_):
        def one(g, fb, m, rb):
            return jax_friction(fb, g, m, rb, budgets)
        out = (jax.vmap(one) if batched else one)(gstack, f_, masses, r_)
        return smooth_loss_j(out)

    fj, rhoj, rj = jnp.asarray(f), jnp.asarray(rho), jnp.asarray(r0)
    gj = jax.grad(loss_j, argnums=(0, 1, 2))(fj, rhoj, rj)
    mj = (jax.vmap(fp.slot_masses) if batched else fp.slot_masses)(
        gstack, rhoj)
    gjm = jax.grad(loss_jm, argnums=1)(fj, mj, rj)

    ft, rhot, rt = (torch.tensor(a, requires_grad=True)
                    for a in (f, rho, r0))
    masses = tfc.slot_masses(tg, rhot)
    out = tfc.self_friction(ft, tfc.sweep_operands(tg, masses, budgets, N),
                            rt)
    gt = torch.autograd.grad(smooth_loss_t(out), [ft, rhot, rt, *masses])
    assert np.abs(np.asarray(gj[0])).max() > 0
    if budget == "drop":
        assert bool(tg.overflow.any()), "forced budgets dropped nothing"
    for name, a, b in (("f", gj[0], gt[0]), ("r0", gj[2], gt[2]),
                       ("k_red", gjm[0], gt[3]), ("1/m_row", gjm[1], gt[4]),
                       ("1/m_part", gjm[2], gt[5])):
        assert_rel(a, b.numpy(), name)
    # density: self-friction is analytically density-independent (k_red ~
    # rho cancels d ~ 1/rho), so dL/drho is the f32 remainder of a sum of
    # terms c * dm/drho that cancel; both packages must leave a remainder
    # within one f32 rounding of the size of those terms
    cancel = sum(float(torch.sum(torch.abs(c * m.detach())))
                 for c, m in zip(gt[3:], masses)) / float(np.min(rho))
    d_rho = np.abs(np.asarray(gj[1]) - gt[1].numpy()).max()
    assert d_rho <= np.finfo(np.float32).eps * cancel, (d_rho, cancel)


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_bwd_sweep_matches_pallas_bwd_kernel(budget):
    """friction_sweep_bwd_plain against the TPU `_bwd_kernel`'s own outputs
    (interpret mode) on the same cotangent, selects and slot masses: the
    state cotangent and the three slot cotangents."""
    budgets = BUDGETS[budget]
    jg, tg, _ = geoms([7], budgets)
    g = jg[0]
    f, r0, rho = forces([7])
    specs, TC = fp.layer_specs(budgets)
    k_red, imr, imp = fp.slot_masses(g, jnp.asarray(rho[0]))
    n_pad = fp._round_up(N, fp.CHUNK)
    frT = np.zeros((8, n_pad), np.float32)
    frT[:3, :N] = (f[0] + r0[0]).T
    slot = (g.idx_row[None], g.idx_part[None], g.normalT[None],
            k_red[None], imr[None], imp[None])
    _, vals_j = fp._grid_call(fp._fwd_kernel, [(8, TC)], g.counts[None],
                              jnp.asarray(frT)[None], *slot, specs=specs,
                              interpret=True)
    cot = np.random.RandomState(8).randn(N, 3).astype(np.float32)
    gT = np.zeros((8, n_pad), np.float32)
    gT[:3, :N] = cot.T
    gout_j, ck_j, ci_j, cp_j = fp._grid_call(
        fp._bwd_kernel, [(TC,), (TC,), (TC,)], g.counts[None],
        jnp.asarray(gT)[None], *slot, vals_j, specs=specs, interpret=True)

    kt = tfc.slot_masses(tg, torch.as_tensor(rho))
    _, vals_t = tfc.friction_sweep_plain(torch.as_tensor(f + r0), tg, *kt,
                                         budgets)
    gout_t, ck_t, ci_t, cp_t = tfc.friction_sweep_bwd_plain(
        torch.as_tensor(cot)[None], tg, *kt, vals_t, budgets)
    np.testing.assert_allclose(gout_t[0].numpy(),
                               np.asarray(gout_j)[0, :3, :N].T, rtol=2e-5,
                               atol=1e-6)
    for a, b in ((ck_t, ck_j), (ci_t, ci_j), (cp_t, cp_j)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b)[0],
                                   rtol=2e-5, atol=1e-6)
    assert np.abs(ck_t.numpy()).max() > 0 and np.abs(ci_t.numpy()).max() > 0
    assert np.abs(gout_t[0].numpy() - cot).max() > 1e-3


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_bwd_sweep_matches_autograd_of_plain_sweep(budget):
    budgets = BUDGETS[budget]
    _, tg, _ = geoms([2, 3], budgets)
    f, r0, rho = forces([2, 3])
    fr = torch.tensor(f + r0, requires_grad=True)
    masses = [m.detach().requires_grad_(True)
              for m in tfc.slot_masses(tg, torch.as_tensor(rho))]
    out, vals = tfc.friction_sweep_plain(fr, tg, *masses, budgets)
    cot = torch.as_tensor(np.random.RandomState(9).randn(2, N, 3)
                          .astype(np.float32))
    ga = torch.autograd.grad(out, [fr] + masses, cot)
    gb = tfc.friction_sweep_bwd_plain(cot, tg, *[m.detach() for m in masses],
                                      vals.detach(), budgets)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    assert float(ga[1].abs().max()) > 0
