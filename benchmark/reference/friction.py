"""Layered self-friction over compact contact slots: slot geometry, the
CUDA forward and backward sweeps and their plain PyTorch versions.

Counterpart of `diffcloth_tpu/core/friction_pallas.py`: `layer_specs`,
`KernelGeom`, `build_kernel_geom` (with `x=`), `slot_masses` (:76-202),
the custom-VJP sweep (:472-492) and `self_friction_kernel` (:495-516).
The TPU `_fwd_kernel` becomes `csrc/friction_fwd.cu` and `_bwd_kernel`
(the transposed linearization at the saved selects) `csrc/friction_bwd.cu`.

A step's slot geometry and masses are fixed for all its sweeps and adjoint
trips, so `sweep_operands` validates them once per step (pure Python, on
CPU and card tensors alike), caches the kernels' argument struct and picks
the kernels' route, a pair (state, slots): the sample's (n, 3) state
staged in shared memory, or, when that does not fit beside the slot rows
(n past about 15 000 at the default budgets), kept in global memory (the
`_global` entry points of the same sources); the slot rows staged in
shared memory, or, when they do not fit there (past about 3 000 slots,
as at the drop-free budgets (n,) * 16 of the flagship), read from global
memory (the `_stream` entry points; `_stream_plan` sizes their force
buffers in shared memory), with the state in shared memory where it fits
(n up to about 19 000).
`friction_sweep` / `friction_sweep_bwd` then check only the per-call state
(and selects) against it, and launch the kernels for CUDA tensors or run
`friction_sweep_plain` / `friction_sweep_bwd_plain` for CPU tensors.
`FrictionSweep` ties the two together as a `torch.autograd.Function`.  The
sweep is exact f32 whatever the simulation dtype, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch


MU_CLOTH = 0.1
EPS = 1e-12       # constraints.EPS (safe_norm guard)
CHUNK = 128       # slot chunk of the TPU layout (budgets round up to it)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def layer_specs(budgets: tuple):
    """Static per-layer (start, c_pad, c_eff) in the concatenated slot
    axis: c_eff is the drop budget, c_pad rounds it up to CHUNK."""
    specs = []
    start = 0
    for c_eff in budgets:
        c_pad = _round_up(max(int(c_eff), 1), CHUNK)
        specs.append((start, c_pad, int(c_eff)))
        start += c_pad
    return tuple(specs), start      # (specs, total padded slots TC)


@dataclasses.dataclass
class KernelGeom:
    """Density-independent per-step slot geometry (single: no leading dim;
    batched: a leading (B,) on every field).  Slot axes follow
    `layer_specs(budgets)`."""
    idx_row: torch.Tensor    # (TC,) int32 row vertex index, -1 empty
    idx_part: torch.Tensor   # (TC,) int32 partner vertex index, -1 empty
    normalT: torch.Tensor    # (3, TC) f32 row-signed normal
    area_row: torch.Tensor   # (TC,) f32 lumped area of the row vertex
    area_part: torch.Tensor  # (TC,) f32
    counts: torch.Tensor     # (L,) int32 active slots per layer
    overflow: torch.Tensor   # () bool — a layer exceeded its budget


def build_kernel_geom(tables, area: torch.Tensor, n_particles: int,
                      budgets: tuple, x: torch.Tensor) -> KernelGeom:
    """Partner tables -> kernel slot geometry (once per step), with the JAX
    package's drop rule: per layer the FIRST budgets[l] active rows in index
    order are kept, the surplus dropped and flagged.  Compaction is a
    cumsum and an indexed write (the TPU's compare-and-reduce stands in for
    exactly this); normals come per slot from positions x."""
    partner = tables.partner
    single = partner.dim() == 2
    if single:
        partner, x = partner[None], x[None]
    B = partner.shape[0]
    n = n_particles
    dev = partner.device
    specs, TC = layer_specs(budgets)
    a32 = area.to(torch.float32)
    rows = torch.arange(n, device=dev).expand(B, n)
    ir = torch.full((B, TC + 1), -1, dtype=torch.int64, device=dev)
    ip = torch.full((B, TC + 1), -1, dtype=torch.int64, device=dev)
    counts, overflow = [], torch.zeros(B, dtype=torch.bool, device=dev)
    for l, (start, c_pad, c_eff) in enumerate(specs):
        p = partner[:, l]
        has = p >= 0
        pos = torch.cumsum(has, dim=-1) - 1
        n_act = has.sum(dim=-1)
        dest = torch.where(has & (pos < c_eff), start + pos, TC)  # TC=scratch
        ir.scatter_(1, dest, rows)
        ip.scatter_(1, dest, p)
        counts.append(torch.clamp(n_act, max=c_eff))
        overflow = overflow | (n_act > c_eff)
    ir, ip = ir[:, :TC], ip[:, :TC]
    valid = ir >= 0
    irc, ipc = ir.clamp(min=0), ip.clamp(min=0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    x32 = x.to(torch.float32)
    xr = torch.gather(x32, 1, irc[..., None].expand(B, TC, 3))
    xp = torch.gather(x32, 1, ipc[..., None].expand(B, TC, 3))
    dd = xr - xp
    norm = torch.sqrt(torch.sum(dd * dd, dim=-1, keepdim=True))
    nrm = torch.where(valid[..., None], dd / torch.clamp(norm, min=1e-12),
                      zero)
    geom = KernelGeom(
        idx_row=ir.to(torch.int32), idx_part=ip.to(torch.int32),
        normalT=nrm.transpose(1, 2).contiguous(),
        area_row=torch.where(valid, a32[irc], zero),
        area_part=torch.where(valid, a32[ipc], zero),
        counts=torch.stack(counts, dim=1).to(torch.int32),
        overflow=overflow)
    if single:
        geom = KernelGeom(**{f.name: getattr(geom, f.name)[0]
                             for f in dataclasses.fields(geom)})
    return geom


def slot_masses(geom: KernelGeom, density):
    """(k_red, inv_m_row, inv_m_part) per slot from density (scalar, or (B,)
    for a batched geom), with the JAX package's masked-reciprocal guards."""
    rho = torch.as_tensor(density, dtype=torch.float32,
                          device=geom.area_row.device)
    if rho.dim() == 1:
        rho = rho[:, None]
    one = torch.ones((), dtype=torch.float32, device=rho.device)
    zero = torch.zeros((), dtype=torch.float32, device=rho.device)
    m_row = rho * geom.area_row
    m_part = rho * geom.area_part
    m_row_safe = torch.where(geom.area_row > 0, m_row, one)
    m_part_safe = torch.where(geom.area_part > 0, m_part, one)
    imr = torch.where(geom.area_row > 0, 1.0 / m_row_safe, zero)
    imp = torch.where(geom.area_part > 0, 1.0 / m_part_safe, zero)
    msum = m_row + m_part
    msum_safe = torch.where(msum > 0, msum, one)
    k_red = torch.where(msum > 0, m_row * m_part / msum_safe, zero)
    return k_red, imr, imp


# ---------------------------------------------------------------------------
# the forward sweep

def dry_friction_slots(nrm: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """dry_friction_force with mu = 0.1 on (..., 3) slot data, written op
    for op as the CUDA kernel computes it (three-term sums left to right)."""
    sd = (d[..., 0] * nrm[..., 0] + d[..., 1] * nrm[..., 1]
          + d[..., 2] * nrm[..., 2])[..., None]
    fN = nrm * sd
    fT = d - fN
    n2 = (fT[..., 0] * fT[..., 0] + fT[..., 1] * fT[..., 1]
          + fT[..., 2] * fT[..., 2])[..., None]
    safe = n2 > EPS * EPS
    tnorm = torch.where(safe, torch.sqrt(torch.where(safe, n2, 1.0)), EPS)
    t_hat = fT / tnorm
    slide = MU_CLOTH * torch.abs(sd)
    r = torch.where(tnorm <= slide, -fN - fT, -fN - slide * t_hat)
    return torch.where(sd < 0.0, r, 0.0)


def friction_sweep_plain(fr, geom: KernelGeom, kred, imr, imp,
                         budgets: tuple):
    """Plain PyTorch version of the sweep kernel.  fr (B, n, 3) f32 ->
    (fr' (B, n, 3), vals (B, 6, TC)); vals rows 0-2 hold q, 3-5 p.  Written
    without in-place updates, so that autograd of it is a second oracle
    for the backward sweep."""
    specs, _ = layer_specs(budgets)
    B = fr.shape[0]
    vals = []
    for l, (start, c_pad, _) in enumerate(specs):
        if not bool(geom.counts[:, l].any()):
            # an empty layer leaves fr as it is (the kernel skips it too)
            vals.append(fr.new_zeros((B, 6, c_pad)))
            continue
        sl = slice(start, start + c_pad)
        act = (torch.arange(c_pad, device=fr.device)[None]
               < geom.counts[:, l:l + 1])
        ir = torch.where(act, geom.idx_row[:, sl].long(), 0)
        ip = torch.where(act, geom.idx_part[:, sl].long(), 0)
        q = torch.gather(fr, 1, ir[..., None].expand(B, c_pad, 3))
        p = torch.gather(fr, 1, ip[..., None].expand(B, c_pad, 3))
        q = torch.where(act[..., None], q, 0.0)
        p = torch.where(act[..., None], p, 0.0)
        d = q * imr[:, sl, None] - p * imp[:, sl, None]
        r = kred[:, sl, None] * dry_friction_slots(
            geom.normalT[:, :, sl].transpose(1, 2), d)
        r = torch.where(act[..., None], r, 0.0)
        vals.append(torch.cat([q, p], dim=-1).transpose(1, 2))
        fr = fr.scatter_add(1, ir[..., None].expand(B, c_pad, 3), r)
    return fr, torch.cat(vals, dim=-1).contiguous()


# ---------------------------------------------------------------------------
# a step's slot operands

@dataclasses.dataclass(frozen=True)
class SweepOperands:
    """One step's slot geometry, slot masses (k_red, 1/m_row, 1/m_part) and
    budgets, batched."""
    geom: KernelGeom
    masses: tuple
    budgets: tuple


def sweep_operands(geom: KernelGeom, masses, budgets: tuple,
                   n: int) -> SweepOperands:
    """A step's slot operands; a single geometry (no leading dim, masses
    (TC,)) becomes a batch of one."""
    kred, imr, imp = masses
    if geom.idx_row.dim() == 1:
        geom = KernelGeom(**{f.name: getattr(geom, f.name)[None]
                             for f in dataclasses.fields(geom)})
        kred, imr, imp = kred[None], imr[None], imp[None]
    return SweepOperands(geom=geom, masses=(kred, imr, imp),
                         budgets=tuple(budgets))


def friction_sweep(fr, ops: SweepOperands):
    """One layered self-friction sweep, by the plain version."""
    return friction_sweep_plain(fr, ops.geom, *ops.masses, ops.budgets)


# ---------------------------------------------------------------------------
# the backward sweep: the transposed linearization at the saved selects

def dry_friction_jt_slots(nrm: torch.Tensor, d: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """(d dff/dd)^T w per slot (friction_pallas.py `_dff_JT`, :231-249), on
    (..., 3) slot data, written op for op as the CUDA kernel computes it:

        take-off: 0;  stick: -w;
        slide: -((n.w) + mu sign(sd) (t.w)) n
               - (mu |sd| / |fT|) (w - (n.w) n - (t.w) t)."""
    sd = (d[..., 0] * nrm[..., 0] + d[..., 1] * nrm[..., 1]
          + d[..., 2] * nrm[..., 2])[..., None]
    fN = nrm * sd
    fT = d - fN
    n2 = (fT[..., 0] * fT[..., 0] + fT[..., 1] * fT[..., 1]
          + fT[..., 2] * fT[..., 2])[..., None]
    safe = n2 > EPS * EPS
    tnorm = torch.where(safe, torch.sqrt(torch.where(safe, n2, 1.0)), EPS)
    t_hat = fT / tnorm
    slide = MU_CLOTH * torch.abs(sd)
    nw = (nrm[..., 0] * w[..., 0] + nrm[..., 1] * w[..., 1]
          + nrm[..., 2] * w[..., 2])[..., None]
    tw = (t_hat[..., 0] * w[..., 0] + t_hat[..., 1] * w[..., 1]
          + t_hat[..., 2] * w[..., 2])[..., None]
    jt_slide = (-(nw + MU_CLOTH * torch.sign(sd) * tw) * nrm
                - (slide / tnorm) * ((w - nw * nrm) - tw * t_hat))
    jt = torch.where(tnorm <= slide, -w, jt_slide)
    return torch.where(sd < 0.0, jt, 0.0)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Three-term dot product over the last dim, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def friction_sweep_bwd_plain(g, geom: KernelGeom, kred, imr, imp, vals,
                             budgets: tuple):
    """Plain PyTorch version of the backward sweep kernel (friction_pallas.py
    `_bwd_kernel`, :309-376).  g (B, n, 3) f32, the cotangent of the sweep's
    output; vals (B, 6, TC) the forward's saved q and p.  Layers run in
    reverse; every slot of a layer reads the cotangent left after the later
    layers.  Returns (g' (B, n, 3), c_kred, c_imr, c_imp (B, TC) each), the
    slot cotangents zero past each layer's count."""
    specs, TC = layer_specs(budgets)
    B = g.shape[0]
    g = g.clone()
    ck = torch.zeros((B, TC), dtype=torch.float32, device=g.device)
    ci = torch.zeros_like(ck)
    cp = torch.zeros_like(ck)
    for l in reversed(range(len(specs))):
        if not bool(geom.counts[:, l].any()):
            continue
        start, c_pad, _ = specs[l]
        sl = slice(start, start + c_pad)
        act = (torch.arange(c_pad, device=g.device)[None]
               < geom.counts[:, l:l + 1])
        a3 = act[..., None]
        ir = torch.where(act, geom.idx_row[:, sl].long(), 0)
        ip = torch.where(act, geom.idx_part[:, sl].long(), 0)
        w3 = torch.gather(g, 1, ir[..., None].expand(B, c_pad, 3))
        w3 = torch.where(a3, w3, 0.0)
        q = vals[:, 0:3, sl].transpose(1, 2)
        p = vals[:, 3:6, sl].transpose(1, 2)
        mr, mp, kr = imr[:, sl, None], imp[:, sl, None], kred[:, sl, None]
        nrm = geom.normalT[:, :, sl].transpose(1, 2)
        d = q * mr - p * mp
        u = torch.where(a3, kr * dry_friction_jt_slots(nrm, d, w3), 0.0)
        ck[:, sl] = torch.where(act, _dot3(dry_friction_slots(nrm, d), w3),
                                0.0)
        ci[:, sl] = torch.where(act, _dot3(u, q), 0.0)
        cp[:, sl] = torch.where(act, -_dot3(u, p), 0.0)
        # (g + row adds) + partner adds: each vertex is a row in at most one
        # slot and a partner in at most one slot of a layer (a matching)
        g.scatter_add_(1, ir[..., None].expand(B, c_pad, 3), u * mr)
        g.scatter_add_(1, ip[..., None].expand(B, c_pad, 3), -(u * mp))
    return g, ck, ci, cp


def friction_sweep_bwd(g, vals, ops: SweepOperands):
    """The backward sweep, by the plain version."""
    return friction_sweep_bwd_plain(g, ops.geom, *ops.masses, vals,
                                    ops.budgets)


class FrictionSweep(torch.autograd.Function):
    """The sweep as a differentiable function of (fr, k_red, 1/m_row,
    1/m_part), the counterpart of the `jax.custom_vjp` at
    friction_pallas.py:472-492: the forward saves `vals`, the backward is
    the transposed-linearization kernel.  The masses are `ops.masses`,
    passed again so that autograd sees them.  The slot geometry (indices,
    normals, counts) is a constant: it gets no cotangent, as there."""

    @staticmethod
    def forward(ctx, fr, kred, imr, imp, ops: SweepOperands):
        out, vals = friction_sweep(fr, ops)
        ctx.save_for_backward(vals)
        ctx.ops = ops
        return out

    @staticmethod
    def backward(ctx, g):
        vals, = ctx.saved_tensors
        gfr, ck, ci, cp = friction_sweep_bwd(g.contiguous(), vals, ctx.ops)
        return gfr, ck, ci, cp, None


def self_friction(f: torch.Tensor, ops: SweepOperands,
                  r_init: torch.Tensor) -> torch.Tensor:
    """r_init + the layered self-friction contributions (counterpart of
    `self_friction_kernel`, which takes the density where this takes
    `ops = sweep_operands(geom, slot_masses(geom, density), budgets, n)`).
    f, r_init (n,3) (with single-sample operands) or (B,n,3) in the
    simulation dtype; the sweep runs in f32 through `FrictionSweep`, so the
    result is differentiable in f, r_init and the masses, the casts to and
    from f32 carrying the cotangent."""
    single = f.dim() == 2
    if single:
        f, r_init = f[None], r_init[None]
    fr = (f + r_init).to(torch.float32).contiguous()
    out = FrictionSweep.apply(fr, *ops.masses, ops)
    r = r_init + (out - fr).to(f.dtype)
    return r[0] if single else r
