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

import ctypes
import dataclasses
import functools

import torch

from diffcloth_tpu_torch.core import cuda_build
from diffcloth_tpu_torch.core import launch_count as lc

MU_CLOTH = 0.1
EPS = 1e-12       # constraints.EPS (safe_norm guard)
CHUNK = 128       # slot chunk of the TPU layout (budgets round up to it)
SMEM_LIMIT = 227 * 1024   # dynamic shared memory per block on the H100


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
# a step's slot operands, validated once

class _SweepArgs(ctypes.Structure):
    """The slot operands as both kernels take them: `friction::SweepGeom`
    in csrc/friction_common.cuh, field for field."""
    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "idx_row", "idx_part", "normalT", "kred", "imr", "imp", "counts",
        "layer_start")]
        + [(k, ctypes.c_int) for k in (
            "L", "B", "n", "TC", "max_c_pad", "fwd_buf", "bwd_buf")])


def _smem_bytes(n: int, TC: int, max_c_pad: int, L: int, in_rows: int,
                out_rows: int, bufs: int, fbuf: int = 0) -> int:
    """Shared memory of one sweep block, `friction::smem_layout`'s total:
    the mbarrier, the (n, 3) state (n = 0 on the global-state route), staged
    and built slot rows of TC, slot buffers of (max c_pad, 3), `fbuf` bytes
    of per-slot forces (the streamed-slot route's), counts and
    layer_start."""
    def a16(x):
        return (x + 15) & ~15
    return (16 + a16(12 * n) + a16(4 * TC * in_rows)
            + a16(4 * TC * out_rows) + a16(12 * max_c_pad * bufs)
            + a16(fbuf) + 4 * (2 * L + 1))


# the backward block is the larger of the two: 14 staged slot rows
# (indices, normal, masses, selects), 3 cotangent rows, 2 slot buffers
BWD_SMEM_ROWS = (14, 3, 2)

# the streamed-slot route's force buffer, bytes a slot per kernel: the
# force beside its row index; the backward's row and partner adds
STREAM_FORCE_BYTES = {"fwd": 16, "bwd": 32}


def _stream_plan(n: int, TC: int, max_c_pad: int, L: int, fbytes: int):
    """The force buffer, in slots, of a streamed-slot kernel that keeps
    `fbytes` bytes of forces a slot, with an (n, 3) state in shared memory
    (n = 0: in global memory) that fits there: the widest layer where it
    fits beside the state, else as many CHUNKs as do (down to none: the
    scratch takes the rest).  Total bytes: `_smem_bytes(n, TC, max_c_pad,
    L, 0, 0, 0, fbytes * buf)`, as `friction::stream_layout`."""
    left = SMEM_LIMIT - _smem_bytes(n, TC, max_c_pad, L, 0, 0, 0)
    return min(max_c_pad, left // fbytes // CHUNK * CHUNK)


@functools.lru_cache(maxsize=None)
def _layer_start(budgets: tuple, device: torch.device) -> torch.Tensor:
    """(L+1,) int32 slot offsets of the layers, on the device (copied once
    per budget tuple, not once per step)."""
    specs, TC = layer_specs(budgets)
    return torch.tensor([s for s, _, _ in specs] + [TC], dtype=torch.int32,
                        device=device)


@dataclasses.dataclass(frozen=True)
class SweepOperands:
    """One step's validated slot operands for a (B, n, 3) state: the batched
    geometry, the slot masses (k_red, 1/m_row, 1/m_part), the budgets, and
    `args`, a pointer to the kernels' argument struct (it points into these
    tensors, which this object keeps alive).  Made by `sweep_operands`."""
    geom: KernelGeom
    masses: tuple
    budgets: tuple
    state_shape: tuple    # (B, n, 3)
    vals_shape: tuple     # (B, 6, TC)
    device: torch.device
    args: object
    route: str            # "shared" or "global": where the state lives
    slots: str = "shared"   # "shared" or "stream": where the slot rows live
    max_c_pad: int = 0    # the widest layer
    # the streamed-slot route's force-buffer slots of each kernel ("fwd",
    # "bwd"), `_stream_plan`'s; None on the other routes
    bufs: dict = None


# the routes (state, slots) in the order they are tried: the first whose
# backward block fits in shared memory is taken
ROUTES = (("shared", "shared"), ("global", "shared"), ("shared", "stream"),
          ("global", "stream"))


def sweep_operands(geom: KernelGeom, masses, budgets: tuple,
                   n: int) -> SweepOperands:
    """Validate a step's slot geometry and masses once, for every sweep and
    adjoint trip of the step: contiguous int32 / f32 tensors on one device,
    of the shapes `budgets` give, and pick the kernels' route, the first of
    ROUTES whose blocks fit in shared memory.  Pure Python on
    shapes, dtypes and devices, so CPU tensors are held to it too.  A
    single geometry (no leading dim, masses (TC,)) becomes a batch of one.
    Raises ValueError."""
    kred, imr, imp = masses
    if geom.idx_row.dim() == 1:
        geom = KernelGeom(**{f.name: getattr(geom, f.name)[None]
                             for f in dataclasses.fields(geom)})
        kred, imr, imp = kred[None], imr[None], imp[None]
    specs, TC = layer_specs(budgets)
    B, L = geom.idx_row.shape[0], len(specs)
    dev = geom.idx_row.device
    f32, i32 = torch.float32, torch.int32
    for name, t, shape, dt in (
            ("idx_row", geom.idx_row, (B, TC), i32),
            ("idx_part", geom.idx_part, (B, TC), i32),
            ("normalT", geom.normalT, (B, 3, TC), f32),
            ("counts", geom.counts, (B, L), i32),
            ("k_red", kred, (B, TC), f32),
            ("inv_m_row", imr, (B, TC), f32),
            ("inv_m_part", imp, (B, TC), f32)):
        if (tuple(t.shape) != shape or t.dtype != dt or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"sweep operands: {name} must be a contiguous {dt} {shape} "
                f"tensor on {dev}, got a{'' if t.is_contiguous() else ' non'}"
                f"-contiguous {t.dtype} {tuple(t.shape)} on {t.device}")
    max_c_pad = max(c_pad for _, c_pad, _ in specs)
    if n < 1:
        raise ValueError(f"sweep operands: n = {n}")
    # the backward block is the larger: the state goes to global memory
    # when it does not fit there beside the slot rows, the slot rows when
    # they do not fit at all; a streamed route's force buffer shrinks
    # before the state leaves shared memory
    for route, slot_route in ROUTES:
        n_state = n if route == "shared" else 0
        if _smem_bytes(n_state, TC, max_c_pad, L,
                       *(BWD_SMEM_ROWS if slot_route == "shared"
                         else (0, 0, 0))) <= SMEM_LIMIT:
            break
    else:
        raise ValueError(f"sweep operands: no route of n = {n}, {TC} slots "
                         f"fits the sweeps' shared memory")
    bufs = ({k: _stream_plan(n_state, TC, max_c_pad, L, v)
             for k, v in STREAM_FORCE_BYTES.items()}
            if slot_route == "stream" else None)
    ls = _layer_start(tuple(budgets), dev)
    args = _SweepArgs(*(t.data_ptr() for t in (
        geom.idx_row, geom.idx_part, geom.normalT, kred, imr, imp,
        geom.counts, ls)), L, B, n, TC, max_c_pad,
        *((bufs["fwd"], bufs["bwd"]) if bufs else (0, 0)))
    return SweepOperands(geom=geom, masses=(kred, imr, imp),
                         budgets=tuple(budgets), state_shape=(B, n, 3),
                         vals_shape=(B, 6, TC), device=dev,
                         args=ctypes.pointer(args), route=route,
                         slots=slot_route, max_c_pad=max_c_pad, bufs=bufs)


def stream_scratch(ops: SweepOperands, kernel: str):
    """The global scratch a streamed-slot kernel ("fwd" or "bwd") takes for
    the slots of a layer wider than its force buffer: its shape, (B,
    max_c_pad - buffer, 4) f32 (the backward's (B, 2, max_c_pad - buffer,
    4): row and partner adds), or None where the buffer holds the widest
    layer, and on the other routes."""
    if ops.bufs is None:
        return None
    wider = ops.max_c_pad - ops.bufs[kernel]
    if wider <= 0:
        return None
    B = ops.state_shape[0]
    return (B, wider, 4) if kernel == "fwd" else (B, 2, wider, 4)


def _check_call(name: str, t: torch.Tensor, shape: tuple,
                ops: SweepOperands) -> None:
    """The per-call check: a contiguous f32 tensor of `shape` on the
    operands' device."""
    if (t.shape != shape or t.dtype != torch.float32 or t.device != ops.device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous torch.float32 {shape} "
                         f"tensor on {ops.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _symbol(name: str, ops: SweepOperands) -> str:
    """A sweep's entry point for the operands' route, which is also its
    launch count's name (`launch_count`): `name`, `name`_global,
    `name`_stream or `name`_global_stream."""
    return (name + ("_global" if ops.route == "global" else "")
            + ("_stream" if ops.slots == "stream" else ""))


@functools.lru_cache(maxsize=None)
def _load_kernel(name: str, symbol: str, n_args: int):
    """A sweep kernel's C entry point `symbol` in library `name`, loaded and
    configured once (argument types and the shared-memory limit), so that
    a sweep pays neither."""
    lib = cuda_build.load(name)
    init = getattr(lib, symbol + "_init")
    init.argtypes = [ctypes.c_int]
    init.restype = ctypes.c_int
    cuda_build.check(init(SMEM_LIMIT), symbol + "_init")
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.POINTER(_SweepArgs)] + [ctypes.c_void_p] * n_args
    fn.restype = ctypes.c_int
    return fn


@lc.counted("friction_fwd")
def friction_sweep(fr, ops: SweepOperands):
    """One layered self-friction sweep on batched slot data: the CUDA
    kernel of the operands' route for CUDA tensors, the plain version for
    CPU tensors.  fr (B, n, 3) f32 -> (fr', vals (B, 6, TC)).  The kernel
    counts its launches on the device: `launches` reads them,
    `global_launches` the global-state routes' and `stream_launches` the
    streamed-slot routes' (`launch_count`)."""
    _check_call("friction_sweep: fr", fr, ops.state_shape, ops)
    if not fr.is_cuda:
        return friction_sweep_plain(fr, ops.geom, *ops.masses, ops.budgets)
    out = torch.empty_like(fr)
    vals = fr.new_empty(ops.vals_shape)
    symbol = _symbol("friction_fwd", ops)
    # the streamed route: a null scratch where the force buffer holds
    # every layer
    shape = stream_scratch(ops, "fwd")
    scratch = ([fr.new_empty(shape) if shape else None]
               if ops.slots == "stream" else [])
    cuda_build.check(_load_kernel("friction_fwd", symbol, 5 + len(scratch))(
        ops.args, fr.data_ptr(), out.data_ptr(), vals.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in scratch),
        lc.address(symbol, fr.device),
        torch.cuda.current_stream(fr.device).cuda_stream), symbol)
    return out, vals


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


@lc.counted("friction_bwd")
def friction_sweep_bwd(g, vals, ops: SweepOperands):
    """The backward sweep on batched slot data: the CUDA kernel of the
    operands' route for CUDA tensors, the plain version for CPU tensors.
    g (B, n, 3) f32, vals (B, 6, TC) the forward's selects.  Returns (g',
    c_kred, c_imr, c_imp) as `friction_sweep_bwd_plain` does.  Counted as
    `friction_sweep` is."""
    _check_call("friction_sweep_bwd: g", g, ops.state_shape, ops)
    _check_call("friction_sweep_bwd: vals", vals, ops.vals_shape, ops)
    if not g.is_cuda:
        return friction_sweep_bwd_plain(g, ops.geom, *ops.masses, vals,
                                        ops.budgets)
    B, _, TC = ops.vals_shape
    out = torch.empty_like(g)
    ck = g.new_empty((3, B, TC))
    symbol = _symbol("friction_bwd", ops)
    # the streamed route: a null scratch where the force buffer holds
    # every layer
    shape = stream_scratch(ops, "bwd")
    scratch = ([g.new_empty(shape) if shape else None]
               if ops.slots == "stream" else [])
    cuda_build.check(_load_kernel("friction_bwd", symbol, 6 + len(scratch))(
        ops.args, g.data_ptr(), vals.data_ptr(), out.data_ptr(),
        ck.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in scratch),
        lc.address(symbol, g.device),
        torch.cuda.current_stream(g.device).cuda_stream), symbol)
    return (out,) + ck.unbind(0)


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
