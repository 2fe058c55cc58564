"""Self-collision layering: symmetric partner lists -> per-layer partner
tables, the tapered per-layer slot budgets, and the sort-based sweep
pipeline of large meshes.

Counterpart of the parts of `diffcloth_tpu/core/selfcol.py` the port runs:
`SelfContactTables`, `layer_tables_from_partners` (:435-527, in its
`with_normals=False` form — the friction geometry builds normals per
compact slot) and `compact_slot_budgets` (:563-569) on the kernel path;
`SelfContactSet`, `_narrow_phase`, `detect_self_collisions_sweep`,
`assign_layers`, `build_layer_tables` and `empty_self_contacts` (:48-380,
:678-685) on the sweep path, which `ClothSim` takes past n = 10000, where
the detection kernel's (n_pad, n_pad) admissibility table and its n^2 work
stop paying.  Both paths end in the same `SelfContactTables`, which feed
`friction_cuda.build_kernel_geom`.  The sweep path is plain PyTorch (the
JAX package runs it as XLA, not Pallas), batched over a leading (B,) dim.

Layering is K rounds of parallel greedy matching on canonical pair ids
(reference contactSorting, Simulation.cpp:422-624): per round every
particle's owner is the smallest id among its still-unassigned entries, and
entry (p, q) joins layer k iff both owners agree on it.  The JAX package
loops while any entry is unassigned; here the loop runs a fixed
`max_layers` rounds (a round with nothing left changes nothing), which
gives identical tables and needs no host sync.
"""
from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.device import resolve_device

BIG_ID = torch.iinfo(torch.int64).max


@dataclasses.dataclass
class SelfContactTables:
    """Per-layer partner tables.  Single: partner (L, n), n_layers ();
    batched: (B, L, n) and (B,)."""
    partner: torch.Tensor    # int64 partner index, -1 = none
    n_layers: torch.Tensor   # int64 number of populated layers


def layer_tables_from_partners(partner_nk: torch.Tensor,
                               max_layers: int) -> SelfContactTables:
    """Symmetric per-row partner lists (n, K) or (B, n, K) (-1 = empty;
    each unordered pair appears in BOTH rows) -> per-layer partner tables.

    Rows whose detection count overflowed K keep the JAX package's known
    limitation (selfcol.py:471-482): a one-sided entry can block its row
    for every round, so an overflow step may drop more pairs; such steps
    are flagged through `selfcol_overflow`."""
    single = partner_nk.dim() == 2
    p = (partner_nk[None] if single else partner_nk).long()
    B, n, K = p.shape
    valid = p >= 0
    pc = p.clamp(min=0)
    rows = torch.arange(n, device=p.device)[None, :, None]
    pri = torch.minimum(rows, pc) * n + torch.maximum(rows, pc)
    layer = torch.full_like(p, -1)
    unassigned = valid
    flat_pc = pc.reshape(B, n * K)
    for k in range(max_layers):
        ids = torch.where(unassigned, pri, BIG_ID)
        owner = ids.amin(dim=-1)                              # (B, n)
        owner_p = torch.gather(owner, 1, flat_pc).reshape(B, n, K)
        win = unassigned & (owner[..., None] == pri) & (owner_p == pri)
        layer = torch.where(win, k, layer)
        unassigned = unassigned & ~win
    lsel = torch.arange(max_layers, device=p.device)[None, :, None, None]
    hit = layer[:, None] == lsel                              # (B, L, n, K)
    partner = torch.where(hit, pc[:, None], -1).amax(dim=-1)  # (B, L, n)
    n_layers = layer.reshape(B, -1).amax(dim=-1) + 1
    if single:
        return SelfContactTables(partner=partner[0], n_layers=n_layers[0])
    return SelfContactTables(partner=partner, n_layers=n_layers)


def compact_slot_budgets(n_layers: int, c0: int = 256,
                         c_rest: int = 128) -> tuple:
    """Static per-layer slot budgets, tapered: greedy matching packs most
    pairs into the earliest layers."""
    taper = [c0] + [c_rest] + [c_rest // 2] * max(n_layers - 2, 0)
    return tuple(taper[:max(n_layers, 1)])


# ---------------------------------------------------------------------------
# the sweep pipeline (pair lists)

@dataclasses.dataclass
class SelfContactSet:
    """Fixed-capacity active self-contact pairs for one step (frozen), each
    field with a leading (B,) dim when batched.  Active slots (mask) hold
    distinct unordered pairs, which `build_layer_tables` relies on."""
    pair_i: torch.Tensor     # (C,) int64 smaller index of the pair
    pair_j: torch.Tensor     # (C,) int64 larger index
    normal: torch.Tensor     # (C, 3) from j to i (normalized x_i - x_j)
    mask: torch.Tensor       # (C,) bool
    layer: torch.Tensor      # (C,) int64 layer id, -1 when unassigned
    overflow: torch.Tensor   # () bool: capacity or window exceeded

    def first(self) -> "SelfContactSet":
        """Sample 0 of a batched set, without its leading dim."""
        return SelfContactSet(**{f.name: getattr(self, f.name)[0]
                                 for f in dataclasses.fields(self)})


def _norm(a: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """|a| over the last dim as jnp.linalg.norm computes it."""
    return torch.sqrt(torch.sum(a * a, dim=-1, keepdim=keepdim))


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, n, ...) at idx (B, P) -> (B, P, ...)."""
    B, P = idx.shape
    return torch.gather(t, 1, idx.reshape((B, P) + (1,) * (t.dim() - 2))
                        .expand((B, P) + t.shape[2:]))


def _narrow_phase(i, j, valid, radii, x, v, h: float,
                  cap_pairs: int) -> SelfContactSet:
    """Swept sphere-sphere test over (B, P) candidate arrays, compacted to
    `cap_pairs` slots in candidate order (selfcol.py:58-113).

    With p(t) = (x_i - x_j) + t (v_i - v_j), the distance is taken at
    t in {0, h, t_mid} with t_mid = -2 (v.p0)/|v|^2 when it lies in [0, h]:
    the reference's doubled minimizer (Simulation.cpp:207), kept for
    parity.  A pair collides when that distance is below r_i + r_j."""
    i, j = torch.minimum(i, j), torch.maximum(i, j)
    B = x.shape[0]
    p0 = _rows(x, i) - _rows(x, j)
    dv = _rows(v, i) - _rows(v, j)
    p1 = p0 + h * dv
    d0 = _norm(p0)
    d1 = _norm(p1)
    denom = torch.clamp(torch.sum(dv * dv, dim=-1), min=1e-30)
    t_mid = -2.0 * torch.sum(dv * p0, dim=-1) / denom
    in_seg = (t_mid >= 0.0) & (t_mid <= h)
    d_mid = _norm(p0 + t_mid[..., None] * dv)
    dmin = torch.minimum(d0, d1)
    dmin = torch.where(in_seg, torch.minimum(dmin, d_mid), dmin)
    thresh = radii[i] + radii[j]
    hit = (dmin < thresh) & valid

    # compaction in candidate order: the k-th hit goes to slot k, hits
    # past the capacity to a scratch slot that is cut off
    pos = torch.cumsum(hit, dim=-1) - 1
    tgt = torch.where(hit & (pos < cap_pairs), pos, cap_pairs)
    nrm_all = p0 / torch.clamp(_norm(p0, keepdim=True), min=1e-12)

    def compact(src, fill, dtype):
        out = torch.full((B, cap_pairs + 1) + src.shape[2:], fill,
                         dtype=dtype, device=x.device)
        t = tgt.reshape(tgt.shape + (1,) * (src.dim() - 2)).expand_as(src)
        return out.scatter_(1, t, src.to(dtype))[:, :cap_pairs]

    return SelfContactSet(
        pair_i=compact(i, 0, torch.int64),
        pair_j=compact(j, 0, torch.int64),
        normal=compact(nrm_all, 0.0, x.dtype),
        mask=compact(hit, False, torch.bool),
        layer=torch.full((B, cap_pairs), -1, dtype=torch.int64,
                         device=x.device),
        overflow=hit.sum(dim=-1) > cap_pairs)


def detect_self_collisions_sweep(allowed: torch.Tensor, radii, x, v,
                                 h: float, window: int,
                                 cap_pairs: int) -> SelfContactSet:
    """Sweep-and-prune broad phase and the narrow phase (selfcol.py:
    215-278): particles sorted along the longest current AABB axis, pairs
    within `window` places in that order whose axis gap is below the
    conservative reach r_i + r_j + h (|v_i| + |v_j|) (a lower bound of the
    swept distance, so no colliding pair is pruned by it).  A pair the
    window cannot see (more than `window` particles in one reach-length
    slab) raises the overflow flag.  O(n log n + n window) per sample, no
    n^2 term but the lookup of `allowed`, the (n, n) bool non-adjacency
    table (zero diagonal).  x, v (n, 3) or (B, n, 3)."""
    single = x.dim() == 2
    if single:
        x, v = x[None], v[None]
    B, n, _ = x.shape
    dev = x.device
    window = min(window, n - 1)
    lo = x.amin(dim=1)
    hi = x.amax(dim=1)
    ax = torch.argmax(hi - lo, dim=-1)                       # (B,)
    key = torch.gather(x, 2, ax[:, None, None].expand(B, n, 1))[..., 0]
    perm = torch.argsort(key, dim=-1, stable=True)           # (B, n)
    skey = torch.gather(key, 1, perm)
    s_srt = torch.gather(_norm(v), 1, perm)
    r_srt = radii.to(x.dtype)[perm]

    pos2 = (torch.arange(n, device=dev)[None, :]
            + torch.arange(1, window + 1, device=dev)[:, None])  # (W, n)
    in_range = pos2 < n
    pos2c = torch.clamp(pos2, max=n - 1).reshape(-1)
    i = perm[:, None, :].expand(B, window, n)
    j = perm[:, pos2c].reshape(B, window, n)
    gap = skey[:, pos2c].reshape(B, window, n) - skey[:, None, :]
    reach = (r_srt[:, None, :] + r_srt[:, pos2c].reshape(B, window, n)
             + h * (s_srt[:, None, :]
                    + s_srt[:, pos2c].reshape(B, window, n)))
    valid = in_range & (gap < reach) & allowed[i, j]

    # window-miss: the particle `window` places ahead still within the
    # most conservative reach means a pair may have been cut by the window
    r_max = r_srt.amax(dim=-1, keepdim=True)
    s_max = s_srt.amax(dim=-1, keepdim=True)
    key_ahead = torch.cat([skey[:, window:],
                           torch.full((B, window), float("inf"),
                                      dtype=skey.dtype, device=dev)], dim=1)
    missed = (key_ahead - skey < r_srt + r_max + h * (s_srt + s_max)).any(-1)

    cs = _narrow_phase(i.reshape(B, -1), j.reshape(B, -1),
                       valid.reshape(B, -1), radii, x, v, h, cap_pairs)
    cs.overflow = cs.overflow | missed
    return cs.first() if single else cs


def assign_layers(contacts: SelfContactSet, n_particles: int,
                  max_layers: int) -> SelfContactSet:
    """Rounds of parallel greedy matching on the canonical pair id
    i * n + j (selfcol.py:281-330): every unassigned active pair offers its
    id to both endpoints (a scatter-min), and joins the round's layer iff it
    won both.  The id, not the slot, orders the matching, so the layers do
    not depend on the broad phase's candidate order.  Pairs left after
    `max_layers` rounds are masked out."""
    single = contacts.pair_i.dim() == 1
    cs = contacts
    if single:
        cs = SelfContactSet(**{f.name: getattr(cs, f.name)[None]
                               for f in dataclasses.fields(cs)})
    B = cs.pair_i.shape[0]
    pri = cs.pair_i * n_particles + cs.pair_j
    layer = cs.layer
    unassigned = cs.mask
    for k in range(max_layers):
        ids = torch.where(unassigned, pri, BIG_ID)
        owner = torch.full((B, n_particles), BIG_ID, dtype=torch.int64,
                           device=pri.device)
        owner.scatter_reduce_(1, cs.pair_i, ids, "amin")
        owner.scatter_reduce_(1, cs.pair_j, ids, "amin")
        win = (unassigned & (torch.gather(owner, 1, cs.pair_i) == pri)
               & (torch.gather(owner, 1, cs.pair_j) == pri))
        layer = torch.where(win, k, layer)
        unassigned = unassigned & ~win
    out = dataclasses.replace(cs, layer=layer, mask=cs.mask & (layer >= 0))
    return out.first() if single else out


def build_layer_tables(contacts: SelfContactSet, n_particles: int,
                       max_layers: int) -> SelfContactTables:
    """Layered pairs -> per-layer partner tables (selfcol.py:333-380), one
    write per endpoint: each particle is in at most one pair of a layer, so
    every (layer, particle) address is written once.  The normals stay out:
    the friction geometry takes them per slot from positions."""
    single = contacts.pair_i.dim() == 1
    pi, pj, lay, mask = (contacts.pair_i, contacts.pair_j, contacts.layer,
                         contacts.mask)
    if single:
        pi, pj, lay, mask = pi[None], pj[None], lay[None], mask[None]
    B, C = pi.shape
    L, n = max_layers, n_particles
    valid = mask & (lay >= 0) & (lay < L)
    oob = L * n + torch.arange(C, device=pi.device)
    addr_i = torch.where(valid, lay * n + pi, oob)
    addr_j = torch.where(valid, lay * n + pj, oob)
    flat = torch.full((B, L * n + C), -1, dtype=torch.int64,
                      device=pi.device)
    flat.scatter_(1, addr_i, pj)
    flat.scatter_(1, addr_j, pi)
    partner = flat[:, :L * n].reshape(B, L, n)
    n_layers = torch.where(valid, lay, -1).amax(dim=-1) + 1 if C else \
        torch.zeros(B, dtype=torch.int64, device=pi.device)
    if single:
        return SelfContactTables(partner=partner[0], n_layers=n_layers[0])
    return SelfContactTables(partner=partner, n_layers=n_layers)


def empty_self_contacts(cap_pairs: int, dtype=torch.float32,
                        device=None) -> SelfContactSet:
    """A contact set with no active pair, on the card unless `device` says
    otherwise."""
    device = resolve_device(device)
    return SelfContactSet(
        pair_i=torch.zeros(cap_pairs, dtype=torch.int64, device=device),
        pair_j=torch.zeros(cap_pairs, dtype=torch.int64, device=device),
        normal=torch.zeros((cap_pairs, 3), dtype=dtype, device=device),
        mask=torch.zeros(cap_pairs, dtype=torch.bool, device=device),
        layer=torch.full((cap_pairs,), -1, dtype=torch.int64, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device))
