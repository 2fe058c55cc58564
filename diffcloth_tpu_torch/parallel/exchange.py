"""The tensor-parallel solve's all-gather of row blocks: the CUDA kernels
(`csrc/peer_exchange.cu`) and their plain version, NCCL's or gloo's
`all_gather_into_tensor`.

Counterpart of the `jax.lax.all_gather(local, "tp", axis=0, tiled=True)`
in the JAX package's `make_tp_solve` (diffcloth_tpu/parallel/mesh.py:49-58),
which sits inside the jitted step's while_loops.  `all_gather_rows(local,
gather)` takes this rank's block (B, m, 3) and returns (B, tp * m, 3), the
tp ranks' blocks in group-rank order along dim 1, as a transpose of a
contiguous (tp * m, B, 3), the layout of the dense product `dense_ops.mm`
(so a tp = 1 step rounds as the dense step does).  On CUDA tensors it
launches the kernels: a peer-to-peer copy through memory every rank of the
group maps (CUDA IPC), ordered by flags in that memory, so that it can run
inside a captured graph's WHILE body, where NCCL's all-gather cannot (a
program holding it there fails to instantiate: the staged probe of
tests/test_torch_parallel_cuda.py).  On CPU tensors it runs the plain
version.

The regions are set up once per group and block shape, at the first
exchange of that shape (uncaptured: the warm-up of a program runs before
its capture), by a collective on the group: each rank allocates its
region, the ranks trade IPC handles and PCI bus ids with
`all_gather_object`, and each maps its peers' regions after checking that
its card can reach theirs directly.  `row_gather(group)` keeps one
`RowGather` per group, so every sim of a group shares its regions (its
exchanges run one at a time, in the same order on every rank, as the
group's collectives do).  The regions live as long as the process: a
peer may still write into one until its last exchange ends.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from diffcloth_tpu_torch.core import cuda_build
from diffcloth_tpu_torch.core import launch_count as lc

MAX_RANKS = 8          # ranks of a tp group the kernels take
SLOT_ALIGN = 256       # bytes a slot is rounded up to
# seconds a rank's kernel waits for a peer's block before it traps (a
# peer still capturing or building its programs delays the first launch)
TIMEOUT_S = 120


def all_gather_rows_plain(local: torch.Tensor, group) -> torch.Tensor:
    """Plain version: local (B, m, 3) -> (B, tp * m, 3) by
    `dist.all_gather_into_tensor` over the group (NCCL or gloo) on the
    transposed blocks."""
    t = local.transpose(0, 1).contiguous()
    tp = dist.get_world_size(group)
    out = t.new_empty((tp * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out.transpose(0, 1)


@functools.lru_cache(maxsize=None)
def _lib():
    """csrc/peer_exchange.cu's entry points, loaded and typed once."""
    lib = cuda_build.load("peer_exchange")
    vp, pvp, cp, i, ll = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                          ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong)
    for name, args in (
            ("px_region_alloc", [ll, pvp, cp]),
            ("px_region_open", [cp, pvp]),
            ("px_bus_id", [i, cp, i]),
            ("px_can_access", [i, cp, ctypes.POINTER(i)]),
            ("px_exchange", [pvp, i, i, vp, vp, ll, ll, ll, vp, vp])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.px_header_bytes.restype = ll
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"peer exchange: {what} failed: cudaError {err}")


class RowGather:
    """The all-gather of row blocks over a tp group (`group` None: the
    world), with the regions of its kernels, one set per block shape."""

    def __init__(self, group=None):
        self.group = group
        self.tp = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if self.tp > MAX_RANKS:
            raise ValueError(f"peer exchange: at most {MAX_RANKS} ranks in "
                             f"a tp group, not {self.tp}")
        self._regions = {}    # (device, block bytes) -> (array, slot)

    def __call__(self, local: torch.Tensor) -> torch.Tensor:
        return all_gather_rows(local, self)

    def regions(self, device: torch.device, nbytes: int):
        """(the group's region pointers as a ctypes array, slot bytes) for
        blocks of `nbytes`; set up at their first use."""
        key = (device.index, nbytes)
        held = self._regions.get(key)
        if held is None:
            held = self._regions[key] = self._setup(device, nbytes)
        return held

    def _setup(self, device, nbytes):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("peer exchange: the first exchange of a block "
                               "shape sets up its regions, a collective, and "
                               "must not be captured")
        lib = _lib()
        slot = -(-nbytes // SLOT_ALIGN) * SLOT_ALIGN
        size = lib.px_header_bytes() + 2 * self.tp * slot
        ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(64)
        bus = ctypes.create_string_buffer(32)
        with torch.cuda.device(device):
            _check(lib.px_region_alloc(size, ctypes.byref(ptr), handle),
                   "allocating a region")
            _check(lib.px_bus_id(device.index, bus, len(bus)), "bus id")
            info = [None] * self.tp
            dist.all_gather_object(info, (handle.raw, bus.value),
                                   group=self.group)
            table = (ctypes.c_void_p * MAX_RANKS)()
            for r, (h, peer_bus) in enumerate(info):
                if r == self.rank:
                    table[r] = ptr.value
                    continue
                ok = ctypes.c_int(0)
                _check(lib.px_can_access(device.index, peer_bus,
                                         ctypes.byref(ok)), "peer access")
                if not ok.value:
                    raise RuntimeError(
                        f"peer exchange: rank {self.rank}'s card "
                        f"({bus.value.decode()}) cannot reach rank {r}'s "
                        f"({peer_bus.decode()}) peer to peer")
                peer = ctypes.c_void_p()
                _check(lib.px_region_open(h, ctypes.byref(peer)),
                       f"mapping rank {r}'s region")
                table[r] = peer.value
        return table, slot


_GATHERS = {}    # id(group) -> (group, its RowGather)


def row_gather(group=None) -> RowGather:
    """The group's one `RowGather` (`group` None: the world), made at its
    first use.  The entry holds the group, so its id names no other."""
    key = dist.group.WORLD if group is None else group
    held = _GATHERS.get(id(key))
    if held is None or held[0] is not key:
        held = _GATHERS[id(key)] = (key, RowGather(group))
    return held[1]


@lc.counted("peer_exchange")
def all_gather_rows(local: torch.Tensor, gather: RowGather) -> torch.Tensor:
    """This rank's block local (B, m, 3) -> (B, tp * m, 3) over the group
    of `gather`: the kernels for CUDA tensors, the plain version for CPU
    tensors.  The kernels count their launches on the device (`launches`,
    one per exchange)."""
    if not local.is_cuda:
        return all_gather_rows_plain(local, gather.group)
    if local.dim() != 3 or local.element_size() % 4:
        raise ValueError(f"all_gather_rows: a (B, m, k) block of 4- or "
                         f"8-byte values, got {local.dtype} "
                         f"{tuple(local.shape)}")
    # (m, B, k) contiguous: no copy for dense_ops.mm's product
    t = local.transpose(0, 1).contiguous()
    nbytes = t.numel() * t.element_size()
    table, slot = gather.regions(t.device, nbytes)
    out = t.new_empty((gather.tp * t.shape[0],) + tuple(t.shape[1:]))
    _check(_lib().px_exchange(
        table, gather.rank, gather.tp, t.data_ptr(), out.data_ptr(), nbytes,
        slot, int(TIMEOUT_S * 1e9), lc.address("peer_exchange", t.device),
        torch.cuda.current_stream(t.device).cuda_stream), "launch")
    return out.transpose(0, 1)
