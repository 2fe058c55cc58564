"""Launch counts of the port's hand-written kernels, kept on the device.

Each kernel takes the address of its count, an int64 in a per-device
vector, and adds one to it from one thread of its first block, once per
launch (`count_launch`, csrc/launch_count.cuh).  So a launch is counted
where it runs: called from the host, or replayed inside a captured graph,
where a loop body runs as often as the device decides.  A wrapper's
`launches` (and the friction sweeps' `global_launches` and
`stream_launches`, their global-state and streamed-slot routes) reads the
count, waiting for the device; `zero()` zeroes every count.

A capture runs nothing, so it counts nothing.  `graphs.py` learns which
kernels a captured segment or loop body holds from `tally`: while it is a
list, every wrapper call adds one to its kernel's entry.
"""
from __future__ import annotations

import functools

import torch

# one count per kernel and route (the sweeps' entry points); `named`
# reports them
SWEEP_ROUTES = ("", "_global", "_stream", "_global_stream")
SLOTS = (tuple("friction_fwd" + r for r in SWEEP_ROUTES)
         + tuple("friction_bwd" + r for r in SWEEP_ROUTES)
         + ("selfcol_detect", "hessenberg_lstsq", "peer_exchange",
            "kdv_linearize", "kdv_pre", "kdv_rows", "trip_update"))
_INDEX = {k: i for i, k in enumerate(SLOTS)}
_counts = {}      # device index -> (len(SLOTS),) int64 tensor
_zero = [0] * len(SLOTS)   # the device values at the last zero()
tally = None


def address(slot: str, device: torch.device) -> int:
    """The device address of `slot`'s count on `device`, for the launch
    about to be made there (noted in `tally` when it is a list)."""
    i = _INDEX[slot]
    if tally is not None:
        tally[i] += 1
    t = _counts.get(device.index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("launch counts: the first launch on a device "
                               "must not be a captured one")
        t = torch.zeros(len(SLOTS), dtype=torch.int64, device=device)
        torch.cuda.synchronize(device)
        _counts[device.index] = t
    return t.data_ptr() + 8 * i


def named(per_slot) -> dict:
    """Per-slot counts -> {counter: count}: friction_fwd and friction_bwd
    count every route's launches, the _global ones the global-state
    routes' (slots shared or streamed), the _stream ones the streamed-slot
    routes' (state shared or global)."""
    raw = dict(zip(SLOTS, (int(k) for k in per_slot)))
    c = {k: v for k, v in raw.items() if not k.startswith("friction_")}
    for k in ("friction_fwd", "friction_bwd"):
        shared, glob, stream, both = (raw[k + r] for r in SWEEP_ROUTES)
        c[k] = shared + glob + stream + both
        c[k + "_global"] = glob + both
        c[k + "_stream"] = stream + both
    return c


def _device_counts() -> list:
    total = [0] * len(SLOTS)
    for dev, t in _counts.items():
        torch.cuda.synchronize(dev)
        total = [a + b for a, b in zip(total, t.tolist())]
    return total


def read_all() -> dict:
    """{counter: launches since the last zero()} (waits for the device)."""
    return named(a - z for a, z in zip(_device_counts(), _zero))


def zero() -> None:
    """Start every count again from 0 (waits for the device)."""
    _zero[:] = _device_counts()


class Counted:
    """A kernel's wrapper, called as the function it wraps, whose
    `launches` reads its kernel's count (every route), `global_launches`
    its global-state routes' and `stream_launches` its streamed-slot
    routes'."""

    def __init__(self, fn, counter: str):
        functools.update_wrapper(self, fn)
        self._counter = counter

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self) -> int:
        return read_all()[self._counter]

    @property
    def global_launches(self) -> int:
        return read_all()[self._counter + "_global"]

    @property
    def stream_launches(self) -> int:
        return read_all()[self._counter + "_stream"]


def counted(counter: str):
    """Decorator: `Counted(fn, counter)`."""
    return lambda fn: Counted(fn, counter)
