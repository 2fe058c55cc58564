"""The step's programs run uncaptured: segments called in turn, each masked
loop run in blocks while any episode is still active (the host reads
`st["go"]` before every block)."""
from __future__ import annotations

import dataclasses
from typing import Callable


def resolve(cuda_graphs, device, solve_fn=None) -> bool:
    """Never captured."""
    return False


@dataclasses.dataclass
class Loop:
    """A masked while loop of a program: `block(st, k)` runs k iterations
    and leaves st["go"] (B,) bool: which episodes are still active.  At
    most `total` iterations, in blocks of `every` (the last one shorter
    when `every` does not divide `total`); a block runs while any episode
    is active.  A finished episode's extra iterations are masked no-ops."""
    block: Callable
    total: int
    every: int
    name: str = "loop"


def run_blocks(total: int, every: int, run_block, active=None) -> int:
    """`total` masked iterations as blocks of `every`: run_block(k) runs k
    of them.  Before every block the host reads active() (a (B,) bool
    tensor) and stops when no episode is active; active None runs every
    block.  Returns the iterations run, masked ones included."""
    for k in range(0, total, every):
        if active is not None and not bool(active().any()):
            return k
        run_block(min(every, total - k))
    return total


class BlockGraphs:
    """The dicts of tensors a step's segments read and write."""

    enabled = False

    def __init__(self, enabled: bool = False):
        self._bufs = {}

    def bind(self, name, tensors: dict, once=()) -> dict:
        st = self._bufs.setdefault(name, {})
        st.update(tensors)
        return st

    def store(self, st: dict, values: dict) -> None:
        st.update(values)

    def take(self, t):
        return t

    def program(self, key, segments, st: dict) -> None:
        for seg in segments:
            if isinstance(seg, Loop):
                run_blocks(seg.total, seg.every,
                           lambda k, s=seg: s.block(st, k), lambda: st["go"])
            else:
                seg(st)
