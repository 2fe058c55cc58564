"""The port's host timing: the tracer of the step's device programs, and
per-episode solver statistics.

The tracer says where a window of device programs (`core/graphs.py`) spent
its time.  It is on while `graphs.TIMING` is a list, the switch under which
every program launch also appends its (start, end) CUDA events there.  A
list it has not seen before opens a new window, which it keeps after
`TIMING` is set back to None.  In a window it records

  * host spans (`span(name)`, one tree per evaluation): a name, start and
    end on `time.perf_counter`, the parent span and the evaluation's number.
    An `evaluate` span is an evaluation: at its start the tracer
    synchronizes the card, reads the host clock and records a CUDA event,
    the origin that maps every later launch's events onto the host clock;
  * each program launch (`launch`): its kind (the program key's first
    entry: "pd" the PD step, "adj" the adjoint), the innermost host span
    open when the host queued it, and its events;
  * the programs' loop counters (body runs, and the device nanoseconds
    inside each loop, which `csrc/graph_program.cu` reads from
    `%globaltimer`), copied on the device before each program's first
    launch in the window and after every launch.

`last_report()` turns the last window into numbers (one device read): the
launches' event seconds by kind and by host span, the device's idle
seconds (the window less the launches) given to the innermost host span
open over them, and each loop's body runs, iterations and device seconds.
The window and its report outlive the sim that ran it.  With tracing off a
span is one check of `graphs.TIMING`.

`EpisodeStats` is the counterpart of the reference's per-episode solver
log records (convergeIter / cumulateIter / totalConverged,
Simulation.h:94-98).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from diffcloth_tpu_torch.core import graphs as _graphs

# the span that is an evaluation (and takes the clock's origin)
EVALUATE = "evaluate"
# where idle time outside every span goes
BETWEEN = "between evaluations"


@dataclass
class Span:
    name: str
    parent: int          # the parent's index in Window.spans, -1: a root
    evaluation: int      # the enclosing evaluate span's number, -1: none
    start: float         # time.perf_counter seconds
    end: float = math.nan


class Window:
    """What the tracer kept while one `graphs.TIMING` list was on."""

    def __init__(self, timing: list):
        self.timing = timing
        self.spans: List[Span] = []
        self.stack: List[int] = []     # the open spans, innermost last
        self.origins = []              # (host seconds, CUDA event)
        self.launches = []             # (kind, span, origin, events)
        self.counters = {}             # id(runs) -> _Counters
        self.evaluations = 0
        self._report = None

    def open(self, name: str) -> int:
        parent = self.stack[-1] if self.stack else -1
        if name == EVALUATE:
            evaluation = self.evaluations
            self.evaluations += 1
            start = self._origin()
        else:
            evaluation = self.spans[parent].evaluation if parent >= 0 else -1
            start = time.perf_counter()
        self.spans.append(Span(name, parent, evaluation, start))
        self.stack.append(len(self.spans) - 1)
        return len(self.spans) - 1

    def close(self, i: int) -> None:
        """Close span i, and any span still open inside it."""
        end = self.spans[i].end = time.perf_counter()
        if i in self.stack:
            for j in self.stack[self.stack.index(i) + 1:]:
                self.spans[j].end = end
            del self.stack[self.stack.index(i):]

    def _origin(self) -> float:
        """Synchronize, read the host clock, record the origin event."""
        if not torch.cuda.is_available():
            return time.perf_counter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.origins.append((t0, event))
        return t0

    def report(self) -> dict:
        """The window's numbers (see `last_report`); made once the window
        is closed."""
        if self._report is not None:
            return self._report
        out = self._make_report()
        if _graphs.TIMING is not self.timing:
            self._report = out
        return out

    def _make_report(self) -> dict:
        if self.launches:
            torch.cuda.synchronize()
        kind_s: Dict[str, float] = {}
        launch_s: Dict[str, Dict[str, float]] = {}
        counts: Dict[str, int] = {}
        busy = []
        for kind, sp, o, (a, b) in self.launches:
            t0, origin = self.origins[o]
            start = t0 + origin.elapsed_time(a) / 1e3
            d = a.elapsed_time(b) / 1e3
            busy.append((start, start + d))
            where = self.spans[sp].name if sp >= 0 else BETWEEN
            kind_s[kind] = kind_s.get(kind, 0.0) + d
            by = launch_s.setdefault(kind, {})
            by[where] = by.get(where, 0.0) + d
            counts[kind] = counts.get(kind, 0) + 1
        ends = [s.end for s in self.spans if not math.isnan(s.end)]
        ends += [e for _, e in busy]
        starts = [s.start for s in self.spans] + [t for t, _ in self.origins]
        if not starts:
            return {}
        start, end = min(starts), max(ends + starts)
        return dict(wall_s=end - start,
                    busy_s=sum(e - s for s, e in busy),
                    evaluations=self.evaluations, launches=counts,
                    kind_s=kind_s, launch_s=launch_s,
                    idle_s=attribute_idle(idle_intervals(busy, start, end),
                                          self.spans, start, end),
                    loops=self._loops())

    def _loops(self) -> dict:
        """{kind: {loop name: {"runs", "iters", "device_s"}}} over the
        window: body runs, iterations (runs x block length, masked ones
        included) and device seconds inside the loop (one device read)."""
        cs = [c for c in self.counters.values() if c.runs.numel()]
        if not cs:
            return {}
        diffs = torch.cat([(c.last - c.first).flatten() for c in cs]).cpu()
        out, at = {}, 0
        for c in cs:
            d = diffs[at:at + c.runs.numel()].view(c.runs.shape).tolist()
            at += c.runs.numel()
            for (name, every, _), row in zip(c.bodies, d):
                lp = out.setdefault(c.kind, {}).setdefault(
                    name, dict(runs=0, iters=0, device_s=0.0))
                lp["runs"] += row[0]
                lp["iters"] += row[0] * every
                lp["device_s"] += row[2] / 1e9
        return out


@dataclass
class _Counters:
    """A program's loop counters (`graphs._Program.runs`) in a window: the
    tensor, copies from before its first launch and after its last."""
    kind: str
    bodies: list
    runs: torch.Tensor
    first: torch.Tensor
    last: torch.Tensor


def idle_intervals(busy, start: float, end: float) -> list:
    """The complement in [start, end] of the union of the `busy`
    (start, end) intervals, as sorted (start, end) pairs."""
    out, t = [], start
    for s, e in sorted(busy):
        s, e = max(s, start), min(e, end)
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return out


def attribute_idle(idle, spans: List[Span], start: float,
                   end: float) -> Dict[str, float]:
    """{span name: seconds}: each idle instant goes to the innermost span
    open over it, BETWEEN where none is.  `idle`: sorted disjoint
    (start, end) pairs; `spans` nest (one still open ends with its parent,
    a root at `end`)."""
    s = np.array([a for a, _ in idle], np.float64)
    e = np.array([b for _, b in idle], np.float64)
    cum = np.concatenate([[0.0], np.cumsum(e - s)])

    def before(x):      # idle seconds before x
        j = int(np.searchsorted(e, x, side="right"))
        return cum[j] + (max(0.0, x - s[j]) if j < len(s) else 0.0)

    def until(i):       # where span i ends (-1: the window)
        if i < 0:
            return end
        sp = spans[i]
        return until(sp.parent) if math.isnan(sp.end) else min(sp.end, end)

    def within(i):      # idle seconds inside span i (-1: the window)
        lo = start if i < 0 else max(spans[i].start, start)
        return before(until(i)) - before(lo)

    total = {i: within(i) for i in range(-1, len(spans))}
    own = dict(total)
    for i, sp in enumerate(spans):
        own[sp.parent] -= total[i]
    out: Dict[str, float] = {}
    for i, sec in own.items():
        name = BETWEEN if i < 0 else spans[i].name
        out[name] = out.get(name, 0.0) + sec
    return out


_last: Optional[Window] = None


def _window() -> Window:
    """The window of the current `graphs.TIMING` list (opened at its first
    sight)."""
    global _last
    if _last is None or _last.timing is not _graphs.TIMING:
        _last = Window(_graphs.TIMING)
    return _last


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("window", "name", "index")

    def __init__(self, window: Window, name: str):
        self.window, self.name = window, name

    def __enter__(self):
        self.index = self.window.open(self.name)
        return None

    def __exit__(self, *exc):
        self.window.close(self.index)
        return False


def span(name: str):
    """A host span of the current window, as a context manager (`with
    span("forward"):`); with tracing off a shared no-op."""
    if _graphs.TIMING is None:
        return _OFF
    return _On(_window(), name)


def launch(key, runs: torch.Tensor, bodies: list) -> tuple:
    """A program launch about to be queued (`graphs.BlockGraphs.program`,
    tracing on): its (start, end) CUDA events, the start one recorded;
    the program's loop counters `runs` copied at its first launch in the
    window."""
    w = _window()
    if not w.origins:
        w._origin()
    kind = key[0] if isinstance(key, tuple) else str(key)
    if id(runs) not in w.counters:
        w.counters[id(runs)] = _Counters(kind, bodies, runs, runs.clone(),
                                         runs.clone())
    events = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
    events[0].record()
    w.launches.append((kind, w.stack[-1] if w.stack else -1,
                       len(w.origins) - 1, events))
    return events


def launched(runs: torch.Tensor) -> None:
    """After a traced launch: its program's loop counters, copied on the
    device."""
    _last.counters[id(runs)].last.copy_(runs)


def last_window() -> Optional[Window]:
    """The last window opened, kept after tracing is switched off."""
    return _last


def last_report() -> Optional[dict]:
    """The last window's numbers, None where it recorded nothing:
    {"wall_s": its host seconds, first span or origin to last end,
    "busy_s": the launches' event seconds, "evaluations", "launches":
    {kind: count}, "kind_s": {kind: event seconds}, "launch_s": {kind:
    {innermost span's name: event seconds}}, "idle_s": {innermost span's
    name: idle seconds} (they sum to wall_s less busy_s), "loops": {kind:
    {loop: {"runs", "iters", "device_s"}}}}."""
    if _last is None or not (_last.spans or _last.launches):
        return None
    return _last.report()


@dataclass
class EpisodeStats:
    """Per-episode solver statistics (the reference's forward and backward
    log records, convergeIter / cumulateIter / totalConverged,
    Simulation.h:94-98)."""
    n_steps: int = 0
    total_pd_iters: int = 0
    n_converged: int = 0
    forward_s: float = 0.0
    backward_s: float = 0.0

    @classmethod
    def from_records(cls, recs, forward_s: float = 0.0,
                     backward_s: float = 0.0) -> "EpisodeStats":
        """From a single episode's records."""
        iters = recs.steps.iters.detach().cpu().numpy().astype(np.int64)
        conv = recs.steps.converged.detach().cpu().numpy()
        return cls(n_steps=int(iters.shape[0]),
                   total_pd_iters=int(iters.sum()),
                   n_converged=int(conv.sum()),
                   forward_s=forward_s, backward_s=backward_s)

    def report(self) -> str:
        sps = self.n_steps / self.forward_s if self.forward_s > 0 else 0.0
        return (f"[episode] steps={self.n_steps} "
                f"PD iters={self.total_pd_iters} "
                f"({self.total_pd_iters / max(self.n_steps, 1):.1f}/step) "
                f"converged={self.n_converged}/{self.n_steps} "
                f"forward={self.forward_s * 1e3:.1f} ms ({sps:.1f} steps/s) "
                f"backward={self.backward_s * 1e3:.1f} ms")
