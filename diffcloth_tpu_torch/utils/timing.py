"""Hierarchical wall-clock timing, device profiling and per-episode solver
statistics.

Counterpart of `diffcloth_tpu/utils/timing.py` (the reference's `Timer`,
engine/Timer.h:11-201, and the percentage tables of its forward and
backward logs, `exportStatistics`, Simulation.cpp:4003).  Sections time
host-side around device calls; the caller synchronises the card inside a
section whose work it means to count.  `trace` records a torch.profiler
trace for kernel-level attribution.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class _Section:
    total_s: float = 0.0
    count: int = 0


@dataclass
class Timer:
    """Labeled tic/toc accumulator with nesting via '/' paths (reference
    Timer::tic/toc, engine/Timer.h:30-96)."""
    sections: Dict[str, _Section] = field(default_factory=dict)
    _stack: List[str] = field(default_factory=list)
    _starts: List[float] = field(default_factory=list)

    def tic(self, label: str) -> None:
        path = "/".join(self._stack + [label])
        self._stack.append(label)
        self._starts.append(time.perf_counter())
        self.sections.setdefault(path, _Section())

    def toc(self) -> float:
        label = self._stack.pop()
        dt = time.perf_counter() - self._starts.pop()
        full = "/".join(self._stack + [label])
        sec = self.sections.setdefault(full, _Section())
        sec.total_s += dt
        sec.count += 1
        return dt

    @contextlib.contextmanager
    def section(self, label: str):
        self.tic(label)
        try:
            yield
        finally:
            self.toc()

    def merge(self, other: "Timer") -> None:
        for k, v in other.sections.items():
            sec = self.sections.setdefault(k, _Section())
            sec.total_s += v.total_s
            sec.count += v.count

    def report(self, title: str = "Timing") -> str:
        """Percentage-breakdown table: each section's total and its share
        of the top-level sections' total."""
        total = sum(s.total_s for k, s in self.sections.items()
                    if "/" not in k)
        lines = [f"== {title}: total {total * 1e3:.1f} ms =="]
        for k in sorted(self.sections):
            s = self.sections[k]
            pct = 100.0 * s.total_s / total if total > 0 else 0.0
            indent = "  " * k.count("/")
            name = k.rsplit("/", 1)[-1]
            lines.append(f"{indent}{name:<28s} {s.total_s * 1e3:>10.2f} ms "
                         f"{pct:>6.1f}%  (x{s.count})")
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": s.total_s, "count": s.count}
                for k, s in self.sections.items()}

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1)


@contextlib.contextmanager
def trace(logdir: str):
    """Record a torch.profiler trace of the block (host operators, and the
    card's kernels when there is one) into `logdir` as a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
