"""Device programs of the step: the port's counterpart of the JAX package's
jitted step, whose loops are `lax.while_loop`s on the device.

The JAX package runs a step as one compiled program: the contact prologue
(`diffcloth_tpu/core/step.py:468-557`), the PD loop (`:626`), the adjoint's
fixed point (`:774`), its GMRES cycles (`:754`, `:782`, their least
squares on the device, `:136`) and Jacobi-PCG (`:185`).  The port writes a
step's forward and its adjoint each as a list of segments over a dict of
tensors (`core/step.py`): a callable is a straight segment, a `Loop` a
masked while loop, run in blocks of `every` iterations while any episode
is still active (`st["go"]`, a (B,) bool tensor the blocks keep up to
date).  `BlockGraphs.program` runs such a list:

  * uncaptured (the CPU, `cuda_graphs=False`, a step given a `solve_fn`
    other than the tensor-parallel one): the segments are called in turn,
    and the host reads `st["go"].any()` before every block of a loop
    (`run_blocks`);
  * captured (a CUDA device): the first run of a program is its warm-up
    (uncaptured, on the capture stream: it loads every kernel library and
    allocates cuBLAS's workspace); the second captures each straight
    segment and each loop's block (one per block length) into a PyTorch
    graph and builds one CUDA graph of them (`csrc/graph_program.cu`):
    child-graph nodes for the segments and, per loop, a WHILE conditional
    node whose body is the block followed by a kernel that reads the
    predicate; every later run launches that graph.  A loop ends on the
    device: the host neither reads nor waits between a step's segments or
    iterations.  A capture or a build that fails raises.

A graph bakes in its kernels' arguments, so every tensor a program reads
is copied into the static buffer bound to its name (`bind`) once per call
(entries named in `once` only when their source tensor changes), and the
segments write what they make into static buffers (`store`).

The kernels count their own launches on the device (`launch_count`), so a
replayed graph counts what it ran.  A capture runs nothing: the kernels a
segment or a loop's block holds are the wrapper calls its capture makes
(`launch_count.tally`).  The loops' bodies count their runs on the device
too.  `summary()` reports, per program, its warm-up, launches, kernels per
launch and, per loop, its body runs and kernels per run: what the
launches x kernels per launch plus the runs x kernels per run predict, a
cross-check of the kernels' own counts.

What stays uncaptured: a step given a `solve_fn` other than the
tensor-parallel solve (the caller's solve may hold collectives or host
work; a WHILE body holding NCCL's all-gather fails to instantiate, so
the tp solve gathers with `parallel/exchange.py`'s kernels), and what
lies between steps (the episode's freeze select and records).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import gc
import weakref
from typing import Callable

import numpy as np
import torch

from diffcloth_tpu_torch.core import cuda_build
from diffcloth_tpu_torch.core import launch_count as lc


def resolve(cuda_graphs, device: torch.device, solve_fn=None) -> bool:
    """Whether a step runs captured: `cuda_graphs` None means yes on a CUDA
    device unless the step is given a `solve_fn` other than the
    tensor-parallel solve (`parallel/mesh.make_tp_solve`'s, marked
    `capturable`: its all-gather is a kernel pair that runs inside a
    capture); True asks for graphs and raises where there can be none (the
    CPU, another `solve_fn`); False runs the same segments uncaptured (the
    counterpart of `jax.disable_jit()`)."""
    capturable = solve_fn is None or getattr(solve_fn, "capturable", False)
    if cuda_graphs is None:
        return device.type == "cuda" and capturable
    if cuda_graphs and device.type != "cuda":
        raise ValueError(f"cuda_graphs=True needs a CUDA device, not "
                         f"{device}")
    if cuda_graphs and not capturable:
        raise ValueError("cuda_graphs=True with a solve_fn: a step given a "
                         "solve_fn other than the tensor-parallel solve runs "
                         "uncaptured (the caller's solve may hold "
                         "collectives or host work)")
    return bool(cuda_graphs)


@dataclasses.dataclass
class Loop:
    """A masked while loop of a program: `block(st, k)` runs k iterations
    and leaves st["go"] (B,) bool: which episodes are still active.  At
    most `total` iterations, in blocks of `every` (the last one shorter
    when `every` does not divide `total`); a block runs while any episode
    is active.  A finished episode's extra iterations are masked no-ops.
    `name` names the loop in `summary()`."""
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


def _run_uncaptured(segments, st: dict) -> None:
    for seg in segments:
        if isinstance(seg, Loop):
            run_blocks(seg.total, seg.every,
                       lambda k, s=seg: s.block(st, k), lambda: st["go"])
        else:
            seg(st)


@functools.lru_cache(maxsize=None)
def _lib():
    """csrc/graph_program.cu's entry points, loaded and typed once."""
    lib = cuda_build.load("graph_program")
    vp, pvp, i = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), \
        ctypes.c_int
    for name, args in (("gp_create", [pvp]),
                       ("gp_add_child", [vp, vp, vp, pvp]),
                       ("gp_add_loop", [vp, vp, vp, vp, i, i, vp, vp, pvp]),
                       ("gp_instantiate", [vp, pvp]),
                       ("gp_launch", [vp, vp]),
                       ("gp_destroy", [vp, vp])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"graph program: {what} failed: cudaError {err}")


class _Program:
    """One key's program: its warm-up, then its CUDA graph and launches."""

    def __init__(self):
        self.eager = 1                         # the warm-up
        self.launches = 0
        self.graph = self.exec = None
        self.captured = []                     # PyTorch graphs, kept alive
        self.straight = [0] * len(lc.SLOTS)    # kernels per launch
        self.bodies = []      # per loop body: (name, every, kernels)
        self.runs = None      # (loops, 2) int64 on the card: body runs,
        #                       loop entries, over every launch
        self.iters = None     # (loops,) int32: runs in the current launch
        self.base = None      # runs at the last reset (host)

    def __del__(self):
        if self.exec is not None or self.graph is not None:
            try:
                _lib().gp_destroy(self.graph, self.exec)
            except Exception:   # interpreter shutdown
                pass


# when a list, every program launch appends its (start, end) CUDA events:
# the device time of the programs, which the profiler cannot see whole (it
# sees few or none of the kernels inside the loop bodies)
TIMING = None


class BlockGraphs:
    """The programs of one step function: their bound buffers and, when
    `enabled`, their graphs, keyed by the caller (kind, batch size, dtype,
    ...).  Dropped with the step function."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._bufs = {}       # bind name -> dict of tensors
        self._once = {}       # (entry, shape, dtype) -> (buffer, ref, version)
        self._programs = {}   # key -> _Program
        self._stream = None
        self._pool = None

    def bind(self, name, tensors: dict, once=()) -> dict:
        """The dict the segments of `name` read and write, with `tensors`
        (None values pass through) merged in.  Uncaptured it holds the given
        tensors themselves.  Captured it holds static buffers, allocated at
        the first bind of an entry (with the entry's strides, so that a
        product reads its operand as the uncaptured segment does: the host
        P^{-1} arrives column-major) and copied into after; an entry in
        `once` shares one buffer across names (per shape and dtype) and is
        copied only when its source tensor (or the source's version)
        changes."""
        st = self._bufs.setdefault(name, {})
        if not self.enabled:
            st.update(tensors)
            return st
        for k, v in tensors.items():
            if v is None:
                st[k] = None
                continue
            if k in once:
                st[k] = self._bind_once(k, v)
                continue
            buf = st.get(k)
            if buf is None:
                st[k] = v.clone()
                continue
            if buf.shape != v.shape or buf.dtype != v.dtype:
                raise ValueError(f"bind {name!r}: {k} is {v.dtype} "
                                 f"{tuple(v.shape)}, its buffer {buf.dtype} "
                                 f"{tuple(buf.shape)}")
            buf.copy_(v)
        return st

    def _bind_once(self, k: str, v: torch.Tensor) -> torch.Tensor:
        key = (k, tuple(v.shape), v.dtype)
        held = self._once.get(key)
        if held is not None:
            buf, ref, version = held
            if ref() is v and v._version == version:
                return buf
            buf.copy_(v)
        else:
            buf = v.clone()
        self._once[key] = (buf, weakref.ref(v), v._version)
        return buf

    def store(self, st: dict, values: dict) -> None:
        """A segment's results into st: uncaptured the tensors themselves;
        captured, copied into their static buffers (made by the warm-up's
        run, which stores copies)."""
        for k, v in values.items():
            if not self.enabled:
                st[k] = v
                continue
            buf = st.get(k)
            if buf is None:
                st[k] = v.clone()
            elif buf.shape != v.shape or buf.dtype != v.dtype:
                raise ValueError(f"store: {k} is {v.dtype} {tuple(v.shape)}"
                                 f", its buffer {buf.dtype} "
                                 f"{tuple(buf.shape)}")
            else:
                buf.copy_(v)

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """A result out of st: captured, a copy (the buffer is the next
        call's); uncaptured, the tensor itself."""
        return t.clone() if self.enabled else t

    def program(self, key, segments, st: dict) -> None:
        """Run `segments` (callables and `Loop`s) on st: uncaptured, or, when
        enabled, the key's warm-up, then its capture and build, then
        launches of its graph on the current stream."""
        if not self.enabled:
            _run_uncaptured(segments, st)
            return
        p = self._programs.get(key)
        if p is None:
            if self._stream is None:
                self._stream = torch.cuda.Stream()
                self._pool = torch.cuda.graph_pool_handle()
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                _run_uncaptured(segments, st)
            torch.cuda.current_stream().wait_stream(self._stream)
            self._programs[key] = _Program()
            return
        if p.exec is None:
            self._build(p, segments, st)
        events = None
        if TIMING is not None:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        _check(_lib().gp_launch(p.exec, torch.cuda.current_stream()
                                .cuda_stream), "launch")
        if events is not None:
            events[1].record()
            TIMING.append(events)
        p.launches += 1

    def _capture(self, p: _Program, fn) -> tuple:
        """fn() captured into a PyTorch graph of the shared pool: (its raw
        cudaGraph_t, kernels per run by `launch_count.SLOTS`)."""
        g = torch.cuda.CUDAGraph(keep_graph=True)
        lc.tally = kernels = [0] * len(lc.SLOTS)
        # no garbage collection inside a capture: collecting a dropped
        # sim's programs destroys their graphs (`_Program.__del__`), a call
        # that invalidates the capture under way
        collecting = gc.isenabled()
        gc.disable()
        try:
            # every buffer a segment reads or writes is a static one of st;
            # what it allocates comes from the programs' pool, shared by
            # the programs of this step function, which run one after
            # another on one stream and keep nothing alive between runs
            with torch.cuda.graph(g, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                fn()
        finally:
            lc.tally = None
            if collecting:
                gc.enable()
        p.captured.append(g)
        return ctypes.c_void_p(g.raw_cuda_graph()), kernels

    def _build(self, p: _Program, segments, st: dict) -> None:
        lib = _lib()
        bodies = []
        for seg in segments:
            if isinstance(seg, Loop):
                nfull, rem = divmod(seg.total, seg.every)
                bodies += [(seg, k, cap) for k, cap in (
                    (seg.every, nfull), (rem, 1)) if k and cap]
        dev = torch.cuda.current_device()
        p.runs = torch.zeros((len(bodies), 2), dtype=torch.int64, device=dev)
        p.iters = torch.zeros(max(len(bodies), 1), dtype=torch.int32,
                              device=dev)
        p.base = np.zeros((len(bodies), 2), np.int64)
        graph = ctypes.c_void_p()
        _check(lib.gp_create(ctypes.byref(graph)), "create")
        p.graph = graph
        dep = ctypes.c_void_p()
        for seg in segments:
            node = ctypes.c_void_p()
            if not isinstance(seg, Loop):
                child, kernels = self._capture(p, lambda s=seg: s(st))
                p.straight = [a + b for a, b in zip(p.straight, kernels)]
                _check(lib.gp_add_child(graph, dep, child, ctypes.byref(node)),
                       "a segment")
                dep = node
                continue
            go = st["go"]
            if go.dtype != torch.bool or go.dim() != 1 or \
                    not go.is_contiguous():
                raise ValueError("a loop's predicate st['go'] must be a "
                                 "contiguous (B,) bool tensor")
            for body, k, cap in bodies:
                if body is not seg:
                    continue
                i = len(p.bodies)
                child, kernels = self._capture(
                    p, lambda s=seg, k=k: s.block(st, k))
                p.bodies.append((seg.name, k, kernels))
                _check(lib.gp_add_loop(
                    graph, dep, child, go.data_ptr(), go.numel(), cap,
                    p.iters[i:].data_ptr(), p.runs[i].data_ptr(),
                    ctypes.byref(node)), "a loop")
                dep = node
                node = ctypes.c_void_p()
        exe = ctypes.c_void_p()
        _check(lib.gp_instantiate(graph, ctypes.byref(exe)), "instantiate")
        p.exec = exe

    def _runs(self) -> dict:
        """{key: (loops, 2) body runs and entries, host} of the built
        programs (one device read)."""
        progs = {k: p for k, p in self._programs.items()
                 if p.runs is not None and len(p.bodies)}
        if not progs:
            return {}
        now = torch.cat([p.runs.flatten() for p in progs.values()]).cpu()
        out, at = {}, 0
        for k, p in progs.items():
            out[k] = now[at:at + p.runs.numel()].numpy().reshape(
                p.runs.shape)
            at += p.runs.numel()
        return out

    def reset(self) -> None:
        """Zero every program's counts of warm-ups, launches and runs."""
        for k, now in self._runs().items():
            self._programs[k].base = now
        for p in self._programs.values():
            p.eager = p.launches = 0

    def summary(self) -> dict:
        """{key: {"eager": warm-up runs, "launches": graph launches,
        "kernels": {counter: straight kernels per launch}, "loops":
        [{"name": the loop's, "every": block length, "runs": body runs,
        "entries": loop entries, "kernels": {counter: kernels per body
        run}}]}} for every program run since the last `reset()` (one device
        read)."""
        runs = self._runs()

        def named(ks):
            return {name: k for name, k in lc.named(ks).items() if k}

        out = {}
        for key, p in self._programs.items():
            if not p.eager + p.launches:
                continue
            loops = []
            for (name, every, kernels), now, base in zip(
                    p.bodies, runs.get(key, ()),
                    p.base if p.base is not None else ()):
                loops.append({"name": name, "every": every,
                              "runs": int(now[0] - base[0]),
                              "entries": int(now[1] - base[1]),
                              "kernels": named(kernels)})
            out[key] = {"eager": p.eager, "launches": p.launches,
                        "kernels": named(p.straight), "loops": loops}
        return out
