"""CUDA graphs of the step's loop blocks: the port's counterpart of the JAX
package's jitted `while_loop`s.

The JAX package runs a step as compiled device programs: the PD loop
(`diffcloth_tpu/core/step.py:626`), Jacobi-PCG (`:185`) and the adjoint's
fixed point (`:774`) are `lax.while_loop`s inside the jitted episode
(`core/sim.py:423`).  The port's step (`core/step.py`) writes each of those
loops as a block of CHECK_EVERY masked iterations over a dict of tensors,
followed by the host's any-active check; `BlockGraphs` runs such a block:

  * uncaptured (the CPU, `cuda_graphs=False`, a step given `solve_fn`): the
    block's function is called on the dict;
  * captured (a CUDA device): the dict's tensors are static buffers, the
    block's first run per key is its warm-up (eager, on the capture stream:
    it loads and configures every kernel library and allocates cuBLAS's
    workspace), the second captures it into a `torch.cuda.CUDAGraph`, and
    every later run replays that graph.  A capture that fails raises.

A graph bakes in its kernels' arguments, so every tensor a block reads is
copied into the static buffer bound to its name (`bind`) once per step (or
per call: entries named in `once`, the dense P^{-1}, are copied only when
their source tensor changes).  The blocks read nothing else of the step.

Python counters do not tick on replay.  The kernels' launch counters that
tick while a block is captured are kernels per replay: they are taken back
after the capture, and each replay adds them again, so the counters still
count what ran on the card.  `summary()` reports, per block, its eager
runs (the warm-up), its replays and its kernels per replay.

What stays uncaptured, run once per step or per cycle on the host's
orders: the step's prologue (obstacle and self-collision detection,
layering, slot compaction, the slot operands; the detection kernel sets
its shared-memory attribute on every launch), the residual VJP, the GMRES
adjoint mode and the fixed point's GMRES fallback (their Hessenberg least
squares is host work), the controller's MLP, and any step given a
`solve_fn` (the caller's solve may hold collectives or host work).
"""
from __future__ import annotations

import weakref

import torch

from diffcloth_tpu_torch.core import friction_cuda as fc
from diffcloth_tpu_torch.core import selfcol_cuda as scd

# the kernels' launch counters, by the names chip_smoke.py reports them
COUNTERS = (("friction_fwd", fc.friction_sweep, "launches"),
            ("friction_fwd_global", fc.friction_sweep, "global_launches"),
            ("friction_bwd", fc.friction_sweep_bwd, "launches"),
            ("friction_bwd_global", fc.friction_sweep_bwd, "global_launches"),
            ("selfcol_detect", scd.detect_partners, "launches"))


def _read_counters() -> list:
    return [getattr(fn, attr) for _, fn, attr in COUNTERS]


def _add_counters(counts) -> None:
    for (_, fn, attr), k in zip(COUNTERS, counts):
        if k:
            setattr(fn, attr, getattr(fn, attr) + k)


def resolve(cuda_graphs, device: torch.device, solve_fn=None) -> bool:
    """Whether a step runs its blocks captured: `cuda_graphs` None means
    yes on a CUDA device unless the step is given a `solve_fn`; True asks
    for graphs and raises where there can be none (the CPU, a `solve_fn`);
    False runs the same blocks uncaptured (the counterpart of
    `jax.disable_jit()`)."""
    if cuda_graphs is None:
        return device.type == "cuda" and solve_fn is None
    if cuda_graphs and device.type != "cuda":
        raise ValueError(f"cuda_graphs=True needs a CUDA device, not "
                         f"{device}")
    if cuda_graphs and solve_fn is not None:
        raise ValueError("cuda_graphs=True with a solve_fn: a step given "
                         "solve_fn runs uncaptured (the caller's solve may "
                         "hold collectives or host work)")
    return bool(cuda_graphs)


class _Block:
    """One key's block: its warm-up run, then its graph and replays."""

    def __init__(self):
        self.graph = None
        self.kernels = [0] * len(COUNTERS)   # launches per replay
        self.eager = 1                        # the warm-up
        self.replays = 0


class BlockGraphs:
    """The blocks of one step function: their bound buffers and, when
    `enabled`, their graphs, keyed by the caller (batch size, dtype,
    route, block length).  Dropped with the step function."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._bufs = {}       # bind name -> dict of tensors
        self._once = {}       # entry -> (static buffer, source ref, version)
        self._blocks = {}     # run key -> _Block
        self._stream = None
        self._pool = None

    def bind(self, name, tensors: dict, once=()) -> dict:
        """The dict the blocks of `name` read and write, with `tensors`
        (None values pass through) merged in.  Uncaptured it holds the given
        tensors themselves, so a block writes its carry into them in place:
        pass carry tensors that nothing else holds.  Captured it holds
        static buffers, allocated at the first bind of an entry (with the
        entry's strides, so that a product reads its operand as the
        uncaptured block does: the host P^{-1} arrives column-major) and
        copied into after; an entry in `once` shares one buffer across
        names and is copied only when its source tensor (or the source's
        version) changes."""
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
        held = self._once.get(k)
        if held is not None:
            buf, ref, version = held
            if ref() is v and v._version == version:
                return buf
            if buf.shape != v.shape or buf.dtype != v.dtype:
                raise ValueError(f"bind: {k} is {v.dtype} {tuple(v.shape)}, "
                                 f"its buffer {buf.dtype} {tuple(buf.shape)}")
            buf.copy_(v)
        else:
            buf = v.clone()
        self._once[k] = (buf, weakref.ref(v), v._version)
        return buf

    def run(self, key, block, st: dict) -> None:
        """block(st): called directly when uncaptured; captured, the first
        run for `key` is the warm-up, the second captures, later ones
        replay."""
        if not self.enabled:
            block(st)
            return
        b = self._blocks.get(key)
        if b is None:
            if self._stream is None:
                self._stream = torch.cuda.Stream()
                self._pool = torch.cuda.graph_pool_handle()
            # the warm-up: a real run of the block, on the capture stream
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                block(st)
            torch.cuda.current_stream().wait_stream(self._stream)
            self._blocks[key] = _Block()
            return
        if b.graph is None:
            before = _read_counters()
            graph = torch.cuda.CUDAGraph()
            # every buffer the block reads or writes is a static one of st;
            # what it allocates comes from the graphs' pool, shared by the
            # blocks of this step function, which run one after another on
            # one stream and keep nothing alive between runs
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream,
                                  capture_error_mode="thread_local"):
                block(st)
            # the capture launched nothing: take its ticks back, as
            # kernels per replay
            b.kernels = [a - c for a, c in zip(_read_counters(), before)]
            _add_counters([-k for k in b.kernels])
            b.graph = graph
        b.graph.replay()
        b.replays += 1
        _add_counters(b.kernels)

    def reset(self) -> None:
        """Zero every block's counts of runs."""
        for b in self._blocks.values():
            b.eager = b.replays = 0

    def summary(self) -> dict:
        """{key: {"eager": warm-up runs, "replays": graph replays,
        "kernels": {counter: launches per replay}}} for every block run
        since the last `reset()` (its warm-up ran eagerly)."""
        return {key: {"eager": b.eager, "replays": b.replays,
                      "kernels": {name: k for (name, _, _), k
                                  in zip(COUNTERS, b.kernels) if k}}
                for key, b in self._blocks.items() if b.eager + b.replays}
