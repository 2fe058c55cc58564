"""Batch-of-episodes data parallelism and a row-sharded P^{-1} solve on
torch.distributed.

Counterpart of `diffcloth_tpu/parallel/mesh.py` (a JAX device mesh with
shard_map): one process per rank here, on its own card (NCCL) or on the
CPU (gloo), on a (dp, tp) grid of ranks laid out as the JAX mesh lays out
its devices (rank = d * tp + t):

  * dp: each dp rank runs its slice of a batch of episodes; losses are
    all-gathered to (B,) and gradients averaged over the batch (the JAX
    package's `pmean` over dp), the distributed L-BFGS-B objective;
  * tp: P^{-1}'s rows shard over the tp ranks of a dp group; each
    multiplies its (n/tp, n) block and the (n, 3) solution is
    all-gathered (`exchange.all_gather_rows`: on the card a peer-to-peer
    copy that runs inside the step's captured programs, as the JAX
    package's all_gather runs inside its jitted while_loops).  Everything
    else (projections, friction, the loops' exits) runs replicated on the
    tp ranks, which compute the same bits from the same gathered solution,
    so their loops run the same iterations.

The solve is a constant to autograd (as P^{-1} is in the step's
`StepFn`), so no collective needs a gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from diffcloth_tpu_torch.core import dense_ops as dn
from diffcloth_tpu_torch.core.device import resolve_device
from diffcloth_tpu_torch.core.types import SimParams
from diffcloth_tpu_torch.parallel import exchange


def initialize_distributed(backend: Optional[str] = None,
                           init_method: str = "env://",
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, device=None) -> None:
    """Join the process group (once per process, before any collective).
    `backend` None: NCCL when `device` is the card (its default), gloo on
    the CPU.  `init_method` "env://" reads MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK as torchrun sets them; give "tcp://host:port" or
    "file://path" with world_size and rank otherwise."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


@dataclasses.dataclass
class Mesh:
    """This rank's place on the (dp, tp) grid and its two groups."""
    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    dp_group: object     # the dp ranks that share this rank's tp index
    tp_group: object     # the tp ranks of this rank's dp group


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """The (dp, tp) grid over the world's ranks (dp None: world // tp).
    Every rank calls it with the same arguments (it creates every group)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp {dp} x tp {tp} != world size {world}")
    dp_group = tp_group = None
    for t in range(tp):
        g = dist.new_group([d * tp + t for d in range(dp)])
        if rank % tp == t:
            dp_group = g
    for d in range(dp):
        g = dist.new_group([d * tp + t for t in range(tp)])
        if rank // tp == d:
            tp_group = g
    return Mesh(dp=dp, tp=tp, dp_rank=rank // tp, tp_rank=rank % tp,
                dp_group=dp_group, tp_group=tp_group)


def make_tp_solve(group=None):
    """The row-sharded P^{-1} apply, for `ClothSim(..., solve_fn=...)`:
    solve(p_inv_block (n/tp, n), rhs (B, n, 3)) -> (B, n, 3), this rank's
    block product all-gathered over `group` (the mesh's tp_group).  The one
    `solve_fn` a step runs captured (`graphs.resolve`: `capturable`).
    Every solve of a group shares its gather (`exchange.row_gather`)."""
    gather = exchange.row_gather(group)

    def solve(p_inv_block, rhs):
        return gather(dn.mm(p_inv_block, rhs))

    solve.capturable = True
    return solve


def _rows(a: torch.Tensor, part: int, parts: int) -> torch.Tensor:
    if a.shape[0] % parts:
        raise ValueError(f"{a.shape[0]} rows do not split into {parts}")
    m = a.shape[0] // parts
    return a[part * m:(part + 1) * m]


def shard_rollout_batch(mesh: Mesh, batch):
    """This rank's slice of a batch-leading tensor or `SimParams` (the dp
    rank's contiguous B/dp episodes)."""
    if isinstance(batch, SimParams):
        return SimParams(**{k: _rows(v, mesh.dp_rank, mesh.dp)
                            for k, v in batch.items()})
    return _rows(batch, mesh.dp_rank, mesh.dp)


def _gather_dp(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    if mesh.dp == 1:
        return local
    out = local.new_empty((mesh.dp * local.shape[0],) + local.shape[1:])
    dist.all_gather_into_tensor(out, local.contiguous(),
                                group=mesh.dp_group)
    return out


def batched_value_and_grad(sim, loss_fn, mesh: Mesh,
                           reduce_grads: bool = True,
                           p_inv_spec: Optional[str] = None,
                           chunk: Optional[int] = None):
    """The data-parallel episode objective over a batch of parameters:
    fn(params_batch (batched SimParams, all B episodes, the same on every
    rank), p_inv) -> (losses (B,), grads).  Each rank runs its dp slice.
    reduce_grads=True: the gradient averaged over the whole batch, an
    unbatched SimParams, the same on every rank; otherwise every episode's
    gradient, all-gathered.  p_inv_spec "tp": p_inv is the full P^{-1} and
    each rank passes its tp row block to the step; pair it with a sim built
    with `solve_fn=make_tp_solve(mesh.tp_group)`.  `chunk` given: each
    rank's episodes run `sim.episode_value_and_grad_chunked` in chunks of
    `chunk` steps (the horizon's residuals never held at once: the dress)."""
    value_and_grad = (sim.episode_value_and_grad(loss_fn) if chunk is None
                      else sim.episode_value_and_grad_chunked(
                          loss_fn, chunk, batched=True))

    def fn(params_batch: SimParams, p_inv):
        if p_inv_spec == "tp":
            p_inv = _rows(p_inv, mesh.tp_rank, mesh.tp)
        losses, grads = value_and_grad(shard_rollout_batch(mesh,
                                                           params_batch),
                                       p_inv=p_inv)
        losses = _gather_dp(mesh, losses)
        if not reduce_grads:
            return losses, SimParams(**{k: _gather_dp(mesh, g)
                                        for k, g in grads.items()})
        out = {}
        for k, g in grads.items():
            g = g.mean(dim=0)
            if mesh.dp > 1:
                dist.all_reduce(g, group=mesh.dp_group)
            out[k] = g / mesh.dp
        return losses, SimParams(**out)

    return fn
