"""The tensor-parallel solve (`parallel/mesh.make_tp_solve`, an NCCL
all-gather) on the card.  A step given any `solve_fn` runs uncaptured
(`core/graphs.resolve`) and `cuda_graphs=True` with one raises: on a
world-size-1 NCCL group in this process, the tp step's losses equal the
plain (captured) step's bit for bit; on two ranks (one card each,
spawned; skips below two cards), the ranks' replicated results are bit
for bit alike.

These tests need NVIDIA GPUs and skip without them; run them there with

    python -m pytest --noconftest -q tests/test_torch_parallel_cuda.py

The scene is the flagship stand-in's physics (the tshirt wind system-ID,
n = 1024) cut to STEPS steps, B episodes of perturbed winds, half of them
starting folded, so that self-contact and the friction kernels run.
"""
import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from diffcloth_tpu_torch import losses
from diffcloth_tpu_torch.config import LossType
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.geometry import states
from diffcloth_tpu_torch.parallel import mesh as pmesh
from diffcloth_tpu_torch.tasks.registry import TSHIRT_GRID_STANDIN

pytestmark = pytest.mark.cuda
STEPS = 4
B = 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL and the CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tp_value_and_grad(mesh, tp=True) -> dict:
    """This rank's value-and-grad (dp = 1: the whole batch), with the tp
    solve or (tp False) the plain step, the third of three calls:
    {"losses", "wind", "launches", "captured"} as numpy."""
    scene = gb.build_scene(dataclasses.replace(TSHIRT_GRID_STANDIN,
                                               step_num=STEPS))
    sim = ClothSim(scene, device="cuda", dtype=torch.float32,
                   solve_fn=pmesh.make_tp_solve(mesh.tp_group) if tp
                   else None)
    base = sim.default_params()
    x0 = np.stack([states.folded_grid(scene, 16,
                                      -1.5 * float(scene.radii.mean())),
                   scene.x_rest])
    winds = np.random.RandomState(0).randn(B, 3) * 0.02 + [0.04, 0.004,
                                                           0.04]
    params = base.expand(B).replace(
        x0=torch.as_tensor(x0, dtype=sim.dtype, device=sim.device),
        wind=torch.as_tensor(winds, dtype=sim.dtype, device=sim.device))
    target = torch.zeros((STEPS + 1, sim.n, 3), dtype=sim.dtype,
                         device=sim.device)
    loss_fn = losses.make_loss_fn(LossType.MATCH_TRAJECTORY,
                                  losses.LossInfo(target_x=target))
    fn = pmesh.batched_value_and_grad(sim, loss_fn, mesh,
                                      reduce_grads=False,
                                      p_inv_spec="tp" if tp else None)
    p_inv = sim.p_inv(base)
    for _ in range(3):
        for g in sim.graphs:
            g.reset()
        L, grads = fn(params, p_inv)
    torch.cuda.synchronize()
    launches = sum(p["launches"] for g in sim.graphs
                   for p in g.summary().values())
    return {"losses": L.cpu().numpy(), "wind": grads.wind.cpu().numpy(),
            "launches": np.asarray(launches),
            "captured": np.asarray(sim.cuda_graphs)}


def refuses_graphs(mesh):
    with pytest.raises(ValueError, match="solve_fn"):
        ClothSim(gb.build_scene(TSHIRT_GRID_STANDIN), device="cuda",
                 solve_fn=pmesh.make_tp_solve(mesh.tp_group),
                 cuda_graphs=True)


def test_tp_step_runs_uncaptured_world_one(card):
    """On one rank the tp step runs uncaptured by default, with losses
    equal bit for bit to the plain step's (captured), and
    `cuda_graphs=True` with the tp solve raises."""
    pmesh.initialize_distributed("nccl", f"tcp://localhost:{free_port()}",
                                 1, 0)
    try:
        mesh = pmesh.make_mesh(1, 1)
        refuses_graphs(mesh)
        t, p = tp_value_and_grad(mesh), tp_value_and_grad(mesh, tp=False)
    finally:
        dist.destroy_process_group()
    assert not bool(t["captured"]) and int(t["launches"]) == 0
    assert bool(p["captured"]) and int(p["launches"]) > 0
    np.testing.assert_array_equal(t["losses"], p["losses"])
    assert np.isfinite(t["losses"]).all() and np.abs(t["wind"]).max() > 0


def rank_worker(rank, world, port, out_dir):
    torch.cuda.set_device(rank)
    pmesh.initialize_distributed("nccl", f"tcp://localhost:{port}", world,
                                 rank)
    try:
        mesh = pmesh.make_mesh(1, world)
        refuses_graphs(mesh)
        np.savez(f"{out_dir}/rank{rank}.npz", **tp_value_and_grad(mesh))
    finally:
        dist.destroy_process_group()


def test_tp_step_of_two_ranks_runs_uncaptured(card, tmp_path):
    """On two ranks (one card each) the tp step runs uncaptured by default,
    `cuda_graphs=True` raises, and the ranks' replicated results agree bit
    for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    import torch.multiprocessing as mp
    mp.spawn(rank_worker, args=(2, free_port(), str(tmp_path)), nprocs=2)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for res in ranks:
        assert not bool(res["captured"]) and int(res["launches"]) == 0
        assert np.isfinite(res["losses"]).all()
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    np.testing.assert_array_equal(ranks[0]["wind"], ranks[1]["wind"])
