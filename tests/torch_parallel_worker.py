"""The rank worker of tests/test_torch_parallel.py (a helper, not
collected): imports no JAX, so the spawned ranks start without it and
without the test suite's 8-device JAX setup.

`run(rank, world, init_file, out_dir)` joins a gloo group of `world`
ranks through `file://init_file`, evaluates the port's tiny scene's
batched objective on a dp = world mesh and on a dp = world/2 x tp = 2
mesh (its step's P^{-1} row-sharded), and rank 0 saves both results to
`out_dir/port_parallel.npz`.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.parallel import mesh as pmesh

B = 8


def tiny_cfg(m):
    """tests/test_parallel.py's scene, for either package's config module."""
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=2, cloth_dim_y=2,
                              k_stiff_stretching=300, k_stiff_bending=0.05,
                              grid_num_x=4, grid_num_y=4, density=0.3),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 60.0,
        step_num=3, name="tiny")


def winds(batch):
    return np.random.RandomState(0).randn(batch, 3) * 0.05


def tiny_sim(solve_fn=None):
    return ClothSim(gb.build_scene(tiny_cfg(tc)), device="cpu",
                    dtype=torch.float64, solve_fn=solve_fn)


def population(sim, batch):
    base = sim.default_params()
    return base, base.expand(batch).replace(
        wind=torch.as_tensor(winds(batch)))


def loss_fn(sim):
    target = torch.zeros((sim.n_steps + 1, sim.n, 3), dtype=sim.dtype)
    return tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                           tl.LossInfo(target_x=target))


def run(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    pmesh.initialize_distributed("gloo", f"file://{init_file}", world, rank)
    results = {}
    for name, dp, tp in (("dp", world, 1), ("dp_tp", world // 2, 2)):
        mesh = pmesh.make_mesh(dp, tp)
        sim = tiny_sim(pmesh.make_tp_solve(mesh.tp_group) if tp > 1
                       else None)
        base, params_b = population(sim, B)
        fn = pmesh.batched_value_and_grad(
            sim, loss_fn(sim), mesh, p_inv_spec="tp" if tp > 1 else None)
        losses, grads = fn(params_b, sim.p_inv(base))
        results[f"{name}_losses"] = losses.numpy()
        results[f"{name}_wind"] = grads.wind.numpy()
        results[f"{name}_x0"] = grads.x0.numpy()
    if rank == 0:
        np.savez(os.path.join(out_dir, "port_parallel.npz"), **results)
    dist.barrier()
    dist.destroy_process_group()
