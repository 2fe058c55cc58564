"""The rank worker of tests/test_torch_parallel.py and tests/tp_f32_gap.py
(a helper, not collected): imports no JAX, so the spawned ranks start
without it and without the test suite's 8-device JAX setup.

`run(rank, world, init_file, out_dir, cases)` joins a gloo group of
`world` ranks through `file://init_file` and, for each (scene, dtype) of
`cases`, evaluates the scene's batched objective on a dp = world mesh and
on a dp = world/2 x tp = 2 mesh (its step's P^{-1} row-sharded); rank 0
saves every result to `out_dir/port_parallel.npz`: the losses and every
SimParams gradient class, keyed `{prefix}{mode}_{name}` (`prefix` of
`key_prefix`).  The scenes: "tiny", tests/test_parallel.py's 4 x 4 grid
(B = 8, no contact); "contact", the flagship stand-in's physics on an
8 x 8 grid started folded half over half as chip_smoke.py folds the
flagship (B = 4, 3 steps, self-contact from the first step).
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.geometry import states
from diffcloth_tpu_torch.parallel import mesh as pmesh

B = 8
CONTACT_B = 4
CONTACT_GRID = 8
DEFAULT_CASES = (("tiny", "float64"), ("contact", "float64"))


def tiny_cfg(m):
    """tests/test_parallel.py's scene, for either package's config module."""
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=2, cloth_dim_y=2,
                              k_stiff_stretching=300, k_stiff_bending=0.05,
                              grid_num_x=4, grid_num_y=4, density=0.3),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 60.0,
        step_num=3, name="tiny")


def contact_cfg(m):
    """The flagship stand-in's physics (tshirt stiffness and density,
    WIND_SIN, h = 1/90, two corners attached) on an 8 x 8 grid, 3 steps,
    for either package's config module."""
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                              k_stiff_stretching=550, k_stiff_bending=0.01,
                              grid_num_x=CONTACT_GRID,
                              grid_num_y=CONTACT_GRID, density=0.124),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=3, name="folded_contact")


def contact_x0(scene) -> np.ndarray:
    """The grid folded half over half at 1.5 r (numpy, f64)."""
    return states.folded_grid(scene, CONTACT_GRID // 2,
                              1.5 * float(scene.radii.mean()))


def winds(batch):
    return np.random.RandomState(0).randn(batch, 3) * 0.05


def contact_winds():
    """Four winds about the folded grid's (0.5, 0.05, 0.5)."""
    return (np.random.RandomState(0).randn(CONTACT_B, 3) * 0.3
            + np.array([0.5, 0.05, 0.5]))


def tiny_sim(solve_fn=None):
    return ClothSim(gb.build_scene(tiny_cfg(tc)), device="cpu",
                    dtype=torch.float64, solve_fn=solve_fn)


def population(sim, batch):
    base = sim.default_params()
    return base, base.expand(batch).replace(
        wind=torch.as_tensor(winds(batch)))


def scene_sim(scene: str, dtype: torch.dtype, solve_fn=None,
              device="cpu"):
    """The port's sim of a scene of this file (on the CPU unless
    `device` says otherwise)."""
    cfg = tiny_cfg(tc) if scene == "tiny" else contact_cfg(tc)
    return ClothSim(gb.build_scene(cfg), device=device, dtype=dtype,
                    solve_fn=solve_fn)


def scene_population(scene: str, sim):
    """(base, batched params) of a scene of this file."""
    if scene == "tiny":
        base, params = population(sim, B)
        return base, params.replace(wind=params.wind.to(sim.dtype))
    base = sim.default_params().replace(x0=torch.as_tensor(
        contact_x0(sim.scene_host), dtype=sim.dtype, device=sim.device))
    return base, base.expand(CONTACT_B).replace(
        wind=torch.as_tensor(contact_winds(), dtype=sim.dtype,
                             device=sim.device))


def loss_fn(sim):
    target = torch.zeros((sim.n_steps + 1, sim.n, 3), dtype=sim.dtype,
                         device=sim.device)
    return tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                           tl.LossInfo(target_x=target))


def key_prefix(scene: str, dtype: str) -> str:
    """The saved keys' prefix: none for the tiny scene in f64 (the keys the
    test file has always read), else scene and dtype."""
    return "" if (scene, dtype) == ("tiny", "float64") else \
        f"{scene}_{dtype}_"


def run(rank, world, init_file, out_dir, cases=DEFAULT_CASES):
    torch.set_num_threads(1)
    pmesh.initialize_distributed("gloo", f"file://{init_file}", world, rank)
    results = {}
    for scene, dtype in cases:
        prefix = key_prefix(scene, dtype)
        for name, dp, tp in (("dp", world, 1), ("dp_tp", world // 2, 2)):
            mesh = pmesh.make_mesh(dp, tp)
            sim = scene_sim(scene, getattr(torch, dtype),
                            pmesh.make_tp_solve(mesh.tp_group) if tp > 1
                            else None)
            base, params_b = scene_population(scene, sim)
            fn = pmesh.batched_value_and_grad(
                sim, loss_fn(sim), mesh, p_inv_spec="tp" if tp > 1 else None)
            losses, grads = fn(params_b, sim.p_inv(base))
            results[f"{prefix}{name}_losses"] = losses.numpy()
            for field, g in grads.items():
                if g is not None:
                    results[f"{prefix}{name}_{field}"] = g.numpy()
    if rank == 0:
        np.savez(os.path.join(out_dir, "port_parallel.npz"), **results)
    dist.barrier()
    dist.destroy_process_group()
