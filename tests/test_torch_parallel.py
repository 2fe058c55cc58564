"""Port parity for `diffcloth_tpu_torch/parallel/mesh.py` on
torch.distributed, mirroring tests/test_parallel.py: four gloo ranks (one
process each, spawned with torch.multiprocessing, joined within a time
limit) run the 8-episode batched objective of that file's tiny scene on a
dp = 4 mesh and on a dp = 2 x tp = 2 mesh whose step row-shards P^{-1};
the parent holds them to the unsharded batch, to each other and to the
JAX package's `pmesh.batched_value_and_grad` on its 8-device CPU mesh.
The ranks run `tests/torch_parallel_worker.py`, which imports no JAX.

Tolerances, as tests/test_parallel.py's: dp = 4 against the unsharded
batch, losses rtol 1e-12 and the wind gradient 1e-10 (the same episodes;
the mean over the batch summed in another order); dp x tp against dp,
1e-10 and 1e-8 (the sharded P^{-1} product sums its rows in other
blocks); against the JAX package, 1e-10 and 1e-8 (f64, no contact).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

from diffcloth_tpu import config as jc
from diffcloth_tpu import losses as jl
from diffcloth_tpu.core import step as jstep
from diffcloth_tpu.core.sim import ClothSim as JaxSim
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu.parallel import mesh as jmesh
from torch_cpu import one_intra_op_thread  # noqa: F401
import torch_parallel_worker as worker

WORLD = 4
JOIN_S = 300


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    ctx = mp.spawn(worker.run, args=(WORLD, str(out / "init"), str(out)),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD} ranks ran past {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    assert not any(p.is_alive() for p in ctx.processes)
    with np.load(out / "port_parallel.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jax_runs():
    sim = JaxSim(jgb.build_scene(worker.tiny_cfg(jc)), dtype=jnp.float64)
    base = sim.default_params()
    params_b = jax.vmap(lambda w: base._replace(wind=w))(
        jnp.asarray(worker.winds(worker.B)))
    p_inv = sim.p_inv(base)
    target = jnp.zeros((sim.n_steps + 1, sim.n, 3), sim.dtype)
    loss_fn = jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                              jl.LossInfo(target_x=target))
    out = {}
    mesh = jmesh.make_mesh(dp=4, tp=1, devices=jax.devices()[:4])
    L, g = jmesh.batched_value_and_grad(sim, loss_fn, mesh)(params_b, p_inv)
    out["dp_losses"], out["dp_wind"] = np.asarray(L), np.asarray(g.wind)
    sim_tp = JaxSim(sim.scene_host, dtype=jnp.float64)
    sim_tp.step, sim_tp.residual = jstep.make_step(
        sim_tp.scene_dev, sim_tp.stage_dev, sim_tp.prims, h=sim_tp.h,
        wind_config=sim_tp.cfg.wind_config, flags=sim_tp.flags,
        eps_forward=sim_tp.eps_forward, eps_backward=sim_tp.eps_backward,
        solve_fn=jmesh.make_tp_solve("tp"))
    sim_tp.steps, sim_tp.residuals = [sim_tp.step], [sim_tp.residual]
    mesh = jmesh.make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    L, g = jmesh.batched_value_and_grad(sim_tp, loss_fn, mesh,
                                        p_inv_spec=P("tp"))(params_b, p_inv)
    out["dp_tp_losses"], out["dp_tp_wind"] = np.asarray(L), np.asarray(
        g.wind)
    return out


def test_dp_sharded_vg_matches_unsharded(port_runs):
    sim = worker.tiny_sim()
    base, params_b = worker.population(sim, worker.B)
    L, g = sim.episode_value_and_grad(worker.loss_fn(sim))(params_b)
    np.testing.assert_allclose(port_runs["dp_losses"], L.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(port_runs["dp_wind"],
                               g.wind.mean(dim=0).numpy(), rtol=1e-10)
    np.testing.assert_allclose(port_runs["dp_x0"], g.x0.mean(dim=0).numpy(),
                               rtol=1e-10, atol=1e-14)


def test_tp_sharded_solve_matches_dense(port_runs):
    np.testing.assert_allclose(port_runs["dp_tp_losses"],
                               port_runs["dp_losses"], rtol=1e-10)
    np.testing.assert_allclose(port_runs["dp_tp_wind"],
                               port_runs["dp_wind"], rtol=1e-8)


@pytest.mark.parametrize("mode", ["dp", "dp_tp"])
def test_parallel_objective_matches_jax(port_runs, jax_runs, mode):
    np.testing.assert_allclose(port_runs[f"{mode}_losses"],
                               jax_runs[f"{mode}_losses"], rtol=1e-10)
    np.testing.assert_allclose(port_runs[f"{mode}_wind"],
                               jax_runs[f"{mode}_wind"], rtol=1e-8)


def test_scaling_bench_runs_on_gloo_ranks(tmp_path):
    """apps/scaling_bench.py, one process per rank (two gloo ranks, dp x
    tp = 1 x 2 in the training row), writes its JSON line."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    out = tmp_path / "scaling.json"
    run = subprocess.run(
        [sys.executable, "-m", "diffcloth_tpu_torch.apps.scaling_bench",
         "--cpu", "--ranks", "2", "--tp", "2", "--grid", "4", "--steps",
         "2", "--batch-per-rank", "1", "--repeats", "1", "--out", str(out)],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
        capture_output=True, text=True, timeout=JOIN_S)
    assert run.returncode == 0, run.stderr[-3000:]
    line = json.loads(out.read_text())
    assert line["ranks"] == 2 and line["tp"] == 2 and line["device"] == "cpu"
    for key in ("forward_steps_per_sec_1rank", "forward_steps_per_sec_nrank",
                "train_steps_per_sec_1rank", "train_steps_per_sec_nrank"):
        assert line[key] > 0, key
