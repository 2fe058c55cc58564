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

Every gradient class the objective returns (x0, v0, density, k_pertype,
wind, wind_freq, wind_phase, and the zero ones) is held to the JAX
package's on both meshes, f64, on the tiny scene and on a contact scene
(torch_parallel_worker.contact_cfg: the flagship stand-in's physics on an
8 x 8 grid started folded half over half, B = 4, 3 steps, self-contact
from the first step; the JAX ClothSim on its Pallas pipeline in interpret
mode): within 1e-8 of each class's largest entry without contact, 1e-6
with it (the self-friction sweep is f32 inside the f64 simulation in both
packages, and the two f32 sweeps may round a row's sum apart), losses
rtol 1e-10 and 1e-8.  The f32 tp-against-plain gaps of both packages are
measured by tests/tp_f32_gap.py.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
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
def jax_runs(jax_classes):
    """The JAX package's losses and wind gradients of the tiny scene."""
    return {f"{mode}_{k}": (L if k == "losses" else g["wind"])
            for mode in ("dp", "dp_tp")
            for L, g in [jax_classes["tiny", mode]]
            for k in ("losses", "wind")}


def jax_contact_sim(dtype, tp: bool):
    """The JAX ClothSim of the contact scene on its Pallas pipeline, its
    step given the tp solve when `tp` (the parallel test's construction)."""
    sim = JaxSim(jgb.build_scene(worker.contact_cfg(jc)), dtype=dtype,
                 self_method="pallas", self_friction_impl="pallas")
    if tp:
        sim.step, sim.residual = jstep.make_step(
            sim.scene_dev, sim.stage_dev, sim.prims, h=sim.h,
            wind_config=sim.cfg.wind_config, flags=sim.flags,
            eps_forward=sim.eps_forward, eps_backward=sim.eps_backward,
            self_cfg=sim.self_cfg, solve_fn=jmesh.make_tp_solve("tp"))
        sim.steps, sim.residuals = [sim.step], [sim.residual]
    return sim


def jax_contact_population(sim):
    base = sim.default_params()._replace(x0=jnp.asarray(
        worker.contact_x0(sim.scene_host), sim.dtype))
    params = jax.vmap(lambda w: base._replace(wind=w))(
        jnp.asarray(worker.contact_winds(), sim.dtype))
    target = jnp.zeros((sim.n_steps + 1, sim.n, 3), sim.dtype)
    return base, params, jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                                         jl.LossInfo(target_x=target))


def jax_mesh_objective(dtype, tp: bool):
    """The JAX package's batched objective of the contact scene on a dp = 4
    or a dp = 2 x tp = 2 mesh of four host devices: (losses, {class:
    gradient}) as numpy."""
    sim = jax_contact_sim(dtype, tp)
    base, params, loss_fn = jax_contact_population(sim)
    mesh = jmesh.make_mesh(dp=2 if tp else 4, tp=2 if tp else 1,
                           devices=jax.devices()[:4])
    L, g = jmesh.batched_value_and_grad(
        sim, loss_fn, mesh, p_inv_spec=P("tp") if tp else P())(
            params, sim.p_inv(base))
    return np.asarray(L), {k: np.asarray(v) for k, v in g._asdict().items()}


@pytest.fixture(scope="module")
def jax_classes():
    """Every gradient class of the JAX package's objectives, f64: the tiny
    scene's and the contact scene's, dp and dp x tp."""
    sim = JaxSim(jgb.build_scene(worker.tiny_cfg(jc)), dtype=jnp.float64)
    base = sim.default_params()
    params_b = jax.vmap(lambda w: base._replace(wind=w))(
        jnp.asarray(worker.winds(worker.B)))
    target = jnp.zeros((sim.n_steps + 1, sim.n, 3), sim.dtype)
    loss_fn = jl.make_loss_fn(jc.LossType.MATCH_TRAJECTORY,
                              jl.LossInfo(target_x=target))
    out = {}
    for mode, dp, tp in (("dp", 4, 1), ("dp_tp", 2, 2)):
        s = sim
        if tp > 1:
            s = JaxSim(sim.scene_host, dtype=jnp.float64)
            s.step, s.residual = jstep.make_step(
                s.scene_dev, s.stage_dev, s.prims, h=s.h,
                wind_config=s.cfg.wind_config, flags=s.flags,
                eps_forward=s.eps_forward, eps_backward=s.eps_backward,
                solve_fn=jmesh.make_tp_solve("tp"))
            s.steps, s.residuals = [s.step], [s.residual]
        mesh = jmesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:4])
        L, g = jmesh.batched_value_and_grad(
            s, loss_fn, mesh, p_inv_spec=P("tp") if tp > 1 else P())(
                params_b, sim.p_inv(base))
        out["tiny", mode] = (np.asarray(L), {
            k: np.asarray(v) for k, v in g._asdict().items()})
        out["contact", mode] = jax_mesh_objective(jnp.float64, tp > 1)
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


def test_contact_scene_has_self_contact():
    """The contact scene's episodes touch themselves from the first step
    (the port's rollout of the same population, f64, on the CPU)."""
    sim = worker.scene_sim("contact", torch.float64)
    _, params = worker.scene_population("contact", sim)
    st = sim.rollout(params).steps
    assert (st.selfcol_pairs[:, 0] > 0).all(), st.selfcol_pairs
    assert not bool(st.selfcol_overflow.any())


@pytest.mark.parametrize("mode", ["dp", "dp_tp"])
@pytest.mark.parametrize("scene", ["tiny", "contact"])
def test_parallel_gradient_classes_match_jax(port_runs, jax_classes, scene,
                                             mode):
    """Losses and every gradient class of the objective against the JAX
    package's, f64, on both meshes, within 1e-8 (no contact) or 1e-6 (the
    contact scene) of each class's largest entry."""
    prefix = worker.key_prefix(scene, "float64")
    L_jax, g_jax = jax_classes[scene, mode]
    tol = 1e-8 if scene == "tiny" else 1e-6
    np.testing.assert_allclose(port_runs[f"{prefix}{mode}_losses"], L_jax,
                               rtol=1e-10 if scene == "tiny" else 1e-8)
    nonzero = 0
    for field, ref in g_jax.items():
        got = port_runs[f"{prefix}{mode}_{field}"]
        assert got.shape == ref.shape, field
        scale = float(np.abs(ref).max())
        nonzero += scale > 0
        err = float(np.abs(got - ref).max())
        assert err <= tol * scale + 1e-300, (field, err, scale)
    assert nonzero >= 7, "fewer nonzero gradient classes than expected"


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
