"""Port parity for the auxiliary subsystems, mirroring
tests/test_subsystems.py: episode export and re-import, the viewer,
checkpoints and their garbage collection, the episode statistics, the energy
diagnostics, the explosion freeze and the finite-difference oracle, on
the 5 x 5 grid scene of test_subsystems.py (6 steps, f64, the CPU).

Tolerances: the port's episode within 1e-9 of the JAX package's (f64, no
self-contact on this flat grid); OBJ frames written from the same arrays
by both packages identical, and the two packages' own episodes' frames
within 1e-8 (8 decimals in the file, plus the episodes' gap); the energies
rtol 1e-10 of the JAX package's on the same state (the same f64 formulas);
FD against the adjoint rtol 2e-3, as test_subsystems.py holds the JAX
package.
"""
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu.core import diagnostics as jdiag
from diffcloth_tpu.core.sim import ClothSim as JaxSim
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu.io import export as jexport
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl
from diffcloth_tpu_torch.core import diagnostics as diag
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.core.types import EpisodeRecords, StepRecord
from diffcloth_tpu_torch.geometry import builder as tgb
from diffcloth_tpu_torch.geometry import objio
from diffcloth_tpu_torch.io import export as texport
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64
WIND = [0.2, 0.05, 0.1]


def scene_cfg(m):
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=2, cloth_dim_y=2,
                              k_stiff_stretching=300, k_stiff_bending=0.05,
                              grid_num_x=5, grid_num_y=5, density=0.3),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 60.0,
        step_num=6, name="subsys")


@pytest.fixture(scope="module")
def small():
    scene = tgb.build_scene(scene_cfg(tc))
    sim = TorchSim(scene, device="cpu", dtype=F64)
    params = sim.default_params().replace(wind=torch.tensor(WIND, dtype=F64))
    return scene, sim, params, sim.rollout(params)


@pytest.fixture(scope="module")
def jax_small():
    scene = jgb.build_scene(scene_cfg(jc))
    sim = JaxSim(scene, dtype=jnp.float64)
    params = sim.default_params()._replace(wind=jnp.array(WIND, jnp.float64))
    return scene, sim, params, sim.rollout(params)


def records_from_jax(jrecs) -> EpisodeRecords:
    """The JAX package's records as the port's (numpy in between)."""
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    st = jrecs.steps
    N = st.x.shape[0]
    zeros = torch.zeros(N, dtype=torch.int32)
    return EpisodeRecords(x0=t(jrecs.x0), v0=t(jrecs.v0), steps=StepRecord(
        x=t(st.x), v=t(st.v), f=t(st.f), r=t(st.r), x_fixed=t(st.x_fixed),
        converged=t(st.converged), iters=t(st.iters),
        avg_deformation=t(st.avg_deformation),
        max_deformation=t(st.max_deformation),
        selfcol_overflow=t(st.selfcol_overflow), selfcol_pairs=zeros,
        selfcol_slots=zeros, obstacle_contacts=zeros.long(),
        cg_iters=zeros))


def test_export_import_episode(small, jax_small, tmp_path):
    scene, sim, params, recs = small
    jscene, _, _, jrecs = jax_small
    np.testing.assert_allclose(recs.steps.x.numpy(),
                               np.asarray(jrecs.steps.x), rtol=0, atol=1e-9)
    folder = str(tmp_path / "ep")
    texport.export_episode(folder, recs, scene.tris, stats={"note": "test"})
    xs, tris, info = texport.import_episode(folder)
    assert xs.shape == (sim.n_steps + 1, sim.n, 3)
    np.testing.assert_allclose(xs, recs.full_x().numpy(), atol=1e-6)
    np.testing.assert_array_equal(tris, scene.tris)
    assert info["note"] == "test" and len(info["iters"]) == sim.n_steps
    # the JAX package's own episode, exported and re-imported by it
    jfolder = str(tmp_path / "jax_ep")
    jexport.export_episode(jfolder, jrecs, jscene.tris)
    jxs, jtris, _ = jexport.import_episode(jfolder)
    np.testing.assert_allclose(xs, jxs, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tris, jtris)
    # the same records through both exports: the same files
    same = str(tmp_path / "same")
    texport.export_episode(same, records_from_jax(jrecs), jscene.tris)
    for name in sorted(os.listdir(jfolder)):
        if name.endswith(".obj"):
            a = objio.load_obj(os.path.join(same, name))
            b = objio.load_obj(os.path.join(jfolder, name))
            np.testing.assert_array_equal(a[0], b[0], name)
            np.testing.assert_array_equal(a[1], b[1], name)
        else:
            with open(os.path.join(same, name)) as fa, \
                    open(os.path.join(jfolder, name)) as fb:
                assert fa.read() == fb.read(), name


def test_export_refuses_a_batch(small, tmp_path):
    _, sim, params, _ = small
    recs = sim.rollout(params.expand(2))
    with pytest.raises(ValueError):
        texport.export_episode(str(tmp_path / "b"), recs,
                               sim.scene_host.tris)


def test_viewer_renders(small, tmp_path):
    pytest.importorskip("matplotlib")
    scene, sim, params, recs = small
    from diffcloth_tpu_torch.io import render_episode, render_frame
    png = str(tmp_path / "f.png")
    render_frame(recs.steps.x[-1].numpy(), scene.tris, png)
    assert os.path.getsize(png) > 1000
    gif = str(tmp_path / "ep.gif")
    render_episode(recs.full_x().numpy(), scene.tris, gif, stride=3)
    assert os.path.getsize(gif) > 1000


def test_checkpoint_roundtrip(small, tmp_path):
    _, sim, params, _ = small
    from diffcloth_tpu_torch.utils import checkpoint as ckpt
    root = str(tmp_path / "ckpts")
    tree = {"params": params, "step": np.asarray(3), "pair": (1.5, [2, 3])}
    ckpt.save_checkpoint(root, 3, tree, metadata={"demo": "subsys"})
    ckpt.save_checkpoint(root, 7, tree)
    assert ckpt.latest_step(root) == 7
    step, restored = ckpt.restore_checkpoint(root)
    assert step == 7
    np.testing.assert_array_equal(restored["params"]["wind"],
                                  params.wind.numpy())
    assert restored["pair"][1][1] == 3
    with open(os.path.join(root, "ckpt_00000003", "metadata.json")) as fh:
        assert '"demo": "subsys"' in fh.read()
    # restored into the structure of an example tree
    _, back = ckpt.restore_checkpoint(root, 3, like=tree)
    assert isinstance(back["params"], type(params))
    for name, a in params.items():
        got = getattr(back["params"], name)
        assert got.dtype == a.dtype
        torch.testing.assert_close(got, a, rtol=0, atol=0)
    assert back["pair"] == (1.5, [2, 3])
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"))


def test_checkpoint_gc(tmp_path):
    from diffcloth_tpu_torch.utils import checkpoint as ckpt
    root = str(tmp_path / "gc")
    for s in range(8):
        ckpt.save_checkpoint(root, s, {"x": np.arange(3.0)}, keep=3)
    steps = sorted(int(f.split("_")[1]) for f in os.listdir(root))
    assert steps == [5, 6, 7]


def test_timer_report():
    from diffcloth_tpu_torch.utils.timing import EpisodeStats
    recs = types.SimpleNamespace(steps=types.SimpleNamespace(
        iters=torch.tensor([3, 4, 5], dtype=torch.int32),
        converged=torch.tensor([True, True, False])))
    st = EpisodeStats.from_records(recs, forward_s=0.5)
    assert (st.n_steps, st.total_pd_iters, st.n_converged) == (3, 12, 2)
    assert "steps=3" in st.report() and "6.0 steps/s" in st.report()


def test_energy_matches_jax_and_explosion(small, jax_small):
    scene, sim, params, recs = small
    _, jsim, jparams, _ = jax_small
    rng = np.random.RandomState(4)
    x = recs.steps.x[-1].numpy() + 0.05 * rng.randn(sim.n, 3)
    s_n = x + 0.01 * rng.randn(sim.n, 3)
    xf = recs.steps.x_fixed[-1].numpy()
    m = params.density * sim.scene_dev.area
    e = float(diag.system_energy(sim.scene_dev, sim.stage_dev,
                                 params.k_pertype, m, sim.h,
                                 torch.as_tensor(x), torch.as_tensor(s_n),
                                 torch.as_tensor(xf)))
    je = float(jdiag.system_energy(jsim.scene_dev, jsim.stage_dev,
                                   jparams.k_pertype,
                                   jparams.density * jsim.scene_dev.area,
                                   jsim.h, jnp.asarray(x), jnp.asarray(s_n),
                                   jnp.asarray(xf)))
    np.testing.assert_allclose(e, je, rtol=1e-10)
    ce = float(diag.constraint_energy(sim.scene_dev, sim.stage_dev,
                                      params.k_pertype, torch.as_tensor(x),
                                      torch.as_tensor(xf)))
    jce = float(jdiag.constraint_energy(jsim.scene_dev, jsim.stage_dev,
                                        jparams.k_pertype, jnp.asarray(x),
                                        jnp.asarray(xf)))
    np.testing.assert_allclose(ce, jce, rtol=1e-10)
    assert np.isfinite(e) and e > 0 and ce > 0
    # at the rest shape with the clips at rest the constraints are relaxed
    rest = sim.scene_dev.x_rest
    e0 = float(diag.constraint_energy(sim.scene_dev, sim.stage_dev,
                                      params.k_pertype, rest,
                                      sim.stage_dev.fixed_pos_rest))
    assert e0 < 1e-12 * ce
    v = recs.steps.v[-1]
    assert not bool(diag.is_exploded(recs.steps.x[-1], v))
    assert bool(diag.is_exploded(recs.steps.x[-1] * float("nan"), v))


def test_explosion_freeze_in_rollout(small):
    """A zero density gives non-finite accelerations: the episode freezes
    at its last finite state (Simulation.cpp:1415-1424)."""
    _, sim, params, _ = small
    bad = params.replace(density=torch.tensor(0.0, dtype=F64))
    recs = sim.simulate(bad, sim.p_inv(params), sim.x_fixed_seq(bad))
    np.testing.assert_allclose(recs.steps.x[-1].numpy(),
                               recs.steps.x[0].numpy())


def test_fd_adjoint_agreement(small):
    """compare_fd_adjoint on the wind and density gradients of a
    MATCH_TRAJECTORY loss, with the forward tolerance tightened as the
    reference tightens it for FD checks (Simulation.cpp:3648,3661)."""
    import dataclasses
    scene = small[0]
    cfg = dataclasses.replace(scene.cfg, forward_convergence_thresh=1e-11,
                              backward_convergence_thresh=1e-8)
    sim = TorchSim(tgb.build_scene(cfg), device="cpu", dtype=F64,
                   flags=tc.SimFlags(wind_enabled=True,
                                     gradient_clipping=False))
    params = sim.default_params().replace(wind=torch.tensor(WIND, dtype=F64))
    loss_fn = tl.make_loss_fn(
        tc.LossType.MATCH_TRAJECTORY,
        tl.LossInfo(target_x=torch.zeros(sim.n_steps + 1, sim.n, 3,
                                         dtype=F64)))
    vg = sim.episode_value_and_grad(loss_fn)
    _, grads = vg(params)
    fd = diag.finite_difference_gradients(
        lambda p: vg(p)[0], params, fields=("wind", "density"), delta=1e-6)
    rep = diag.compare_fd_adjoint(fd, grads, rtol=2e-3)
    for field, (abs_err, rel_err, ok) in rep.items():
        assert ok, f"{field}: abs={abs_err} rel={rel_err}"
    # the same report as the JAX package's on the same numbers
    jgrads = types.SimpleNamespace(**{k: v.numpy() for k, v in
                                      grads.items()})
    assert jdiag.compare_fd_adjoint(fd, jgrads, rtol=2e-3) == rep
    # a wrong gradient fails it
    bad = grads.replace(wind=grads.wind * 1.1)
    assert not diag.compare_fd_adjoint(fd, bad, rtol=2e-3)["wind"][2]
