"""Port parity for the `diffcloth_py` surface (`api/pysim.py`) and the
autograd bridge (`api/torch_bridge.py`) against the JAX package's, on the
4 x 4 `tiny_task` of tests/test_api.py in f64, mirroring that file.

Tolerances, with their reasons: states within 1e-9 and step_backward_nn's
cotangents within 1e-9 of each one's largest entry (all f64, no contact on
the flat grid; both adjoints run the same fixed point to the scene's
tolerance); the bridge's x and v gradients within 1e-9 the same way; its
a gradient, after the clamp, within 1e-12 relative (the same
rescaling of the same f64 numbers).  The bridge's loss is linear in
(x_new, v_new) with float32-exact coefficients, so its cotangents are
equal in both packages (the JAX bridge hands back float32 states).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu.api import pysim as jpysim
from diffcloth_tpu.api import torch_bridge as jbridge
from diffcloth_tpu.core.sim import ClothSim as JaxSim
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu.geometry import objio as jobjio
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch.api import pysim as tpysim
from diffcloth_tpu_torch.api import torch_bridge as tbridge
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.geometry import builder as tgb
from torch_cpu import one_intra_op_thread  # noqa: F401


def tiny_cfg(m, steps=4):
    fab = m.FabricConfig(cloth_dim_x=1.5, cloth_dim_y=1.5,
                         k_stiff_stretching=300.0, k_stiff_bending=0.05,
                         grid_num_x=4, grid_num_y=4, density=0.3)
    return m.SceneConfig(
        fabric=fab, attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        trajectory=m.TrajectoryConfig.NO_TRAJECTORY,
        primitive_config=m.PrimitiveConfig.NONE,
        wind_config=m.WindConfig.NO_WIND, time_step=1.0 / 60.0,
        step_num=steps, forward_convergence_thresh=1e-10, name="api")


@pytest.fixture(scope="module")
def apis():
    jsim = JaxSim(jgb.build_scene(tiny_cfg(jc)), dtype=jnp.float64,
                  flags=jc.SimFlags(wind_enabled=False,
                                    gradient_clipping=False))
    tsim = TorchSim(tgb.build_scene(tiny_cfg(tc)), device="cpu",
                    dtype=torch.float64,
                    flags=tc.SimFlags(wind_enabled=False,
                                      gradient_clipping=False))
    return (jpysim.SimulationAPI(types.SimpleNamespace(
                sim=jsim, param_base=jsim.default_params())),
            tpysim.SimulationAPI(types.SimpleNamespace(
                sim=tsim, param_base=tsim.default_params())))


def host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def assert_close(got, ref, tol, what):
    got, ref = host(got), host(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= tol * scale, (
        what, np.abs(got - ref).max(), scale)


def test_step_nn_and_records(apis):
    japi, tapi = apis
    for api in apis:
        api.reset_system()
    info0 = tapi.get_state_info()
    assert info0.stepIdx == 0 and len(tapi.forward_records) == 1
    assert isinstance(info0.x, torch.Tensor) and info0.x.shape == (48,)
    a = host(info0.x_fixedpoints)
    np.testing.assert_array_equal(a, japi.get_state_info().x_fixedpoints)
    # moving the clips drags the attached vertices
    a_moved = (a.reshape(-1, 3) + np.array([0.0, 0.5, 0.0])).reshape(-1)
    for idx, clips in ((1, a), (2, a_moved)):
        jinfo = japi.step_nn(idx, japi.get_state_info().x,
                             japi.get_state_info().v, clips)
        tinfo = tapi.step_nn(idx, tapi.get_state_info().x,
                             tapi.get_state_info().v, clips)
        assert tinfo.stepIdx == jinfo.stepIdx == idx
        assert tinfo.t == pytest.approx(jinfo.t)
        assert bool(tinfo.converged) == jinfo.converged
        assert_close(tinfo.x, jinfo.x, 1e-9, "x")
        assert_close(tinfo.v, jinfo.v, 1e-9, "v")
        np.testing.assert_allclose(float(tinfo.avgDeformation),
                                   jinfo.avgDeformation, rtol=1e-12)
    assert len(tapi.forward_records) == 3
    pidx = tapi.sim.stage_host.particle_idx
    x1 = host(tapi.forward_records[1].x).reshape(-1, 3)
    x2 = host(tapi.forward_records[2].x).reshape(-1, 3)
    assert x2[pidx][:, 1].mean() > x1[pidx][:, 1].mean()
    x, v = tapi.get_current_pos_velocity_vec()
    assert torch.equal(x, tapi.get_state_info().x)


def test_step_backward_nn_matches_jax(apis):
    japi, tapi = apis
    for api in apis:
        api.reset_system()
    info = japi.get_state_info()
    rec = japi.step_nn(1, info.x, info.v, info.x_fixedpoints)
    rng = np.random.RandomState(0)
    gx, gv = rng.randn(*rec.x.shape), rng.randn(*rec.v.shape) * 0.1
    ref = japi.step_backward_nn(1, info.x, info.v, info.x_fixedpoints, gx,
                                gv)
    got = tapi.step_backward_nn(1, info.x, info.v, info.x_fixedpoints, gx,
                                gv)
    for name, a, b in zip(("dx", "dv", "da"), got, ref):
        assert a.shape == b.shape
        assert_close(a, b, 1e-9, name)
    assert np.linalg.norm(ref[2]) > 0   # clip positions influence the step


@pytest.mark.parametrize("scale", [2.0 ** -22, 1.0, 2.0 ** 8],
                         ids=["floor", "as_is", "cap"])
def test_bridge_matches_jax_bridge(apis, scale):
    """PySim over one step of both packages on the same inputs; `scale`
    puts |dL/da| under the 0.05 floor, between the bounds, and over the
    3F * action_grad_max_norm cap."""
    japi, tapi = apis
    grads = {}
    for key, api, module in (("jax", japi, jbridge.PySim),
                             ("port", tapi, tbridge.PySim)):
        api.reset_system()
        info = api.get_state_info()
        x, v, a = (torch.tensor(host(u), dtype=torch.float64,
                                requires_grad=True)
                   for u in (info.x, info.v, info.x_fixedpoints))
        x1, v1 = module(api)(x, v, a)
        rng = np.random.RandomState(3)
        cx = torch.tensor(rng.randn(x1.shape[0]).astype(np.float32) * scale)
        cv = torch.tensor(rng.randn(v1.shape[0]).astype(np.float32) * scale)
        (x1.double() * cx.double()).sum().add(
            (v1.double() * cv.double()).sum()).backward()
        grads[key] = (x.grad, v.grad, a.grad, x1)
        assert api.get_state_info().stepIdx == 1
    (jx, jv, ja, jx1), (tx, tv, ta, tx1) = grads["jax"], grads["port"]
    np.testing.assert_allclose(host(tx1), host(jx1), rtol=1e-6)
    assert_close(tx, jx, 1e-9, "dL/dx")
    assert_close(tv, jv, 1e-9, "dL/dv")
    np.testing.assert_allclose(host(ta), host(ja), rtol=1e-12,
                               atol=1e-12 * np.abs(host(ja)).max())
    norm = float(np.linalg.norm(host(ta)))
    cap = ta.shape[0] * tapi.sim.flags.action_grad_max_norm
    want = {"floor": 0.05, "cap": cap}.get(
        {2.0 ** -22: "floor", 2.0 ** 8: "cap"}.get(scale, "as_is"))
    if want is None:
        assert 0.05 < norm < cap
    else:
        assert norm == pytest.approx(want, rel=1e-12)


def test_clamp_leaves_zero_gradient():
    da = torch.zeros(6, dtype=torch.float64)
    assert torch.equal(tbridge.clamp_action_grad(da, 4.0), da)


def test_export_roundtrip(apis, tmp_path):
    _, tapi = apis
    tapi.reset_system()
    info = tapi.get_state_info()
    tapi.step_nn(1, info.x, info.v, info.x_fixedpoints)
    path = tapi.export_current_simulation("roundtrip", str(tmp_path))
    frames = jobjio.import_frames(path)
    assert frames.shape[0] == 2
    np.testing.assert_allclose(frames[-1], host(tapi._x), atol=1e-6)


def test_make_sim_needs_the_hat_mesh_like_jax():
    with pytest.raises(FileNotFoundError):
        jpysim.make_sim("wear_hat")
    with pytest.raises(FileNotFoundError):
        tpysim.make_sim("wear_hat", device="cpu")
