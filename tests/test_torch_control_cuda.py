"""The control path on the card against the CPU: the `PySim` autograd
bridge and one hat-controller `loss_and_grad`, f64 on both devices; the
controller's chunks: a warmed chunk forward with no synchronizing call,
equal to the whole episode's, and the chunked `loss_and_grad` on the card
against the CPU.

These tests need an NVIDIA GPU (the kernels build at first use) and skip
without one; run them there with

    python -m pytest --noconftest -q tests/test_torch_control_cuda.py

Tolerances: the bridge's states and gradients within 1e-9 of each one's
largest entry (no contact on the flat grid, so no f32 friction enters;
the devices differ only in summation order); the controller's loss and
per-sample gradient norms within rtol 1e-6 and its summed gradient
within 1e-6 of its largest entry (the f32 friction sweep inside the f64
simulation, as every card-against-CPU reference); the chunks' forward
against the whole episode's on the card bit for bit (the same operations
on the same values, the controller captured or inline).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch.api.pysim import SimulationAPI
from diffcloth_tpu_torch.api.torch_bridge import PySim
from diffcloth_tpu_torch.apps import hat_controller as hc
from diffcloth_tpu_torch.convert import controller_from_numpy
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.tasks import registry
from diffcloth_tpu_torch.tasks.setup import build_task

pytestmark = pytest.mark.cuda
F64 = torch.float64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def close(a, b, tol):
    a, b = a.detach().cpu(), b.detach().cpu()
    return float((a - b).abs().max()) <= tol * max(float(b.abs().max()),
                                                   1e-300)


def test_bridge_on_card_matches_cpu(dev):
    cfg = tc.SceneConfig(
        fabric=tc.FabricConfig(cloth_dim_x=1.5, cloth_dim_y=1.5,
                               k_stiff_stretching=300.0,
                               k_stiff_bending=0.05, grid_num_x=4,
                               grid_num_y=4, density=0.3),
        attachment_points=tc.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=tc.WindConfig.NO_WIND, time_step=1.0 / 60.0,
        step_num=3, forward_convergence_thresh=1e-10, name="api")
    out = {}
    for device in (dev, "cpu"):
        sim = ClothSim(gb.build_scene(cfg), device=device, dtype=F64,
                       flags=tc.SimFlags(wind_enabled=False,
                                         gradient_clipping=False))
        api = SimulationAPI(types.SimpleNamespace(
            sim=sim, param_base=sim.default_params()))
        info = api.get_state_info()
        x0 = info.x.clone().requires_grad_(True)
        a = (info.x_fixedpoints + 0.1).clone().requires_grad_(True)
        x, v = x0, info.v
        for _ in range(3):
            x, v = PySim(api)(x, v, a)
        c = torch.linspace(-1.0, 1.0, x.shape[0], dtype=F64,
                           device=x.device)
        ((x * c).sum() + (v * v).sum()).backward()
        out[str(device)] = (x, x0.grad, a.grad)
    for got, want in zip(out[str(dev)], out["cpu"]):
        assert close(got, want, 1e-9)


def test_controller_loss_and_grad_on_card_matches_cpu(dev):
    scene = dataclasses.replace(registry.hat_grid_standin(), step_num=4)
    layers = None
    out = {}
    for device in (dev, "cpu"):
        prob = hc.make_problem(build_task("hat", dtype=F64, device=device,
                                          scene=scene))
        if layers is None:
            feat = hc.featurize(prob, prob.x0[None],
                                torch.zeros_like(prob.x0)[None])
            rng = np.random.RandomState(7)
            widths = [feat.shape[1], 64, 64, 3 * prob.clip0.shape[0]]
            layers = [{"w": rng.randn(widths[i], widths[i + 1])
                       / np.sqrt(widths[i]), "b": rng.randn(widths[i + 1])
                       * 0.1} for i in range(3)]
        ctrl = controller_from_numpy(layers, device, F64)
        xs, aas = hc.stack_poses(prob, np.random.RandomState(0), 2)
        out[str(device)] = hc.loss_and_grad(prob, ctrl, xs, aas)
    g, c = out[str(dev)], out["cpu"]
    np.testing.assert_allclose(float(g.loss), float(c.loss), rtol=1e-6)
    np.testing.assert_allclose(g.sample_gnorms, c.sample_gnorms, rtol=1e-6)
    for a, b in zip(g.grads, c.grads):
        assert close(a, b, 1e-6)


def hat_case(device, dtype, steps, B=2):
    """The hat stand-in cut to `steps`, B poses (seed 0) and a controller
    of seeded numpy weights (a last layer large enough that the clips
    move)."""
    scene = dataclasses.replace(registry.hat_grid_standin(), step_num=steps)
    prob = hc.make_problem(build_task("hat", dtype=dtype, device=device,
                                      scene=scene))
    feat = hc.featurize(prob, prob.x0[None], torch.zeros_like(prob.x0)[None])
    widths = [feat.shape[1], 64, 64, 3 * prob.clip0.shape[0]]
    rng = np.random.RandomState(7)
    layers = [{"w": rng.randn(widths[i], widths[i + 1])
               * (1.0 if i == 2 else 1.0 / np.sqrt(widths[i])),
               "b": rng.randn(widths[i + 1]) * 0.1} for i in range(3)]
    xs, aas = hc.stack_poses(prob, np.random.RandomState(0), B)
    return prob, controller_from_numpy(layers, device, dtype), xs, aas


def test_control_chunk_forward_holds_no_host_sync(dev):
    """Once its programs are built, the controller's chunks make no
    synchronizing call (PyTorch's sync debug mode raises on one), and they
    equal the whole episode with the controller inline, bit for bit."""
    prob, ctrl, xs, aas = hat_case(dev, torch.float32, 8)
    ws = ctrl.layers()
    v0 = torch.zeros_like(xs)
    with torch.no_grad():
        for _ in range(2):     # warm-ups and captures
            hc.rollout_chunked(prob, ws, xs, v0, aas, 4)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ch, starts = hc.rollout_chunked(prob, ws, xs, v0, aas, 4,
                                            record=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        whole = hc.closed_loop_rollout(prob, ws, xs, v0, aas, record=True)
    assert prob.graphs.enabled and prob.graphs.summary()
    for k in ("x", "v", "a", "clip_traj", "iters", "states"):
        assert torch.equal(getattr(ch, k), getattr(whole, k)), k
    assert len(starts) == 2


def test_chunked_loss_and_grad_on_card_matches_cpu(dev):
    out = {}
    for device in (dev, "cpu"):
        prob, ctrl, xs, aas = hat_case(device, F64, 6)
        out[str(device)] = hc.loss_and_grad(prob, ctrl, xs, aas, chunk=2)
    g, c = out[str(dev)], out["cpu"]
    np.testing.assert_allclose(float(g.loss), float(c.loss), rtol=1e-6)
    np.testing.assert_allclose(g.sample_gnorms, c.sample_gnorms, rtol=1e-6)
    np.testing.assert_array_equal(g.dropped, c.dropped)
    for a, b in zip(g.grads, c.grads):
        assert close(a, b, 1e-6)
