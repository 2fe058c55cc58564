"""Port parity for one step's implicit adjoint: the VJP of the port's
batched `StepFn` (the PD step with its `step_bwd`, plain versions of the
three kernels on the CPU) against `jax.vjp` of the JAX package's
custom-VJP step on its Pallas pipeline (kernels in interpret mode), in f64,
on a folded grid whose step has self-contact.  The batch holds two
episodes at the same state: the first gets a random cotangent (x_bar,
v_bar), the second a zero one, which must come back as zeros for every
input but x_bar, passed through.  Two cotangent sizes: one under the
gradient-clipping cap (16 n, Simulation.cpp:1460-1466) and one over it.

Tolerances, with their reasons: the step's x within 1e-9 and v within
1e-7 (f64, the f32 friction sweep being the only inexact part, with sums
in another order; v = (x - x_n) / h scales x's gap by 90; the largest gaps
measured were about 1e-10 and 1.1e-8); every input cotangent within 1e-6
of the largest entry of its class.  The adjoint runs to eps_backward =
1e-8 in both, the friction VJP in f32 (about 1e-7 relative), and P^{-1}
spreads that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu.core.sim import ClothSim as JaxSim
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch.convert import sim_params_from_numpy
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.core.types import SimParams
from diffcloth_tpu_torch.geometry import builder as tgb
from diffcloth_tpu_torch.geometry import states
from torch_cpu import one_intra_op_thread  # noqa: F401

GRID = 8
WIND = np.array([0.5, 0.05, 0.5])


def scene_cfg(m):
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                              k_stiff_stretching=550, k_stiff_bending=0.01,
                              grid_num_x=GRID, grid_num_y=GRID,
                              density=0.124),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=2, forward_convergence_thresh=1e-11,
        backward_convergence_thresh=1e-8, name="folded_step")


@pytest.fixture(scope="module")
def step_pair():
    jscene = jgb.build_scene(scene_cfg(jc))
    tscene = tgb.build_scene(scene_cfg(tc))
    x0 = states.folded_grid(tscene, GRID // 2,
                            1.5 * float(tscene.radii.mean()))
    jsim = JaxSim(jscene, dtype=jnp.float64, self_method="pallas",
                  self_friction_impl="pallas")
    tsim = TorchSim(tscene, device="cpu", dtype=torch.float64)
    jp = jsim.default_params()._replace(x0=jnp.asarray(x0),
                                        wind=jnp.asarray(WIND))
    # the state after one step (folded, moving), the input of step 2
    rec = jsim.rollout(jp)
    x1, v1 = np.asarray(rec.steps.x[0]), np.asarray(rec.steps.v[0])
    return jsim, tsim, jp, x1, v1


@pytest.mark.parametrize("scale", [0.5, 2.0], ids=["unclipped", "clipped"])
def test_step_vjp_matches_jax(step_pair, scale):
    jsim, tsim, jp, x1, v1 = step_pair
    n, h = tsim.n, tsim.h
    rng = np.random.RandomState(11)
    x_bar = rng.randn(n, 3) * scale
    v_bar = rng.randn(n, 3) * scale
    clipped = np.linalg.norm(v_bar + h * x_bar) / h > 16.0 * n
    assert clipped == (scale > 1.0)

    p_inv = jsim.p_inv(jp)
    xf = jsim.x_fixed_seq(jp)[1]
    t = jnp.asarray(2.0 * h)
    idx = jnp.asarray(2.0)

    def jstep(x, v, params, x_fixed):
        x2, v2, _ = jsim.step(x, v, params, x_fixed, p_inv, t, idx)
        return x2, v2

    (jx2, jv2), vjp = jax.vjp(jstep, jnp.asarray(x1), jnp.asarray(v1), jp,
                              xf)
    gj = vjp((jnp.asarray(x_bar), jnp.asarray(v_bar)))

    # the port: a batch of two, the second episode with a zero cotangent
    arrays = {k: np.stack([np.asarray(v)] * 2)
              for k, v in jp._asdict().items()}
    leaves = {k: v.requires_grad_(True) for k, v in
              sim_params_from_numpy(arrays, "cpu", torch.float64).items()}
    pt = SimParams(**leaves)
    xs = torch.tensor(np.stack([x1, x1]), requires_grad=True)
    vs = torch.tensor(np.stack([v1, v1]), requires_grad=True)
    xft = torch.tensor(np.stack([np.asarray(xf)] * 2), requires_grad=True)
    x2, v2, aux = tsim.step(xs, vs, pt, xft, tsim.p_inv(pt),
                            torch.tensor(2.0 * h, dtype=torch.float64), 2)
    assert int(aux.selfcol_pairs[0]) > 0, "the step has no self-contact"
    np.testing.assert_allclose(x2[0].detach().numpy(), np.asarray(jx2),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(v2[1].detach().numpy(), np.asarray(jv2),
                               rtol=0, atol=1e-7)
    cot_x = torch.tensor(np.stack([x_bar, np.zeros_like(x_bar)]))
    cot_v = torch.tensor(np.stack([v_bar, np.zeros_like(v_bar)]))
    inputs = [xs, vs, xft] + list(leaves.values())
    gt = torch.autograd.grad((x2, v2), inputs, (cot_x, cot_v),
                             allow_unused=True)
    names = ["x", "v", "x_fixed"] + list(leaves)
    ref = list(gj[:2]) + [gj[3]] + [getattr(gj[2], k) for k in leaves]
    for name, a, b in zip(names, ref, gt):
        a = np.asarray(a)
        b = np.zeros((2,) + a.shape) if b is None else b.numpy()
        scale_ref = max(np.abs(a).max(), 1e-300)
        assert np.abs(b[0] - a).max() <= 1e-6 * scale_ref, (
            name, np.abs(b[0] - a).max(), scale_ref)
        # the zero-cotangent episode: zeros, and x_bar passed through
        np.testing.assert_array_equal(b[1], np.zeros_like(a), err_msg=name)
    for name in ("x", "v", "k_pertype", "density", "wind", "x_fixed"):
        assert np.abs(np.asarray(ref[names.index(name)])).max() > 0, name


@pytest.mark.parametrize("mode", ["no_such_mode"])
def test_unported_adjoint_mode_raises(mode):
    """An `SimFlags.adjoint_mode` other than "fp" (the reference's fixed
    point) and "gmres" (tests/test_torch_adjoint_gmres.py): building the
    step refuses it instead of running "fp" in its place."""
    scene = tgb.build_scene(scene_cfg(tc))
    flags = tc.SimFlags(wind_enabled=True, adjoint_mode=mode)
    with pytest.raises(NotImplementedError, match="adjoint_mode"):
        TorchSim(scene, device="cpu", dtype=torch.float64, flags=flags)
