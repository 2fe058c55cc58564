"""Port parity for the loss library: all eight loss types of
`diffcloth_tpu_torch.losses` against `diffcloth_tpu.losses` on the same
numpy records (f64), values and gradients with respect to every frame's x
and v and the initial state, single and batched (batched records give (B,)
losses, each equal to its episode's).

Tolerances: rtol 1e-12 / atol 1e-15 (the same f64 arithmetic; only the
summation order may differ).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu import losses as jl
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import losses as tl

N, n = 6, 12          # steps, particles
TOL = dict(rtol=1e-12, atol=1e-15)


def records(x0, v0, x, v):
    """The fields a loss reads, for either package."""
    return types.SimpleNamespace(
        x0=x0, v0=v0, steps=types.SimpleNamespace(x=x, v=v))


def loss_infos():
    rng = np.random.RandomState(21)
    cands = np.full((3, 4), -1, np.int64)
    cands[0, :2] = [1, 2]
    cands[1, :4] = [3, 4, 5, 6]
    cands[2, :3] = [7, 8, 11]
    base = dict(
        target_x=rng.randn(N + 1, n, 3), target_v=rng.randn(N + 1, n, 3),
        target_frame_shape=((0, rng.randn(n, 3)), (3, rng.randn(n, 3)),
                            (N, rng.randn(n, 3))),
        target_translation=rng.randn(3), x_init=rng.randn(n, 3),
        target_twirl_height=0.3, loop_points=np.array([0, 4, 9]),
        rest_min=np.array([-1.0, -2.0, -1.0]),
        rest_max=np.array([1.0, 2.0, 1.0]),
        keypoint_frames=np.array([2, 4, N]), keypoint_targets=rng.randn(3, 3),
        keypoint_candidates=cands)
    return base


CASES = [(t.name, t, 0.0) for t in jc.LossType] + [
    ("ASSISTED_DRESSING_KEYPOINTS_tau",
     jc.LossType.ASSISTED_DRESSING_KEYPOINTS, 0.5)]


@pytest.mark.parametrize("name,ltype,tau", CASES, ids=[c[0] for c in CASES])
def test_loss_value_and_gradient_match_jax(name, ltype, tau):
    info = loss_infos()
    rng = np.random.RandomState(22)
    B = 3
    st = [rng.randn(B, n, 3), rng.randn(B, n, 3), rng.randn(B, N, n, 3),
          rng.randn(B, N, n, 3)]
    j_info = jl.LossInfo(**{k: (tuple((f, jnp.asarray(s)) for f, s in v)
                                if k == "target_frame_shape"
                                else jnp.asarray(v)) for k, v in
                            info.items() if not isinstance(v, float)},
                         target_twirl_height=info["target_twirl_height"],
                         keypoint_tau=tau)
    t_info = tl.LossInfo(**info, keypoint_tau=tau)
    j_fn = jl.make_loss_fn(jc.LossType(int(ltype)), j_info)
    t_fn = tl.make_loss_fn(tc.LossType(int(ltype)), t_info)

    # batched: one call on records with a leading B
    leaves = [torch.tensor(a, requires_grad=True) for a in st]
    L_b = t_fn(records(*leaves))
    assert tuple(L_b.shape) == (B,)
    g_b = torch.autograd.grad(L_b.sum(), leaves, allow_unused=True)
    for b in range(B):
        one = [jnp.asarray(a[b]) for a in st]
        L_j, g_j = jax.value_and_grad(
            lambda *a: j_fn(records(*a)), argnums=(0, 1, 2, 3))(*one)
        t_one = [torch.tensor(a[b], requires_grad=True) for a in st]
        L_t = t_fn(records(*t_one))
        g_t = torch.autograd.grad(L_t, t_one, allow_unused=True)
        np.testing.assert_allclose(float(L_t.detach()), float(L_j), **TOL)
        np.testing.assert_allclose(float(L_b[b].detach()), float(L_j),
                                   **TOL)
        for gj, gt, gb in zip(g_j, g_t, g_b):
            gt = np.zeros(gj.shape) if gt is None else gt.numpy()
            gb = np.zeros(gj.shape) if gb is None else gb[b].numpy()
            np.testing.assert_allclose(gt, np.asarray(gj), **TOL)
            np.testing.assert_allclose(gb, np.asarray(gj), **TOL)
    assert float(L_j) > 0


def test_batched_targets_give_each_episode_its_own():
    """MATCH_TRAJECTORY with a (B, N+1, n, 3) target: each episode is held
    to its own target."""
    rng = np.random.RandomState(23)
    tgt = rng.randn(2, N + 1, n, 3)
    x = torch.tensor(rng.randn(2, N, n, 3))
    x0 = torch.tensor(rng.randn(2, n, 3))
    fn = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                         tl.LossInfo(target_x=tgt))
    L = fn(records(x0, x0, x, x))
    for b in range(2):
        one = tl.make_loss_fn(tc.LossType.MATCH_TRAJECTORY,
                              tl.LossInfo(target_x=tgt[b]))
        np.testing.assert_allclose(float(L[b]),
                                   float(one(records(x0[b], x0[b], x[b],
                                                     x[b]))), **TOL)
