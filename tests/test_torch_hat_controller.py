"""Port parity for the closed-loop hat controller
(`diffcloth_tpu_torch/apps/hat_controller.py`) against the JAX app
(`apps/hat_controller.py`), in f64 on the CPU, on the hat's 25 x 25 grid
stand-in in both packages (the port's `registry.hat_grid_standin`, the
JAX registry's HAT_SCENE on the same grid) cut to STEPS steps.

The JAX app builds everything inside its `main()`, so the oracle here
repeats its `featurize`, `net`, action-cotangent clamp, closed-loop scan,
`traj_loss` and per-sample gradients over the JAX package's
`ClothSim.step`.  The controller's weights come from numpy and reach both
packages through `convert.controller_from_numpy` (the JAX side takes the
same arrays).  Tolerances: the loss, the per-sample gradient norms and
the summed policy gradient within 1e-8 relative (f64 throughout; the
poses keep the cloth off the bust and off itself, so no f32 friction
enters); three Adam + cosine + clip updates within 1e-12 of optax's (the
same formulas, in another order of rounding).
"""
import dataclasses
import json
import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffcloth_tpu.tasks import registry as jreg
from diffcloth_tpu.tasks import setup as jsetup
from diffcloth_tpu_torch.apps import hat_controller as hc
from diffcloth_tpu_torch.convert import (controller_from_numpy,
                                         controller_to_numpy)
from diffcloth_tpu_torch.tasks import registry as treg
from diffcloth_tpu_torch.tasks import setup as tsetup
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64
STEPS = 4
B = 2


def jax_standin():
    return dataclasses.replace(
        jreg.HAT_SCENE, step_num=STEPS, fabric=dataclasses.replace(
            jreg.AGENT_HAT_579, is_model=False, grid_num_x=25,
            grid_num_y=25))


@pytest.fixture(scope="module")
def tasks():
    jdemo = jreg.DEMOS["hat"]
    jreg.DEMOS["hat"] = dataclasses.replace(jdemo, scene=jax_standin())
    try:
        jtask = jsetup.build_task("hat", dtype=jnp.float64)
    finally:
        jreg.DEMOS["hat"] = jdemo
    ttask = tsetup.build_task("hat", dtype=F64, device="cpu",
                              scene=dataclasses.replace(
                                  treg.hat_grid_standin(), step_num=STEPS))
    return jtask, ttask


def numpy_weights(widths, seed=7):
    """tanh-MLP weights from numpy: scaled Gaussians, a last layer large
    enough that the clips move."""
    rng = np.random.RandomState(seed)
    return [{"w": rng.randn(widths[i], widths[i + 1])
             * (1.0 if i == len(widths) - 2 else 1.0 / math.sqrt(widths[i])),
             "b": rng.randn(widths[i + 1]) * 0.1}
            for i in range(len(widths) - 1)]


def jax_oracle(jtask, layers, xs, aas, action_grad_clamp, sample_gnorm_max):
    """The JAX app's loss_and_grad (apps/hat_controller.py:97-274), one
    episode per vmapped lane, in one scan."""
    sim = jtask.sim
    params = jtask.param_base
    p_inv = sim.p_inv(params)
    dtype = sim.dtype
    head_center = jnp.asarray(sim.prims.center[0], dtype)
    head_radius = float(sim.prims.radius[0])
    attach_idx = np.asarray(sim.stage_host.particle_idx)
    clip0 = sim.stage_dev.fixed_pos_rest.astype(dtype)
    target = jnp.asarray(jtask.loss_info.x_init, dtype) + jnp.asarray(
        jtask.loss_info.target_translation, dtype)
    dir_pairs = np.array([[394, 562], [32, 108]])
    clip_rest_dist = float(jnp.linalg.norm(clip0[1] - clip0[0]))

    def featurize(x, v):
        x_mean = jnp.mean(x, axis=0)
        v_mean = jnp.mean(v, axis=0)
        elev = head_radius * (x_mean - head_center) / jnp.maximum(
            jnp.linalg.norm(x_mean - head_center), 1e-9)
        proj = elev + head_center
        dirs = (x[dir_pairs[:, 0]] - x[dir_pairs[:, 1]]).reshape(-1)
        return jnp.concatenate([(x - target).reshape(-1), proj, elev,
                                v_mean, dirs])

    def net(ws, s):
        h = s
        for i, layer in enumerate(ws):
            h = h @ layer["w"] + layer["b"]
            if i < len(ws) - 1:
                h = jnp.tanh(h)
        return h

    @jax.custom_vjp
    def clamp_a(a):
        return a

    def clamp_fwd(a):
        return a, None

    def clamp_bwd(_, g):
        nrm = jnp.linalg.norm(g)
        return (g * jnp.where(nrm > action_grad_clamp,
                              action_grad_clamp / jnp.maximum(nrm, 1e-30),
                              1.0),)

    clamp_a.defvjp(clamp_fwd, clamp_bwd)

    def roll(ws, x, a):
        def body(carry, idx_f):
            x, v, a = carry
            out = jnp.clip(net(ws, featurize(x, v)), -1.0, 1.0)
            a = a + ((out + 1.0) / 2.0 * 0.2 - 0.1).reshape(-1, 3)
            x2, v2, _ = sim.step(x, v, params, clamp_a(a), p_inv,
                                 idx_f * sim.h, idx_f)
            return (x2, v2, a), x2[attach_idx]

        (xN, _, _), clips = jax.lax.scan(
            body, (x, jnp.zeros_like(x), a),
            jnp.arange(1, STEPS + 1, dtype=dtype))
        return clips, xN

    def smooth_l1(a, b):
        d = a - b
        ad = jnp.abs(d)
        return jnp.mean(jnp.where(ad < 1.0, 0.5 * d * d, ad - 0.5))

    def traj_loss(clip_traj, xN):
        clip_dist = jnp.linalg.norm(clip_traj[:, 1] - clip_traj[:, 0],
                                    axis=-1)
        stretch = jnp.sum(jnp.clip(
            jnp.abs(clip_dist - clip_rest_dist) - 1.0, 0.0)) * 0.2
        dirs = xN[dir_pairs[:, 0]] - xN[dir_pairs[:, 1]]
        goal = target[dir_pairs[:, 0]] - target[dir_pairs[:, 1]]
        cos = jnp.sum(dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
                      * goal / jnp.linalg.norm(goal, axis=-1,
                                               keepdims=True), axis=-1)
        direction = jnp.sum((0.5 - jnp.clip(cos, None, 0.5)) * 3.0)
        return stretch + direction + smooth_l1(xN.reshape(-1),
                                               target.reshape(-1))

    def sample_loss(ws, x, a):
        return traj_loss(*roll(ws, x, a)) / xs.shape[0]

    ws = jax.tree.map(jnp.asarray, layers)
    Ls, g_ps = jax.jit(jax.vmap(jax.value_and_grad(sample_loss),
                                in_axes=(None, 0, 0)))(
        ws, jnp.asarray(xs), jnp.asarray(aas))
    gn = np.sqrt(sum(np.sum(np.asarray(g).reshape(g.shape[0], -1) ** 2,
                            axis=1) for g in jax.tree.leaves(g_ps)))
    keep = gn <= sample_gnorm_max
    keep = keep if keep.any() else np.ones_like(keep)
    grads = jax.tree.map(lambda g: np.sum(np.where(
        keep.reshape((-1,) + (1,) * (g.ndim - 1)), np.asarray(g), 0.0),
        axis=0), g_ps)
    return float(jnp.sum(Ls)), grads, gn, ~keep


@pytest.fixture(scope="module")
def setting(tasks):
    jtask, ttask = tasks
    prob = hc.make_problem(ttask)
    rng = np.random.RandomState(0)
    poses = [hc.sample_pose(prob, rng) for _ in range(B)]
    xs = np.stack([p[0].numpy() for p in poses])
    aas = np.stack([p[1].numpy() for p in poses])
    feat = hc.featurize(prob, prob.x0[None], torch.zeros_like(prob.x0)[None])
    widths = [feat.shape[1], 64, 64, 3 * prob.clip0.shape[0]]
    return prob, xs, aas, numpy_weights(widths)


def flat(grads):
    return np.concatenate([np.asarray(a).reshape(-1) for a in grads])


@pytest.mark.parametrize("limits", ["defaults", "clamp_and_drop"])
def test_loss_and_per_sample_gradients_match_jax(tasks, setting, limits):
    jtask, _ = tasks
    prob, xs, aas, layers = setting
    ctrl = controller_from_numpy(layers, "cpu", F64)
    clamp, gmax = 4.0, 1e3
    if limits == "clamp_and_drop":
        # a clamp under the action cotangents' norms, and a rejection
        # threshold between the two samples' gradient norms
        free = hc.loss_and_grad(prob, ctrl, torch.as_tensor(xs),
                                torch.as_tensor(aas), 0.0, 0.0)
        clamp = 1e-3
        low = hc.loss_and_grad(prob, ctrl, torch.as_tensor(xs),
                               torch.as_tensor(aas), clamp, 0.0)
        assert not np.allclose(low.sample_gnorms, free.sample_gnorms,
                               rtol=1e-3), "the clamp did not act"
        gmax = float(np.mean(low.sample_gnorms))
    pg = hc.loss_and_grad(prob, ctrl, torch.as_tensor(xs),
                          torch.as_tensor(aas), clamp, gmax)
    L, grads, gn, dropped = jax_oracle(jtask, layers, xs, aas, clamp, gmax)
    np.testing.assert_allclose(float(pg.loss), L, rtol=1e-8)
    np.testing.assert_allclose(pg.sample_gnorms, gn, rtol=1e-8)
    np.testing.assert_array_equal(pg.dropped, dropped)
    assert int(dropped.sum()) == (1 if limits == "clamp_and_drop" else 0)
    want = flat([a for d in grads for a in (d["w"], d["b"])])
    got = flat([g.numpy() for g in pg.grads])
    assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()
    assert np.abs(want).max() > 0


def test_adam_cosine_clip_match_optax():
    """Three updates of `hc.adam_step` at `hc.cosine_lr` rates against
    optax.chain(clip_by_global_norm(1.0), adam(cosine_decay_schedule(lr,
    epochs, alpha=0.1))), as the JAX app builds it, on the same gradients:
    the first with global norm under 1, the others over it."""
    rng = np.random.RandomState(2)
    layers = numpy_weights([6, 5, 4])
    grads = [[{k: rng.randn(*np.shape(v)) * s for k, v in d.items()}
              for d in layers] for s in (0.05, 3.0, 40.0)]
    epochs, lr = 3, 2e-4
    sched = optax.cosine_decay_schedule(lr, decay_steps=epochs, alpha=0.1)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched))
    ws_j = jax.tree.map(jnp.asarray, layers)
    state = opt.init(ws_j)
    ctrl = controller_from_numpy(layers, "cpu", F64)
    params = ctrl.layers()
    opt_t = torch.optim.Adam(params, lr=lr)
    for epoch, g in enumerate(grads):
        gj = jax.tree.map(jnp.asarray, g)
        norm_j = float(optax.global_norm(gj))
        updates, state = opt.update(gj, state)
        ws_j = optax.apply_updates(ws_j, updates)
        rate = hc.cosine_lr(lr, epoch, epochs)
        assert rate == pytest.approx(float(sched(epoch)), rel=1e-15)
        norm_t = hc.adam_step(opt_t, params, [
            torch.as_tensor(a) for d in g for a in (d["w"], d["b"])], rate)
        assert norm_t == pytest.approx(norm_j, rel=1e-12)
        want = flat([np.asarray(a) for d in ws_j for a in (d["w"], d["b"])])
        got = flat([p.detach().numpy() for p in params])
        start = flat([a for d in layers for a in (d["w"], d["b"])])
        # the updates themselves, not only the weights
        np.testing.assert_allclose(got - start, want - start, rtol=1e-12,
                                   atol=1e-12 * np.abs(want - start).max())


def cli(tmp, *args):
    return ["--cpu", "--standin", "--steps", "2", "--train-samples", "2",
            "--val-samples", "1", "--out", str(tmp)] + list(args)


def test_resume_equals_unbroken_run_and_eval_writes_gif(tmp_path):
    """Two epochs in one run equal one epoch and then `--resume` of one,
    bit for bit (weights, log, checkpoint); `--eval` renders the
    best-validation controller to eval.gif."""
    whole, split = tmp_path / "whole", tmp_path / "split"
    assert hc.main(cli(whole, "--epochs", "2")) == 0
    assert hc.main(cli(split, "--epochs", "1")) == 0
    assert hc.main(cli(split, "--epochs", "2", "--resume")) == 0
    for name in ("controller.pkl", "log.json"):
        assert (whole / name).read_bytes() == (split / name).read_bytes(), \
            name
    with np.load(whole / "ckpts" / "ckpt_00000002" / "arrays.npz") as a, \
            np.load(split / "ckpts" / "ckpt_00000002" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    log = json.loads((whole / "log.json").read_text())
    assert [e["epoch"] for e in log] == [0, 1]
    assert all(np.isfinite(e["train"]) and np.isfinite(e["val"])
               for e in log)
    with open(whole / "controller.pkl", "rb") as fh:
        layers = pickle.load(fh)
    assert [sorted(d) for d in layers] == [["b", "w"]] * 3
    assert layers[0]["w"].dtype == np.float32
    assert controller_to_numpy(controller_from_numpy(
        layers, "cpu"))[2]["w"].tobytes() == layers[2]["w"].tobytes()
    assert hc.main(cli(whole, "--eval")) == 0
    assert (whole / "eval.gif").stat().st_size > 0


def test_eval_renders_without_matplotlib(tasks, tmp_path):
    """The GIF of an episode through the viewer's Pillow route (the
    card's machine has no matplotlib)."""
    from diffcloth_tpu_torch.io import viewer
    _, ttask = tasks
    x = ttask.param_base.x0.numpy()
    frames = np.stack([x, x + 0.1, x + 0.2])
    out = viewer.render_episode(frames, ttask.sim.scene_host.tris,
                                os.path.join(tmp_path, "ep.gif"), stride=1,
                                backend="pil")
    from PIL import Image
    with Image.open(out) as im:
        assert im.n_frames == 3
