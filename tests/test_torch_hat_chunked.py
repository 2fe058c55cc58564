"""The hat controller's chunked episode (`diffcloth_tpu_torch/apps/
hat_controller.py`: `chunk_roll`, `vjp_chunk`, `rollout_chunked` and the
chunked `loss_and_grad`, `episode_loss`, `evaluate`) against the JAX app's
own chunk scheme (`apps/hat_controller.py:161-272`) and against the port's
whole-episode route (`closed_loop_rollout`), in f64 on the
CPU, on the hat's 25 x 25 grid stand-in in both packages cut to STEPS = 6
steps, B = 2 poses; chunk 2 and chunk 4 (the largest divisor of 6 at most
4 is 3).

The JAX app builds its chunks inside `main()`, so the oracle here repeats
its `chunk_roll` (a scan of featurize -> MLP -> clip -> action update ->
`sim.step`), `vjp_chunk`, the loss's cotangents and the reverse pass over
the chunks, over the JAX package's `ClothSim.step`.  The clamp's norm is a
traced argument of the oracle, so both settings share its compiles.

Tolerances: against the JAX oracle, the loss, the per-sample gradient
norms and the summed gradient within 1e-8 relative, as the whole-episode
parity test (`test_torch_hat_controller.py`); against the whole-episode
route, the loss, the iteration counts, the states, `episode_loss` and
`evaluate`'s frames bit for bit (the same operations on the same values)
and the gradients within 1e-10 of each layer's largest entry (the chunks
sum the gradient in another order).
"""
import dataclasses
import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
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
STEPS = 6
B = 2
CHUNKS = (2, 4)
# (action-cotangent clamp, rejection threshold; None: between the two
# samples' gradient norms, so that one is dropped)
SETTINGS = {"defaults": (4.0, 1e3), "clamp_and_drop": (1e-3, None)}


@pytest.fixture(scope="module")
def tasks():
    jdemo = jreg.DEMOS["hat"]
    jreg.DEMOS["hat"] = dataclasses.replace(jdemo, scene=dataclasses.replace(
        jreg.HAT_SCENE, step_num=STEPS, fabric=dataclasses.replace(
            jreg.AGENT_HAT_579, is_model=False, grid_num_x=25,
            grid_num_y=25)))
    try:
        jtask = jsetup.build_task("hat", dtype=jnp.float64)
    finally:
        jreg.DEMOS["hat"] = jdemo
    ttask = tsetup.build_task("hat", dtype=F64, device="cpu",
                              scene=dataclasses.replace(
                                  treg.hat_grid_standin(), step_num=STEPS))
    return jtask, ttask


@pytest.fixture(scope="module")
def setting(tasks):
    """The port's problem, B start poses and numpy weights: scaled
    Gaussians, a last layer large enough that the clips move."""
    prob = hc.make_problem(tasks[1])
    xs, aas = hc.stack_poses(prob, np.random.RandomState(0), B)
    feat = hc.featurize(prob, prob.x0[None], torch.zeros_like(prob.x0)[None])
    widths = [feat.shape[1], 64, 64, 3 * prob.clip0.shape[0]]
    rng = np.random.RandomState(7)
    layers = [{"w": rng.randn(widths[i], widths[i + 1])
               * (1.0 if i == 2 else 1.0 / math.sqrt(widths[i])),
               "b": rng.randn(widths[i + 1]) * 0.1} for i in range(3)]
    return prob, xs.numpy(), aas.numpy(), layers


def make_oracle(jtask):
    """The JAX app's chunked loss_and_grad: oracle(layers, xs, aas, clamp,
    chunk) -> (mean loss, per-sample gradients [w0, b0, ...], their
    norms)."""
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
        dirs = (x[dir_pairs[:, 0]] - x[dir_pairs[:, 1]]).reshape(-1)
        return jnp.concatenate([(x - target).reshape(-1),
                                elev + head_center, elev, v_mean, dirs])

    def net(ws, s):
        h = s
        for i, layer in enumerate(ws):
            h = h @ layer["w"] + layer["b"]
            if i < len(ws) - 1:
                h = jnp.tanh(h)
        return h

    @jax.custom_vjp
    def clamp_a(a, max_norm):
        return a

    def clamp_fwd(a, max_norm):
        return a, max_norm

    def clamp_bwd(max_norm, g):
        nrm = jnp.linalg.norm(g)
        return (g * jnp.where(nrm > max_norm,
                              max_norm / jnp.maximum(nrm, 1e-30), 1.0),
                jnp.zeros_like(max_norm))

    clamp_a.defvjp(clamp_fwd, clamp_bwd)

    def chunk_roll(ws, x, v, a, idxs_c, max_norm):
        def body(carry, idx_f):
            x, v, a = carry
            out = jnp.clip(net(ws, featurize(x, v)), -1.0, 1.0)
            a = a + ((out + 1.0) / 2.0 * (hc.V_MAX - hc.V_MIN)
                     + hc.V_MIN).reshape(-1, 3)
            x2, v2, _ = sim.step(x, v, params, clamp_a(a, max_norm), p_inv,
                                 idx_f * sim.h, idx_f)
            return (x2, v2, a), x2[attach_idx]

        (xN, vN, aN), clip_traj = jax.lax.scan(body, (x, v, a), idxs_c)
        return xN, vN, aN, clip_traj

    fwd_jit = jax.jit(jax.vmap(chunk_roll,
                               in_axes=(None, 0, 0, 0, None, None)))

    def vjp_chunk(ws, x, v, a, idxs_c, max_norm, cot):
        _, vjp = jax.vjp(lambda w_, x_, v_, a_: chunk_roll(
            w_, x_, v_, a_, idxs_c, max_norm), ws, x, v, a)
        return vjp(cot)

    bwd_jit = jax.jit(jax.vmap(vjp_chunk,
                               in_axes=(None, 0, 0, 0, None, None, 0)))

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

    loss_cots = jax.jit(jax.value_and_grad(
        lambda clip_traj, xN: jnp.mean(jax.vmap(traj_loss)(clip_traj, xN)),
        argnums=(0, 1)))

    def oracle(layers, xs, aas, clamp, chunk):
        ws = jax.tree.map(jnp.asarray, layers)
        c = next(k for k in range(min(chunk, STEPS), 0, -1)
                 if STEPS % k == 0)
        idx_f = jnp.arange(1, STEPS + 1, dtype=dtype)
        max_norm = jnp.asarray(clamp, dtype)
        x, a = jnp.asarray(xs), jnp.asarray(aas)
        v = jnp.zeros_like(x)
        ins, clips = [], []
        for k in range(STEPS // c):
            ins.append((x, v, a))
            x, v, a, clip_c = fwd_jit(ws, x, v, a, idx_f[k * c:(k + 1) * c],
                                      max_norm)
            clips.append(clip_c)
        L, (dclip, dxN) = loss_cots(jnp.concatenate(clips, axis=1), x)
        cot = (dxN, jnp.zeros_like(v), jnp.zeros_like(a))
        g_ps = None
        for k in reversed(range(STEPS // c)):
            sl = slice(k * c, (k + 1) * c)
            gw, gx, gv, ga = bwd_jit(ws, *ins[k], idx_f[sl], max_norm,
                                     cot + (dclip[:, sl],))
            cot = (gx, gv, ga)
            g_ps = gw if g_ps is None else jax.tree.map(jnp.add, g_ps, gw)
        g_ps = [np.asarray(t) for d in g_ps for t in (d["w"], d["b"])]
        gn = np.sqrt(sum(np.sum(g.reshape(B, -1) ** 2, axis=1)
                         for g in g_ps))
        return float(L), g_ps, gn

    return oracle


@pytest.fixture(scope="module")
def runs(tasks, setting):
    """The JAX oracle's and the port's runs, each made once: ("jax", name,
    chunk), ("torch", name, chunk or None) -> result; the "clamp_and_drop"
    threshold is the mean of the oracle's two gradient norms."""
    prob, xs, aas, layers = setting
    oracle = make_oracle(tasks[0])
    cache, limits = {}, dict(SETTINGS)
    ctrl = controller_from_numpy(layers, "cpu", F64)

    def get(kind, name, chunk):
        key = (kind, name, chunk)
        if key not in cache:
            clamp, gmax = limits[name]
            if kind == "jax":
                cache[key] = oracle(layers, xs, aas, clamp, chunk)
                if gmax is None:
                    limits[name] = (clamp, float(np.mean(cache[key][2])))
            else:
                if gmax is None:
                    get("jax", name, CHUNKS[0])
                    gmax = limits[name][1]
                cache[key] = hc.loss_and_grad(
                    prob, ctrl, torch.as_tensor(xs), torch.as_tensor(aas),
                    clamp, gmax, chunk)
        return cache[key]

    return get, limits


def kept_sum(g_ps, gn, gmax):
    keep = gn <= gmax
    keep = keep if keep.any() else np.ones_like(keep)
    return np.concatenate([np.sum(np.where(
        keep.reshape((-1,) + (1,) * (g.ndim - 1)), g, 0.0), axis=0).ravel()
        for g in g_ps]), ~keep


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_loss_and_grad_matches_the_jax_chunk_scheme(runs, name, chunk):
    get, limits = runs
    L, g_ps, gn = get("jax", name, chunk)
    pg = get("torch", name, chunk)
    want, dropped = kept_sum(g_ps, gn, limits[name][1])
    np.testing.assert_allclose(float(pg.loss), L, rtol=1e-8)
    np.testing.assert_allclose(pg.sample_gnorms, gn, rtol=1e-8)
    np.testing.assert_array_equal(pg.dropped, dropped)
    assert int(dropped.sum()) == (1 if name == "clamp_and_drop" else 0)
    got = np.concatenate([g.numpy().ravel() for g in pg.grads])
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_chunked_loss_and_grad_matches_the_whole_episode(runs, name, chunk):
    get, _ = runs
    pg, whole = get("torch", name, chunk), get("torch", name, None)
    assert torch.equal(pg.loss, whole.loss)
    assert torch.equal(pg.iters, whole.iters)
    np.testing.assert_array_equal(pg.dropped, whole.dropped)
    np.testing.assert_allclose(pg.sample_gnorms, whole.sample_gnorms,
                               rtol=1e-10)
    for g, w in zip(pg.grads, whole.grads):
        assert float((g - w).abs().max()) <= 1e-10 * float(w.abs().max())


@pytest.mark.parametrize("n_steps, chunk, size",
                         [(400, 50, 50), (6, 4, 3), (7, 5, 1), (6, 50, 6)])
def test_chunk_size_is_the_largest_divisor_at_most_chunk(n_steps, chunk,
                                                         size):
    """Every chunk has one length: the largest divisor of the horizon at
    most `chunk` (apps/hat_controller.py:222-225), the whole horizon when
    it is shorter than `chunk`."""
    assert hc.chunk_size(n_steps, chunk) == size


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_states_val_loss_and_eval_frames_match_whole(
        setting, chunk, tmp_path):
    """rollout_chunked's states, clips and final (x, v, a), `episode_loss`
    and `evaluate`'s frames and loss equal the whole episode's bit for
    bit."""
    prob, xs, aas, layers = setting
    ctrl = controller_from_numpy(layers, "cpu", F64)
    ws = ctrl.layers()
    x, a = torch.as_tensor(xs), torch.as_tensor(aas)
    v = torch.zeros_like(x)
    with torch.no_grad():
        whole = hc.closed_loop_rollout(prob, ws, x, v, a, record=True)
        ch, starts = hc.rollout_chunked(prob, ws, x, v, a, chunk,
                                        record=True)
    c = hc.chunk_size(STEPS, chunk)
    assert len(starts) == STEPS // c
    for k in ("x", "v", "a", "clip_traj", "iters", "states"):
        assert torch.equal(getattr(ch, k), getattr(whole, k)), k
    for k, (xk, vk, ak) in enumerate(starts[1:], start=1):
        assert torch.equal(xk, whole.states[:, k * c - 1])
    assert float((whole.x - x).abs().max()) > 0
    assert hc.episode_loss(prob, ctrl, x, a, chunk) == float(
        torch.mean(hc.traj_loss(prob, whole.clip_traj, whole.x)))
    path = tmp_path / "controller.pkl"
    with open(path, "wb") as fh:
        pickle.dump(controller_to_numpy(ctrl), fh)
    ev = hc.evaluate(prob, str(path), log=lambda m: None, chunk=chunk)
    xe, ae = hc.sample_pose(prob, np.random.RandomState(1))
    with torch.no_grad():
        we = hc.closed_loop_rollout(prob, ws, xe[None],
                                    torch.zeros_like(xe)[None], ae[None],
                                    record=True)
    assert ev["loss"] == float(hc.traj_loss(prob, we.clip_traj, we.x)[0])
    np.testing.assert_array_equal(
        ev["frames"], torch.cat([xe[None], we.states[0]]).numpy())
    assert ev["frames"].shape == (STEPS + 1, prob.sim.n, 3)


def test_closed_loop_steps_read_device_time_vectors(setting, monkeypatch):
    """No per-step host tensor: every step of `closed_loop_rollout` gets
    its time and index as views of the problem's device vectors, equal
    bit for bit to `ClothSim._times()`'s."""
    prob, xs, aas, layers = setting
    ts, idxs = prob.sim._times()
    assert torch.equal(prob.times[0], ts) and torch.equal(prob.times[1],
                                                          idxs)
    seen = []
    step = prob.sim.step

    def recording(x, v, pb, a, p_inv, t, step_idx):
        seen.append((t, step_idx))
        return step(x, v, pb, a, p_inv, t, step_idx)

    monkeypatch.setattr(prob.sim, "step", recording)
    ctrl = controller_from_numpy(layers, "cpu", F64)
    with torch.no_grad():
        hc.closed_loop_rollout(prob, ctrl.layers(), torch.as_tensor(xs),
                               torch.zeros(xs.shape, dtype=F64),
                               torch.as_tensor(aas))
    assert len(seen) == STEPS
    for i, (t, step_idx) in enumerate(seen):
        assert t._base is prob.times[0] and step_idx._base is prob.times[1]
        assert torch.equal(t, ts[i]) and int(step_idx) == i + 1
