"""Port parity: host scene build, dense constraint operators, closed-form
projections and the P^{-1} prefactorization (diffcloth_tpu_torch.geometry /
core.dense_ops / core.solver) against the JAX package in f64.

The scene, the operator matrices and P^{-1} are numpy f64 on both sides
before the final cast, so they must be bit-equal.  Operator applications
and projections are the same f64 arithmetic in another library, so they
agree to 1e-12.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu.core import dense_ops as jdn
from diffcloth_tpu.core import solver as jslv
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch.core import dense_ops as tdn
from diffcloth_tpu_torch.core import solver as tslv
from diffcloth_tpu_torch.geometry import builder as tgb

TOL = dict(rtol=1e-12, atol=1e-12)
B = 3


def scene_cfg(m):
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=2, cloth_dim_y=2,
                              k_stiff_stretching=550, k_stiff_bending=0.01,
                              grid_num_x=7, grid_num_y=6, density=0.124,
                              use_spring_constraints=True),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=4, name="dense_ops_grid")


@pytest.fixture(scope="module")
def built():
    js, ts = jgb.build_scene(scene_cfg(jc)), tgb.build_scene(scene_cfg(tc))
    jd = jdn.build_dense_ops(js, js.stages[0], jnp.float64)
    td = tdn.build_dense_ops(ts, ts.stages[0], torch.float64, "cpu")
    rng = np.random.RandomState(7)
    x = ts.x_rest[None] + rng.randn(B, ts.n, 3) * 0.05
    k = np.abs(rng.randn(B, 4)) * [1.0, 1e4, 550.0, 0.01] + 0.1
    return js, ts, jd, td, x, k


def _flat(obj):
    """Every numpy array field of a (nested) host dataclass, by path."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": a for k, a in _flat(v).items()})
    return out


def test_scene_build_matches(built):
    js, ts = built[:2]
    ja, ta = _flat(js), _flat(ts)
    assert ja.keys() == ta.keys() and len(ja) > 10
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    for js_st, ts_st in zip(js.stages, ts.stages):
        for k, a in _flat(js_st).items():
            np.testing.assert_array_equal(_flat(ts_st)[k], a, err_msg=k)


def test_dense_operators_bit_equal(built):
    _, ts, jd, td = built[:4]
    assert td.A_sp.shape[0] > 0, "scene has no springs"
    for name in ("A_s", "A_b", "A_a", "A_sp", "sp_l0", "S", "tri_sw",
                 "b_scale"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)),
                                      err_msg=name)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_apply_A_At_S_match(built, batched):
    _, ts, jd, td, x, k = built
    rng = np.random.RandomState(8)
    xs = x if batched else x[:1]
    ks = k if batched else k[:1]
    ys_t = tdn.apply_A(td, torch.as_tensor(xs if batched else xs[0]))
    d = [rng.randn(len(xs), y.shape[-2], 3) for y in ys_t]
    At_t = tdn.apply_At(td, torch.as_tensor(ks if batched else ks[0]),
                        *[torch.as_tensor(a if batched else a[0]) for a in d])
    S_t = tdn.apply_S_pertype(td.S, torch.as_tensor(ks if batched else ks[0]),
                              torch.as_tensor(xs if batched else xs[0]))
    for b in range(len(xs)):
        sel = (lambda t: t[b]) if batched else (lambda t: t)
        ys_j = jdn.apply_A(jd, jnp.asarray(xs[b]))
        for yt, yj in zip(ys_t, ys_j):
            np.testing.assert_allclose(sel(yt).numpy(), np.asarray(yj), **TOL)
        At_j = jdn.apply_At(jd, jnp.asarray(ks[b]),
                            *[jnp.asarray(a[b]) for a in d])
        np.testing.assert_allclose(sel(At_t).numpy(), np.asarray(At_j),
                                   **TOL)
        S_j = jdn.apply_S_pertype(jd.S, jnp.asarray(ks[b]),
                                  jnp.asarray(xs[b]))
        np.testing.assert_allclose(sel(S_t).numpy(), np.asarray(S_j), **TOL)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_projections_match(built, batched):
    js, ts, jd, td, x, _ = built
    xf = ts.stages[0].fixed_pos_rest
    xs = x if batched else x[0]
    y_t = tdn.apply_A(td, torch.as_tensor(xs))
    xf_t = torch.as_tensor(np.broadcast_to(xf, (B,) + xf.shape).copy()
                           if batched else xf)
    p_t = tdn.projections_from_y(td, y_t[0], y_t[1], xf_t, y_sp=y_t[3])
    for b in range(B if batched else 1):
        sel = (lambda t: t[b]) if batched else (lambda t: t)
        y_j = jdn.apply_A(jd, jnp.asarray(x[b]))
        p_j = jdn.projections_from_y(jd, y_j[0], y_j[1], jnp.asarray(xf),
                                     y_sp=y_j[3])
        for name, pt, pj in zip(("stretch", "bend", "attach", "spring"),
                                p_t, p_j):
            assert pj.shape[0] > 0, name
            np.testing.assert_allclose(sel(pt).numpy(), np.asarray(pj),
                                       err_msg=name, **TOL)


def test_p_inv_bit_equal(built):
    js, ts, _, _, _, k = built
    area = np.asarray(ts.area, np.float64)
    gj = jslv.dense_gram_matrices(js)[0]
    gt = tslv.dense_gram_matrices(ts)[0]
    np.testing.assert_array_equal(gt, gj)
    pj = jslv.make_host_p_inv_fn(gj, area, 1.0 / 90.0, jnp.float64)
    pt = tslv.make_host_p_inv_fn(gt, area, 1.0 / 90.0, torch.float64,
                                  "cpu")
    for kb, rho in ((k[0], 0.124), (k[1], 0.3)):
        np.testing.assert_array_equal(
            pt(torch.as_tensor(kb),
               torch.tensor(rho, dtype=torch.float64)).numpy(),
            np.asarray(pj(jnp.asarray(kb), jnp.asarray(rho))))
