"""Port parity for the obstacle contacts (`diffcloth_tpu_torch.core.contact`)
against the JAX package's `core/contact.py`, on the CPU in f64: the four
analytic primitive tests, the three-sample first-hit detection, and the
obstacle friction with its VJP.

Inputs are seeded numpy points around each primitive.  The primitive tests
branch on thresholds (dist < 0.1, |d| <= 0.4, the capsule window, the bowl
shell), and a point within rounding of one could fall on either side in the
two packages, so points closer than 1e-9 to a threshold are dropped from
the draws; every other point must agree exactly in its branch.

Tolerances, with their reasons:
  * hit masks, contact masks and primitive ids: equal.
  * normals, distances and v_out: 1e-12 (f64; the packages may sum a
    3-vector's squares in another order, a few ulps).
  * obstacle friction and its VJP in f, mu and the mass: 1e-10 (the same
    f64 formulas; the slide branch divides by |f_T|, which a few ulps of
    input move by more than the forward's ulps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu.core import contact as jct
from diffcloth_tpu.tasks import setup as jsetup
from diffcloth_tpu_torch.convert import primitive_set_from_numpy
from diffcloth_tpu_torch.core import contact as tct
from diffcloth_tpu_torch.tasks import setup as tsetup

ATOL = 1e-12
FRICTION_TOL = 1e-10


def prim_pair(entries, enabled=None, kinematic=None):
    """The same primitives in both packages: the JAX set from the JAX task
    setup's `_prim_struct`, the port's carried across by
    `primitive_set_from_numpy` (and held equal to the port's own
    `_prim_struct`)."""
    jp = jsetup._prim_struct(entries, jnp.float64)
    if enabled is not None:
        jp = jp._replace(enabled=np.asarray(enabled))
    if kinematic is not None:
        jp = jp._replace(kinematic=np.asarray(kinematic))
    tp = primitive_set_from_numpy(
        {k: (v if v is None else np.asarray(v))
         for k, v in jp._asdict().items()}, torch.float64, "cpu")
    own = tsetup._prim_struct(entries, torch.float64, "cpu")
    for name in ("center", "velocity", "radius", "length", "axis_rot",
                 "plane_normal", "plane_upper_left", "plane_upper_right",
                 "mu"):
        assert torch.equal(getattr(own, name), getattr(tp, name)), name
    return jp, tp


def away_from(values, thresholds, margin=1e-9):
    keep = np.ones(values[0].shape, bool)
    for v, th in zip(values, thresholds):
        keep &= np.abs(v - th) > margin
    return keep


def assert_test_matches(jfn, tfn, jp, tp, pts, min_hits=1, min_miss=1):
    jh, jn, jd, jv = jfn(jp, 0, jnp.asarray(pts))
    th, tn, tdist, tv = tfn(tp, 0, torch.as_tensor(pts))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    for a, b in ((tn, jn), (tdist, jd), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.broadcast_to(
            np.asarray(b), a.shape), rtol=0, atol=ATOL)
    hits = int(th.sum())
    assert hits >= min_hits and len(pts) - hits >= min_miss, hits
    return th.numpy()


def sphere_points(rng, center, radius, count=400):
    d = rng.randn(count, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = rng.uniform(-0.6, 0.6, count)
    pts = np.asarray(center) + d * (radius + dist)[:, None]
    rn = np.linalg.norm(pts - np.asarray(center), axis=1) - radius
    return pts[away_from([rn], [0.1])]


@pytest.mark.parametrize("rotates", [False, True])
def test_sphere_test_matches(rotates):
    rng = np.random.RandomState(1)
    center = (0.3, -1.2, 0.4)
    jp, tp = prim_pair([dict(kind=jct.P_SPHERE, center=center, radius=1.3,
                             velocity=(0.2, 0.0, -0.1), mu=0.4,
                             rotates=rotates)])
    pts = sphere_points(rng, center, 1.3)
    assert_test_matches(jct._sphere_test, tct._sphere_test, jp, tp, pts)
    if rotates:   # (0,1,0) x n * 8 reaches v_out
        _, n, _, v = tct._sphere_test(tp, 0, torch.as_tensor(pts))
        assert float((v - tp.velocity[0]).abs().max()) > 1.0


def test_plane_test_matches():
    """A tilted bounded rectangle (the slope's): points inside and outside
    it, with d spread over [-1, 1] so that d < -0.4 flips the normal and
    |d| > 0.4 misses."""
    rng = np.random.RandomState(2)
    ul, ur = tsetup.SLOPE_UL, tsetup.SLOPE_UR
    normal = np.cross(ur, ul)
    normal /= np.linalg.norm(normal)
    center = np.array([0.5, -2.0, 1.0])
    jp, tp = prim_pair([dict(kind=jct.P_PLANE, center=center, normal=normal,
                             ul=ul, ur=ur, mu=0.2)])
    eu = (ul + ur) / np.linalg.norm(ul + ur)
    ev = (ur - ul) / np.linalg.norm(ur - ul)
    half_u = abs((ul + ur) @ eu) / 2 + abs((ul - ur) @ eu) / 2
    half_v = abs((ur - ul) @ ev) / 2 + abs((ur + ul) @ ev) / 2
    m = 600
    cu = rng.uniform(-1.3, 1.3, m) * half_u
    cv = rng.uniform(-1.3, 1.3, m) * half_v
    d = rng.uniform(-1.0, 1.0, m)
    keep = away_from([np.abs(cu), np.abs(cv), np.abs(d), d],
                     [half_u, half_v, 0.4, -0.4])
    pts = (center + cu[:, None] * eu + cv[:, None] * ev
           + d[:, None] * normal)[keep]
    hit = assert_test_matches(jct._plane_test, tct._plane_test, jp, tp, pts)
    d, inside = d[keep], ((np.abs(cu) <= half_u) & (np.abs(cv) <= half_v))[
        keep]
    assert (inside & (d < -0.4)).any() and (inside & (d > 0.4)).any()
    assert (~inside & (np.abs(d) < 0.4)).any()
    np.testing.assert_array_equal(hit, inside & (np.abs(d) <= 0.4))


def test_capsule_test_matches():
    """A tilted capsule: points along the axis at t < 0, in (0, 1) and
    > 1, some just outside the r/L acceptance window."""
    rng = np.random.RandomState(3)
    axis = np.array([0.3, 1.0, 0.2])
    from diffcloth_tpu_torch.geometry import builder as tgb
    rot = tgb.axis_to_rotation(axis / np.linalg.norm(axis),
                               np.array([0.0, 1.0, 0.0]))
    base, L, r = np.array([0.1, -0.5, 0.2]), 2.0, 0.6
    jp, tp = prim_pair([dict(kind=jct.P_CAPSULE, center=base, radius=r,
                             length=L, rot=rot, mu=0.3)])
    tip = rot @ np.array([0.0, L, 0.0])
    m = 800
    t = rng.uniform(-0.6, 1.6, m)
    side = rng.randn(m, 3)
    side -= (side @ tip)[:, None] * tip / (tip @ tip)
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    rad = rng.uniform(0.0, r + 0.5, m)
    pts = base + t[:, None] * tip + rad[:, None] * side
    rel = pts - base
    tt = rel @ tip / (tip @ tip)
    d_bot = np.linalg.norm(rel, axis=1) - r
    d_top = np.linalg.norm(rel - tip, axis=1) - (r + 0.1)
    d_body = np.linalg.norm(rel - np.clip(tt, 0, 1)[:, None] * tip,
                            axis=1) - (r + 0.1)
    keep = away_from([tt, tt, tt, tt, d_bot, d_top, d_body],
                     [0.0, 1.0, -r / L, 1.0 + r / L, 0.1, 0.1, 0.1])
    hit = assert_test_matches(jct._capsule_test, tct._capsule_test, jp, tp,
                              pts[keep])
    tt = tt[keep]
    for sel in (tt < 0, (tt > 0) & (tt < 1), tt > 1):
        assert hit[sel].any() and (~hit[sel]).any()
    outside = (tt < -r / L) | (tt > 1 + r / L)
    assert outside.any() and not hit[outside].any()


def test_bowl_test_matches():
    """A bowl: upper and lower points, inside and outside the shell, some
    within its 0.005 thickness."""
    rng = np.random.RandomState(4)
    center, radius = np.array([0.0, 0.5, 0.0]), 0.5
    jp, tp = prim_pair([dict(kind=jct.P_BOWL, center=center, radius=radius,
                             mu=0.0)])
    m = 800
    d = rng.randn(m, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # half the points within 0.01 of the shell, the rest spread wider
    off = np.where(rng.rand(m) < 0.5, rng.uniform(-0.01, 0.01, m),
                   rng.uniform(-0.3, 0.3, m))
    pts = center + d * (radius + off)[:, None]
    rn = np.linalg.norm(pts - center, axis=1)
    keep = away_from([rn - radius, rn, pts[:, 1]],
                     [0.005, radius - 0.005, center[1]])
    hit = assert_test_matches(jct._bowl_test, tct._bowl_test, jp, tp,
                              pts[keep])
    upper = pts[keep, 1] > center[1]
    assert upper.any() and not hit[upper].any()
    assert hit.any() and (~hit[~upper]).any()


def detect_both(jp, tp, x, v, h, t):
    """The port on the (B, n, 3) batch at once; JAX per episode."""
    tc = tct.detect_obstacle_contacts(tp, torch.as_tensor(x),
                                      torch.as_tensor(v), h,
                                      t=None if t is None
                                      else torch.tensor(t, dtype=torch.float64))
    js = [jct.detect_obstacle_contacts(jp, jnp.asarray(x[b]),
                                       jnp.asarray(v[b]), h, t=t)
          for b in range(x.shape[0])]
    for name in ("mask", "prim_id"):
        np.testing.assert_array_equal(
            getattr(tc, name).numpy(),
            np.stack([np.asarray(getattr(c, name)) for c in js]), name)
    for name in ("normal", "v_out"):
        np.testing.assert_allclose(
            getattr(tc, name).numpy(),
            np.stack([np.asarray(getattr(c, name)) for c in js]),
            rtol=0, atol=ATOL, err_msg=name)
    return tc


def cloud(rng, B, n, center, spread):
    return (np.asarray(center) + rng.uniform(-spread, spread, (B, n, 3)),
            rng.randn(B, n, 3) * 2.0)


def keep_clear(x, v, h, centers, radii):
    """Drop particles whose three samples fall within 1e-9 of a sphere's
    threshold (the same particles from every episode)."""
    keep = np.ones(x.shape[1], bool)
    for dt in (0.0, 0.5 * h, h):
        p = x + v * dt
        for c, r in zip(centers, radii):
            dist = np.linalg.norm(p - np.asarray(c), axis=-1) - r
            keep &= (np.abs(dist - 0.1) > 1e-9).all(axis=0)
    return x[:, keep], v[:, keep]


def test_detect_first_hit_order_and_disabled():
    """Three overlapping spheres, B = 3: where two hit, the earlier in
    index order wins; the middle one is disabled, so it is tested and
    skipped (its particles fall to the third)."""
    rng = np.random.RandomState(5)
    centers = [(0.0, 0.0, 0.0), (0.4, 0.0, 0.0), (0.2, 0.3, 0.0)]
    radii = [0.5, 0.5, 0.6]
    entries = [dict(kind=jct.P_SPHERE, center=c, radius=r, mu=0.1 * (i + 1),
                    velocity=(0.0, 0.1 * i, 0.0))
               for i, (c, r) in enumerate(zip(centers, radii))]
    h = 0.05
    x, v = keep_clear(*cloud(rng, 3, 500, (0.2, 0.1, 0.0), 1.0), h, centers,
                      radii)
    for enabled in ([True, True, True], [True, False, True]):
        jp, tp = prim_pair(entries, enabled=enabled)
        cs = detect_both(jp, tp, x, v, h, None)
        ids = cs.prim_id[cs.mask]
        assert {0, 2} <= set(ids.tolist())
        assert (1 in ids.tolist()) == enabled[1]


def test_detect_kinematic_primitive_at_time():
    """A moving sphere beside a static plane floor, detected at t > 0 (its
    center advanced by t v), against the static pose at t = 0."""
    rng = np.random.RandomState(6)
    sphere = dict(kind=jct.P_SPHERE, center=(0.0, 0.0, 0.0), radius=0.5,
                  velocity=(1.5, 0.0, 0.0), mu=0.5)
    floor = dict(kind=jct.P_PLANE, center=(0.0, -0.6, 0.0),
                 normal=(0.0, 1.0, 0.0), ul=(-2.0, 0.0, -2.0),
                 ur=(2.0, 0.0, -2.0), mu=0.2)
    jp, tp = prim_pair([sphere, floor], kinematic=[True, False])
    h = 0.02
    t = 0.4
    x, v = cloud(rng, 2, 600, (0.4, -0.2, 0.0), 1.2)
    x, v = keep_clear(x, v, h, [(0.0, 0.0, 0.0), (t * 1.5, 0.0, 0.0)],
                      [0.5, 0.5])
    y = x[..., 1] + v[..., 1] * np.array([0.0, 0.5 * h, h])[:, None, None]
    near = (np.abs(np.abs(y + 0.6) - 0.4) < 1e-9).any(axis=(0, 1))
    x, v = x[:, ~near], v[:, ~near]
    c0 = detect_both(jp, tp, x, v, h, 0.0)
    ct_ = detect_both(jp, tp, x, v, h, t)
    assert c0.mask.any() and ct_.mask.any()
    assert not torch.equal(c0.mask, ct_.mask)
    assert (ct_.prim_id[ct_.mask] == 1).any()
    moved = tct.prims_at_time(tp, torch.tensor(t, dtype=torch.float64))
    np.testing.assert_allclose(moved.center.numpy(),
                               [[0.6, 0.0, 0.0], [0.0, -0.6, 0.0]],
                               rtol=0, atol=1e-15)


def friction_case(case, rng, B, n):
    """f and the contact normals for one regime of the case split:
    take-off (f along +n), stick (|f_T| well under mu |f_N|) or slide
    (well over)."""
    nrm = rng.randn(B, n, 3)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tan = rng.randn(B, n, 3)
    tan -= np.sum(tan * nrm, -1, keepdims=True) * nrm
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    fn = rng.uniform(0.5, 2.0, (B, n, 1))
    scale = {"takeoff": 0.5, "stick": 0.02, "slide": 5.0}[case]
    ft = rng.uniform(0.5, 1.0, (B, n, 1)) * scale * fn
    sign = 1.0 if case == "takeoff" else -1.0
    return sign * fn * nrm + ft * tan, nrm


@pytest.mark.parametrize("case", ["stick", "slide", "takeoff"])
def test_obstacle_friction_and_vjp_match(case):
    """Per-episode mu (B, P): each episode gathers its own coefficients,
    so dL/dmu stays per episode; VJPs in f, mu and the mass against
    jax.vjp."""
    rng = np.random.RandomState(7 + len(case))
    B, n, P = 3, 40, 2
    f, nrm = friction_case(case, rng, B, n)
    # v_out = 0: d = f, so the case split is f's
    mask = rng.rand(B, n) < 0.8
    prim_id = np.where(mask, rng.randint(0, P, (B, n)), 0)
    mass = rng.uniform(0.05, 0.2, (B, n))
    mu = rng.uniform(0.2, 0.6, (B, P))
    g = rng.randn(B, n, 3)
    cs = tct.ContactSet(mask=torch.as_tensor(mask),
                        normal=torch.as_tensor(nrm),
                        v_out=torch.zeros(B, n, 3, dtype=torch.float64),
                        prim_id=torch.as_tensor(prim_id))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (f, mass, mu)]
    r = tct.obstacle_friction(leaves[0], cs, leaves[1], leaves[2])
    grads = torch.autograd.grad(r, leaves, torch.as_tensor(g))
    for b in range(B):
        jcs = jct.ContactSet(mask=jnp.asarray(mask[b]),
                             normal=jnp.asarray(nrm[b]),
                             v_out=jnp.zeros((n, 3)),
                             prim_id=jnp.asarray(prim_id[b], jnp.int32))
        jr, vjp = jax.vjp(lambda ff, mm, uu: jct.obstacle_friction(
            ff, jcs, mm, uu), jnp.asarray(f[b]), jnp.asarray(mass[b]),
            jnp.asarray(mu[b]))
        np.testing.assert_allclose(r[b].detach().numpy(), np.asarray(jr),
                                   rtol=0, atol=FRICTION_TOL)
        for tg, jg in zip(grads, vjp(jnp.asarray(g[b]))):
            np.testing.assert_allclose(tg[b].numpy(), np.asarray(jg),
                                       rtol=0, atol=FRICTION_TOL)
        assert np.isfinite(np.asarray(jr)).all()
    rr = r.detach()
    if case == "takeoff":
        assert not rr.any() and not grads[2].any()
    else:
        assert rr[torch.as_tensor(mask)].abs().max() > 0
        assert not rr[~torch.as_tensor(mask)].any()
        # mu moves only the slide regime's force
        assert bool(grads[2].abs().max() > 0) == (case == "slide")
