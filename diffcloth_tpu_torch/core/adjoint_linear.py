"""The adjoint's linearized K map: its Jacobians, made once per adjoint
program, and the kernels of a fixed-point trip, with their plain PyTorch
versions.

A step's adjoint needs (dK/dv)^T u at the step's v_new for every trip of
its fixed point and every matvec of its GMRES, where K(v) = b~(x_n + h v)
+ r(f), f = b~ - C v (`core/step.py`).  With z = u + g, g = J_r^T u:

    (dK/dv)^T u = h^2 sum_t k_t A_t^T (J_t^T A_t z - A_t g)

J_t the per-row Jacobians of the weightless projections at x_n + h v_new
(stretch: 6 x 6 per triangle; bending and springs: s (I - y^ y^T) / |y|;
attachments: none), J_r the friction's: r = sweep(f + r_obs(f)) - f, so
g = e + J_obs^T (u + e) with e = sweep^T u - u, the backward sweep
(`friction_cuda.friction_sweep_bwd`) at the `vals` of the step's one
forward sweep, J_obs the obstacle friction's per-particle 3 x 3.  The
constraint GEMMs are the caller's (`core/step.py`); here:

  * `linearize`: the Jacobians (B, 36 T + 4 Bn + 4 S) and J_obs (B, n, 9);
  * `kdv_pre`: (z, g) from u, the backward sweep and J_obs, in the layout
    the GEMM reads;
  * `kdv_rows`: q_t = h^2 k_t (J_t^T (A_t z) - A_t g) per row;
  * `trip_update`: the fixed point's masked convergence update, in place.

Each launches `csrc/adjoint_linear.cu` for CUDA tensors and runs its plain
version for CPU tensors, and counts its launches on the device
(`launch_count`).  Layouts: a "logical" (H, B, N, 3) tensor may be any
view whose last stride is 1 (the kernels take the other strides); the
dense route keeps them node- or row-major, (N, H, B, 3) in memory, so that
the constraint GEMMs read and write them as (N, 3 H B) matrices.  Row
order: stretch 2T (dense: split, column 0 rows then column 1 rows;
sparse: interleaved), bending Bn, attachments F, springs S.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from diffcloth_tpu_torch.core import cuda_build
from diffcloth_tpu_torch.core import launch_count as lc
from diffcloth_tpu_torch.core.constraints import EPS


def jac_width(T: int, Bn: int, S: int) -> int:
    """Entries a sample of the row Jacobians holds."""
    return 36 * T + 4 * Bn + 4 * S


def _dot(a, b):
    """Three-term dot product over the last dim, summed left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _safe_norm(n2):
    """(|v|, safe) from |v|^2 with constraints.safe_norm's guard."""
    safe = n2 > EPS * EPS
    return torch.where(safe, torch.sqrt(torch.where(safe, n2, 1.0)),
                       EPS), safe


# ---------------------------------------------------------------------------
# the Jacobians (once per adjoint program)

def corot_jacobian_plain(a, b, sw):
    """The 6 x 6 Jacobian of sw * corot_project_cols(a, b) (dense_ops.py)
    in (a, b), forward mode over six unit tangents: a, b (..., 3), sw
    (...,) -> (..., 6, 6), J[..., i, j] = d out_i / d in_j."""
    n2a = _dot(a, a)[..., None]
    na, sa = _safe_norm(n2a)
    q0 = a / na
    dq = _dot(b, q0)[..., None]
    bp = b - q0 * dq
    nb, sb = _safe_norm(_dot(bp, bp)[..., None])
    q1 = bp / nb
    tr = na + nb
    rn = torch.sqrt(tr * tr + dq * dq + EPS)
    c0 = (q0 * tr - q1 * dq) / rn
    c1 = (q0 * dq + q1 * tr) / rn
    # tangents: a trailing direction axis j of 6 before the vector axis
    eye = torch.eye(6, dtype=a.dtype, device=a.device)
    da, db = eye[:, :3], eye[:, 3:]
    ex = (lambda t: t[..., None, :])   # (..., 3) -> (..., 1, 3)
    ex1 = (lambda t: t[..., None, :])  # (..., 1) -> (..., 1, 1)
    a_, b_, q0_, bp_, q1_ = map(ex, (a, b, q0, bp, q1))
    na_, nb_, dq_, tr_, rn_ = map(ex1, (na, nb, dq, tr, rn))
    c0_, c1_ = ex(c0), ex(c1)
    dna = torch.where(ex1(sa), _dot(a_, da)[..., None] / na_, 0.0)
    dq0 = (da - q0_ * dna) / na_
    ddq = (_dot(db, q0_) + _dot(b_, dq0))[..., None]
    dbp = (db - q0_ * ddq) - dq0 * dq_
    dnb = torch.where(ex1(sb), _dot(bp_, dbp)[..., None] / nb_, 0.0)
    dq1 = (dbp - q1_ * dnb) / nb_
    dtr = dna + dnb
    drn = (tr_ * dtr + dq_ * ddq) / rn_
    t0 = (((dq0 * tr_ + q0_ * dtr) - (dq1 * dq_ + q1_ * ddq)) / rn_
          - c0_ * (drn / rn_))
    t1 = (((dq0 * dq_ + q0_ * ddq) + (dq1 * tr_ + q1_ * dtr)) / rn_
          - c1_ * (drn / rn_))
    cols = torch.cat([t0, t1], dim=-1) * sw[..., None, None]   # (.., j, i)
    return cols.transpose(-1, -2)


def unit_jacobian_plain(y, s):
    """(y^, c) of p = s y / |y| per row, dp/dy = c (I - y^ y^T): y (..., 3),
    s (...,) -> (..., 4); a degenerate row has y^ = 0, c = s / eps."""
    en, safe = _safe_norm(_dot(y, y)[..., None])
    u = torch.where(safe, y / en, 0.0)
    return torch.cat([u, s[..., None] / en], dim=-1)


def obstacle_jacobian_plain(d, normal, mu, on):
    """dr/dd of contact.dry_friction_force at d (..., 3) with the frozen
    normal, coefficient mu (...,) and contact mask `on` (...,) -> (..., 3,
    3), row-major: 0 off contact or on take-off, -I on stick, on slide
      -n n^T - mu sgn(sd) t n^T - (mu |sd| / |fT|) (I - t t^T) (I - n n^T)
    (the t t^T factor only where |fT| is above the guard)."""
    sd = _dot(d, normal)[..., None]
    fT = d - normal * sd
    tn, safe = _safe_norm(_dot(fT, fT)[..., None])
    th = fT / tn
    slide = mu[..., None] * torch.abs(sd)
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    nn = normal[..., :, None] * normal[..., None, :]
    P = eye - nn
    tp = ((th[..., 0, None] * P[..., 0, :] + th[..., 1, None] * P[..., 1, :])
          + th[..., 2, None] * P[..., 2, :])
    M = torch.where(safe[..., None], P - th[..., :, None] * tp[..., None, :],
                    P)
    sg = torch.sign(sd)[..., None]
    J = ((-nn - (mu[..., None, None] * sg) * (th[..., :, None]
                                              * normal[..., None, :]))
         - (slide / tn)[..., None] * M)
    J = torch.where((tn <= slide)[..., None], -eye, J)
    keep = (on[..., None] & (sd < 0.0))[..., None]
    return torch.where(keep, J, 0.0)


def linearize_plain(y, tri_sw, b_scale, sp_l0, counts: tuple, split: bool,
                    obstacles=None):
    """Plain version of `linearize`: y (B, R, 3) the rows at x_n + h v_new;
    counts (T, Bn, F, S); obstacles None or (f, m, normal, v_out, mask,
    prim_id, mu) -> (jac (B, jac_width), jobs (B, n, 9) or None)."""
    T, Bn, F, S = counts
    B = y.shape[0]
    if split:
        ya, yb = y[:, :T], y[:, T:2 * T]
    else:
        ya, yb = y[:, 0:2 * T:2], y[:, 1:2 * T:2]
    parts = [corot_jacobian_plain(ya, yb, tri_sw.to(y.dtype)).reshape(B, -1),
             unit_jacobian_plain(y[:, 2 * T:2 * T + Bn],
                                 b_scale.to(y.dtype)).reshape(B, -1),
             unit_jacobian_plain(y[:, 2 * T + Bn + F:],
                                 sp_l0.to(y.dtype)).reshape(B, -1)]
    jac = torch.cat(parts, dim=1)
    if obstacles is None:
        return jac, None
    f, m, normal, v_out, mask, prim_id, mu = obstacles
    d = f - v_out * m[..., None]
    mu_i = torch.gather(mu, 1, prim_id)
    jobs = obstacle_jacobian_plain(d, normal, mu_i, mask)
    return jac, jobs.reshape(f.shape[:-1] + (9,))


# ---------------------------------------------------------------------------
# a trip's kernels

def kdv_pre_plain(u, s, jobs, zg) -> None:
    """Plain version of `kdv_pre`, written into zg (H, B, n, 3)."""
    g = torch.zeros_like(u)
    if s is not None:
        g = (s - u.to(torch.float32)).to(u.dtype)
    if jobs is not None:
        v = u + g
        J = jobs.reshape(jobs.shape[:-1] + (3, 3))
        jt = ((J[..., 0, :] * v[..., 0, None] + J[..., 1, :] * v[..., 1, None])
              + J[..., 2, :] * v[..., 2, None])
        g = g + jt
    zg[0].copy_(u + g)
    if zg.shape[0] == 2:
        zg[1].copy_(g)


def kdv_rows_plain(y, jac, k, h2: float, q, counts: tuple,
                   split: bool) -> None:
    """Plain version of `kdv_rows`, written into q (B, R, 3)."""
    T, Bn, F, S = counts
    B = y.shape[1]
    z = y[0]
    g = y[1] if y.shape[0] == 2 else torch.zeros_like(z)
    kh = h2 * k
    if T:
        J = jac[:, :36 * T].reshape(B, T, 6, 6)
        if split:
            ra, rb = slice(0, T), slice(T, 2 * T)
        else:
            ra, rb = slice(0, 2 * T, 2), slice(1, 2 * T, 2)
        zin = torch.cat([z[:, ra], z[:, rb]], dim=-1)       # (B, T, 6)
        out = J[..., 0, :] * zin[..., 0, None]
        for i in range(1, 6):
            out = out + J[..., i, :] * zin[..., i, None]
        ks = kh[:, 2, None, None]
        q[:, ra] = (out[..., :3] - g[:, ra]) * ks
        q[:, rb] = (out[..., 3:] - g[:, rb]) * ks
    for lo, count, col, t in ((2 * T, Bn, 36 * T, 3),
                              (2 * T + Bn + F, S, 36 * T + 4 * Bn, 0)):
        if not count:
            continue
        c = jac[:, col:col + 4 * count].reshape(B, count, 4)
        rows = slice(lo, lo + count)
        zr, uh = z[:, rows], c[..., :3]
        jz = (zr - uh * _dot(uh, zr)[..., None]) * c[..., 3:]
        q[:, rows] = (jz - g[:, rows]) * kh[:, t, None, None]
    if F:
        rows = slice(2 * T + Bn, 2 * T + Bn + F)
        q[:, rows] = (-g[:, rows]) * kh[:, 1, None, None]


def trip_update_plain(lam, nxt, w_norm, it, done, bad, go, eps: float,
                      nh: float) -> None:
    """Plain version of `trip_update`, in place."""
    d = nxt - lam
    delta = torch.sqrt(torch.sum(d * d, dim=(-2, -1))) / nh
    bad_k = ~torch.isfinite(delta) | (
        torch.sqrt(torch.sum(nxt * nxt, dim=(-2, -1)))
        > 1e8 * (w_norm + 1e-30))
    act = ~(done | bad)
    lam.copy_(torch.where(act[:, None, None], nxt, lam))
    it.add_(act.to(it.dtype))
    done.copy_(torch.where(act, delta < eps, done))
    bad.copy_(torch.where(act, bad_k, bad))
    go.copy_(~(done | bad))


# ---------------------------------------------------------------------------
# the wrappers

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_SIGNATURES = {
    "kdv_linearize": [_I, _P, _L, _L, _P, _P, _P] + [_I] * 6 + [_P] + [_I] * 2
    + [_P] * 8 + [_P, _P],
    "kdv_pre": [_I] + [_P] * 4 + [_L] * 3 + [_I] * 3 + [_P, _P],
    "kdv_rows": [_I, _P, _L, _L, _L, _P, _P, _D, _P, _L, _L] + [_I] * 7
    + [_P, _P],
    "trip_update": [_I, _P, _P, _L, _L] + [_P] * 5 + [_D, _D, _I, _I]
    + [_P, _P],
}


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """The C entry point `name` of csrc/adjoint_linear.cu, typed once."""
    fn = getattr(cuda_build.load("adjoint_linear"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, device, *args) -> None:
    cuda_build.check(_kernel(name)(
        *args, lc.address(name, device),
        torch.cuda.current_stream(device).cuda_stream), name)


def _check(name: str, t, dtype, shape=None, contiguous=True) -> None:
    """A launch's per-tensor check: dtype, shape, last stride 1 (and
    contiguity where the kernel indexes it so)."""
    if (t.dtype != dtype or (shape is not None and tuple(t.shape) != shape)
            or t.stride(-1) != 1 or (contiguous and not t.is_contiguous())):
        raise ValueError(
            f"adjoint_linear: {name} must be a {'contiguous ' * contiguous}"
            f"{dtype} {shape} tensor (last stride 1), got {t.dtype} "
            f"{tuple(t.shape)} strides {t.stride()}")


def _ptr(t):
    return None if t is None else t.data_ptr()


@lc.counted("kdv_linearize")
def linearize(y, tri_sw, b_scale, sp_l0, counts: tuple, split: bool,
              obstacles=None):
    """The row Jacobians at y (B, R, 3), the rows of x_n + h v_new (any
    view with last stride 1), and, with obstacles (f, m, normal, v_out,
    mask, prim_id, mu) of the step's frozen contacts, J_obs: (jac (B,
    jac_width), jobs (B, n, 9) or None).  The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if not y.is_cuda:
        return linearize_plain(y, tri_sw, b_scale, sp_l0, counts, split,
                               obstacles)
    T, Bn, F, S = counts
    B, R, _ = y.shape
    dt = y.dtype
    if R != 2 * T + Bn + F + S:
        raise ValueError(f"adjoint_linear: {R} rows, counts {counts}")
    if T + Bn + S == 0 and obstacles is None:
        return y.new_zeros((B, 0)), None
    _check("y", y, dt, contiguous=False)
    consts = [c.to(dt).contiguous() for c in (tri_sw, b_scale, sp_l0)]
    jac = y.new_empty((B, jac_width(T, Bn, S)))
    obs = [None] * 7
    n, P, jobs = 0, 0, None
    if obstacles is not None:
        f, m, normal, v_out, mask, prim_id, mu = obstacles
        n, P = f.shape[1], mu.shape[1]
        obs = [f.contiguous(), m.contiguous(), normal.contiguous(),
               v_out.contiguous(), mask.contiguous(),
               prim_id.to(torch.int64).contiguous(), mu.to(dt).contiguous()]
        for name, t, want in zip(("f", "m", "normal", "v_out", "mu"),
                                 obs[:4] + obs[6:], (dt,) * 5):
            _check(name, t, want)
        jobs = y.new_empty((B, n, 9))
    _launch("kdv_linearize", y.device, int(dt == torch.float64),
            y.data_ptr(), y.stride(0), y.stride(1), *map(_ptr, consts),
            B, T, Bn, F, S, int(split), jac.data_ptr(), n, P,
            *map(_ptr, obs), _ptr(jobs))
    return jac, jobs


@lc.counted("kdv_pre")
def kdv_pre(u, s, jobs, H: int, node_major: bool):
    """(z, g) of a (dK/dv)^T u: u (B, n, 3) the cotangent, s (B, n, 3) f32
    the backward sweep of u (None without self-friction), jobs (B, n, 9)
    J_obs (None without obstacles); H = 2 writes z and g, H = 1 z = u
    alone (a step without contact).  Returns the logical (H, B, n, 3),
    node-major in memory ((n, H, B, 3)) when `node_major`."""
    B, n, _ = u.shape
    shape = (n, H, B, 3) if node_major else (H, B, n, 3)
    buf = u.new_empty(shape)
    zg = buf.permute(1, 2, 0, 3) if node_major else buf
    if not u.is_cuda:
        kdv_pre_plain(u, s, jobs, zg)
        return zg
    u = u.contiguous()
    _check("u", u, u.dtype, (B, n, 3))
    if s is not None:
        _check("s", s, torch.float32, (B, n, 3))
    if jobs is not None:
        _check("jobs", jobs, u.dtype, (B, n, 9))
    _launch("kdv_pre", u.device, int(u.dtype == torch.float64),
            u.data_ptr(), _ptr(s), _ptr(jobs), zg.data_ptr(), zg.stride(0),
            zg.stride(1), zg.stride(2), H, B, n)
    return zg


@lc.counted("kdv_rows")
def kdv_rows(y, jac, k, h2: float, counts: tuple, split: bool,
             row_major: bool):
    """q_t = h^2 k_t (J_t^T z_t - g_t) per row: y the logical (H, B, R, 3)
    rows of [z | g] (H = 1: z alone, g = 0), jac the Jacobians, k (B, 4)
    the stiffness.  Returns the logical (B, R, 3), row-major in memory
    ((R, B, 3)) when `row_major`."""
    H, B, R, _ = y.shape
    buf = y.new_empty((R, B, 3) if row_major else (B, R, 3))
    q = buf.transpose(0, 1) if row_major else buf
    if not y.is_cuda:
        kdv_rows_plain(y, jac, k, h2, q, counts, split)
        return q
    T, Bn, F, S = counts
    if R == 0:
        return q
    _check("y", y, y.dtype, contiguous=False)
    _check("jac", jac, y.dtype, (B, jac_width(T, Bn, S)))
    k = k.to(y.dtype).contiguous()
    _check("k", k, y.dtype, (B, 4))
    _launch("kdv_rows", y.device, int(y.dtype == torch.float64),
            y.data_ptr(), y.stride(0), y.stride(1), y.stride(2),
            jac.data_ptr(), k.data_ptr(), float(h2), q.data_ptr(),
            q.stride(0), q.stride(1), H, B, T, Bn, F, S, int(split))
    return q


@lc.counted("trip_update")
def trip_update(lam, nxt, w_norm, it, done, bad, go, eps: float,
                nh: float) -> None:
    """One fixed-point trip's masked update, in place: per episode delta =
    |lam' - lam| / nh, bad' = delta not finite or |lam'| > 1e8 (|w| +
    1e-30); where the episode is active (not done and not bad) lam <- lam',
    it += 1, done <- delta < eps, bad <- bad'; go <- not (done or bad).
    lam (B, n, 3) contiguous, nxt (B, n, 3) any view with last stride 1."""
    if not lam.is_cuda:
        trip_update_plain(lam, nxt, w_norm, it, done, bad, go, eps, nh)
        return
    B, n, _ = lam.shape
    if nxt.stride(-1) != 1:
        nxt = nxt.contiguous()
    _check("lam", lam, lam.dtype, (B, n, 3))
    _check("lam_next", nxt, lam.dtype, (B, n, 3), contiguous=False)
    _check("w_norm", w_norm, lam.dtype, (B,))
    _check("it", it, torch.int32, (B,))
    for name, t in (("done", done), ("bad", bad), ("go", go)):
        _check(name, t, torch.bool, (B,))
    _launch("trip_update", lam.device, int(lam.dtype == torch.float64),
            lam.data_ptr(), nxt.data_ptr(), nxt.stride(0), nxt.stride(1),
            w_norm.data_ptr(), it.data_ptr(), done.data_ptr(),
            bad.data_ptr(), go.data_ptr(), float(eps), float(nh), B, n)
