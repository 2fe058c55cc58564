"""The adjoint's linearized K map (`core/adjoint_linear.py`, `kdv` in
`core/step.py`) against the autograd product it replaces, in f64 on the
CPU (the kernels' plain versions).

A real backward of one step leaves its adjoint program's entries
(`adjoint_entries`); on them the two products at the step's v_new are
taken: `step.kdv`, the Jacobians made once by the adjoint's start and
applied by the trip's chain, and `step.vjp_k`, K recomputed and
differentiated by `torch.autograd.grad`.  They must agree to 1e-10 of the product's largest entry: the same derivatives
in another order of f64 operations (the friction sweeps run in f32 in
both, on the same inputs, so they agree exactly).  The sparse route reads
its projections from its rows scaled by sqrt(area) (a stretch row) or
sqrt(3 / area) (a hinge), which moves the last bits: about 1e-12 here.

Cases: a cloth on a sphere whose contacts stick, slide and take off (the
cotangent on those particles alone, so each case's 3 x 3 is what the
product reads), a folded cloth whose self-contacts fill four friction
layers, a step without contact, and a scene with every constraint type
(stretch, bending, springs, attachments); each on the dense and the
sparse operators and in both adjoint modes, whose GMRES takes the same
product.  Then the Jacobians' plain versions against autograd of the
functions they differentiate, degenerate inputs included.
"""
import numpy as np
import pytest
import torch

from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch.core import adjoint_linear as al
from diffcloth_tpu_torch.core import contact as ct
from diffcloth_tpu_torch.core import dense_ops as dn
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.geometry import states
from diffcloth_tpu_torch.tasks.setup import _prim_struct
from adjoint_entries import adjoint_entries
from torch_cpu import one_intra_op_thread  # noqa: F401

F64 = torch.float64
RTOL = 1e-10
ROUTES = {"dense": {}, "sparse": dict(dense_ops=False, sparse_ops=True)}
SPHERE = dict(kind=0, center=(0.0, 0.0, -3.02), radius=3.0, mu=0.5)


def scene_of(kind: str):
    """A 7 x 7 cloth of 2 x 2 in the z = 0 plane; "springs" adds edge
    springs and two clipped corners."""
    every = kind == "springs"
    return gb.build_scene(tc.SceneConfig(
        fabric=tc.FabricConfig(cloth_dim_x=2.0, cloth_dim_y=2.0,
                               k_stiff_stretching=250.0,
                               k_stiff_bending=0.05, grid_num_x=7,
                               grid_num_y=7, density=0.3,
                               use_spring_constraints=every),
        attachment_points=(tc.AttachmentConfig.LEFT_RIGHT_CORNERS_2 if every
                           else tc.AttachmentConfig.NO_ATTACHMENTS),
        wind_config=tc.WindConfig.NO_WIND, time_step=1.0 / 90.0,
        step_num=2, forward_convergence_thresh=1e-9, name="kdv_" + kind))


def products(kind: str, route: str, mode: str):
    """(sim, the adjoint's entries of one step of a batch of three
    episodes from a noisy state (the sphere's episodes at mu 0.05, 0.5 and
    5), a cotangent u)."""
    scene = scene_of(kind)
    prims = (_prim_struct([SPHERE], F64, "cpu") if kind == "sphere"
             else None)
    flags = tc.SimFlags(adjoint_mode=mode, contact_enabled=kind != "none")
    sim = ClothSim(scene, device="cpu", dtype=F64, prims=prims, flags=flags,
                   **ROUTES[route])
    B = 3
    p = sim.default_params().expand(B)
    if prims is not None:
        p = p.replace(mu=torch.tensor([[0.05], [0.5], [5.0]], dtype=F64))
    rng = np.random.RandomState(0)
    x0 = np.array(scene.x_rest)
    noise, vscale = 0.01, 2.0
    if kind == "folded":
        x0 = states.folded_grid(scene, 3, 0.5 * float(scene.radii.mean()))
        noise, vscale = 0.05, 0.5
    x = torch.as_tensor(np.stack([x0 + noise * rng.randn(*x0.shape)
                                  for _ in range(B)]))
    v = torch.as_tensor(rng.randn(B, sim.n, 3) * vscale)
    st = adjoint_entries(sim, x, v, p, sim.x_fixed_seq(p)[:, 0],
                         sim.p_inv(p), torch.tensor(0.0, dtype=F64), 1)
    return sim, st, torch.as_tensor(rng.randn(B, sim.n, 3))


def assert_same_product(sim, st, u):
    a, b = sim.step.kdv(st, u), sim.step.vjp_k(st, u)
    scale = float(b.abs().max())
    assert scale > 0
    err = float((a - b).abs().max()) / scale
    assert err <= RTOL, err


def obstacle_cases(entries) -> dict:
    """Per case, the (B, n) particles whose contact is in it, from J_obs:
    take-off (in contact, J = 0), stick (J = -I), slide (the rest)."""
    J = entries["kdv_jobs"].reshape(entries["c_mask"].shape + (3, 3))
    on = entries["c_mask"]
    zero = (J == 0).all(-1).all(-1)
    stick = (J == -torch.eye(3, dtype=J.dtype)).all(-1).all(-1)
    return {"take-off": on & zero, "stick": stick,
            "slide": on & ~zero & ~stick}


@pytest.mark.parametrize("mode", ["fp", "gmres"])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", ["stick", "slide", "take-off"])
def test_obstacle_case(case, route, mode):
    sim, st, u = products("sphere", route, mode)
    sel = obstacle_cases(st)[case]
    assert int(sel.sum()) >= 3, int(sel.sum())
    assert_same_product(sim, st, torch.where(sel[..., None], u, 0.0))
    assert_same_product(sim, st, u)


@pytest.mark.parametrize("mode", ["fp", "gmres"])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", ["folded", "none", "springs"])
def test_step_product(kind, route, mode):
    sim, st, u = products(kind, route, mode)
    if kind == "folded":
        # self-contact across layers: slots in four of them
        assert int((st["counts"] > 0).sum(dim=1).min()) >= 4, st["counts"]
        assert "kdv_vals" in st and "kdv_jobs" not in st
    if kind == "none":
        assert "kdv_vals" not in st and "kdv_jobs" not in st
    if kind == "springs":
        rows = (sim.dense.A_s.shape[0] // 2, sim.dense.A_b.shape[0],
                sim.dense.A_a.shape[0], sim.dense.A_sp.shape[0]) \
            if route == "dense" else sim.sparse.n_rows
        assert min(rows) > 0, rows
    assert_same_product(sim, st, u)


# ---------------------------------------------------------------------------
# the Jacobians against autograd of what they differentiate

def jacobian(fn, x):
    """(out, in) Jacobian of fn at x (one autograd row per output)."""
    return torch.autograd.functional.jacobian(fn, x)


@pytest.mark.parametrize("shape", ["generic", "sheared", "degenerate_b"])
def test_corot_jacobian(shape):
    rng = np.random.RandomState({"generic": 1, "sheared": 2,
                                 "degenerate_b": 3}[shape])
    a = torch.as_tensor(rng.randn(3))
    b = torch.as_tensor(rng.randn(3))
    if shape == "sheared":
        b = 0.9 * a + 0.05 * b
    if shape == "degenerate_b":
        b = 2.0 * a      # b's part normal to a is zero: the guard's branch
    sw = torch.tensor(0.7, dtype=F64)

    def fn(ab):
        c0, c1 = dn.corot_project_cols(ab[:3], ab[3:])
        return torch.cat([c0, c1]) * sw

    want = jacobian(fn, torch.cat([a, b]))
    got = al.corot_jacobian_plain(a, b, sw)
    assert torch.allclose(got, want, rtol=0, atol=1e-12 * float(
        want.abs().max()))


@pytest.mark.parametrize("which", ["bend", "spring", "degenerate"])
def test_unit_jacobian(which):
    rng = np.random.RandomState(5)
    y = torch.as_tensor(rng.randn(3))
    if which == "degenerate":
        y = torch.zeros(3, dtype=F64)
    s = torch.tensor(1.3, dtype=F64)
    proj = dn.bend_proj_from_y if which == "bend" else dn.spring_proj_from_y
    want = jacobian(lambda q: proj(q[None], s[None])[0], y)
    c = al.unit_jacobian_plain(y, s)
    got = c[3] * (torch.eye(3, dtype=F64) - c[:3, None] * c[None, :3])
    assert torch.allclose(got, want, rtol=0, atol=1e-12 * float(
        want.abs().max()))


@pytest.mark.parametrize("case", ["stick", "slide", "take-off", "off"])
def test_obstacle_jacobian(case):
    normal = torch.tensor([0.0, 0.6, 0.8], dtype=F64)
    tangent = torch.tensor([1.0, 0.0, 0.0], dtype=F64)
    mu = torch.tensor(0.5, dtype=F64)
    sd, tn, on = {"stick": (-1.0, 0.3, True), "slide": (-1.0, 0.9, True),
                  "take-off": (0.4, 0.9, True),
                  "off": (-1.0, 0.9, False)}[case]
    d = sd * normal + tn * tangent

    def fn(dd):
        r = ct.dry_friction_force(normal, dd, mu)
        return torch.where(torch.tensor(on), r, 0.0)

    want = jacobian(fn, d)
    got = al.obstacle_jacobian_plain(d, normal, mu, torch.tensor(on))
    assert torch.allclose(got, want, rtol=0, atol=1e-12)
