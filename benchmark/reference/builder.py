"""Host-side scene construction: meshes, constraint topology, A-operator rows.

The port's own copy of `diffcloth_tpu/geometry/builder.py` (numpy only,
without the optional native fast path), so both packages build the very
same `Scene` from one config.  Mirrors the reference scene construction
(`Simulation::createClothMesh{,FromConfig,FromModel}` Simulation.cpp:2557-2757,
`createBendingConstraints` :2096, `createAttachments` :2258,
`updateAreaMatrix`/`updateMassMatrix` :2894-2966, `updateCollisionRadii` :2407).

Everything here is plain NumPy executed once at scene-build time.  The output
is a `MeshTopology`: flat index/coefficient tensors describing the PD
constraint operator A as fixed-arity gather/scatter rows, grouped by
constraint type.  Because every constraint type's weighted rows are
sqrt(k_type) * (weightless rows), the global system matrix is

    P = density * diag(area) + h^2 * sum_t k_t * (A0_t^T A0_t)

with A0_t the *weightless* per-type operator — k and density enter linearly,
which is what makes all stiffness/density gradients flow through the
operator-form residual on device.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.reference.config import (AttachmentConfig, FabricConfig,
                                        Orientation, SceneConfig,
                                        TrajectoryConfig)
from benchmark.reference import objio

# Where reference mesh assets live (read-only): DIFFCLOTH_ASSET_ROOT, else
# `assets/meshes` beside the package.  Garment scenes need the asset; the
# grid scenes (and the flagship stand-in) build without it.
ASSET_ROOT = os.environ.get(
    "DIFFCLOTH_ASSET_ROOT",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "assets", "meshes"))


# ---------------------------------------------------------------------------
# small rotation helpers (reference: engine/UtilityFunctions.h:77-87)

def axis_to_rotation(final_dir: np.ndarray, initial_dir: np.ndarray) -> np.ndarray:
    """Rotation matrix mapping initial_dir onto final_dir (shortest arc)."""
    f = np.asarray(final_dir, dtype=np.float64)
    i = np.asarray(initial_dir, dtype=np.float64)
    f = f / np.linalg.norm(f)
    i = i / np.linalg.norm(i)
    if np.linalg.norm(f - i) <= 1e-5:
        return np.eye(3)
    perp = np.cross(i, f)
    angle = np.arccos(np.clip(np.dot(f, i), -1.0, 1.0))
    axis = perp / np.linalg.norm(perp)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def rotate_points_around_min_corner(pts: np.ndarray, rot: np.ndarray) -> np.ndarray:
    """reference: Simulation::rotatePointsAroundCenter (Simulation.cpp:2152)."""
    lo = pts.min(axis=0)
    return (pts - lo) @ rot.T


def orientation_rotation(cfg: SceneConfig) -> Optional[np.ndarray]:
    """reference: rotatePointsAccordingToConfig (Simulation.h:640-671)."""
    if cfg.orientation == Orientation.FRONT:
        return None
    if cfg.orientation == Orientation.DOWN:
        return axis_to_rotation(np.array([0.0, 1.0, 0.0]),
                                np.array([0.0, 0.0, 1.0]))
    if cfg.orientation == Orientation.BACK:
        r1 = axis_to_rotation(np.array([0.0, 0.0, 1.0]), np.array([1.0, 0.0, 0.0]))
        r2 = axis_to_rotation(np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, -1.0]))
        return r1 @ r2
    if cfg.orientation == Orientation.CUSTOM_ORIENTATION:
        return axis_to_rotation(np.asarray(cfg.up_vector, dtype=np.float64),
                                np.array([0.0, 1.0, 0.0]))
    return None


# ---------------------------------------------------------------------------
# mesh generation / loading

def grid_init_pos(fab: FabricConfig, i: int, j: int) -> np.ndarray:
    """reference: Simulation::getInitParticlePos (Simulation.cpp:1783-1791)."""
    gsx = fab.cloth_dim_x / (fab.grid_num_x - 1)
    gsy = fab.cloth_dim_y / (fab.grid_num_y - 1)
    origin = np.array([-(fab.grid_num_y - 1) / 4.0 * gsy, 15.0, 0.0])
    return np.array([j * gsy, -i * gsx, 0.0]) + origin


def build_grid_mesh(fab: FabricConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Regular grid cloth (reference: createClothMeshFromConfig,
    Simulation.cpp:2611-2757).  Returns raw (uncentered) positions and tris.

    Particle index = i * grid_num_x + j (gridIndicesToParticle, :1794).
    Triangle creation order/winding matches the reference: createTriangle(a,b,c)
    constructs Triangle(c, b, a) (:2628-2632, :2730-2731).
    """
    gy, gx = fab.grid_num_y, fab.grid_num_x
    pts = np.stack([grid_init_pos(fab, i, j)
                    for i in range(gy) for j in range(gx)], axis=0)

    def pid(a: int, b: int) -> int:
        if a < 0 or b < 0 or a >= gy or b >= gx:
            return -1
        return a * gx + b

    tris: List[Tuple[int, int, int]] = []

    def create(a: int, b: int, c: int) -> None:
        if a < 0 or b < 0 or c < 0:
            return
        tris.append((c, b, a))  # reference reverses: mesh.emplace_back(c, b, a)

    for i in range(gy):
        for j in range(gx):
            this_i = pid(i, j)
            left = pid(i, j - 1)
            up = pid(i - 1, j)
            up_right = pid(i - 1, j + 1)
            create(this_i, up, up_right)
            create(up, this_i, left)
    return pts, np.asarray(tris, dtype=np.int32)


def normalize_model_points(pts: np.ndarray, cfg: SceneConfig
                           ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Rotation + scale-normalization of a loaded garment
    (reference: createClothMeshFromModel, Simulation.cpp:2170-2226)."""
    fab = cfg.fabric
    rot = orientation_rotation(cfg)
    if rot is not None:
        pts = rotate_points_around_min_corner(pts, rot)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    dim = hi - lo
    if fab.keep_original_scale_point:
        scale = 1.0
        rest_max, rest_min = hi.copy(), lo.copy()
        translation = np.zeros(3)
        out = pts.copy()
    else:
        scale = dim.max() / fab.cloth_dim_x
        rest_max = dim / scale
        rest_min = np.zeros(3)
        translation = rest_max / 2.0
        rest_min = rest_min - translation
        rest_max = rest_max - translation
        # centers the mesh at the origin (Simulation.cpp:2208-2220)
        out = (pts - lo) / scale - (dim / scale) / 2.0
    meta = {"rest_min": rest_min, "rest_max": rest_max,
            "scale": np.array(scale), "lo": lo}
    return out, meta


def normalize_grid_points(pts: np.ndarray, cfg: SceneConfig
                          ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Centering for generated grids (reference: Simulation.cpp:2675-2707)."""
    fab = cfg.fabric
    rot = orientation_rotation(cfg)
    if rot is not None:
        pts = rotate_points_around_min_corner(pts, rot)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    dim = hi - lo
    if not fab.keep_original_scale_point:
        out = pts - lo - dim / 2.0
        rest_min = -dim / 2.0
        rest_max = dim / 2.0
    else:
        out = pts.copy()
        rest_min = np.zeros(3)
        rest_max = dim
    mid = 0.5 * (hi + lo)  # reference uses raw-space midpoint (:2707)
    meta = {"rest_min": rest_min, "rest_max": rest_max,
            "scale": np.array(1.0), "lo": lo, "mid_raw": mid}
    return out, meta


# ---------------------------------------------------------------------------
# constraint topology

@dataclasses.dataclass
class TriangleElems:
    """Per-triangle rest-state data (reference: Triangle ctor, Triangle.cpp:587-645)."""
    idx: np.ndarray        # (T,3) int32
    inv_duv: np.ndarray    # (T,2,2)
    area: np.ndarray       # (T,)


def build_triangle_elems(x_rest: np.ndarray, tris: np.ndarray) -> TriangleElems:
    p0 = x_rest[tris[:, 0]]
    p1 = x_rest[tris[:, 1]]
    p2 = x_rest[tris[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    # orthonormal 2D material frame (Triangle.cpp:623-630)
    b0 = e1 / np.linalg.norm(e1, axis=1, keepdims=True)
    e2p = e2 - (e2 * b0).sum(axis=1, keepdims=True) * b0
    b1 = e2p / np.linalg.norm(e2p, axis=1, keepdims=True)
    duv = np.stack([
        np.stack([(e1 * b0).sum(1), (e2 * b0).sum(1)], axis=-1),
        np.stack([(e1 * b1).sum(1), (e2 * b1).sum(1)], axis=-1)], axis=1)  # (T,2,2)
    det = duv[:, 0, 0] * duv[:, 1, 1] - duv[:, 0, 1] * duv[:, 1, 0]
    inv = np.empty_like(duv)
    inv[:, 0, 0] = duv[:, 1, 1]
    inv[:, 0, 1] = -duv[:, 0, 1]
    inv[:, 1, 0] = -duv[:, 1, 0]
    inv[:, 1, 1] = duv[:, 0, 0]
    inv = inv / det[:, None, None]
    area = np.abs(det) * 0.5
    return TriangleElems(idx=tris.astype(np.int32), inv_duv=inv, area=area)


@dataclasses.dataclass
class BendingElems:
    """Cotan-weighted hinge bending (reference: TriangleBending ctor,
    TriangleBending.cpp:186-239). idx = (edge_v0, edge_v1, wing0, wing1)."""
    idx: np.ndarray       # (B,4) int32
    w_vert: np.ndarray    # (B,4) cotan vertex weights
    n_rest: np.ndarray    # (B,) rest-state |sum w_i x_i|
    area_sum: np.ndarray  # (B,) A0 + A1


@dataclasses.dataclass
class SpringElems:
    """Length springs on mesh edges (reference: Spring.{h,cpp} — deprecated
    there in favor of Triangle but kept for capability parity; unlike the
    reference, the per-type stiffness k_pertype[0] stays differentiable)."""
    idx: np.ndarray    # (S,2) int32
    l0: np.ndarray     # (S,) rest lengths


def build_spring_elems(x_rest: np.ndarray, tris: np.ndarray) -> SpringElems:
    """One spring per unique mesh edge."""
    if len(tris) == 0:
        return SpringElems(np.zeros((0, 2), np.int32), np.zeros((0,)))
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    e = np.unique(np.sort(e, axis=1), axis=0).astype(np.int32)
    l0 = np.linalg.norm(x_rest[e[:, 0]] - x_rest[e[:, 1]], axis=1)
    return SpringElems(idx=e, l0=l0)


def spring_rows(sp: SpringElems) -> "ARows":
    """1 row per spring, weightless weights (+1, -1)
    (Spring::addConstraint, Spring.cpp:126-141)."""
    S = len(sp.l0)
    if S == 0:
        return ARows(np.zeros((0, 2), np.int32), np.zeros((0, 2)))
    w = np.tile(np.array([1.0, -1.0]), (S, 1))
    return ARows(sp.idx, w)


def extract_bending_pairs(tris: np.ndarray) -> np.ndarray:
    """Shared-edge extraction (reference: createBendingConstraints,
    Simulation.cpp:2096-2131).  Returns (B,4) with [vmin, vmax, other0, other1];
    iteration order matches std::map's sorted (vmin,vmax) key order, opposite
    vertices in triangle-encounter order."""
    edge_map: Dict[Tuple[int, int], List[int]] = {}
    for t in tris:
        for a in range(3):
            for b in range(a + 1, 3):
                v1, v2 = int(t[a]), int(t[b])
                other = int(t[3 - a - b])
                key = (min(v1, v2), max(v1, v2))
                edge_map.setdefault(key, []).append(other)
    quads = []
    for key in sorted(edge_map.keys()):
        others = edge_map[key]
        if len(others) == 2:
            quads.append((key[0], key[1], others[0], others[1]))
        elif len(others) > 2:
            raise ValueError("non-manifold edge %s" % (key,))
    return np.asarray(quads, dtype=np.int32).reshape(-1, 4)


def build_bending_elems(x_rest: np.ndarray, quads: np.ndarray) -> BendingElems:
    if quads.size == 0:
        return BendingElems(idx=np.zeros((0, 4), np.int32),
                            w_vert=np.zeros((0, 4)),
                            n_rest=np.zeros((0,)),
                            area_sum=np.zeros((0,)))
    pos = x_rest[quads]                     # (B,4,3)
    l01 = np.linalg.norm(pos[:, 1] - pos[:, 0], axis=1)
    l02 = np.linalg.norm(pos[:, 2] - pos[:, 0], axis=1)
    l03 = np.linalg.norm(pos[:, 3] - pos[:, 0], axis=1)
    l12 = np.linalg.norm(pos[:, 1] - pos[:, 2], axis=1)
    l13 = np.linalg.norm(pos[:, 1] - pos[:, 3], axis=1)
    r0 = 0.5 * (l01 + l02 + l12)
    A0 = np.sqrt(np.maximum(r0 * (r0 - l01) * (r0 - l02) * (r0 - l12), 0.0))
    r1 = 0.5 * (l01 + l13 + l03)
    A1 = np.sqrt(np.maximum(r1 * (r1 - l01) * (r1 - l03) * (r1 - l13), 0.0))
    cot02 = (l01 ** 2 - l02 ** 2 + l12 ** 2) / (4.0 * A0)
    cot12 = (l01 ** 2 + l02 ** 2 - l12 ** 2) / (4.0 * A0)
    cot03 = (l01 ** 2 - l03 ** 2 + l13 ** 2) / (4.0 * A1)
    cot13 = (l01 ** 2 + l03 ** 2 - l13 ** 2) / (4.0 * A1)
    w = np.stack([cot02 + cot03, cot12 + cot13,
                  -(cot02 + cot12), -(cot03 + cot13)], axis=-1)  # (B,4)
    n_rest = np.linalg.norm((pos * w[:, :, None]).sum(axis=1), axis=1)
    return BendingElems(idx=quads.astype(np.int32), w_vert=w,
                        n_rest=n_rest, area_sum=A0 + A1)


# ---------------------------------------------------------------------------
# attachments

@dataclasses.dataclass
class AttachmentStage:
    """One attachment configuration epoch (one `sysMat` in the reference,
    Simulation.h:361-405). start_frame selects the active stage per step."""
    start_frame: int
    particle_idx: np.ndarray      # (F,) int32 cloth vertices that are clipped
    fixed_pos_rest: np.ndarray    # (F,3) rest positions of the clips
    spline_p0: np.ndarray         # (F,3) spline start points
    spline_p1: np.ndarray         # (F,3) default end points
    spline_yup: np.ndarray        # (F,)


def _nearest_particle(x_rest: np.ndarray, goal: np.ndarray) -> int:
    """Strict-improvement scan starting at particle 0 (createAttachments,
    Simulation.cpp:2278-2285)."""
    d = np.linalg.norm(x_rest - goal[None, :], axis=1)
    best = 0
    for i in range(len(d)):
        if d[i] < d[best]:
            best = i
    return best


def build_attachments(cfg: SceneConfig, x_rest: np.ndarray,
                      rest_min: np.ndarray, rest_max: np.ndarray,
                      fab_raw_grid_endpoints: Optional[Tuple[np.ndarray, np.ndarray]],
                      is_model: bool) -> List[AttachmentStage]:
    """reference: createAttachments (Simulation.cpp:2258-2405)."""
    stages: List[AttachmentStage] = []
    if cfg.attachment_points == AttachmentConfig.NO_ATTACHMENTS:
        return [AttachmentStage(0, np.zeros((0,), np.int32), np.zeros((0, 3)),
                                np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,)))]
    if cfg.attachment_points == AttachmentConfig.LEFT_RIGHT_CORNERS_2:
        if is_model:
            midz = 0.5 * (rest_min[2] + rest_max[2])
            goals = [np.array([rest_min[0], rest_max[1], midz]),
                     np.array([rest_max[0], rest_max[1], midz])]
            pidx = np.array([_nearest_particle(x_rest, g) for g in goals],
                            dtype=np.int32)
            fixed = x_rest[pidx]
            stages.append(AttachmentStage(
                0, pidx, fixed.copy(), fixed.copy(), fixed.copy(),
                np.full((len(pidx),), 10.0)))
        else:
            gx = cfg.fabric.grid_num_x
            pidx = np.array([0, gx - 1], dtype=np.int32)
            fixed = x_rest[pidx]
            p1 = fixed.copy()
            yup = np.full((2,), 8.0)
            if cfg.trajectory == TrajectoryConfig.CORNERS_2_UP and \
                    fab_raw_grid_endpoints is not None:
                # reference quirk: endpoints use *raw* (uncentered) grid coords
                # (Simulation.cpp:2343-2354)
                p1 = np.stack(fab_raw_grid_endpoints, axis=0)
            stages.append(AttachmentStage(0, pidx, fixed.copy(), fixed.copy(),
                                          p1, yup))
    elif cfg.attachment_points == AttachmentConfig.CUSTOM_ARRAY:
        for frac, verts in cfg.custom_attachment_vertex_idx:
            pidx = np.asarray(verts, dtype=np.int32)
            fixed = x_rest[pidx]
            stages.append(AttachmentStage(
                int(frac * cfg.step_num), pidx, fixed.copy(), fixed.copy(),
                fixed.copy(), np.full((len(pidx),), 10.0)))
    return stages


# ---------------------------------------------------------------------------
# A-operator rows (weightless; sqrt(k_type) applied on device)

@dataclasses.dataclass
class ARows:
    """Fixed-arity gather/scatter representation of one constraint type's
    weightless operator A0: row r computes sum_s w[r,s] * x[idx[r,s]]."""
    idx: np.ndarray   # (R, K) int32
    w: np.ndarray     # (R, K) float64


def stretch_rows(tri: TriangleElems) -> ARows:
    """2 rows per triangle — one per deformation-gradient column
    (reference: Triangle::addConstraint, Triangle.cpp:287-308).
    weightless weight = sqrt(area_rest)."""
    T = len(tri.area)
    if T == 0:
        return ARows(np.zeros((0, 3), np.int32), np.zeros((0, 3)))
    sw = np.sqrt(tri.area)[:, None]                     # (T,1)
    u = tri.inv_duv                                     # (T,2,2)
    rows_idx = np.repeat(tri.idx[:, None, :], 2, axis=1).reshape(2 * T, 3)
    # column i of F: coeffs (-(u00+u10), u00, u10) for i=0 etc.
    w = np.stack([
        np.stack([-(u[:, 0, 0] + u[:, 1, 0]), u[:, 0, 0], u[:, 1, 0]], axis=-1),
        np.stack([-(u[:, 0, 1] + u[:, 1, 1]), u[:, 0, 1], u[:, 1, 1]], axis=-1),
    ], axis=1) * sw[:, :, None]                         # (T,2,3)
    return ARows(rows_idx.astype(np.int32), w.reshape(2 * T, 3))


def bend_rows(bend: BendingElems) -> ARows:
    """1 row per hinge (reference: TriangleBending::addConstraint,
    TriangleBending.cpp:11-27). weightless weight = sqrt(3/(A0+A1))."""
    B = len(bend.n_rest)
    if B == 0:
        return ARows(np.zeros((0, 4), np.int32), np.zeros((0, 4)))
    sw = np.sqrt(3.0 / bend.area_sum)[:, None]
    return ARows(bend.idx, bend.w_vert * sw)


def attach_rows(stage: AttachmentStage) -> ARows:
    """1 row per clipped vertex (reference: AttachmentSpring::addConstraint);
    weightless weight = 1."""
    F = len(stage.particle_idx)
    return ARows(stage.particle_idx.reshape(F, 1).astype(np.int32),
                 np.ones((F, 1)))


def rows_to_dense_ata(rows: ARows, n: int) -> np.ndarray:
    """Dense (n,n) A0^T A0 on host for prefactorization."""
    R, K = rows.idx.shape
    S = np.zeros((n, n))
    if R == 0:
        return S
    for s1 in range(K):
        for s2 in range(K):
            np.add.at(S, (rows.idx[:, s1], rows.idx[:, s2]),
                      rows.w[:, s1] * rows.w[:, s2])
    return S


def rows_to_ata_diag(rows: ARows, n: int) -> np.ndarray:
    """diag(A0^T A0) only — O(n) memory, for the matrix-free CG solve path
    (the dense (n,n) Gram stack at >~10k vertices costs GBs of host RAM
    for data the Jacobi preconditioner never reads)."""
    d = np.zeros((n,))
    if rows.idx.shape[0]:
        np.add.at(d, rows.idx, rows.w * rows.w)
    return d


# ---------------------------------------------------------------------------
# lumped areas / collision radii

def lumped_areas(n: int, tri: TriangleElems) -> np.ndarray:
    """reference: updateAreaMatrix (Simulation.cpp:2894-2929)."""
    area = np.zeros((n,))
    for k in range(3):
        np.add.at(area, tri.idx[:, k], tri.area / 3.0)
    return area


def collision_radii(n: int, x_rest: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """radius = (min incident edge)/2 - 0.01
    (reference: updateCollisionRadii, Simulation.cpp:2407-2431)."""
    min_edge = np.full((n,), 100.0)
    for (a, b, c) in tris:
        for (u, v) in ((a, b), (b, c), (c, a)):
            d = np.linalg.norm(x_rest[u] - x_rest[v])
            min_edge[u] = min(min_edge[u], d)
            min_edge[v] = min(min_edge[v], d)
    return min_edge / 2.0 - 0.01


def adjacency_exclusion(n: int, tris: np.ndarray) -> np.ndarray:
    """Boolean (n,n) table of mesh-adjacent pairs excluded from self-collision
    (reference: pointpointConnectionTable, Simulation.cpp:2228-2240)."""
    conn = np.zeros((n, n), dtype=bool)
    np.fill_diagonal(conn, True)
    if len(tris):
        t = np.asarray(tris, np.int64)
        conn[t[:, :, None], t[:, None, :]] = True
    return conn


# ---------------------------------------------------------------------------
# the full host-side scene

@dataclasses.dataclass
class Scene:
    cfg: SceneConfig
    x_rest: np.ndarray            # (n,3) normalized rest positions
    v_init: np.ndarray            # (n,3)
    tris: np.ndarray              # (T,3)
    triangle: TriangleElems
    bending: BendingElems
    stages: List[AttachmentStage]
    area: np.ndarray              # (n,) lumped areas
    radii: np.ndarray             # (n,)
    rest_min: np.ndarray
    rest_max: np.ndarray
    rest_mid: np.ndarray
    conn_table: np.ndarray        # (n,n) bool adjacency exclusion
    springs: "SpringElems" = dataclasses.field(
        default_factory=lambda: SpringElems(np.zeros((0, 2), np.int32),
                                            np.zeros((0,))))

    @property
    def n(self) -> int:
        return len(self.x_rest)

    @property
    def n_fixed(self) -> int:
        return len(self.stages[0].particle_idx)


def build_scene(cfg: SceneConfig) -> Scene:
    fab = cfg.fabric
    raw_grid_endpoints = None
    if fab.is_model:
        path = fab.name if os.path.isabs(fab.name) else os.path.join(
            ASSET_ROOT, fab.name)
        pts, tris = objio.load_obj(path)
        if fab.custom_init_pos and fab.init_pos_file:
            pts = objio.load_pos_txt(os.path.join(ASSET_ROOT, fab.init_pos_file))
        x_rest, meta = normalize_model_points(pts, cfg)
        is_model = True
    else:
        pts, tris = build_grid_mesh(fab)
        if fab.custom_init_pos and fab.init_pos_file:
            pts = objio.load_pos_txt(os.path.join(ASSET_ROOT, fab.init_pos_file))
        x_rest, meta = normalize_grid_points(pts, cfg)
        raw_grid_endpoints = (grid_init_pos(fab, fab.grid_num_y - 1, 0),
                              grid_init_pos(fab, fab.grid_num_y - 1,
                                            fab.grid_num_x - 1))
        is_model = False

    tri = build_triangle_elems(x_rest, tris)
    quads = extract_bending_pairs(tris)
    bend = build_bending_elems(x_rest, quads)
    springs = (build_spring_elems(x_rest, tris)
               if getattr(fab, "use_spring_constraints", False)
               else SpringElems(np.zeros((0, 2), np.int32), np.zeros((0,))))
    stages = build_attachments(cfg, x_rest, meta["rest_min"], meta["rest_max"],
                               raw_grid_endpoints, is_model)
    n = len(x_rest)
    area = lumped_areas(n, tri)
    radii = collision_radii(n, x_rest, tris)
    conn = adjacency_exclusion(n, tris)
    rest_mid = 0.5 * (meta["rest_min"] + meta["rest_max"])
    return Scene(cfg=cfg, x_rest=x_rest, v_init=np.zeros_like(x_rest),
                 tris=tris, triangle=tri, bending=bend, stages=stages,
                 area=area, radii=radii,
                 rest_min=meta["rest_min"], rest_max=meta["rest_max"],
                 rest_mid=rest_mid, conn_table=conn, springs=springs)
