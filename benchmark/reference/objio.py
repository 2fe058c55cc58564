"""OBJ / txt mesh IO (host-side NumPy).

Parity with reference MeshFileHandler (`loadOBJFile`, `loadPosFile_txt`,
per-frame OBJ export used by `exportSimulation`, Simulation.cpp:4195-4239).

The port's own copy of `diffcloth_tpu/geometry/objio.py`, NumPy only
(the JAX package's optional native fast path is not carried over).
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load vertices (V,3) float64 and triangle indices (T,3) int32.

    Handles 'v x y z' and 'f a b c' (1-based, with optional /vt/vn suffixes).
    Quads are fan-triangulated.
    """
    verts: List[Tuple[float, float, float]] = []
    tris: List[Tuple[int, int, int]] = []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                parts = line.split()[1:]
                idx = [int(p.split("/")[0]) - 1 for p in parts]
                for k in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))
    return (np.asarray(verts, dtype=np.float64),
            np.asarray(tris, dtype=np.int32))


def load_pos_txt(path: str) -> np.ndarray:
    """Load a whitespace-separated position file: one 'x y z' per line.

    reference: MeshFileHandler::loadPosFile_txt.
    """
    data = np.loadtxt(path, dtype=np.float64)
    return data.reshape(-1, 3)


def save_obj(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    """Write an OBJ frame (used for trajectory export / offline viewing)."""
    verts = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    lines = []
    for v in verts:
        lines.append(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}")
    for t in tris:
        lines.append(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def export_frames(folder: str, xs: np.ndarray, tris: np.ndarray,
                  prefix: str = "") -> None:
    """Export a trajectory (N,n,3) as numbered OBJ frames for offline viewing.

    Parity with exportSimulation's per-frame clothXXX.obj output
    (Simulation.cpp:4195-4239)."""
    os.makedirs(folder, exist_ok=True)
    for i, x in enumerate(xs):
        save_obj(os.path.join(folder, f"{prefix}cloth{i}.obj"), x, tris)


def import_frames(folder: str, prefix: str = "cloth") -> np.ndarray:
    """Re-import a folder of exported OBJ frames (sorted by frame number).

    Parity with resetForwardRecordsFromFolder (Simulation.h:574-620)."""
    files = [f for f in os.listdir(folder)
             if f.startswith(prefix) and f.endswith(".obj")]
    files.sort(key=lambda f: int("".join(c for c in f if c.isdigit()) or 0))
    frames = [load_obj(os.path.join(folder, f))[0] for f in files]
    return np.stack(frames, axis=0)
