"""Initial states with self-contact for grid scenes.

A grid cloth at rest touches nothing, so the self-collision path only
works once the cloth folds.  `folded_grid` starts it folded: the last
`rows` rows of the grid mirrored back about the line between rows
gy - rows - 1 and gy - rows, lying `gap` off the cloth plane along its
normal.  With gap < 2r every folded vertex (but the first folded row, which
is mesh-adjacent to the row it covers) starts in contact with the vertex it
covers.
"""
from __future__ import annotations

import numpy as np

from diffcloth_tpu_torch.geometry import builder as gb


def folded_grid(scene: gb.Scene, rows: int, gap: float) -> np.ndarray:
    """(n, 3) positions of a flat grid scene with its last `rows` rows
    folded back over the others at distance `gap` along the cloth's normal,
    the normal's largest component taken positive (+z for a cloth in a
    z = const plane, +y for one in a y = const plane)."""
    fab = scene.cfg.fabric
    gy, gx = fab.grid_num_y, fab.grid_num_x
    if fab.is_model or scene.n != gx * gy or not 0 < rows < gy:
        raise ValueError("folded_grid needs a grid scene and 0 < rows < gy")
    x = np.array(scene.x_rest, np.float64).reshape(gy, gx, 3)
    normal = np.cross(x[0, 1] - x[0, 0], x[1, 0] - x[0, 0])
    normal = normal / np.linalg.norm(normal)
    normal = normal * np.sign(normal[np.argmax(np.abs(normal))])
    hinge = gy - rows     # first folded row
    mid = 0.5 * (x[hinge - 1] + x[hinge])    # (gx, 3) the fold line
    x[hinge:] = 2.0 * mid - x[hinge:] + gap * normal
    return x.reshape(-1, 3)
