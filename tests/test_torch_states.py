"""`geometry.states.folded_grid` on grids in a z = const plane (the
flagship stand-in, FRONT) and a y = const plane (the sphere scene, DOWN):
the unfolded rows stay at rest and folded row hinge + k covers row
hinge - 1 - k, `gap` off the cloth along the normal's positive axis.
Tolerance 1e-12: the DOWN grid's rotation leaves rounding of 1e-16 in its
plane coordinate."""
import dataclasses

import numpy as np
import pytest

from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.geometry import states
from diffcloth_tpu_torch.tasks import registry

G = 6


@pytest.mark.parametrize("cfg_name, axis", [
    ("TSHIRT_GRID_STANDIN", 2), ("ROTATING_SPHERE_SCENE", 1)])
@pytest.mark.parametrize("gap", [0.3, -0.2])
def test_folded_grid_covers_rows(cfg_name, axis, gap):
    cfg = getattr(registry, cfg_name)
    cfg = dataclasses.replace(cfg, fabric=dataclasses.replace(
        cfg.fabric, grid_num_x=G, grid_num_y=G))
    scene = gb.build_scene(cfg)
    rows = G // 2
    x_rest = np.asarray(scene.x_rest, np.float64).reshape(G, G, 3)
    x = states.folded_grid(scene, rows, gap).reshape(G, G, 3)
    np.testing.assert_array_equal(x[:G - rows], x_rest[:G - rows])
    covered = x_rest[G - rows - 1::-1][:rows].copy()
    covered[..., axis] += gap
    np.testing.assert_allclose(x[G - rows:], covered, rtol=0, atol=1e-12)


def test_folded_grid_rejects_bad_rows():
    scene = gb.build_scene(dataclasses.replace(
        registry.ROTATING_SPHERE_SCENE, fabric=dataclasses.replace(
            registry.SPHERE_FABRIC, grid_num_x=G, grid_num_y=G)))
    for rows in (0, G):
        with pytest.raises(ValueError):
            states.folded_grid(scene, rows, 0.1)
