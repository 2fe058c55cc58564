"""Port parity for the native mesh IO and scene preprocessing
(`diffcloth_tpu_torch/native/fastobj.py`, built with g++ from the port's
own `native/diffcloth_native.cpp` at first use): the OBJ round trip, and
`extract_bending_pairs` / `conn_table` equal to the port's NumPy scene
builder and to the JAX package's `diffcloth_tpu.native.fastobj` on the
same grid.  Exact, but for positions read back from the files' 8
decimals (within 5e-9)."""
import numpy as np
import pytest

from diffcloth_tpu.native import fastobj as jfast
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.geometry import objio
from diffcloth_tpu_torch.native import fastobj


@pytest.fixture(scope="module")
def grid():
    fab = tc.FabricConfig(cloth_dim_x=3, cloth_dim_y=2, grid_num_x=9,
                          grid_num_y=7)
    verts, tris = gb.build_grid_mesh(fab)
    return np.asarray(verts, np.float64), np.asarray(tris, np.int32)


def test_obj_round_trip(grid, tmp_path):
    verts, tris = grid
    path = str(tmp_path / "grid.obj")
    fastobj.save_obj(path, verts, tris)
    v, t = fastobj.load_obj(path)
    assert v.dtype == np.float64 and t.dtype == np.int32
    np.testing.assert_array_equal(t, tris)
    np.testing.assert_allclose(v, verts, rtol=0, atol=5e-9)
    # the same file through the NumPy reader and the JAX package's reader
    v2, t2 = objio.load_obj(path)
    np.testing.assert_array_equal(v2, v)
    np.testing.assert_array_equal(t2, t)
    vj, tj = jfast.load_obj(path)
    np.testing.assert_array_equal(vj, v)
    np.testing.assert_array_equal(tj, t)
    # and a file the NumPy writer wrote reads back the same
    objio.save_obj(str(tmp_path / "np.obj"), verts, tris)
    assert (tmp_path / "np.obj").read_text() == (tmp_path /
                                                 "grid.obj").read_text()


def test_quads_fan_triangulate(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1/1 2/2/2 "
                    "3/3/3 4/4/4\n")
    v, t = fastobj.load_obj(str(path))
    assert v.shape == (4, 3)
    np.testing.assert_array_equal(t, [[0, 1, 2], [0, 2, 3]])
    np.testing.assert_array_equal(objio.load_obj(str(path))[1], t)


def test_bending_pairs_and_conn_table_match(grid):
    verts, tris = grid
    n = verts.shape[0]
    quads = fastobj.extract_bending_pairs(tris)
    assert quads.shape[1] == 4 and len(quads) > 0
    np.testing.assert_array_equal(quads, gb.extract_bending_pairs(tris))
    np.testing.assert_array_equal(quads, jfast.extract_bending_pairs(tris))
    table = fastobj.conn_table(tris, n)
    np.testing.assert_array_equal(table, gb.adjacency_exclusion(n, tris))
    np.testing.assert_array_equal(table, jfast.conn_table(tris, n))


def test_bad_meshes_raise(grid):
    _, tris = grid
    fan = np.array([[0, 1, 2], [0, 1, 3], [0, 1, 4]])   # edge 0-1 thrice
    with pytest.raises(ValueError, match="non-manifold"):
        fastobj.extract_bending_pairs(fan)
    with pytest.raises(ValueError, match="outside"):
        fastobj.conn_table(tris, int(tris.max()))
    with pytest.raises(ValueError, match="outside"):
        fastobj.conn_table(-tris, int(tris.max()) + 1)
