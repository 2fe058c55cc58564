"""The port's ClothSim picks its large-mesh algorithms where the JAX
package's does (diffcloth_tpu/core/sim.py:183-300): the CG solve past
n = 8000, the sparse operators once the dense ones would pass 300 MB, the
sweep detection past n = 10000.  Both packages build the same grid scenes
(the flagship stand-in's physics): 48 x 48 (n = 2304, just past the
operator gate: sparse operators, dense P^{-1}, kernel detection) and
101 x 100 (n = 10 100, past all three switches).  Only the sims are built
(no step runs), in f32 as the card runs them.  Each choice must agree
exactly; the Jacobi diagonal of the cg path must equal the JAX package's
bit for bit (the same f64 host arithmetic, cast to f32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcloth_tpu import config as jc
from diffcloth_tpu.core.sim import ClothSim as JaxSim
from diffcloth_tpu.geometry import builder as jgb
from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch.convert import sim_params_from_numpy
from diffcloth_tpu_torch.core import sim as tsim_mod
from diffcloth_tpu_torch.core.sim import ClothSim as TorchSim
from diffcloth_tpu_torch.geometry import builder as tgb

# the JAX package's method names as the port calls them
METHOD = {"matrix": "kernel", "pallas": "kernel", "sweep": "sweep"}


def grid_cfg(m, nx, ny):
    return m.SceneConfig(
        fabric=m.FabricConfig(cloth_dim_x=6, cloth_dim_y=6,
                              k_stiff_stretching=550, k_stiff_bending=0.01,
                              grid_num_x=nx, grid_num_y=ny, density=0.124),
        attachment_points=m.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=m.WindConfig.WIND_SIN, time_step=1.0 / 90.0,
        step_num=3, name="size_switch")


@pytest.mark.parametrize("grid,expect", [
    ((48, 48), ("dense", False, "kernel")),
    ((101, 100), ("cg", False, "sweep"))], ids=["48x48", "101x100"])
def test_size_switches_match_jax(grid, expect):
    jscene = jgb.build_scene(grid_cfg(jc, *grid))
    tscene = tgb.build_scene(grid_cfg(tc, *grid))
    jsim = JaxSim(jscene, dtype=jnp.float32)
    tsim = TorchSim(tscene, device="cpu", dtype=torch.float32)
    got = (tsim.solve_mode, tsim.dense is not None, tsim.self_cfg.method)
    want = (jsim.solve_mode, jsim.dense is not None,
            METHOD[jsim.self_cfg.method])
    assert got == want == expect
    assert (tsim.sparse is not None) == (jsim.sparse is not None) is True
    if tsim.self_cfg.method == "sweep":
        assert tsim.self_cfg.window == jsim.self_cfg.window == 48
        assert tsim.self_cfg.cap_pairs == jsim.self_cfg.cap_pairs == 5050
        assert tuple(tsim.self_cfg.allowed.shape) == (tsim.n, tsim.n)
    if tsim.solve_mode == "cg":
        p = jsim.default_params()
        tp = sim_params_from_numpy(
            {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
        d = tsim.p_inv(tp)
        assert tuple(d.shape) == (tsim.n,)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jsim.p_inv(p)))


def test_operator_gate_sits_between_46_and_48():
    """The dense operators' bytes (the JAX package's formula) pass 300 MB
    between the 46 x 46 and 48 x 48 grids; explicit flags override the
    gate as there (sparse_ops=True wins over dense_ops)."""
    small = tgb.build_scene(grid_cfg(tc, 46, 46))
    large = tgb.build_scene(grid_cfg(tc, 48, 48))
    gate = tsim_mod.DENSE_OPS_MAX_BYTES
    assert tsim_mod.dense_ops_bytes(small) <= gate
    assert tsim_mod.dense_ops_bytes(large) > gate
    tiny = tgb.build_scene(grid_cfg(tc, 5, 5))
    sim = TorchSim(tiny, device="cpu", dense_ops=True, sparse_ops=True)
    assert sim.dense is None and sim.sparse is not None
    with pytest.raises(NotImplementedError, match="gather/scatter"):
        TorchSim(tiny, device="cpu", dense_ops=False, sparse_ops=False)
    with pytest.raises(ValueError, match="solve_mode"):
        TorchSim(tiny, device="cpu", solve_mode="direct")
