"""Every public function of the port that takes a `device` puts its tensors
on the card unless the caller asks for the CPU: without a card it raises
(asking for device='cpu'), and with device="cpu" it runs on the CPU.  The
card's absence is simulated by patching `torch.cuda.is_available`, so these
tests mean the same with and without one."""
import numpy as np
import pytest
import torch

from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch import convert
from diffcloth_tpu_torch.apps import hat_controller
from diffcloth_tpu_torch.core import (contact, dense_ops, selfcol, sim,
                                      solver, types)
from diffcloth_tpu_torch.core.device import resolve_device
from diffcloth_tpu_torch.geometry import builder as gb
from diffcloth_tpu_torch.tasks import setup


@pytest.fixture(scope="module")
def scene():
    return gb.build_scene(tc.SceneConfig(
        fabric=tc.FabricConfig(cloth_dim_x=2, cloth_dim_y=2,
                               k_stiff_stretching=300, k_stiff_bending=0.05,
                               grid_num_x=4, grid_num_y=4, density=0.3),
        attachment_points=tc.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
        wind_config=tc.WindConfig.WIND_SIN, time_step=1.0 / 60.0,
        step_num=2, name="tiny"))


SPHERE = [dict(kind=contact.P_SPHERE, center=(0.0, -1.0, 0.0), radius=0.5,
               mu=0.3)]


def _cpu_prims():
    return setup._prim_struct(SPHERE, device="cpu")


def _prims_arrays():
    p = _cpu_prims()
    return {f: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for f, v in vars(p).items()}


def _params_arrays():
    p = types.make_sim_params(4, 1, 1, 2, device="cpu")
    return convert.sim_params_to_numpy(p)


# each entry point, called with **kw, -> one tensor it placed
ENTRIES = {
    "make_sim_params": lambda s, **kw: types.make_sim_params(
        4, 1, 1, 2, **kw).density,
    "sim_params_from_numpy": lambda s, **kw: convert.sim_params_from_numpy(
        _params_arrays(), **kw).wind,
    "scene_to_device": lambda s, **kw: sim.scene_to_device(s, **kw).area,
    "stage_to_device": lambda s, **kw: sim.stage_to_device(
        s.stages[0], **kw).attach_w,
    "build_dense_ops": lambda s, **kw: dense_ops.build_dense_ops(
        s, s.stages[0], **kw).S,
    "make_host_p_inv_fn": lambda s, **kw: solver.make_host_p_inv_fn(
        solver.dense_gram_matrices(s)[0], np.asarray(s.area, np.float64),
        1.0 / 60.0, **kw)(torch.tensor([0.0, 1e4, 300.0, 0.05]),
                          torch.tensor(0.3)),
    "empty_primitive_set": lambda s, **kw: contact.empty_primitive_set(
        **kw).mu,
    "ClothSim": lambda s, **kw: sim.ClothSim(s, **kw).scene_dev.area,
    # obstacles made on the CPU follow the sim to its device
    "ClothSim_prims": lambda s, **kw: sim.ClothSim(
        s, prims=_cpu_prims(), **kw).prims.center,
    "prim_struct": lambda s, **kw: setup._prim_struct(SPHERE, **kw).center,
    "primitive_set_from_numpy": lambda s, **kw:
        convert.primitive_set_from_numpy(_prims_arrays(), **kw).radius,
    "Controller": lambda s, **kw: hat_controller.Controller(
        [4, 3, 2], **kw).weights[0],
    "empty_self_contacts": lambda s, **kw: selfcol.empty_self_contacts(
        8, **kw).pair_i,
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_point_defaults_to_the_card(scene, entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRIES[entry](scene)
    assert ENTRIES[entry](scene, device="cpu").device.type == "cpu"


def test_resolve_device_picks_the_card_when_there_is_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(torch.device("cuda", 0))
