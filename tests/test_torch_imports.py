"""The port stands alone: `diffcloth_tpu_torch` (its optimizer, task setup,
losses and command line included) and `chip_smoke.py` import neither JAX
nor the JAX package, and the port's entry points run on the card unless
the caller asks for the CPU."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

# run in a fresh interpreter where importing jax or diffcloth_tpu raises
_BLOCKED_CHILD = r'''
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "diffcloth_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch
import diffcloth_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    diffcloth_tpu_torch.__path__, "diffcloth_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the gradient path's modules are among them
need = {"diffcloth_tpu_torch.losses", "diffcloth_tpu_torch.tasks.setup",
        "diffcloth_tpu_torch.optim.helper", "diffcloth_tpu_torch.optim.lbfgsb",
        "diffcloth_tpu_torch.optim.solver", "diffcloth_tpu_torch.apps.optimize",
        "diffcloth_tpu_torch.io.export", "diffcloth_tpu_torch.io.viewer",
        "diffcloth_tpu_torch.utils.checkpoint",
        "diffcloth_tpu_torch.utils.timing",
        "diffcloth_tpu_torch.api.pysim", "diffcloth_tpu_torch.api.torch_bridge",
        "diffcloth_tpu_torch.apps.hat_controller",
        "diffcloth_tpu_torch.apps.scaling_bench",
        "diffcloth_tpu_torch.parallel.mesh",
        "diffcloth_tpu_torch.native.fastobj"}
assert need <= set(names), need - set(names)
# the card's machine has none of these: no module may need them to import
extra = [m for m in sys.modules
         if m.split(".")[0] in ("matplotlib", "imageio", "orbax")]
assert not extra, extra
import chip_smoke

from diffcloth_tpu_torch import config as tc
from diffcloth_tpu_torch.core.sim import ClothSim
from diffcloth_tpu_torch.geometry import builder as gb

cfg = tc.SceneConfig(
    fabric=tc.FabricConfig(cloth_dim_x=2, cloth_dim_y=2,
                           k_stiff_stretching=300, k_stiff_bending=0.05,
                           grid_num_x=5, grid_num_y=5, density=0.3),
    attachment_points=tc.AttachmentConfig.LEFT_RIGHT_CORNERS_2,
    wind_config=tc.WindConfig.WIND_SIN, time_step=1.0 / 60.0, step_num=3,
    name="tiny")
scene = gb.build_scene(cfg)
sim = ClothSim(scene, device="cpu")
p = sim.default_params().replace(wind=torch.tensor([0.5, 0.0, 0.5]))
rec = sim.rollout(p)
assert rec.steps.x.shape == (3, 25, 3), rec.steps.x.shape
assert bool(torch.isfinite(rec.steps.x).all())
assert not torch.equal(rec.steps.x[-1], p.x0), "the cloth did not move"

torch.cuda.is_available = lambda: False      # a machine without a card
from diffcloth_tpu_torch.api.pysim import make_sim
from diffcloth_tpu_torch.apps import hat_controller, optimize, scaling_bench
from diffcloth_tpu_torch.optim.solver import solve_demo
from diffcloth_tpu_torch.tasks.setup import build_task
for entry in (lambda: ClothSim(scene), lambda: build_task("wind"),
              lambda: solve_demo("wind", population=2, maxiter=1),
              lambda: optimize.main(["--demo", "wind", "--mode",
                                     "simulate"]),
              lambda: make_sim("wind"),
              lambda: hat_controller.main(["--standin", "--epochs", "0"]),
              lambda: scaling_bench.main([])):
    try:
        entry()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("an entry point ran without a card")
assert not any(m.split(".")[0] in ("jax", "diffcloth_tpu")
               for m in sys.modules)
print("OK", len(names))
'''


def test_port_runs_with_jax_and_the_jax_package_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_CHILD], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.startswith("OK"), out.stdout


def test_port_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(import\s+(jax|jaxlib|diffcloth_tpu)\b"
        r"|from\s+(jax|jaxlib|diffcloth_tpu)(\.|\s))", re.M)
    files = sorted((ROOT / "diffcloth_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert not offenders, offenders
