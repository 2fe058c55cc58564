"""The port's command line (`diffcloth_tpu_torch.apps.optimize`) on the
CPU: the simulate mode's episode export and report, --mode visualize on
what it exported, and the optimize mode with --tau, --export-iters and
--tau-ladder, mirroring the JAX package's apps/optimize.py.  The `wind`
demo is cut to 3 steps; `sock` is the keypoint task of
tests/keypoint_task.py, installed as the solver's build_task.  Runs in a
temporary working directory (the CLI writes output/NAME/ there)."""
import dataclasses
import json
import os

import numpy as np
import pytest

from diffcloth_tpu_torch.apps import optimize
from diffcloth_tpu_torch.io import export as texport
from diffcloth_tpu_torch.optim import solver as tsolver
from diffcloth_tpu_torch.tasks import registry
from torch_cpu import one_intra_op_thread  # noqa: F401

import keypoint_task

CPU = ["--cpu", "--x64"]


@pytest.fixture
def workdir(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    task = registry.DEMOS["wind"]
    monkeypatch.setitem(registry.DEMOS, "wind", dataclasses.replace(
        task, scene=dataclasses.replace(task.scene, step_num=3)))
    keypoint_task.patch_build_task(monkeypatch, tsolver,
                                   keypoint_task.torch_task)
    return tmp_path


def test_simulate_exports_and_visualize_renders(workdir, capsys):
    optimize.main(["--demo", "wind", "--mode", "simulate", "--exp", "sim"]
                  + CPU)
    out = capsys.readouterr().out
    assert "[episode] steps=3" in out and "converged=3/3" in out
    xs, tris, info = texport.import_episode(os.path.join("output", "sim"))
    assert xs.shape == (4, 625, 3) and np.isfinite(xs).all()
    assert info["episode_report"].startswith("[episode] steps=3")
    pytest.importorskip("matplotlib")
    optimize.main(["--mode", "visualize", "--exp", "sim"])
    pngs = os.listdir(os.path.join("output", "sim", "pngs"))
    assert sorted(pngs) == ["frame0000.png"]   # stride 5 over 4 frames
    optimize.main(["--mode", "visualize", "--exp", "sim", "--gif"])
    assert os.path.getsize(os.path.join("output", "sim", "episode.gif")) > 0


def test_visualize_needs_an_exported_folder(workdir):
    with pytest.raises(SystemExit):
        optimize.main(["--mode", "visualize", "--exp", "missing"])
    with pytest.raises(SystemExit):
        optimize.parse_args(["--mode", "simulate"])        # no --demo
    with pytest.raises(SystemExit):
        optimize.parse_args(["--demo", "sock", "--tau", "0.5",
                             "--tau-ladder"])


def test_optimize_with_tau_and_export_iters(workdir, capsys):
    optimize.main(["--demo", "sock", "--maxiter", "2", "--tau", "0.5",
                   "--export-iters", "--exp", "fit"] + CPU)
    out = capsys.readouterr().out
    assert "hard-max loss at the smoothed optimum" in out
    folder = os.path.join("output", "fit")
    with open(os.path.join(folder, "optimization.json")) as fh:
        log = json.load(fh)
    assert log["n_iters"] == 2
    assert os.path.isdir(os.path.join(folder, "iter1"))
    assert os.path.isdir(os.path.join(folder, "final"))


def test_optimize_tau_ladder(workdir, capsys):
    optimize.main(["--demo", "sock", "--maxiter", "4", "--tau-ladder",
                   "--exp", "ladder"] + CPU)
    assert "(tau ladder)" in capsys.readouterr().out
    with open(os.path.join("output", "ladder", "tau_ladder.json")) as fh:
        ladder = json.load(fh)
    assert ladder["taus"] == [2.0, 0.5, 0.1, 0.0]
    assert len(ladder["rungs"]) == 4
    assert all(np.isfinite(r["hard_max_loss"]) for r in ladder["rungs"])
