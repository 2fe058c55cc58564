"""On a card: one short traced run of each cell through the benchmark's
command, its result line read back; the program's backward self-friction
sweep broken, read as the limits are read, fails the cell.  Skips
without a card."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import check, run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sphere_mu.grad"])
def test_a_traced_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          cell, "--seed", "2147483659", "--seconds", "1",
                          "--trace", "1"], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0 and r["metrics"]
    assert out.stderr.strip().splitlines()[-1].startswith(
        list(r["checks"])[-1])


@pytest.mark.cuda
def test_friction_fault_fails_the_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = "sphere_mu.grad"
    out = subprocess.run([sys.executable, "benchmark/control.py",
                          "--workload", cell, "--seeds", "2154483666",
                          "--fault", "friction_bwd"], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    lim = check.limits(cell)
    assert not check.verdict({k: row[k] for k in lim}, lim)
