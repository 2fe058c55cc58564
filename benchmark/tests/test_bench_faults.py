"""A run on the CPU at a tiny size, with the harness's look for a card
skipped: sound, it is correct; with the timed path broken underneath it
is not, for each fault the cell can have (a step that returns its state
unchanged; half of the batch left out and the mean of the rest in its
place, in the whole answer or in the gradient alone; an answer altered
where it is produced); and the control, the reference in TF32 in the
program's place, fails a limit.  A cell on one card has no exchange
between chips to leave out.  The self-friction sweep's VJP wrong at the
steps with self-contact moves the judged cotangents far past a sound
run's here, and fails the cell at its own size on a card
(`test_bench_card.py`)."""
import subprocess
import sys

import pytest
import torch

from benchmark import check, control, run
from benchmark.tests.conftest import contact, tiny

CELLS = ("sphere_mu.grad",)
SEED = 2 ** 31 + 21


def _run(cell, size=tiny):
    torch.set_num_threads(2)
    return run.run_cell(cell, SEED, 0.1, False, device="cpu",
                        overrides=size(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(check.limits(cell))


def _unchanged_step(monkeypatch):
    from diffcloth_tpu_torch.core.sim import ClothSim
    init = ClothSim.__init__

    def broken(self, *a, **k):
        init(self, *a, **k)
        inner = self.steps[0]

        def step(x, v, *rest):
            _, _, aux = inner(x, v, *rest)
            return x * 1.0, v * 1.0, aux
        self.steps[0] = self.step = step
    monkeypatch.setattr(ClothSim, "__init__", broken)


def _half_batch(monkeypatch, loss=True):
    from diffcloth_tpu_torch.optim.helper import OptimizeHelper
    vg = OptimizeHelper.batched_loss_and_grad

    def half_vg(self, X):
        L, G = vg(self, X)
        h = len(L) // 2
        if loss:
            L[h:] = L[:h].mean()
        G[h:] = G[:h].mean(0)
        return L, G
    monkeypatch.setattr(OptimizeHelper, "batched_loss_and_grad", half_vg)


def _half_batch_grad(monkeypatch):
    _half_batch(monkeypatch, loss=False)


def _altered_answer(monkeypatch):
    from diffcloth_tpu_torch.optim.helper import OptimizeHelper
    vg = OptimizeHelper.batched_loss_and_grad

    def altered_vg(self, X):
        L, G = vg(self, X)
        return L * 1.01, G * 1.01
    monkeypatch.setattr(OptimizeHelper, "batched_loss_and_grad", altered_vg)


FAULTS = [_unchanged_step, _half_batch, _half_batch_grad, _altered_answer]


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__.lstrip("_") for f in FAULTS])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_friction_fault_shows_at_the_contact_steps(cell, monkeypatch):
    """The backward sweep's slot contributions doubled (as `control.py
    --fault friction_bwd` plants it) at the `contact` size, where the cloth
    meets itself late in the episode: the largest cotangent gap over the
    judged steps reads far past the sound run's."""
    from diffcloth_tpu_torch.core import friction_cuda as fc
    sound = _run(cell, contact)
    assert sound["correct"]
    calls, inner = [], fc.friction_sweep_bwd

    def doubled(g, vals, ops):
        calls.append(int(ops.geom.counts.sum()))
        out, *slots = inner(g, vals, ops)
        return (g + 2.0 * (out - g), *slots)
    monkeypatch.setattr(fc, "friction_sweep_bwd", doubled)
    broken = _run(cell, contact)
    assert calls and max(calls) > 0
    gap = [r["checks"]["adjoint_gap"]["value"] for r in (sound, broken)]
    assert gap[1] > 30 * gap[0]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    torch.set_num_threads(2)
    rows = control.control_readings(cell, [5], 1, device="cpu",
                                    overrides=tiny(cell))
    numbers = {k: v for k, v in rows[0].items()
               if k not in ("cell", "side", "seed")}
    assert not check.verdict(numbers, check.limits(cell))


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "sphere_mu.grad", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
