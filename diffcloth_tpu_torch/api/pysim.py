"""The stateful `diffcloth_py` surface, on the port.

Counterpart of `diffcloth_tpu/api/pysim.py` (reference:
src/code/python_interface.cpp, module `diffcloth_py`, :164-378, and
PySimulations.h): `make_sim` / `make_optimize_helper` mirror `makeSim` /
`makeOptimizeHelper` (python_interface.cpp:12-89, :137), and
`SimulationAPI` is the stateful `Simulation` facade with the `stepNN` /
`stepBackwardNN` semantics that closed-loop controllers use.

A step is `sim.step` (the differentiable `StepFn`) on a batch of one;
`step_backward_nn` is one `torch.autograd.grad` through it.  The records
hold detached tensors on the sim's device (numpy in the JAX package), so
that stepping never waits on the host; `export_current_simulation`
converts them once.
"""
from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from diffcloth_tpu_torch.core.types import SimParams
from diffcloth_tpu_torch.geometry import objio
from diffcloth_tpu_torch.optim.helper import OptimizeHelper
from diffcloth_tpu_torch.tasks.setup import TaskSetup, build_task

# reference demo names (python_interface.cpp:12-89 wires "wear_hat" and
# "wear_sock"; the rest map to the CLI demos)
_EXAMPLES = {
    "wear_hat": "hat",
    "wear_sock": "sock",
    "wind_tshirt": "tshirt",
    "wind": "wind",
    "rotating_sphere": "sphere",
    "dress_twirl": "dress",
    "slope": "slope",
}


class StateInfo(NamedTuple):
    """reference: the ForwardInformation subset exposed to Python.  x, v
    and x_fixedpoints are flattened (3n,) / (3F,) tensors in the
    reference's layout; converged and the deformations are 0-dim tensors
    (reading them waits for the device)."""
    x: torch.Tensor
    v: torch.Tensor
    x_fixedpoints: torch.Tensor
    t: float
    stepIdx: int
    converged: torch.Tensor
    avgDeformation: torch.Tensor
    maxDeformation: torch.Tensor


class SimulationAPI:
    """Stateful facade over the functional ClothSim, mirroring the
    reference `Simulation` object held by Python controllers."""

    def __init__(self, task: TaskSetup):
        self.task = task
        self.sim = task.sim
        self.params = task.param_base
        self._p_inv = self.sim.p_inv(self.params)
        self.ndof_u = 3 * len(self.sim.stage_host.particle_idx)
        self.scene_config = self.sim.cfg
        self.primitives = self.sim.prims
        self.forward_records: List[StateInfo] = []
        self.reset_system()

    # ------------------------------------------------------------- state

    def state_tensor(self, a) -> torch.Tensor:
        """`a` (tensor, array or list) as an (m, 3) tensor of the sim's
        device and dtype, detached from any graph of the caller."""
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.array(a))
        return a.to(device=self.sim.device,
                    dtype=self.sim.dtype).detach().reshape(-1, 3)

    def _push_record(self, x, v, x_fixed, step_idx, converged=True,
                     avg_def=1.0, max_def=1.0):
        def scalar(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=self.sim.device)

        self.forward_records.append(StateInfo(
            x=x.detach().reshape(-1), v=v.detach().reshape(-1),
            x_fixedpoints=x_fixed.detach().reshape(-1),
            t=step_idx * self.sim.h, stepIdx=step_idx,
            converged=scalar(converged, torch.bool),
            avgDeformation=scalar(avg_def, self.sim.dtype),
            maxDeformation=scalar(max_def, self.sim.dtype)))

    def reset_system(self) -> None:
        """reference: Simulation::resetSystem (Simulation.cpp:2834-2845)."""
        self._x = self.params.x0
        self._v = self.params.v0
        self._x_fixed = self.sim.stage_dev.fixed_pos_rest.to(self.sim.dtype)
        self._step_idx = 0
        self.forward_records = []
        self._push_record(self._x, self._v, self._x_fixed, 0)

    def get_state_info(self) -> StateInfo:
        return self.forward_records[-1]

    def get_current_pos_velocity_vec(self
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._x.reshape(-1), self._v.reshape(-1)

    def set_params(self, params: SimParams) -> None:
        """resetSystemWithParams analogue: refactorizes the solver."""
        self.params = params
        self._p_inv = self.sim.p_inv(params)
        self.reset_system()

    # ------------------------------------------------------------ stepping

    def differentiable_step(self, idx: int, x, v, a):
        """Step `idx` from (x, v) with clip targets a, each (m, 3) of the
        sim's dtype: (x_new, v_new, StepAux), differentiable in x, v, a
        (and the params) through the step's implicit adjoint."""
        t = torch.as_tensor(idx * self.sim.h, dtype=self.sim.dtype,
                            device=self.sim.device)
        x2, v2, aux = self.sim.step(x[None], v[None],
                                    self.params.as_batched(), a[None],
                                    self._p_inv, t, idx)
        return x2[0], v2[0], aux

    def record_step(self, idx: int, x_new, v_new, a, aux) -> StateInfo:
        """Make (x_new, v_new) after clip targets a the current state."""
        self._x, self._v = x_new.detach(), v_new.detach()
        self._x_fixed = a.detach()
        self._step_idx = idx
        self._push_record(self._x, self._v, self._x_fixed, idx,
                          aux.converged[0], aux.avg_deformation[0],
                          aux.max_deformation[0])
        return self.get_state_info()

    def step(self) -> StateInfo:
        """Autonomous step using the scene's own trajectory config."""
        xfs = self.sim.x_fixed_seq(self.params)
        i = min(self._step_idx, xfs.shape[0] - 1)
        return self.step_nn(self._step_idx + 1, self._x, self._v, xfs[i])

    def step_nn(self, idx: int, x, v, fixed_point_pos) -> StateInfo:
        """reference: Simulation::stepNN (Simulation.cpp:1020-1041) — one
        step with externally-set clip targets (PER_STEP_TRAJECTORY)."""
        a = self.state_tensor(fixed_point_pos)
        with torch.no_grad():
            x2, v2, aux = self.differentiable_step(
                idx, self.state_tensor(x), self.state_tensor(v), a)
        return self.record_step(idx, x2, v2, a, aux)

    def step_backward_nn(self, idx: int, x, v, a, dL_dx_new, dL_dv_new
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
        """reference: Simulation::stepBackwardNN (Simulation.cpp:1443-1452):
        the per-step adjoint returning flattened (dL/dx, dL/dv,
        dL/dxfixed), by one autograd pass through the step re-run at the
        given inputs (its implicit adjoint does the solve)."""
        leaves = [self.state_tensor(u).requires_grad_(True)
                  for u in (x, v, a)]
        with torch.enable_grad():
            x2, v2, _ = self.differentiable_step(idx, *leaves)
            grads = torch.autograd.grad(
                (x2, v2), leaves,
                (self.state_tensor(dL_dx_new), self.state_tensor(dL_dv_new)),
                allow_unused=True)
        return tuple(torch.zeros_like(u).reshape(-1) if g is None
                     else g.reshape(-1) for g, u in zip(grads, leaves))

    # ------------------------------------------------------------- export

    def export_current_simulation(self, name: str,
                                  folder: str = "output") -> str:
        """reference: exportCurrentSimulation -> per-frame OBJ files."""
        path = os.path.join(folder, name)
        xs = torch.stack([r.x.reshape(-1, 3) for r in self.forward_records])
        objio.export_frames(path, xs.cpu().numpy(), self.sim.scene_host.tris)
        return path


def make_sim(example_name: str, run_backward: bool = True,
             dtype=torch.float32, device=None) -> SimulationAPI:
    """reference: makeSim (python_interface.cpp:12-89, :367); on the card
    unless `device` says otherwise."""
    demo = _EXAMPLES.get(example_name, example_name)
    return SimulationAPI(build_task(demo, dtype=dtype, device=device))


def make_optimize_helper(example_name: str,
                         sim: Optional[SimulationAPI] = None
                         ) -> OptimizeHelper:
    """reference: makeOptimizeHelper (python_interface.cpp:137, :369)."""
    if sim is None:
        sim = make_sim(example_name)
    task = sim.task
    return OptimizeHelper(task.sim, task.mask, task.loss_fn(),
                          param_base=task.param_base)
