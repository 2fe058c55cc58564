"""The PyTorch autograd bridge (reference: src/python_code/pySim/
functional.py `SimFunction`, :18-102, and pySim/pySim.py `PySim`, :12-33),
as a native autograd op of the port.

Counterpart of `diffcloth_tpu/api/torch_bridge.py`, which crosses
torch -> numpy -> JAX once per step in each direction.  Here the forward
is the differentiable step itself (`SimulationAPI.differentiable_step`,
whose backward is the step's implicit adjoint) and nothing leaves the
device.  The backward returns (dL/dx, dL/dv, dL/da) with the reference's
dL/da norm clamp (functional.py:89-99): a nonzero dL/da is rescaled to
the norm max(min(3F * max_norm, |dL/da|), 0.05), max_norm being
`flags.action_grad_max_norm`, which also raises small norms to 0.05.

Inputs are flattened (3n,) / (3n,) / (3F,) tensors of any float dtype;
the step runs in the sim's dtype and the outputs come back in x's (the
JAX bridge returns float32 always, the reference's `.float()`).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch import Tensor, nn

from diffcloth_tpu_torch.api.pysim import SimulationAPI


def clamp_action_grad(da: Tensor, max_norm: float) -> Tensor:
    """The reference's dL/da clamp (functional.py:89-99) on a flattened
    dL/da, without a host sync."""
    nrm = torch.linalg.vector_norm(da)
    target = nrm.clamp(max=da.shape[0] * max_norm).clamp(min=0.05)
    return torch.where(nrm > 1e-7, da * (target / nrm.clamp(min=1e-30)), da)


class SimFunction(torch.autograd.Function):
    """torch.autograd.Function over one simulator step
    (reference: pySim/functional.py:18-102)."""

    @staticmethod
    def forward(ctx: Any, x: Tensor, v: Tensor, a: Tensor,
                sim: SimulationAPI) -> Tuple[Tensor, Tensor]:
        idx = sim.get_state_info().stepIdx + 1
        leaves = [sim.state_tensor(u).requires_grad_(True)
                  for u in (x, v, a)]
        with torch.enable_grad():
            x2, v2, aux = sim.differentiable_step(idx, *leaves)
        sim.record_step(idx, x2, v2, leaves[2], aux)
        ctx.graph = (leaves, x2, v2)
        ctx.max_norm = sim.sim.flags.action_grad_max_norm
        return (x2.detach().reshape(-1).to(x.dtype),
                v2.detach().reshape(-1).to(x.dtype))

    @staticmethod
    def backward(ctx: Any, dL_dx_next: Tensor, dL_dv_next: Tensor):
        leaves, x2, v2 = ctx.graph
        dx, dv, da = (
            torch.zeros_like(u) if g is None else g
            for g, u in zip(torch.autograd.grad(
                (x2, v2), leaves,
                (dL_dx_next.reshape(x2.shape).to(x2.dtype),
                 dL_dv_next.reshape(v2.shape).to(v2.dtype)),
                allow_unused=True), leaves))
        ctx.graph = None
        return (dx.reshape(-1), dv.reshape(-1),
                clamp_action_grad(da.reshape(-1), ctx.max_norm), None)


class PySim(nn.Module):
    """nn.Module wrapper (reference: pySim/pySim.py:12-33)."""

    def __init__(self, sim: SimulationAPI):
        super().__init__()
        self.sim = sim

    def forward(self, x: Tensor, v: Tensor, a: Tensor
                ) -> Tuple[Tensor, Tensor]:
        return SimFunction.apply(x, v, a, self.sim)
