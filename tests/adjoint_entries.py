"""The entries of a step's adjoint program, reached by a real backward:
for the tests that hold the trips' product (`step.kdv`) to the autograd
one (`step.vjp_k`) on the state the adjoint itself builds (imported by
them, not collected)."""
import torch


def adjoint_entries(sim, x, v, params, x_fixed, p_inv, t, step_idx) -> dict:
    """One step from (x, v) and its backward at a fixed cotangent, on a
    sim whose programs run uncaptured; returns the dict its adjoint
    program read and wrote: its inputs, its start's entries and the
    linearization of K."""
    assert not sim.step.graphs.enabled, "the entries of a captured program"
    x = x.detach().clone().requires_grad_(True)
    x1, v1, _ = sim.step(x, v.detach(), params, x_fixed, p_inv, t, step_idx)
    gen = torch.Generator().manual_seed(0)
    cot = [torch.randn(a.shape, generator=gen, dtype=a.dtype).to(a.device)
           for a in (x1, v1)]
    torch.autograd.grad([x1, v1], x, cot)
    return sim.step.graphs.bind(("adj", x.shape[0], x.dtype, ()), {})
