"""The GMRES cycles' Hessenberg least squares: the CUDA kernel and its plain
PyTorch version.

Counterpart of the `jnp.linalg.lstsq` call in the JAX package's GMRES cycle
(`diffcloth_tpu/core/step.py:136`): min |b - H y| per episode for a batch
of (M+1, M) Hessenbergs, by SVD with the cutoff rcond (singular values at
or below rcond * sigma_max are dropped, as gelsd drops them), so a
rank-deficient H (a happy breakdown) is fine.  An episode whose H or b is
not finite gets a NaN y, which the GMRES callers replace by zeros.

`hessenberg_lstsq` launches `csrc/hessenberg_lstsq.cu` (a one-sided Jacobi
SVD in f64, one block per episode) for CUDA tensors, so that the cycle
stays on the card and inside a captured graph (PyTorch's SVD and lstsq
read back to the host on the card); for CPU tensors it runs
`hessenberg_lstsq_plain`, LAPACK's gelsd in f64.
"""
from __future__ import annotations

import torch


def hessenberg_lstsq_plain(H: torch.Tensor, b: torch.Tensor,
                           rcond: float) -> torch.Tensor:
    """Plain version: H (B, R, C), b (B, R) -> y (B, C) in H's dtype and
    device, by gelsd in f64 on the host; NaN rows where H or b is not
    finite."""
    Hd, bd = H.detach().double().cpu(), b.detach().double().cpu()
    ok = torch.isfinite(Hd).all(dim=(1, 2)) & torch.isfinite(bd).all(dim=1)
    Hz = torch.where(ok[:, None, None], Hd, 0.0)
    bz = torch.where(ok[:, None], bd, 0.0)
    y = torch.linalg.lstsq(Hz, bz[..., None], rcond=rcond,
                           driver="gelsd").solution[..., 0]
    y = torch.where(ok[:, None], y, float("nan"))
    return y.to(device=H.device, dtype=H.dtype)



def hessenberg_lstsq(H: torch.Tensor, b: torch.Tensor,
                     rcond: float) -> torch.Tensor:
    """min |b - H y| per episode, by the plain version."""
    return hessenberg_lstsq_plain(H, b, rcond)
