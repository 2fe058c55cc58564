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

import ctypes
import functools

import torch

from diffcloth_tpu_torch.core import cuda_build
from diffcloth_tpu_torch.core import launch_count as lc

MAX_DIM = 32     # rows and columns the kernel accepts


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


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, loaded and typed once."""
    fn = cuda_build.load("hessenberg_lstsq").hessenberg_lstsq
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lc.counted("hessenberg_lstsq")
def hessenberg_lstsq(H: torch.Tensor, b: torch.Tensor,
                     rcond: float) -> torch.Tensor:
    """min |b - H y| per episode: the CUDA kernel for CUDA tensors (f32 or
    f64, computed in f64), the plain version for CPU tensors.  H (B, R, C),
    b (B, R) with R, C <= 32.  The kernel counts its launches on the
    device (`launches`)."""
    if not H.is_cuda:
        return hessenberg_lstsq_plain(H, b, rcond)
    B, R, C = H.shape
    if (H.dtype not in (torch.float32, torch.float64) or b.dtype != H.dtype
            or tuple(b.shape) != (B, R) or b.device != H.device):
        raise ValueError(f"hessenberg_lstsq: H (B, R, C) and b (B, R) of one "
                         f"float dtype on one device, got H {H.dtype} "
                         f"{tuple(H.shape)}, b {b.dtype} {tuple(b.shape)}")
    if not (1 <= R <= MAX_DIM and 1 <= C <= MAX_DIM):
        raise ValueError(f"hessenberg_lstsq: at most {MAX_DIM} rows and "
                         f"columns, got {R} x {C}")
    H, b = H.contiguous(), b.contiguous()
    y = H.new_empty((B, C))
    cuda_build.check(_kernel()(
        H.data_ptr(), b.data_ptr(), y.data_ptr(), B, R, C,
        int(H.dtype == torch.float64), float(rcond),
        lc.address("hessenberg_lstsq", H.device),
        torch.cuda.current_stream(H.device).cuda_stream), "hessenberg_lstsq")
    return y
