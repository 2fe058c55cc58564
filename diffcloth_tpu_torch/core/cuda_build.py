"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into its own shared library under
`build/torch_kernels/` at the repository root, then loaded with `ctypes`
(no PyTorch headers, so a build takes seconds).  Libraries are named by a
hash of their source, the shared headers (`csrc/*.cuh`) and the flags, so
an edited source or header is rebuilt and an unchanged one is reused.  Nothing is built at import time: the first CUDA
launch builds what it needs, and `build_all` builds every kernel at once,
one `nvcc` process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

# every kernel source of the port
KERNELS = ("selfcol_detect", "friction_fwd", "friction_bwd", "hessenberg_lstsq",
           "graph_program", "peer_exchange", "adjoint_linear")

# --fmad=false: no multiply-add contraction, so a kernel's f32 arithmetic
# rounds op for op like its plain PyTorch version (detection hits at the
# reach boundary must not flip between the two)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _paths(name: str):
    src = os.path.join(CSRC_DIR, name + ".cu")
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")
    return src, lib


def library_path(name: str) -> str:
    """Where kernel `name`'s shared library is (or will be) built."""
    return _paths(name)[1]


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp, lib, log) or None
    when the library is already built."""
    src, lib = _paths(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    log = os.path.join(BUILD_DIR, name + ".log")
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, lib, log


def _finish_build(name: str, job) -> str:
    """Wait for one nvcc; returns its output (ptxas register / spill
    report), raises on a failed build."""
    proc, tmp, lib, log = job
    out, _ = proc.communicate()
    with open(log, "w") as fh:
        fh.write(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):"
                           f"\n{out}")
    os.replace(tmp, lib)
    return out


def build_all(names: List[str] = KERNELS) -> Dict[str, str]:
    """Build every listed kernel in parallel (one nvcc each, all started
    together).  Returns {name: nvcc output} for the ones built now."""
    jobs = {n: _start_build(n) for n in names}
    return {n: _finish_build(n, j) for n, j in jobs.items() if j is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start_build(name)
            if job is not None:
                _finish_build(name, job)
            lib = _libs[name] = ctypes.CDLL(_paths(name)[1])
        return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
