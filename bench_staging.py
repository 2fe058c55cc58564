#!/usr/bin/env python3
"""Per-block data movement between global and shared memory on one NVIDIA
GPU: TMA bulk copies against plain 16-byte loads and stores.

    python3 bench_staging.py

The friction sweep kernels (diffcloth_tpu_torch/csrc/friction_*.cu) run one
block per sample and move 12-64 KB per block between device memory and
shared memory; this script times the ways to do that, at 32 blocks of 256
threads (the flagship stand-in's batch), and prints one line per size:
device microseconds per launch (torch.profiler) of a kernel that moves
`KB` kilobytes per block

  tma_load        one bulk copy (cp.async.bulk ... complete_tx) on an
                  mbarrier, one thread issuing
  plain_load      16-byte loads, every thread a share
  tma_store       one bulk store (cp.async.bulk.global.shared::cta) and
                  its wait_group.read
  plain_store     16-byte stores from shared memory, every thread a share
  zero_store      16-byte stores of zeros from registers

beside the launch floor (a one-element zero_()).  The card's name and power
limit come first.  Needs nvcc (CUDA_HOME, PATH or /usr/local/cuda).
"""
import ctypes
import os
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
__device__ __forceinline__ uint32_t su(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__global__ void __launch_bounds__(256) move(int mode, int bytes,
    const uint4* __restrict__ src, uint4* __restrict__ dst) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = (uint64_t*)smem;
  uint4* buf = (uint4*)(smem + 16);
  const size_t off = (size_t)blockIdx.x * bytes / 16;
  if (mode == 0) {                       // TMA bulk load
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   ::"r"(su(bar)), "r"(1u) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(su(bar)), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(su(buf)), "l"((uint64_t)(src + off)), "r"(bytes),
          "r"(su(bar)) : "memory");
    }
    __syncthreads();
    uint32_t done = 0;
    do {
      asm volatile("{\n .reg .pred p;\n"
                   " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                   " selp.u32 %0, 1, 0, p;\n}\n"
                   : "=r"(done) : "r"(su(bar)), "r"(0u) : "memory");
    } while (!done);
  } else if (mode == 1) {                // plain 16-byte loads
    for (int e = threadIdx.x; e < bytes / 16; e += 256) buf[e] = src[off + e];
    __syncthreads();
  } else if (mode == 2) {                // TMA bulk store
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   ::"l"((uint64_t)(dst + off)), "r"(su(buf)), "r"(bytes)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  } else if (mode == 3) {                // plain 16-byte stores
    __syncthreads();
    for (int e = threadIdx.x; e < bytes / 16; e += 256) dst[off + e] = buf[e];
  } else {                               // 16-byte stores of zeros
    for (int e = threadIdx.x; e < bytes / 16; e += 256)
      dst[off + e] = make_uint4(0, 0, 0, 0);
  }
  // a use of the loaded data, so that no load is dropped
  if (mode <= 1 && threadIdx.x == 0 && buf[1].x == 0xdeadbeefu)
    dst[0] = buf[0];
}
extern "C" int move_init() {
  return (int)cudaFuncSetAttribute(
      move, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
}
extern "C" int move_launch(int blocks, int mode, int bytes, const void* src,
                           void* dst, void* stream) {
  move<<<blocks, 256, 16 + bytes, (cudaStream_t)stream>>>(
      mode, bytes, (const uint4*)src, (uint4*)dst);
  return (int)cudaGetLastError();
}
"""

# (label, mode); the bulk copies are not run at 0 KB
CASES = (("tma_load", 0), ("plain_load", 1), ("tma_store", 2),
         ("plain_store", 3), ("zero_store", 4))
SIZES_KB = (0, 4, 12, 28, 48, 64)
BLOCKS = 32


def build():
    from diffcloth_tpu_torch.core import cuda_build
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "bench_staging.cu")
    lib = os.path.join(cuda_build.BUILD_DIR, "libbench_staging.so")
    with open(src, "w") as fh:
        fh.write(SOURCE)
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([cuda_build.nvcc_path(), *flags, "-o", lib, src],
                   check=True)
    return ctypes.CDLL(lib)


def main():
    import torch
    if not torch.cuda.is_available():
        print("bench_staging: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import device_ms, nvidia_smi_line
    print(nvidia_smi_line(), flush=True)
    lib = build()
    if lib.move_init() != 0:
        raise RuntimeError("move_init failed")
    lib.move_launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    src = torch.zeros(BLOCKS * 64 * 1024, dtype=torch.uint8, device="cuda")
    dst = torch.zeros_like(src)
    stream = torch.cuda.current_stream().cuda_stream
    one = torch.zeros(1, device="cuda")
    floor = device_ms(lambda: one.zero_(), reps=100) * 1e3
    print(f"launch floor {floor:.2f} us; device us per launch of "
          f"{BLOCKS} blocks:", flush=True)
    for kb in SIZES_KB:
        row = []
        for label, mode in CASES:
            if kb == 0 and mode in (0, 2):
                continue

            def launch(mode=mode):
                err = lib.move_launch(BLOCKS, mode, kb * 1024,
                                      src.data_ptr(), dst.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            row.append(f"{label} {device_ms(launch, reps=100) * 1e3:.2f}")
        print(f"{kb:3d} KB: " + "  ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
