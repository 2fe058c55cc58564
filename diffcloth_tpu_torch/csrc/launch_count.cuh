// Launch counts kept on the device (core/launch_count.py): a kernel adds
// one to its count from one thread of its first block, once per launch,
// whether the host launched it or a captured graph replayed it.
#pragma once

__device__ __forceinline__ void count_launch(unsigned long long* count) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0)
    atomicAdd(count, 1ull);
}
