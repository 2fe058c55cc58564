// One load phase and one store phase for a block that works on a sample
// held whole in shared memory (csrc/friction_fwd.cu, csrc/friction_bwd.cu).
// csrc/selfcol_detect.cu uses the pieces of the load on their own: init()
// once per barrier, arm() per staged segment, wait() with the phase's
// parity.
//
// Load: thread 0 initialises an mbarrier and issues one TMA bulk copy
// (cp.async.bulk ... mbarrier::complete_tx::bytes) for every piece whose
// global and shared addresses and size are multiples of 16 bytes; every
// thread issues a 4-byte cp.async for its share of the other pieces (an
// (n, 3) state with n % 4 != 0).  After a __syncthreads() every thread
// waits once on the barrier's phase 0: all pieces cost one latency round
// trip, issued together.
//
// Store: every thread writes its share of each piece with coalesced
// 16-byte stores (4-byte ones where a piece is not 16-byte aligned).  TMA
// bulk stores were measured slower here: a launch of 32 blocks each
// storing 12, 28 or 48 KB took 1.32, 1.85 and 2.69 us by bulk store against
// 1.11, 1.42 and 1.88 us by plain 16-byte stores (device time on an H100
// 80GB HBM3 at 700 W, `python3 bench_staging.py`); TMA bulk loads were as
// fast as plain 16-byte loads or faster (1.39 and 1.61 us against 1.65 and
// 2.00 us at 12 and 28 KB).
#pragma once
#include <cstdint>

namespace staging {

// `bytes` bytes between a global and a shared address, either direction.
struct Piece {
  void* dst;
  const void* src;
  int bytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Both addresses and the size are multiples of 16 bytes.
__device__ __forceinline__ bool aligned16(const Piece& p) {
  return ((reinterpret_cast<uintptr_t>(p.dst) |
           reinterpret_cast<uintptr_t>(p.src) |
           static_cast<uintptr_t>(p.bytes)) & 15) == 0;
}

// One thread initialises a barrier that takes a single arrival per phase;
// the block synchronises before any thread waits on it.
__device__ __forceinline__ void init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(1u) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread: the barrier's current phase expects the 16-byte aligned
// pieces' bytes (0 completes it at once), and their bulk copies start.
// Unaligned pieces are left to the caller.
template <int N>
__device__ __forceinline__ void arm(const Piece (&p)[N], uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  uint32_t tx = 0;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (aligned16(p[i])) tx += p[i].bytes;
  // the single arrival, expecting the bulk copies' bytes
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(b), "r"(tx) : "memory");
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (aligned16(p[i]) && p[i].bytes > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(smem_u32(p[i].dst)),
          "l"(reinterpret_cast<uint64_t>(p[i].src)), "r"(p[i].bytes), "r"(b)
          : "memory");
}

// Global -> shared, once per barrier.  Every thread calls it; then
// __syncthreads() and wait(bar) before reading a piece.
template <int N>
__device__ __forceinline__ void load(const Piece (&p)[N], uint64_t* bar) {
  if (threadIdx.x == 0) {
    init(bar);
    arm(p, bar);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (aligned16(p[i])) continue;
    const uint32_t d = smem_u32(p[i].dst);
    const char* s = static_cast<const char*>(p[i].src);
    for (int e = threadIdx.x; e < p[i].bytes / 4; e += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                   ::"r"(d + 4 * e), "l"(s + 4 * e) : "memory");
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Wait until the barrier's phase of the given parity has completed (every
// bulk copy of that phase landed): 0 for its first phase, 1 for its
// second, and so on alternating.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity = 0) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  } while (!done);
}

// Words of type T of a piece, every blockDim.x-th by each thread, read
// four at a time before they are written.
template <typename T>
__device__ __forceinline__ void copy_words(const Piece& p) {
  T* d = static_cast<T*>(p.dst);
  const T* s = static_cast<const T*>(p.src);
  const int n = p.bytes / static_cast<int>(sizeof(T));
  for (int e0 = threadIdx.x; e0 < n; e0 += 4 * blockDim.x) {
    T w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e0 + k * blockDim.x < n) w[k] = s[e0 + k * blockDim.x];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e0 + k * blockDim.x < n) d[e0 + k * blockDim.x] = w[k];
  }
}

// Shared -> global.  Every thread calls it after its last shared-memory
// write; it synchronises the block itself.
template <int N>
__device__ __forceinline__ void store(const Piece (&p)[N]) {
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (aligned16(p[i]))
      copy_words<uint4>(p[i]);
    else
      copy_words<uint32_t>(p[i]);
  }
}

}  // namespace staging
