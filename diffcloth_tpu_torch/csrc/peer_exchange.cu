// The tensor-parallel solve's all-gather as two kernels that peers reach
// through CUDA IPC: the port's counterpart of the `jax.lax.all_gather` in
// the JAX package's `make_tp_solve` (diffcloth_tpu/parallel/mesh.py:49-58),
// which XLA compiles into the jitted step's while_loops.  Not a TPU
// kernel: NCCL computes the same function (`all_gather_into_tensor`), but
// a program whose WHILE body holds NCCL's captured all-gather fails to
// instantiate (cudaErrorInvalidValue, NCCL 2.28 on H100s joined by
// NVLink), and a body of these kernels runs, so the tp step's programs
// keep their loops on the device.
//
// Every rank of a tp group owns one region of device memory, mapped by
// every peer (cudaIpcOpenMemHandle):
//
//   Header:  flag[r]  the last epoch rank r pushed into this region
//            epoch    this rank's exchanges so far
//            arrive   blocks of the running publish that have finished
//   slots:   [2 parities][tp ranks] one block each
//
// A block is this rank's rows of the solution, (m, B, 3) contiguous, and
// the result their concatenation (tp * m, B, 3), as NCCL's
// all_gather_into_tensor lays it out.  `publish` (epoch e = epoch + 1)
// copies this rank's block into its part of the result and into slot
// [e & 1][me] of every peer's region; its last block to finish (an arrival count) raises
// flag[me] = e in every peer's region with a release store at system
// scope.  `gather` waits (acquire at system scope) until every peer's flag
// in this region has reached e, then copies the peers' blocks out of the
// local slots into the result.  Two parities suffice: a peer pushes epoch
// e + 2 into parity e & 1 only after its own gather of e + 1, which waited
// for this rank's publish of e + 1, which the stream runs after this
// rank's gather of e.  Every copy moves words as they are, so the result
// equals NCCL's bit for bit.  A gather that waits longer than its timeout
// prints which peer it waited for and traps: a hang becomes an error.
//
// Bound: bytes.  Each rank reads its block once, writes it tp times (its
// own rows and tp - 1 peers' slots over NVLink) and copies tp - 1 blocks
// from its slots into the result: at the flagship's B = 32, n = 1024, tp
// = 2, 196 KB each way, a few microseconds at NVLink's 450 GB/s each way;
// at these sizes the two launches and the flag's round trip dominate.
//
// Plain C interface for ctypes; every function returns a cudaError_t.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstring>

#include "launch_count.cuh"

namespace {

constexpr int kMaxRanks = 8;
constexpr long long kHeaderBytes = 256;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;   // two per SM of an H100

struct Header {
  unsigned long long flag[kMaxRanks];
  unsigned long long epoch;
  unsigned int arrive;
};
static_assert(sizeof(Header) <= kHeaderBytes, "header too large");

struct Regions {
  char* r[kMaxRanks];
};

__device__ __forceinline__ void store_release_sys(unsigned long long* p,
                                                  unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename W>
__device__ __forceinline__ W* slot(char* region, int parity, int tp, int r,
                                   long long slot_bytes) {
  return (W*)(region + kHeaderBytes + (long long)(parity * tp + r) *
                                          slot_bytes);
}

// local (words) -> out's block `me` and every peer's slot
template <typename W>
__global__ void publish(Regions reg, int me, int tp,
                        const W* __restrict__ local, W* __restrict__ out,
                        long long words, long long slot_bytes,
                        unsigned long long* launches) {
  count_launch(launches);
  Header* mine = (Header*)reg.r[me];
  // read before any block arrives: the last one to arrive bumps it
  const unsigned long long e =
      *(volatile unsigned long long*)&mine->epoch + 1;
  const int parity = (int)(e & 1);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < words; i += (long long)gridDim.x * blockDim.x) {
    const W v = local[i];
    out[me * words + i] = v;
    for (int p = 0; p < tp; ++p)
      if (p != me) slot<W>(reg.r[p], parity, tp, me, slot_bytes)[i] = v;
  }
  if (tp == 1) return;
  // the block's stores (ordered before thread 0's fence by the barrier)
  // reach the peers before the block arrives
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    const unsigned prev = atomicAdd(&mine->arrive, 1u);
    if (prev == gridDim.x - 1) {   // every block's stores are done
      __threadfence_system();
      *(volatile unsigned*)&mine->arrive = 0u;
      *(volatile unsigned long long*)&mine->epoch = e;
      for (int p = 0; p < tp; ++p)
        if (p != me)
          store_release_sys(&((Header*)reg.r[p])->flag[me], e);
    }
  }
}

// the peers' blocks of epoch `epoch` out of this rank's slots into out
template <typename W>
__global__ void gather(Regions reg, int me, int tp, W* __restrict__ out,
                       long long words, long long slot_bytes,
                       long long timeout_ns) {
  Header* mine = (Header*)reg.r[me];
  const unsigned long long e = *(volatile unsigned long long*)&mine->epoch;
  const int parity = (int)(e & 1);
  if (threadIdx.x == 0) {
    const unsigned long long t0 = now_ns();
    for (int p = 0; p < tp; ++p) {
      if (p == me) continue;
      unsigned long long f;
      while ((f = load_acquire_sys(&mine->flag[p])) < e) {
        if ((long long)(now_ns() - t0) > timeout_ns) {
          printf("peer_exchange: rank %d waited %lld s for rank %d's block "
                 "of epoch %llu (its flag is at %llu)\n",
                 me, timeout_ns / 1000000000ll, p, e, f);
          __trap();
        }
        __nanosleep(64);
      }
    }
  }
  __syncthreads();
  const long long total = (tp - 1) * words;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int q = (int)(i / words);
    const int p = q + (q >= me);
    const long long k = i - q * words;
    out[p * words + k] = slot<W>(reg.r[me], parity, tp, p, slot_bytes)[k];
  }
}

int grid_for(long long words) {
  const long long g = (words + kThreads - 1) / kThreads;
  return (int)(g < 1 ? 1 : (g > kMaxBlocks ? kMaxBlocks : g));
}

template <typename W>
cudaError_t launch(const Regions& reg, int me, int tp, const void* local,
                   void* out, long long bytes, long long slot_bytes,
                   long long timeout_ns, unsigned long long* launches,
                   cudaStream_t stream) {
  const long long words = bytes / (long long)sizeof(W);
  publish<W><<<grid_for(words), kThreads, 0, stream>>>(
      reg, me, tp, (const W*)local, (W*)out, words, slot_bytes, launches);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tp == 1) return err;
  gather<W><<<grid_for((tp - 1) * words), kThreads, 0, stream>>>(
      reg, me, tp, (W*)out, words, slot_bytes, timeout_ns);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// Bytes of a region before its slots.
long long px_header_bytes() { return kHeaderBytes; }

// A zeroed region of `bytes` on the current device and its IPC handle
// (64 bytes, cudaIpcMemHandle_t); waits for the zeroing.
int px_region_alloc(long long bytes, void** ptr, void* handle) {
  void* p = nullptr;
  cudaError_t err = cudaMalloc(&p, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  *ptr = p;
  err = cudaMemset(p, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle((cudaIpcMemHandle_t*)handle, p);
  return (int)err;
}

// A peer's region, mapped into this process from its handle.
int px_region_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

// The PCI bus id of `device` ("0000:00:00.0"), for the peers to find it.
int px_bus_id(int device, char* out, int len) {
  return (int)cudaDeviceGetPCIBusId(out, len, device);
}

// Whether `device` can reach the card with PCI bus id `peer_bus_id`
// directly (the same card can).
int px_can_access(int device, const char* peer_bus_id, int* ok) {
  int peer = -1;
  cudaError_t err = cudaDeviceGetByPCIBusId(&peer, peer_bus_id);
  if (err != cudaSuccess) return (int)err;
  if (peer == device) {
    *ok = 1;
    return 0;
  }
  return (int)cudaDeviceCanAccessPeer(ok, device, peer);
}

// One exchange on `stream`: regions[0..tp) the group's regions (this
// rank's own at [me]), local this rank's block of `bytes`, out (tp x
// bytes) the result; slots of slot_bytes each.
int px_exchange(const void* const* regions, int me, int tp, const void* local,
                void* out, long long bytes, long long slot_bytes,
                long long timeout_ns, void* launches, void* stream) {
  if (tp < 1 || tp > kMaxRanks || me < 0 || me >= tp || bytes % 4 ||
      slot_bytes % 16 || slot_bytes < bytes)
    return (int)cudaErrorInvalidValue;
  Regions reg = {};
  for (int r = 0; r < tp; ++r) reg.r[r] = (char*)regions[r];
  unsigned long long* count = (unsigned long long*)launches;
  cudaStream_t s = (cudaStream_t)stream;
  if (bytes % 16 == 0 && aligned16(local) && aligned16(out))
    return (int)launch<uint4>(reg, me, tp, local, out, bytes, slot_bytes,
                              timeout_ns, count, s);
  return (int)launch<unsigned>(reg, me, tp, local, out, bytes, slot_bytes,
                               timeout_ns, count, s);
}

}  // extern "C"
