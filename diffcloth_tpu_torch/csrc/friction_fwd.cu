// Layered Gauss-Seidel self-friction sweep over compact contact slots.
//
// Replaces the Pallas TPU kernel diffcloth_tpu/core/friction_pallas.py
// `_fwd_kernel` (launched by `_grid_call` through `fwd_grid`).
//
// Per sample and per layer l (slots [start_l, start_l + counts[l]) of the
// concatenated slot axis): every slot s reads the PRE-layer force state
// q = fr[row_s], p = fr[part_s], forms d = q * imr_s - p * imp_s and
// r_s = kred_s * dff(n_s, d) with mu = 0.1 (the Signorini-Coulomb
// take-off / stick / slide split, friction_pallas.py `_dff_T`), then adds
// r_s into fr[row_s].  It also writes vals (q and p of every slot, zeros for
// slots past counts[l]) for the transposed-linearization backward.  Exact
// f32 throughout: the TPU build's bf16-rounded one-hot selects are not
// copied.
//
// What bounds it on the H100: neither bytes nor operations — one call
// moves about 40 KB per sample (the (n,3) state in and out, the slot data,
// vals) and does a few hundred operations per active slot; the sweep is a
// chain of dependent layers inside one block, so its time is launch and
// synchronisation latency.  Design: one block per sample keeps the whole
// (n,3) f32 state in shared memory (12 KB at n = 1024) for all layers;
// per layer a read phase computes every active slot's force from the
// pre-layer state into a shared slot buffer, __syncthreads(), then a write
// phase adds them into the rows with shared-memory atomicAdd (rows are
// unique within a layer by construction; a duplicate would sum, as the
// TPU kernel's one-hot product does).  Slots past counts[l] cost only
// their vals zero-fill, as the TPU kernel skips empty 128-slot chunks.
// Compiled with --fmad=false so every product and sum rounds as in the
// plain PyTorch version.
#include <cuda_runtime.h>

#include "friction_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
friction_kernel(const float* __restrict__ fr_in, float* __restrict__ fr_out,
                float* __restrict__ vals, const int* __restrict__ idx_row,
                const int* __restrict__ idx_part,
                const float* __restrict__ normalT,
                const float* __restrict__ kred, const float* __restrict__ imr,
                const float* __restrict__ imp, const int* __restrict__ counts,
                const int* __restrict__ layer_start, int L, int n, int TC) {
  extern __shared__ float smem[];
  float* fr = smem;              // (n, 3) force state
  float* r_slot = smem + 3 * n;  // (max c_pad, 3) per-layer slot forces
  const int b = blockIdx.x;
  const float* src = fr_in + (size_t)b * 3 * n;
  for (int e = threadIdx.x; e < 3 * n; e += kThreads) fr[e] = src[e];

  const size_t so = (size_t)b * TC;   // slot offset of this sample
  float* vq = vals + (size_t)b * 6 * TC;
  for (int l = 0; l < L; ++l) {
    const int start = layer_start[l];
    const int c_pad = layer_start[l + 1] - start;
    const int cnt = counts[b * L + l];
    __syncthreads();   // previous layer's writes (or the load) are visible
    for (int s = threadIdx.x; s < c_pad; s += kThreads) {
      const int slot = start + s;
      if (s < cnt) {
        const int row = idx_row[so + slot];
        const int part = idx_part[so + slot];
        const float mr = imr[so + slot], mp = imp[so + slot];
        const float kr = kred[so + slot];
        float q[3], p[3], d[3], nrm[3], r[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          q[c] = fr[3 * row + c];
          p[c] = fr[3 * part + c];
          nrm[c] = normalT[((size_t)b * 3 + c) * TC + slot];
          d[c] = q[c] * mr - p[c] * mp;
        }
        friction::dry_friction(nrm, d, r);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          r_slot[3 * s + c] = kr * r[c];
          vq[(size_t)c * TC + slot] = q[c];
          vq[(size_t)(3 + c) * TC + slot] = p[c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < 6; ++c) vq[(size_t)c * TC + slot] = 0.0f;
      }
    }
    __syncthreads();   // every read of the pre-layer state is done
    for (int s = threadIdx.x; s < cnt; s += kThreads) {
      const int row = idx_row[so + start + s];
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(&fr[3 * row + c], r_slot[3 * s + c]);
    }
  }
  __syncthreads();
  float* dst = fr_out + (size_t)b * 3 * n;
  for (int e = threadIdx.x; e < 3 * n; e += kThreads) dst[e] = fr[e];
}

}  // namespace

// Called once when the library is loaded: lets a launch use up to
// max_smem bytes of dynamic shared memory (above the 48 KB default).
extern "C" int friction_fwd_init(int max_smem) {
  return (int)cudaFuncSetAttribute(
      friction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
}

// fr_in / fr_out (B, n, 3) f32; vals (B, 6, TC) f32; idx_row / idx_part
// (B, TC) int32; normalT (B, 3, TC); kred / imr / imp (B, TC) f32; counts
// (B, L) int32; layer_start (L + 1) int32 with layer l's slots in
// [layer_start[l], layer_start[l + 1]); max_c_pad the widest layer.  The
// shared memory it needs, 3 (n + max_c_pad) floats, must not exceed what
// friction_fwd_init allowed.
extern "C" int friction_fwd(const float* fr_in, float* fr_out, float* vals,
                            const int* idx_row, const int* idx_part,
                            const float* normalT, const float* kred,
                            const float* imr, const float* imp,
                            const int* counts, const int* layer_start, int L,
                            int B, int n, int TC, int max_c_pad,
                            void* stream) {
  if (B < 1 || n < 1 || L < 1 || TC < 1 || max_c_pad < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * (n + max_c_pad) * sizeof(float);
  friction_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      fr_in, fr_out, vals, idx_row, idx_part, normalT, kred, imr, imp,
      counts, layer_start, L, n, TC);
  return (int)cudaGetLastError();
}
