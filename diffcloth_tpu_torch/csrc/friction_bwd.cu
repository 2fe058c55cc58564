// Transposed linearization of the layered self-friction sweep at its saved
// selects: the backward of csrc/friction_fwd.cu.
//
// Replaces the Pallas TPU kernel diffcloth_tpu/core/friction_pallas.py
// `_bwd_kernel` (launched by `_grid_call` through `bwd_grid`).
//
// The forward sweep adds, per layer l and active slot s, the force
// r_s = kred_s * dff(n_s, d_s) with d_s = q_s * imr_s - p_s * imp_s into
// fr[row_s], where q_s = fr[row_s] and p_s = fr[part_s] are read from the
// pre-layer state and saved in vals.  Its transpose visits the layers in
// reverse.  Every slot of a layer reads the cotangent g left after the
// later layers, w = g[row_s], and forms
//   u   = kred * dff_jt(n, d, w)              (the per-slot 3x3 Jacobian^T)
//   ck  = dff(n, d) . w                       (cotangent of kred)
//   ci  = u . q,   cp = -(u . p)              (cotangents of imr and imp)
// then u * imr is added to g[row_s] and -(u * imp) to g[part_s].  Slots
// past counts[l] get zero slot cotangents.
//
// What bounds it on the H100: neither bytes nor operations.  One call moves
// about 40 KB per sample (the (n, 3) cotangent in and out, the active slots'
// data and vals, three slot cotangent rows) and does about a hundred
// operations per active slot; the layers are a dependent chain inside one
// block, so its time is launch and synchronisation latency.  Design, after
// the forward: one block per sample keeps the whole (n, 3) f32 cotangent in
// shared memory for all layers.  Per layer a read phase computes every
// active slot's row and partner adds from the pre-layer cotangent into two
// shared slot buffers, __syncthreads(), a row pass adds the row buffer,
// __syncthreads(), a partner pass adds the partner buffer.  A layer is a
// matching (each vertex is the row of at most one slot and the partner of
// at most one slot, selfcol.layer_tables_from_partners), so no two threads
// of a pass add into one vertex, and every vertex receives (g + row) + part
// in that order, as the plain version's two scatter-adds give it.  Compiled
// with --fmad=false so every product and sum rounds as in the plain
// PyTorch version.
#include <cuda_runtime.h>

#include "friction_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
friction_bwd_kernel(const float* __restrict__ g_in, float* __restrict__ g_out,
                    float* __restrict__ c_kred, float* __restrict__ c_imr,
                    float* __restrict__ c_imp, const float* __restrict__ vals,
                    const int* __restrict__ idx_row,
                    const int* __restrict__ idx_part,
                    const float* __restrict__ normalT,
                    const float* __restrict__ kred,
                    const float* __restrict__ imr,
                    const float* __restrict__ imp,
                    const int* __restrict__ counts,
                    const int* __restrict__ layer_start, int L, int n, int TC,
                    int max_c_pad) {
  extern __shared__ float smem[];
  float* g = smem;                        // (n, 3) cotangent
  float* add_row = smem + 3 * n;          // (max c_pad, 3) row adds
  float* add_part = add_row + 3 * max_c_pad;  // (max c_pad, 3) partner adds
  const int b = blockIdx.x;
  const float* src = g_in + (size_t)b * 3 * n;
  for (int e = threadIdx.x; e < 3 * n; e += kThreads) g[e] = src[e];

  const size_t so = (size_t)b * TC;   // slot offset of this sample
  const float* vq = vals + (size_t)b * 6 * TC;
  for (int l = L - 1; l >= 0; --l) {
    const int start = layer_start[l];
    const int c_pad = layer_start[l + 1] - start;
    const int cnt = counts[b * L + l];
    __syncthreads();   // the later layer's adds (or the load) are visible
    for (int s = threadIdx.x; s < c_pad; s += kThreads) {
      const int slot = start + s;
      if (s < cnt) {
        const int row = idx_row[so + slot];
        const float mr = imr[so + slot], mp = imp[so + slot];
        const float kr = kred[so + slot];
        float q[3], p[3], d[3], nrm[3], w[3], jt[3], r[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          q[c] = vq[(size_t)c * TC + slot];
          p[c] = vq[(size_t)(3 + c) * TC + slot];
          nrm[c] = normalT[((size_t)b * 3 + c) * TC + slot];
          w[c] = g[3 * row + c];
          d[c] = q[c] * mr - p[c] * mp;
        }
        friction::dry_friction_jt(nrm, d, w, jt);
        friction::dry_friction(nrm, d, r);
        float u[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          u[c] = kr * jt[c];
          add_row[3 * s + c] = u[c] * mr;
          add_part[3 * s + c] = -(u[c] * mp);
        }
        c_kred[so + slot] = r[0] * w[0] + r[1] * w[1] + r[2] * w[2];
        c_imr[so + slot] = u[0] * q[0] + u[1] * q[1] + u[2] * q[2];
        c_imp[so + slot] = -(u[0] * p[0] + u[1] * p[1] + u[2] * p[2]);
      } else {
        c_kred[so + slot] = 0.0f;
        c_imr[so + slot] = 0.0f;
        c_imp[so + slot] = 0.0f;
      }
    }
    __syncthreads();   // every read of the pre-layer cotangent is done
    for (int s = threadIdx.x; s < cnt; s += kThreads) {
      const int row = idx_row[so + start + s];
#pragma unroll
      for (int c = 0; c < 3; ++c) g[3 * row + c] += add_row[3 * s + c];
    }
    __syncthreads();   // row adds land before the partner adds
    for (int s = threadIdx.x; s < cnt; s += kThreads) {
      const int part = idx_part[so + start + s];
#pragma unroll
      for (int c = 0; c < 3; ++c) g[3 * part + c] += add_part[3 * s + c];
    }
  }
  __syncthreads();
  float* dst = g_out + (size_t)b * 3 * n;
  for (int e = threadIdx.x; e < 3 * n; e += kThreads) dst[e] = g[e];
}

}  // namespace

// Called once when the library is loaded: lets a launch use up to
// max_smem bytes of dynamic shared memory (above the 48 KB default).
extern "C" int friction_bwd_init(int max_smem) {
  return (int)cudaFuncSetAttribute(friction_bwd_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   max_smem);
}

// g_in / g_out (B, n, 3) f32; c_kred / c_imr / c_imp (B, TC) f32 outputs;
// vals (B, 6, TC) the forward's saved q and p; idx_row / idx_part (B, TC)
// int32; normalT (B, 3, TC); kred / imr / imp (B, TC) f32; counts (B, L)
// int32; layer_start (L + 1) int32 with layer l's slots in
// [layer_start[l], layer_start[l + 1]); max_c_pad the widest layer.  The
// shared memory it needs, 3 (n + 2 max_c_pad) floats, must not exceed what
// friction_bwd_init allowed.
extern "C" int friction_bwd(const float* g_in, float* g_out, float* c_kred,
                            float* c_imr, float* c_imp, const float* vals,
                            const int* idx_row, const int* idx_part,
                            const float* normalT, const float* kred,
                            const float* imr, const float* imp,
                            const int* counts, const int* layer_start, int L,
                            int B, int n, int TC, int max_c_pad,
                            void* stream) {
  if (B < 1 || n < 1 || L < 1 || TC < 1 || max_c_pad < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * (n + 2 * max_c_pad) * sizeof(float);
  friction_bwd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      g_in, g_out, c_kred, c_imr, c_imp, vals, idx_row, idx_part, normalT,
      kred, imr, imp, counts, layer_start, L, n, TC, max_c_pad);
  return (int)cudaGetLastError();
}
