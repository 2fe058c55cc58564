// What the forward and backward sweeps share (csrc/friction_fwd.cu,
// csrc/friction_bwd.cu): the per-step slot operands, one sample's
// shared-memory layout, the copy of a sample's state for the global-state
// route, and the per-slot dry-friction math, the
// Signorini-Coulomb take-off / stick / slide split with mu = 0.1
// (friction_pallas.py `_fric_cases`, `_dff_T`, `_dff_JT`), op for op as the
// plain PyTorch versions in core/friction_cuda.py compute it: three-term
// sums left to right, and the kernels are compiled with --fmad=false.
#pragma once
#include <math.h>

#include "staging.cuh"

namespace friction {

constexpr float kMu = 0.1f;     // cloth-cloth friction (Simulation.cpp:666)
constexpr float kEps = 1e-12f;  // safe_norm guard (constraints.EPS)
constexpr int kThreads = 256;   // one block of kThreads per sample

// The slot operands of one step, fixed for all its sweeps and adjoint
// trips; the wrapper validates them once and passes this struct by pointer
// (`_SweepArgs` in core/friction_cuda.py mirrors its layout).  Slot axes
// are the concatenated layers, layer l in [layer_start[l],
// layer_start[l + 1]); TC and every layer's width are multiples of 128.
struct SweepGeom {
  const int* idx_row;      // (B, TC) row vertex of each slot
  const int* idx_part;     // (B, TC) partner vertex
  const float* normalT;    // (B, 3, TC) row-signed normal
  const float* kred;       // (B, TC) reduced mass
  const float* imr;        // (B, TC) 1 / row mass
  const float* imp;        // (B, TC) 1 / partner mass
  const int* counts;       // (B, L) active slots per layer
  const int* layer_start;  // (L + 1)
  int L, B, n, TC, max_c_pad;
};

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// One sample's shared memory, byte offsets (core/friction_cuda.py
// `_smem_bytes` computes the same total): the mbarrier at 0, the
// (n_state, 3) state (n_state = n on the shared-memory route, 0 on the
// global-state route), `in_rows` staged slot rows of TC, `out_rows` slot
// rows built for the store, `bufs` (max c_pad, 3) slot buffers, then counts
// (L) and layer_start (L + 1).
struct Smem {
  int state, slots, outs, bufs, ints, bytes;
};

__host__ __device__ inline Smem smem_layout(const SweepGeom& g, int n_state,
                                            int in_rows, int out_rows,
                                            int bufs) {
  Smem m;
  m.state = 16;
  m.slots = m.state + align16(12 * n_state);
  m.outs = m.slots + align16(4 * g.TC * in_rows);
  m.bufs = m.outs + align16(4 * g.TC * out_rows);
  m.ints = m.bufs + align16(12 * g.max_c_pad * bufs);
  m.bytes = m.ints + 4 * (2 * g.L + 1);
  return m;
}

// The global-state route: the block copies its sample's (n, 3) state from
// `in` to `out` (16-byte words where both rows are aligned), and the layer
// chain then works on `out` in global memory.  The caller synchronises the
// block before any thread reads what another copied: __syncthreads() makes
// a block's global writes visible to all its threads.
__device__ __forceinline__ void copy_state(float* out, const float* in,
                                           int n) {
  const staging::Piece p = {out, in, 12 * n};
  if (staging::aligned16(p))
    staging::copy_words<uint4>(p);
  else
    staging::copy_words<uint32_t>(p);
}

// Zero `rows` slot rows of TC at every slot past its layer's count: the
// outputs of inactive slots, in one shared-memory pass.
__device__ __forceinline__ void zero_inactive(float* rows, int n_rows,
                                              const int* cnt, const int* ls,
                                              int L, int TC) {
  for (int t = threadIdx.x; t < TC; t += blockDim.x) {
    int l = 0;
    while (l + 1 < L && t >= ls[l + 1]) ++l;
    if (t - ls[l] >= cnt[l])
      for (int r = 0; r < n_rows; ++r) rows[r * TC + t] = 0.0f;
  }
}

// The case data of one slot at the relative force d against normal n.
struct Cases {
  float sd;          // d . n
  float fN[3];       // normal part n * sd
  float fT[3];       // tangential part d - fN
  float tnorm;       // |fT|, kEps where it vanishes
  float slide;       // mu |sd|
  bool in_contact;   // sd < 0
  bool stick;        // |fT| <= mu |sd|
};

__device__ __forceinline__ Cases cases(const float n[3], const float d[3]) {
  Cases c;
  c.sd = d[0] * n[0] + d[1] * n[1] + d[2] * n[2];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c.fN[k] = n[k] * c.sd;
    c.fT[k] = d[k] - c.fN[k];
  }
  const float n2 = c.fT[0] * c.fT[0] + c.fT[1] * c.fT[1] + c.fT[2] * c.fT[2];
  c.tnorm = n2 > kEps * kEps ? sqrtf(n2) : kEps;
  c.slide = kMu * fabsf(c.sd);
  c.in_contact = c.sd < 0.0f;
  c.stick = c.tnorm <= c.slide;
  return c;
}

// r = dry_friction_force(n, d, mu).
__device__ __forceinline__ void dry_friction(const float n[3],
                                             const float d[3], float r[3]) {
  const Cases c = cases(n, d);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t_hat = c.fT[k] / c.tnorm;
    const float rk = c.stick ? (-c.fN[k] - c.fT[k])
                             : (-c.fN[k] - c.slide * t_hat);
    r[k] = c.in_contact ? rk : 0.0f;
  }
}

// jt = (d dry_friction / d d)^T w: 0 at take-off, -w when sticking, and
// -((n.w) + mu sign(sd) (t.w)) n - (mu |sd| / |fT|) (w - (n.w) n - (t.w) t)
// when sliding.
__device__ __forceinline__ void dry_friction_jt(const float n[3],
                                                const float d[3],
                                                const float w[3],
                                                float jt[3]) {
  const Cases c = cases(n, d);
  float t_hat[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) t_hat[k] = c.fT[k] / c.tnorm;
  const float nw = n[0] * w[0] + n[1] * w[1] + n[2] * w[2];
  const float tw = t_hat[0] * w[0] + t_hat[1] * w[1] + t_hat[2] * w[2];
  const float sgn = c.sd > 0.0f ? 1.0f : (c.sd < 0.0f ? -1.0f : 0.0f);
  const float a = -(nw + kMu * sgn * tw);
  const float s = c.slide / c.tnorm;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float jk = c.stick ? -w[k]
                             : a * n[k] - s * ((w[k] - nw * n[k]) - tw * t_hat[k]);
    jt[k] = c.in_contact ? jk : 0.0f;
  }
}

}  // namespace friction
