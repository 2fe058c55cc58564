// What the forward and backward sweeps share (csrc/friction_fwd.cu,
// csrc/friction_bwd.cu): the per-step slot operands, one sample's
// shared-memory layout, the copy of a sample's state for the global-state
// route, the streamed-slot route's force buffer, layer chain and zeroing
// pass, and the per-slot dry-friction math, the
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
// the streamed-slot route's zeroing blocks of a launch: a sample's block
// (blockIdx.y 0) runs its layer chain, and ceil(kZeroBlocks / B) more
// (blockIdx.y 1, 2, ...) share the zeroing of its inactive slots' outputs
// in global memory (7 a sample at B = 32)
constexpr int kZeroBlocks = 224;
// threads of a streamed-slot block (128 and 256 measured alike, 512 and
// 1024 slower: PERF.md)
constexpr int kStreamThreads = 256;

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
  // the streamed-slot route's force buffer of each kernel, slots in shared
  // memory (0 on the other routes)
  int fwd_buf, bwd_buf;
};

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// One sample's shared memory, byte offsets (core/friction_cuda.py
// `_smem_bytes` computes the same total): the mbarrier at 0, the
// (n_state, 3) state (n_state = n on the shared-memory route, 0 on the
// global-state route), `in_rows` staged slot rows of TC, `out_rows` slot
// rows built for the store, `bufs` (max c_pad, 3) slot buffers (all three
// 0 on the streamed-slot route), `fbuf` bytes of per-slot forces (0 on the
// other routes), then counts (L) and layer_start (L + 1).
struct Smem {
  int state, slots, outs, bufs, fbuf, ints, bytes;
};

__host__ __device__ inline Smem smem_layout(const SweepGeom& g, int n_state,
                                            int in_rows, int out_rows,
                                            int bufs, int fbuf = 0) {
  Smem m;
  m.state = 16;
  m.slots = m.state + align16(12 * n_state);
  m.outs = m.slots + align16(4 * g.TC * in_rows);
  m.bufs = m.outs + align16(4 * g.TC * out_rows);
  m.fbuf = m.bufs + align16(12 * g.max_c_pad * bufs);
  m.ints = m.fbuf + align16(fbuf);
  m.bytes = m.ints + 4 * (2 * g.L + 1);
  return m;
}

// A streamed-slot force buffer the kernels take: a multiple of 4 slots,
// and a scratch wherever the widest layer is wider than the buffer.
__host__ __device__ inline bool buf_ok(int buf, int max_c_pad,
                                       const void* scratch) {
  return buf >= 0 && buf % 4 == 0 && (buf >= max_c_pad || scratch != nullptr);
}

// The streamed-slot block of a kernel that keeps `fbytes` bytes of forces
// a slot: the state (n_state as above) and a force buffer of `buf` slots.
__host__ __device__ inline Smem stream_layout(const SweepGeom& g,
                                              int n_state, int fbytes,
                                              int buf) {
  return smem_layout(g, n_state, 0, 0, 0, fbytes * buf);
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

// The streamed-slot route's zeroing pass: every slot past its layer's
// count in `rows` slot rows of TC (`stride` floats apart, rows 16-byte
// aligned) gets 0.  A warp takes 128 slots of one layer at a time (TC and
// the layer starts are multiples of 128), a lane 4 of them in each row: a
// 16-byte store where all 4 are inactive, 4-byte ones in the 4 where a
// count ends.  `parts` blocks share the pass, this one takes part `part`;
// it never writes an active slot, which the chain block writes meanwhile.
__device__ __forceinline__ void zero_inactive_stream(
    float* rows, int n_rows, const int* cnt, const int* ls, int L, int TC,
    size_t stride, int part, int parts) {
  const int warps = blockDim.x / 32;
  int l = 0;
  for (int c = part * warps + threadIdx.x / 32; c < TC / 128;
       c += parts * warps) {
    const int t = 128 * c + 4 * (threadIdx.x & 31);
    while (l + 1 < L && t >= ls[l + 1]) ++l;
    const int first = ls[l] + cnt[l];   // the layer's first inactive slot
    for (int r = 0; r < n_rows; ++r) {
      float* p = rows + r * stride + t;
      if (t >= first)
        *reinterpret_cast<float4*>(p) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      else
        for (int e = first - t; e < 4; ++e) p[e] = 0.0f;
    }
  }
}

// The streamed-slot route's chain takes a layer of kNarrow slots or fewer
// (a narrow one) on warp 0 alone, its slot data in the lanes' registers; a
// wider one on the whole block, its slot data read from global memory.
constexpr int kNarrow = 32;

// The streamed-slot route's layer chain: every non-empty layer of the L,
// in chain order (dir +1 from layer 0, -1 from layer L - 1).  A wide layer
// runs wide(l) on every thread; it starts with a __syncthreads() of its
// own.  A run of narrow layers runs on warp 0 alone, the other warps going
// on to the layer after it: warp 0 loads each narrow layer's slot data
// into its lanes' registers (load(l, x)) two narrow layers ahead, into
// three register sets of type S in turn, and calls narrow(l, x); a run
// after a wide layer starts with a __syncthreads(), so that warp 0 sees
// that layer's adds.
template <typename S, typename W, typename N, typename Ld>
__device__ __forceinline__ void chain(const int* cnt, int L, int dir, W wide,
                                      N narrow, Ld load) {
  const auto next = [&](int l) {   // the next non-empty layer, or past L
    do l += dir;
    while (l >= 0 && l < L && cnt[l] == 0);
    return l;
  };
  const auto next_narrow = [&](int l) {   // or -1
    if (l < 0) return -1;
    l = next(l);
    return l >= 0 && l < L && cnt[l] <= kNarrow ? l : -1;
  };
  bool pending = false;   // a wide layer's adds, not yet synchronised
  for (int l = next(dir > 0 ? -1 : L); l >= 0 && l < L;) {
    if (cnt[l] > kNarrow) {
      wide(l);
      pending = true;
      l = next(l);
      continue;
    }
    if (pending) __syncthreads();
    pending = false;
    if (threadIdx.x >= 32) {
      do l = next(l);
      while (l >= 0 && l < L && cnt[l] <= kNarrow);
      continue;
    }
    S a, b, c;
    int n1 = next_narrow(l), n2;
    load(l, a);
    if (n1 >= 0) load(n1, b);
    for (;;) {
      if ((n2 = next_narrow(n1)) >= 0) load(n2, c);
      narrow(l, a);
      if (n1 < 0) break;
      l = n1;
      n1 = n2;
      if ((n2 = next_narrow(n1)) >= 0) load(n2, a);
      narrow(l, b);
      if (n1 < 0) break;
      l = n1;
      n1 = n2;
      if ((n2 = next_narrow(n1)) >= 0) load(n2, b);
      narrow(l, c);
      if (n1 < 0) break;
      l = n1;
      n1 = n2;
    }
    l = next(l);
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
