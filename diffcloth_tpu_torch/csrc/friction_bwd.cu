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
// What bounds it on the H100: latency.  One call moves about 40 KB per
// sample (the (n, 3) cotangent in and out, the slot rows and vals, three
// slot cotangent rows) and does about a hundred operations per active slot:
// its byte bound is under half a microsecond, below what any launch costs;
// the layers are a dependent chain inside one block per sample.  Design,
// as the forward's: one load phase (csrc/staging.cuh) stages the sample's
// cotangent, slot rows and vals into shared memory with TMA bulk copies on
// one mbarrier, one round trip in all.  The layer chain touches only shared
// memory: per non-empty layer a read phase computes every active slot's row
// and partner adds from the pre-layer cotangent into two slot buffers and
// its three cotangents into shared rows, __syncthreads(), a row pass adds
// the row buffer, __syncthreads(), a partner pass adds the partner buffer.
// A layer is a matching (each vertex is the row of at most one slot and the
// partner of at most one slot, selfcol.layer_tables_from_partners), so no
// two threads of a pass add into one vertex, and every vertex receives
// (g + row) + part in that order, as the plain version's two scatter-adds
// give it: the kernel equals the plain version bit for bit.  Empty layers
// cost nothing; a sample with no active slot carries its cotangent
// through.  Inactive slots' cotangents are zeroed in one shared-memory
// pass, and one store phase writes g and the three cotangent rows with
// coalesced 16-byte stores (4-byte cp.async loads and 4-byte stores for a
// state whose rows are not 16-byte aligned).  Compiled with --fmad=false
// so every product and sum rounds as in the plain PyTorch version.
//
// The global-state route (friction_bwd_global), for a cotangent too large
// for shared memory beside the slot rows, as the forward's: the block
// copies its sample's cotangent from g_in to g_out, and the layer chain
// reads and adds into the slot rows' vertices of g_out in global memory,
// with the same read, row and partner passes and __syncthreads() between
// them; bit-equal to the plain version.
//
// The streamed-slot routes (friction_bwd_stream, friction_bwd_global_stream),
// for slot rows too large for shared memory, the forward's design
// (csrc/friction_fwd.cu) in reverse layer order: a wide layer's slot data
// (indices, normal, masses and the six vals rows) read from global memory
// by every warp, its row and partner adds, each beside its vertex index,
// in a force buffer in shared memory (a global scratch only for the slots
// of a layer wider than the buffer) between the read, row and partner
// passes and their __syncthreads(); a narrow layer's slot data loaded into
// warp 0's registers two narrow layers ahead, its adds kept there between
// __syncwarp(); so every vertex still receives (g + row) + part.  The
// three slot cotangents go to ck_out from registers (coalesced by slot);
// the cotangent stays in shared memory when it fits, else in g_out; the
// sample's other blocks zero the inactive slots' cotangents; bit-equal to
// the plain version.
#include <cuda_runtime.h>

#include "friction_common.cuh"
#include "launch_count.cuh"
#include "staging.cuh"

namespace {

using friction::kStreamThreads;
using friction::kThreads;

// kGlobalState: the cotangent lives in g_out (global memory) instead of
// shared memory.
template <bool kGlobalState>
__global__ void __launch_bounds__(kThreads)
friction_bwd_kernel(const friction::SweepGeom g,
                    const float* __restrict__ g_in,
                    const float* __restrict__ vals_in,
                    float* g_out, float* __restrict__ ck_out,
                    unsigned long long* launches) {
  extern __shared__ __align__(16) unsigned char smem[];
  count_launch(launches);
  const friction::Smem m =
      friction::smem_layout(g, kGlobalState ? 0 : g.n, 14, 3, 2);
  const int b = blockIdx.x, TC = g.TC, L = g.L;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* gs = kGlobalState ? g_out + (size_t)b * 3 * g.n    // (n, 3)
                           : reinterpret_cast<float*>(smem + m.state);
  int* row_of = reinterpret_cast<int*>(smem + m.slots);       // staged rows
  int* part_of = row_of + TC;
  float* nrmT = reinterpret_cast<float*>(part_of + TC);       // (3, TC)
  float* kr_s = nrmT + 3 * TC;
  float* mr_s = kr_s + TC;
  float* mp_s = mr_s + TC;
  float* vq = mp_s + TC;                                      // (6, TC)
  float* ck = reinterpret_cast<float*>(smem + m.outs);        // (3, TC)
  float* ci = ck + TC;
  float* cp = ci + TC;
  float* add_row = reinterpret_cast<float*>(smem + m.bufs);   // (c_pad, 3)
  float* add_part = add_row + 3 * g.max_c_pad;                // (c_pad, 3)
  int* cnt = reinterpret_cast<int*>(smem + m.ints);
  int* ls = cnt + L;

  const size_t so = (size_t)b * TC;   // slot offset of this sample
  const float* state_in = g_in + (size_t)b * 3 * g.n;
  if constexpr (kGlobalState) {
    const staging::Piece in[] = {
        {row_of, g.idx_row + so, 4 * TC},
        {part_of, g.idx_part + so, 4 * TC},
        {nrmT, g.normalT + 3 * so, 12 * TC},
        {kr_s, g.kred + so, 4 * TC},
        {mr_s, g.imr + so, 4 * TC},
        {mp_s, g.imp + so, 4 * TC},
        {vq, vals_in + 6 * so, 24 * TC}};
    staging::load(in, bar);
    friction::copy_state(gs, state_in, g.n);   // seen after the sync below
  } else {
    const staging::Piece in[] = {
        {gs, state_in, 12 * g.n},
        {row_of, g.idx_row + so, 4 * TC},
        {part_of, g.idx_part + so, 4 * TC},
        {nrmT, g.normalT + 3 * so, 12 * TC},
        {kr_s, g.kred + so, 4 * TC},
        {mr_s, g.imr + so, 4 * TC},
        {mp_s, g.imp + so, 4 * TC},
        {vq, vals_in + 6 * so, 24 * TC}};
    staging::load(in, bar);
  }
  for (int i = threadIdx.x; i <= L; i += kThreads) {
    ls[i] = g.layer_start[i];
    if (i < L) cnt[i] = g.counts[b * L + i];
  }
  __syncthreads();
  friction::zero_inactive(ck, 3, cnt, ls, L, TC);   // while copies land
  staging::wait(bar);

  bool synced = true;   // every thread sees the cotangent as it stands
  for (int l = L - 1; l >= 0; --l) {
    const int c_l = cnt[l];
    if (c_l == 0) continue;
    if (!synced) __syncthreads();   // the later layer's adds are visible
    const int start = ls[l];
    for (int s = threadIdx.x; s < c_l; s += kThreads) {
      const int slot = start + s;
      const int row = row_of[slot];
      const float mr = mr_s[slot], mp = mp_s[slot], kr = kr_s[slot];
      float q[3], p[3], d[3], nrm[3], w[3], jt[3], r[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q[c] = vq[c * TC + slot];
        p[c] = vq[(3 + c) * TC + slot];
        nrm[c] = nrmT[c * TC + slot];
        w[c] = gs[3 * row + c];
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
      ck[slot] = r[0] * w[0] + r[1] * w[1] + r[2] * w[2];
      ci[slot] = u[0] * q[0] + u[1] * q[1] + u[2] * q[2];
      cp[slot] = -(u[0] * p[0] + u[1] * p[1] + u[2] * p[2]);
    }
    __syncthreads();   // every read of the pre-layer cotangent is done
    for (int s = threadIdx.x; s < c_l; s += kThreads) {
      const int row = row_of[start + s];
#pragma unroll
      for (int c = 0; c < 3; ++c) gs[3 * row + c] += add_row[3 * s + c];
    }
    __syncthreads();   // row adds land before the partner adds
    for (int s = threadIdx.x; s < c_l; s += kThreads) {
      const int part = part_of[start + s];
#pragma unroll
      for (int c = 0; c < 3; ++c) gs[3 * part + c] += add_part[3 * s + c];
    }
    synced = false;
  }
  const size_t sc = (size_t)g.B * TC;   // ck_out's row stride
  if constexpr (kGlobalState) {
    const staging::Piece out[] = {
        {ck_out + so, ck, 4 * TC},
        {ck_out + sc + so, ci, 4 * TC},
        {ck_out + 2 * sc + so, cp, 4 * TC}};
    staging::store(out);
  } else {
    const staging::Piece out[] = {
        {g_out + (size_t)b * 3 * g.n, gs, 12 * g.n},
        {ck_out + so, ck, 4 * TC},
        {ck_out + sc + so, ci, 4 * TC},
        {ck_out + 2 * sc + so, cp, 4 * TC}};
    staging::store(out);
  }
}

// the streamed-slot route's force buffer's bytes a slot: the row and the
// partner add, each beside its vertex index
constexpr int kForceBytes = 32;

// A slot's data: its vertices, normal, masses, and its q and p of the
// forward sweep.
struct Slot {
  int row, part;
  float nrm[3];
  float kr, mr, mp;
  float q[3], p[3];
};

// Slot t of the sample at slot offset so, from global memory.
__device__ __forceinline__ void load_slot(Slot& x,
                                          const friction::SweepGeom& g,
                                          const float* vals, size_t so,
                                          int t) {
  const int TC = g.TC;
  x.row = g.idx_row[so + t];
  x.part = g.idx_part[so + t];
  x.kr = g.kred[so + t];
  x.mr = g.imr[so + t];
  x.mp = g.imp[so + t];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x.nrm[c] = g.normalT[3 * so + c * TC + t];
    x.q[c] = vals[6 * so + c * TC + t];
    x.p[c] = vals[6 * so + (3 + c) * TC + t];
  }
}

// The streamed-slot route (see the header).  scratch: (B, 2, max_c_pad -
// buf) float4, the row and partner adds of slots past the force buffer
// (null when no layer is wider than it).
template <bool kGlobalState>
__global__ void __launch_bounds__(kStreamThreads)
friction_bwd_kernel_stream(const friction::SweepGeom g,
                           const float* __restrict__ g_in,
                           const float* __restrict__ vals_in, float* g_out,
                           float* __restrict__ ck_out,
                           float4* __restrict__ scratch,
                           unsigned long long* launches) {
  extern __shared__ __align__(16) unsigned char smem[];
  count_launch(launches);
  const friction::Smem m =
      friction::stream_layout(g, kGlobalState ? 0 : g.n, kForceBytes,
                              g.bwd_buf);
  const int b = blockIdx.x, TC = g.TC, L = g.L;
  const size_t so = (size_t)b * TC;     // slot offset of this sample
  const size_t sc = (size_t)g.B * TC;   // ck_out's row stride
  float* ck = ck_out + so;              // rows ck, ci, cp, sc apart
  int* cnt = reinterpret_cast<int*>(smem + m.ints);
  int* ls = cnt + L;
  for (int i = threadIdx.x; i <= L; i += blockDim.x) {
    ls[i] = g.layer_start[i];
    if (i < L) cnt[i] = g.counts[b * L + i];
  }
  if (blockIdx.y > 0) {
    // a zeroing block: its part of the sample's inactive slot cotangents
    __syncthreads();
    friction::zero_inactive_stream(ck, 3, cnt, ls, L, TC, sc, blockIdx.y - 1,
                                   gridDim.y - 1);
    return;
  }
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);   // the cotangent's
  float* gs = kGlobalState ? g_out + (size_t)b * 3 * g.n    // (n, 3)
                           : reinterpret_cast<float*>(smem + m.state);
  const float* state_in = g_in + (size_t)b * 3 * g.n;
  const int F = g.bwd_buf, W = g.max_c_pad - F;
  float4* rbuf = reinterpret_cast<float4*>(smem + m.fbuf);   // row adds
  float4* pbuf = rbuf + F;                                    // partner adds
  float4* rscr = scratch ? scratch + (size_t)b * 2 * W : nullptr;
  float4* pscr = scratch ? rscr + W : nullptr;
  if constexpr (kGlobalState) {
    friction::copy_state(gs, state_in, g.n);   // seen after the sync below
  } else {
    const staging::Piece in[] = {{gs, state_in, 12 * g.n}};
    staging::load(in, bar);
  }
  __syncthreads();   // the counts are staged
  if constexpr (!kGlobalState) staging::wait(bar);

  // slot `slot`'s row and partner adds from its data, beside their
  // vertices (ar, ap); its three cotangents to ck_out
  const auto adds = [&](int slot, const Slot& x, float4& ar, float4& ap) {
    float d[3], w[3], jt[3], r[3], u[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      w[c] = gs[3 * x.row + c];
      d[c] = x.q[c] * x.mr - x.p[c] * x.mp;
    }
    friction::dry_friction_jt(x.nrm, d, w, jt);
    friction::dry_friction(x.nrm, d, r);
#pragma unroll
    for (int c = 0; c < 3; ++c) u[c] = x.kr * jt[c];
    ar = make_float4(u[0] * x.mr, u[1] * x.mr, u[2] * x.mr,
                     __int_as_float(x.row));
    ap = make_float4(-(u[0] * x.mp), -(u[1] * x.mp), -(u[2] * x.mp),
                     __int_as_float(x.part));
    ck[slot] = r[0] * w[0] + r[1] * w[1] + r[2] * w[2];
    ck[sc + slot] = u[0] * x.q[0] + u[1] * x.q[1] + u[2] * x.q[2];
    ck[2 * sc + slot] = -(u[0] * x.p[0] + u[1] * x.p[1] + u[2] * x.p[2]);
  };
  const auto add = [&](const float4& a) {
    float* y = gs + 3 * __float_as_int(a.w);
    y[0] += a.x;
    y[1] += a.y;
    y[2] += a.z;
  };
  const auto wide = [&](int l) {
    const int c_l = cnt[l], start = ls[l];
    __syncthreads();   // the later layers' adds are visible
    for (int s = threadIdx.x; s < c_l; s += blockDim.x) {
      Slot x;
      load_slot(x, g, vals_in, so, start + s);
      float4 ar, ap;
      adds(start + s, x, ar, ap);
      if (s < F) {
        rbuf[s] = ar;
        pbuf[s] = ap;
      } else {
        rscr[s - F] = ar;
        pscr[s - F] = ap;
      }
    }
    __syncthreads();   // every read of the pre-layer cotangent is done
    for (int s = threadIdx.x; s < c_l; s += blockDim.x)
      add(s < F ? rbuf[s] : rscr[s - F]);
    __syncthreads();   // row adds land before the partner adds
    for (int s = threadIdx.x; s < c_l; s += blockDim.x)
      add(s < F ? pbuf[s] : pscr[s - F]);
  };
  // warp 0 on a narrow layer: lane s slot s, its adds in its registers
  const auto narrow = [&](int l, const Slot& x) {
    const bool on = threadIdx.x < cnt[l];
    __syncwarp();   // the later layer's adds are visible
    float4 ar, ap;
    if (on) adds(ls[l] + threadIdx.x, x, ar, ap);
    __syncwarp();   // every read of the pre-layer cotangent
    if (on) add(ar);
    __syncwarp();   // row adds land before the partner adds
    if (on) add(ap);
  };
  const auto load = [&](int l, Slot& x) {
    if (threadIdx.x < cnt[l])
      load_slot(x, g, vals_in, so, ls[l] + threadIdx.x);
  };
  friction::chain<Slot>(cnt, L, -1, wide, narrow, load);
  if constexpr (!kGlobalState) {
    const staging::Piece out[] = {
        {g_out + (size_t)b * 3 * g.n, gs, 12 * g.n}};
    staging::store(out);
  }   // else the cotangent is in place
}

template <bool kGlobalState>
int init(int max_smem) {
  return (int)cudaFuncSetAttribute(friction_bwd_kernel<kGlobalState>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   max_smem);
}

template <bool kGlobalState>
int init_stream(int max_smem) {
  return (int)cudaFuncSetAttribute(
      friction_bwd_kernel_stream<kGlobalState>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
}

bool geom_ok(const friction::SweepGeom* g) {
  return g->B >= 1 && g->n >= 1 && g->L >= 1 && g->TC >= 1 &&
         g->max_c_pad >= 1;
}

template <bool kGlobalState>
int launch(const friction::SweepGeom* g, const float* g_in, const float* vals,
           float* g_out, float* ck_out, unsigned long long* launches,
           void* stream) {
  if (!geom_ok(g) || g_in == g_out || !launches)
    return (int)cudaErrorInvalidValue;
  const int smem =
      friction::smem_layout(*g, kGlobalState ? 0 : g->n, 14, 3, 2).bytes;
  friction_bwd_kernel<kGlobalState>
      <<<g->B, kThreads, smem, (cudaStream_t)stream>>>(*g, g_in, vals, g_out,
                                                         ck_out, launches);
  return (int)cudaGetLastError();
}

template <bool kGlobalState>
int launch_stream(const friction::SweepGeom* g, const float* g_in,
                  const float* vals, float* g_out, float* ck_out,
                  float* scratch, unsigned long long* launches,
                  void* stream) {
  if (!geom_ok(g) || g_in == g_out || !launches ||
      !friction::buf_ok(g->bwd_buf, g->max_c_pad, scratch))
    return (int)cudaErrorInvalidValue;
  const int smem = friction::stream_layout(*g, kGlobalState ? 0 : g->n,
                                           kForceBytes, g->bwd_buf)
                       .bytes;
  friction_bwd_kernel_stream<kGlobalState>
      <<<dim3(g->B, 1 + (friction::kZeroBlocks + g->B - 1) / g->B),
         kStreamThreads, smem,
         (cudaStream_t)stream>>>(*g, g_in, vals, g_out, ck_out,
                                 reinterpret_cast<float4*>(scratch),
                                 launches);
  return (int)cudaGetLastError();
}

}  // namespace

// Called once when the library is loaded: lets a launch use up to
// max_smem bytes of dynamic shared memory (above the 48 KB default).
extern "C" int friction_bwd_init(int max_smem) { return init<false>(max_smem); }
extern "C" int friction_bwd_global_init(int max_smem) {
  return init<true>(max_smem);
}
extern "C" int friction_bwd_stream_init(int max_smem) {
  return init_stream<false>(max_smem);
}
extern "C" int friction_bwd_global_stream_init(int max_smem) {
  return init_stream<true>(max_smem);
}

// g: the step's slot operands; g_in / g_out (B, n, 3) f32, not the same
// buffer; vals (B, 6, TC) the forward's saved q and p; ck_out (3, B, TC)
// f32, the cotangents of kred, imr and imp; launches the kernel's launch count
// (device memory, core/launch_count.py), one added per launch.  The shared
// memory it needs,
// friction::smem_layout(g, n, 14, 3, 2), must not exceed what
// friction_bwd_init allowed.
extern "C" int friction_bwd(const friction::SweepGeom* g, const float* g_in,
                            const float* vals, float* g_out, float* ck_out,
                            unsigned long long* launches, void* stream) {
  return launch<false>(g, g_in, vals, g_out, ck_out, launches, stream);
}

// The global-state route, the same arguments; its shared memory,
// friction::smem_layout(g, 0, 14, 3, 2), holds no cotangent.
extern "C" int friction_bwd_global(const friction::SweepGeom* g,
                                   const float* g_in, const float* vals,
                                   float* g_out, float* ck_out,
                                   unsigned long long* launches, void* stream) {
  return launch<true>(g, g_in, vals, g_out, ck_out, launches, stream);
}

// The streamed-slot routes, with the cotangent in shared memory
// (friction::stream_layout(g, n, 32, bwd_buf)) or in g_out (the same with
// n_state 0); ck_out 16-byte aligned, its rows a multiple of 4 floats;
// scratch (B, 2, max_c_pad - bwd_buf, 4) f32
// the row and partner adds of slots past the force buffer, null when
// bwd_buf >= max_c_pad.
extern "C" int friction_bwd_stream(const friction::SweepGeom* g,
                                   const float* g_in, const float* vals,
                                   float* g_out, float* ck_out,
                                   float* scratch,
                                   unsigned long long* launches,
                                   void* stream) {
  return launch_stream<false>(g, g_in, vals, g_out, ck_out, scratch,
                              launches, stream);
}
extern "C" int friction_bwd_global_stream(const friction::SweepGeom* g,
                                          const float* g_in,
                                          const float* vals, float* g_out,
                                          float* ck_out, float* scratch,
                                          unsigned long long* launches,
                                          void* stream) {
  return launch_stream<true>(g, g_in, vals, g_out, ck_out, scratch,
                             launches, stream);
}
