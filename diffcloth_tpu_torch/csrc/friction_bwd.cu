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
// for slot rows too large for shared memory, as the forward's: the slot
// rows and vals are read from global memory, the three slot cotangents
// written straight into ck_out, the row and partner adds kept in a global
// scratch of (max c_pad, 6) per sample between the read and the add
// passes, with the same __syncthreads() between them; the cotangent in
// shared memory when it fits alone, else in g_out; inactive slots'
// cotangents zeroed by kZeroParts blocks per sample, as the forward's;
// bit-equal to the plain version.
#include <cuda_runtime.h>

#include "friction_common.cuh"
#include "launch_count.cuh"
#include "staging.cuh"

namespace {

using friction::kThreads;

// kGlobalState: the cotangent lives in g_out (global memory) instead of
// shared memory.  kStream: the slot rows, vals, the slot cotangents and the
// per-slot adds stay in global memory (scratch: (B, max c_pad, 6) f32).
template <bool kGlobalState, bool kStream>
__global__ void __launch_bounds__(kThreads)
friction_bwd_kernel(const friction::SweepGeom g,
                    const float* __restrict__ g_in,
                    const float* __restrict__ vals_in,
                    float* g_out, float* __restrict__ ck_out,
                    float* __restrict__ scratch,
                    unsigned long long* launches) {
  extern __shared__ __align__(16) unsigned char smem[];
  count_launch(launches);
  const int rows = kStream ? 0 : 1;
  const friction::Smem m = friction::smem_layout(
      g, kGlobalState ? 0 : g.n, 14 * rows, 3 * rows, 2 * rows);
  const int b = blockIdx.x, TC = g.TC, L = g.L;
  if constexpr (kStream) {
    if (blockIdx.y > 0) {
      // a zeroing block: its part of the sample's inactive slots, then done
      int* cnt = reinterpret_cast<int*>(smem + m.ints);
      int* ls = cnt + L;
      for (int i = threadIdx.x; i <= L; i += kThreads) {
        ls[i] = g.layer_start[i];
        if (i < L) cnt[i] = g.counts[b * L + i];
      }
      __syncthreads();
      friction::zero_inactive(ck_out + (size_t)b * TC, 3, cnt, ls, L, TC, (size_t)g.B * TC,
                              blockIdx.y, gridDim.y);
      return;
    }
  }
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* gs = kGlobalState ? g_out + (size_t)b * 3 * g.n    // (n, 3)
                           : reinterpret_cast<float*>(smem + m.state);
  const size_t so = (size_t)b * TC;   // slot offset of this sample
  const size_t sc = (size_t)g.B * TC;   // ck_out's row stride
  const float* state_in = g_in + (size_t)b * 3 * g.n;
  const int* row_of;
  const int* part_of;
  const float *nrmT, *kr_s, *mr_s, *mp_s, *vq;
  float *ck, *ci, *cp;   // the slot cotangents, rows `ck_stride` apart
  float *add_row, *add_part;   // (c_pad, 3) each
  size_t ck_stride;
  if constexpr (kStream) {
    row_of = g.idx_row + so;
    part_of = g.idx_part + so;
    nrmT = g.normalT + 3 * so;
    kr_s = g.kred + so;
    mr_s = g.imr + so;
    mp_s = g.imp + so;
    vq = vals_in + 6 * so;
    ck_stride = sc;
    ck = ck_out + so;
    add_row = scratch + (size_t)b * 6 * g.max_c_pad;
    if constexpr (kGlobalState) {
      friction::copy_state(gs, state_in, g.n);   // seen after the sync below
    } else {
      const staging::Piece in[] = {{gs, state_in, 12 * g.n}};
      staging::load(in, bar);
    }
  } else {
    int* rs = reinterpret_cast<int*>(smem + m.slots);         // staged rows
    int* ps = rs + TC;
    float* ns = reinterpret_cast<float*>(ps + TC);             // (3, TC)
    float* ks = ns + 3 * TC;
    float* ms = ks + TC;
    float* pms = ms + TC;
    float* vs = pms + TC;                                      // (6, TC)
    const staging::Piece slot_rows[] = {
        {rs, g.idx_row + so, 4 * TC},
        {ps, g.idx_part + so, 4 * TC},
        {ns, g.normalT + 3 * so, 12 * TC},
        {ks, g.kred + so, 4 * TC},
        {ms, g.imr + so, 4 * TC},
        {pms, g.imp + so, 4 * TC},
        {vs, vals_in + 6 * so, 24 * TC}};
    if constexpr (kGlobalState) {
      staging::load(slot_rows, bar);
      friction::copy_state(gs, state_in, g.n);   // seen after the sync below
    } else {
      const staging::Piece in[] = {{gs, state_in, 12 * g.n},
                                   slot_rows[0], slot_rows[1], slot_rows[2],
                                   slot_rows[3], slot_rows[4], slot_rows[5],
                                   slot_rows[6]};
      staging::load(in, bar);
    }
    row_of = rs;
    part_of = ps;
    nrmT = ns;
    kr_s = ks;
    mr_s = ms;
    mp_s = pms;
    vq = vs;
    ck_stride = TC;
    ck = reinterpret_cast<float*>(smem + m.outs);              // (3, TC)
    add_row = reinterpret_cast<float*>(smem + m.bufs);
  }
  ci = ck + ck_stride;
  cp = ci + ck_stride;
  add_part = add_row + 3 * g.max_c_pad;
  int* cnt = reinterpret_cast<int*>(smem + m.ints);
  int* ls = cnt + L;
  for (int i = threadIdx.x; i <= L; i += kThreads) {
    ls[i] = g.layer_start[i];
    if (i < L) cnt[i] = g.counts[b * L + i];
  }
  __syncthreads();
  // while copies land (on the streamed route, part 0 of the zeroing)
  friction::zero_inactive(ck, 3, cnt, ls, L, TC, ck_stride, 0, gridDim.y);
  if constexpr (!(kStream && kGlobalState)) staging::wait(bar);

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
  if constexpr (kGlobalState && kStream) {
    return;   // the cotangent and the slot cotangents are in place
  } else if constexpr (kGlobalState) {
    const staging::Piece out[] = {
        {ck_out + so, ck, 4 * TC},
        {ck_out + sc + so, ci, 4 * TC},
        {ck_out + 2 * sc + so, cp, 4 * TC}};
    staging::store(out);
  } else if constexpr (kStream) {
    const staging::Piece out[] = {
        {g_out + (size_t)b * 3 * g.n, gs, 12 * g.n}};
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

template <bool kGlobalState, bool kStream>
int init(int max_smem) {
  return (int)cudaFuncSetAttribute(
      friction_bwd_kernel<kGlobalState, kStream>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
}

template <bool kGlobalState, bool kStream>
int launch(const friction::SweepGeom* g, const float* g_in, const float* vals,
           float* g_out, float* ck_out, float* scratch,
           unsigned long long* launches, void* stream) {
  if (g->B < 1 || g->n < 1 || g->L < 1 || g->TC < 1 || g->max_c_pad < 1 ||
      g_in == g_out || !launches || (kStream && !scratch))
    return (int)cudaErrorInvalidValue;
  const int rows = kStream ? 0 : 1;
  const int smem = friction::smem_layout(*g, kGlobalState ? 0 : g->n,
                                         14 * rows, 3 * rows, 2 * rows).bytes;
  friction_bwd_kernel<kGlobalState, kStream>
      <<<dim3(g->B, kStream ? friction::kZeroParts : 1), kThreads, smem,
         (cudaStream_t)stream>>>(
          *g, g_in, vals, g_out, ck_out, scratch, launches);
  return (int)cudaGetLastError();
}

}  // namespace

// Called once when the library is loaded: lets a launch use up to
// max_smem bytes of dynamic shared memory (above the 48 KB default).
extern "C" int friction_bwd_init(int max_smem) {
  return init<false, false>(max_smem);
}
extern "C" int friction_bwd_global_init(int max_smem) {
  return init<true, false>(max_smem);
}
extern "C" int friction_bwd_stream_init(int max_smem) {
  return init<false, true>(max_smem);
}
extern "C" int friction_bwd_global_stream_init(int max_smem) {
  return init<true, true>(max_smem);
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
  return launch<false, false>(g, g_in, vals, g_out, ck_out, nullptr,
                              launches, stream);
}

// The global-state route, the same arguments; its shared memory,
// friction::smem_layout(g, 0, 14, 3, 2), holds no cotangent.
extern "C" int friction_bwd_global(const friction::SweepGeom* g,
                                   const float* g_in, const float* vals,
                                   float* g_out, float* ck_out,
                                   unsigned long long* launches, void* stream) {
  return launch<true, false>(g, g_in, vals, g_out, ck_out, nullptr, launches,
                             stream);
}

// The streamed-slot routes, with the cotangent in shared memory
// (friction::smem_layout(g, n, 0, 0, 0)) or in g_out
// (friction::smem_layout(g, 0, 0, 0, 0)); scratch (B, max_c_pad, 6) f32
// holds the per-slot row and partner adds of a layer.
extern "C" int friction_bwd_stream(const friction::SweepGeom* g,
                                   const float* g_in, const float* vals,
                                   float* g_out, float* ck_out,
                                   float* scratch,
                                   unsigned long long* launches,
                                   void* stream) {
  return launch<false, true>(g, g_in, vals, g_out, ck_out, scratch, launches,
                             stream);
}
extern "C" int friction_bwd_global_stream(const friction::SweepGeom* g,
                                          const float* g_in,
                                          const float* vals, float* g_out,
                                          float* ck_out, float* scratch,
                                          unsigned long long* launches,
                                          void* stream) {
  return launch<true, true>(g, g_in, vals, g_out, ck_out, scratch, launches,
                            stream);
}
