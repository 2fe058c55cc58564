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
// What bounds it on the H100: latency.  One call moves about 40 KB per
// sample (the (n, 3) state in and out, the slot rows, vals) and does a few
// dozen operations per active slot: at 3.35 TB/s its byte bound is under
// half a microsecond, below what any launch costs.  What is left is a
// chain of dependent steps inside one block per sample.  Design: one load
// phase (csrc/staging.cuh) brings the sample's state and all its slot rows
// into shared memory with TMA bulk copies on one mbarrier, so the block
// pays one memory round trip where a per-layer reload paid 2 L + 2.  The
// layer chain then touches only shared memory: per non-empty layer a read
// phase computes every active slot's force from the pre-layer state into a
// slot buffer and its q, p into the vals rows, __syncthreads(), and a
// write phase adds the forces into the rows.  A layer is a matching (each
// vertex is the row of at most one slot, selfcol.layer_tables_from_
// partners), so no two threads add into one row and each row gets one
// add, bit-equal to the plain version's scatter-add.  Empty layers cost
// nothing; a sample with no active slot only carries its state through.
// Inactive slots' vals are zeroed in one shared-memory pass, and one store
// phase writes the state and vals back with coalesced 16-byte stores
// (measured faster than TMA bulk stores, csrc/staging.cuh).  A state whose
// rows are not 16-byte aligned (n % 4 != 0) is loaded by 4-byte cp.async
// beside the bulk copies.  Compiled with --fmad=false so every product and
// sum rounds as in the plain PyTorch version.
//
// The global-state route (friction_fwd_global): a state past about
// 15 000 vertices does not fit the 227 KB of shared memory beside the slot
// rows (core/friction_cuda.py `sweep_operands` picks the route).  Then the
// block copies its sample's state from fr_in to fr_out, 16-byte words by
// every thread, and the layer chain reads and writes only the slot rows'
// vertices of fr_out, in global memory; the slot rows, vals and the slot
// buffer stay in shared memory.  __syncthreads() between the phases makes
// the block's global writes visible to all its threads, a layer is still a
// matching, so there are still no atomics, and the result is bit-equal to
// the plain version.  Its bound is the copy: the state in and out once.
//
// The streamed-slot route (friction_fwd_stream, friction_fwd_global_stream):
// a step whose slot rows do not fit shared memory (the drop-free budgets
// (n,) * 16 of a 1024-vertex cloth are 16 384 slots, some 1.1 MB of rows)
// leaves them in global memory.  Each thread reads its slots' indices,
// normal and masses there (coalesced by slot), writes q and p straight into
// vals_out and the slot's force into a global scratch row of (max c_pad, 3)
// per sample; __syncthreads() ends the layer's read phase before any add,
// so every slot still reads the pre-layer state, and the add phase reads the
// forces back.  The state stays in shared memory when it fits alone (n up
// to about 19 000), else in fr_out as on the global-state route.
// Inactive slots' vals are zeroed in vals_out by kZeroParts blocks per
// sample (blockIdx.y; block 0 also runs the layer chain, the others only
// zero, never touching an active slot).  Bit-equal to the plain version,
// as the other routes: the same operations in the same order.
#include <cuda_runtime.h>

#include "friction_common.cuh"
#include "launch_count.cuh"
#include "staging.cuh"

namespace {

using friction::kThreads;

// kGlobalState: the state lives in fr_out (global memory) instead of
// shared memory.  kStream: the slot rows, vals and the per-slot forces stay
// in global memory (scratch: (B, max c_pad, 3) f32) instead of shared.
template <bool kGlobalState, bool kStream>
__global__ void __launch_bounds__(kThreads)
friction_kernel(const friction::SweepGeom g, const float* __restrict__ fr_in,
                float* fr_out, float* __restrict__ vals_out,
                float* __restrict__ scratch, unsigned long long* launches) {
  extern __shared__ __align__(16) unsigned char smem[];
  count_launch(launches);
  const int rows = kStream ? 0 : 1;
  const friction::Smem m = friction::smem_layout(
      g, kGlobalState ? 0 : g.n, 8 * rows, 6 * rows, rows);
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
      friction::zero_inactive(vals_out + (size_t)b * 6 * TC, 6, cnt, ls, L, TC, TC,
                              blockIdx.y, gridDim.y);
      return;
    }
  }
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* fr = kGlobalState ? fr_out + (size_t)b * 3 * g.n   // (n, 3)
                           : reinterpret_cast<float*>(smem + m.state);
  const size_t so = (size_t)b * TC;   // slot offset of this sample
  const int* row_of;
  const int* part_of;
  const float *nrmT, *kr_s, *mr_s, *mp_s;
  float* vals;     // (6, TC)
  float* r_slot;   // (c_pad, 3)
  if constexpr (kStream) {
    row_of = g.idx_row + so;
    part_of = g.idx_part + so;
    nrmT = g.normalT + 3 * so;
    kr_s = g.kred + so;
    mr_s = g.imr + so;
    mp_s = g.imp + so;
    vals = vals_out + 6 * so;
    r_slot = scratch + (size_t)b * 3 * g.max_c_pad;
  } else {
    int* rs = reinterpret_cast<int*>(smem + m.slots);         // staged rows
    int* ps = rs + TC;
    float* ns = reinterpret_cast<float*>(ps + TC);             // (3, TC)
    float* ks = ns + 3 * TC;
    float* ms = ks + TC;
    float* pms = ms + TC;
    const staging::Piece slot_rows[] = {
        {rs, g.idx_row + so, 4 * TC},
        {ps, g.idx_part + so, 4 * TC},
        {ns, g.normalT + 3 * so, 12 * TC},
        {ks, g.kred + so, 4 * TC},
        {ms, g.imr + so, 4 * TC},
        {pms, g.imp + so, 4 * TC}};
    const float* state_in = fr_in + (size_t)b * 3 * g.n;
    if constexpr (kGlobalState) {
      staging::load(slot_rows, bar);
      friction::copy_state(fr, state_in, g.n);   // seen after the sync below
    } else {
      const staging::Piece in[] = {{fr, state_in, 12 * g.n},
                                   slot_rows[0], slot_rows[1], slot_rows[2],
                                   slot_rows[3], slot_rows[4], slot_rows[5]};
      staging::load(in, bar);
    }
    row_of = rs;
    part_of = ps;
    nrmT = ns;
    kr_s = ks;
    mr_s = ms;
    mp_s = pms;
    vals = reinterpret_cast<float*>(smem + m.outs);
    r_slot = reinterpret_cast<float*>(smem + m.bufs);
  }
  if constexpr (kStream) {
    const float* state_in = fr_in + (size_t)b * 3 * g.n;
    if constexpr (kGlobalState) {
      friction::copy_state(fr, state_in, g.n);   // seen after the sync below
    } else {
      const staging::Piece in[] = {{fr, state_in, 12 * g.n}};
      staging::load(in, bar);
    }
  }
  int* cnt = reinterpret_cast<int*>(smem + m.ints);
  int* ls = cnt + L;
  for (int i = threadIdx.x; i <= L; i += kThreads) {
    ls[i] = g.layer_start[i];
    if (i < L) cnt[i] = g.counts[b * L + i];
  }
  __syncthreads();
  // while copies land (on the streamed route, part 0 of the zeroing)
  friction::zero_inactive(vals, 6, cnt, ls, L, TC, TC, 0, gridDim.y);
  if constexpr (!(kStream && kGlobalState)) staging::wait(bar);

  bool synced = true;   // every thread sees the state as it stands
  for (int l = 0; l < L; ++l) {
    const int c_l = cnt[l];
    if (c_l == 0) continue;
    if (!synced) __syncthreads();   // the previous layer's adds are visible
    const int start = ls[l];
    for (int s = threadIdx.x; s < c_l; s += kThreads) {
      const int slot = start + s;
      const int row = row_of[slot], part = part_of[slot];
      const float mr = mr_s[slot], mp = mp_s[slot], kr = kr_s[slot];
      float q[3], p[3], d[3], nrm[3], r[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q[c] = fr[3 * row + c];
        p[c] = fr[3 * part + c];
        nrm[c] = nrmT[c * TC + slot];
        d[c] = q[c] * mr - p[c] * mp;
      }
      friction::dry_friction(nrm, d, r);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        r_slot[3 * s + c] = kr * r[c];
        vals[c * TC + slot] = q[c];
        vals[(3 + c) * TC + slot] = p[c];
      }
    }
    __syncthreads();   // every read of the pre-layer state is done
    for (int s = threadIdx.x; s < c_l; s += kThreads) {
      const int row = row_of[start + s];
#pragma unroll
      for (int c = 0; c < 3; ++c) fr[3 * row + c] += r_slot[3 * s + c];
    }
    synced = false;
  }
  if constexpr (kGlobalState && kStream) {
    return;   // the state and vals are in place
  } else if constexpr (kGlobalState) {
    const staging::Piece out[] = {
        {vals_out + (size_t)b * 6 * TC, vals, 24 * TC}};
    staging::store(out);
  } else if constexpr (kStream) {
    const staging::Piece out[] = {
        {fr_out + (size_t)b * 3 * g.n, fr, 12 * g.n}};
    staging::store(out);
  } else {
    const staging::Piece out[] = {
        {fr_out + (size_t)b * 3 * g.n, fr, 12 * g.n},
        {vals_out + (size_t)b * 6 * TC, vals, 24 * TC}};
    staging::store(out);
  }
}

template <bool kGlobalState, bool kStream>
int init(int max_smem) {
  return (int)cudaFuncSetAttribute(friction_kernel<kGlobalState, kStream>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   max_smem);
}

template <bool kGlobalState, bool kStream>
int launch(const friction::SweepGeom* g, const float* fr_in, float* fr_out,
           float* vals, float* scratch, unsigned long long* launches,
           void* stream) {
  if (g->B < 1 || g->n < 1 || g->L < 1 || g->TC < 1 || g->max_c_pad < 1 ||
      fr_in == fr_out || !launches || (kStream && !scratch))
    return (int)cudaErrorInvalidValue;
  const int rows = kStream ? 0 : 1;
  const int smem = friction::smem_layout(*g, kGlobalState ? 0 : g->n,
                                         8 * rows, 6 * rows, rows).bytes;
  friction_kernel<kGlobalState, kStream>
      <<<dim3(g->B, kStream ? friction::kZeroParts : 1), kThreads, smem,
         (cudaStream_t)stream>>>(*g, fr_in, fr_out, vals, scratch, launches);
  return (int)cudaGetLastError();
}

}  // namespace

// Called once when the library is loaded: lets a launch use up to
// max_smem bytes of dynamic shared memory (above the 48 KB default).
extern "C" int friction_fwd_init(int max_smem) {
  return init<false, false>(max_smem);
}
extern "C" int friction_fwd_global_init(int max_smem) {
  return init<true, false>(max_smem);
}
extern "C" int friction_fwd_stream_init(int max_smem) {
  return init<false, true>(max_smem);
}
extern "C" int friction_fwd_global_stream_init(int max_smem) {
  return init<true, true>(max_smem);
}

// g: the step's slot operands; fr_in / fr_out (B, n, 3) f32, not the same
// buffer; vals (B, 6, TC) f32; launches the kernel's launch count (device
// memory, core/launch_count.py), one added per launch.  The shared memory
// it needs, friction::smem_layout(g, n, 8, 6, 1), must not exceed what
// friction_fwd_init allowed.
extern "C" int friction_fwd(const friction::SweepGeom* g, const float* fr_in,
                            float* fr_out, float* vals,
                            unsigned long long* launches, void* stream) {
  return launch<false, false>(g, fr_in, fr_out, vals, nullptr, launches,
                              stream);
}

// The global-state route, the same arguments; its shared memory,
// friction::smem_layout(g, 0, 8, 6, 1), holds no state.
extern "C" int friction_fwd_global(const friction::SweepGeom* g,
                                   const float* fr_in, float* fr_out,
                                   float* vals, unsigned long long* launches,
                                   void* stream) {
  return launch<true, false>(g, fr_in, fr_out, vals, nullptr, launches,
                             stream);
}

// The streamed-slot routes, with the state in shared memory
// (friction::smem_layout(g, n, 0, 0, 0)) or in fr_out
// (friction::smem_layout(g, 0, 0, 0, 0)); scratch (B, max_c_pad, 3) f32
// holds the per-slot forces of a layer.
extern "C" int friction_fwd_stream(const friction::SweepGeom* g,
                                   const float* fr_in, float* fr_out,
                                   float* vals, float* scratch,
                                   unsigned long long* launches,
                                   void* stream) {
  return launch<false, true>(g, fr_in, fr_out, vals, scratch, launches,
                             stream);
}
extern "C" int friction_fwd_global_stream(const friction::SweepGeom* g,
                                          const float* fr_in, float* fr_out,
                                          float* vals, float* scratch,
                                          unsigned long long* launches,
                                          void* stream) {
  return launch<true, true>(g, fr_in, fr_out, vals, scratch, launches,
                            stream);
}
