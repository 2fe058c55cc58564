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
// leaves them in global memory.  Its time is the chain block's dependent
// steps per non-empty layer, and, beside it, the zeroing of the inactive
// slots' vals (12.6 MB at B = 32 there: the byte bound).  At those shapes
// most layers hold a few slots a sample, and a layer's time is its slot's
// arithmetic, the barriers and the round trips around it; so the sample's
// chain block (blockIdx.y 0) takes each layer one of two ways
// (friction::chain).  A wide layer (over 32 slots) runs on every warp,
// each thread reading its slots' data from global memory (coalesced by
// slot); each slot's force goes, beside its row index, to a force buffer
// in shared memory (a global scratch holds only the slots of a layer
// wider than the buffer), __syncthreads(), and the add phase needs only
// that buffer.  A run of narrow layers runs on warp 0 alone, lane s slot
// s, two __syncwarp() a layer: each lane loads its slot's data into
// registers two narrow layers ahead, and keeps its force in registers
// between the read and the add.  Either way a slot writes its q and p to
// vals_out (coalesced by slot).  The state stays in shared memory when it
// fits (n up to about 19 000), else in fr_out as on the global-state
// route.  The sample's other blocks (kZeroBlocks / B of them) zero its
// inactive slots' vals in vals_out with 16-byte stores, never touching an
// active slot, off the chain's path.  Bit-equal to the plain version, as
// the other routes: the same operations in the same order.
// core/friction_cuda.py `_stream_plan` sizes the force buffer.
#include <cuda_runtime.h>

#include "friction_common.cuh"
#include "launch_count.cuh"
#include "staging.cuh"

namespace {

using friction::kStreamThreads;
using friction::kThreads;

// kGlobalState: the state lives in fr_out (global memory) instead of
// shared memory.
template <bool kGlobalState>
__global__ void __launch_bounds__(kThreads)
friction_kernel(const friction::SweepGeom g, const float* __restrict__ fr_in,
                float* fr_out, float* __restrict__ vals_out,
                unsigned long long* launches) {
  extern __shared__ __align__(16) unsigned char smem[];
  count_launch(launches);
  const friction::Smem m =
      friction::smem_layout(g, kGlobalState ? 0 : g.n, 8, 6, 1);
  const int b = blockIdx.x, TC = g.TC, L = g.L;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* fr = kGlobalState ? fr_out + (size_t)b * 3 * g.n   // (n, 3)
                           : reinterpret_cast<float*>(smem + m.state);
  int* row_of = reinterpret_cast<int*>(smem + m.slots);       // staged rows
  int* part_of = row_of + TC;
  float* nrmT = reinterpret_cast<float*>(part_of + TC);       // (3, TC)
  float* kr_s = nrmT + 3 * TC;
  float* mr_s = kr_s + TC;
  float* mp_s = mr_s + TC;
  float* vals = reinterpret_cast<float*>(smem + m.outs);      // (6, TC)
  float* r_slot = reinterpret_cast<float*>(smem + m.bufs);    // (c_pad, 3)
  int* cnt = reinterpret_cast<int*>(smem + m.ints);
  int* ls = cnt + L;

  const size_t so = (size_t)b * TC;   // slot offset of this sample
  const float* state_in = fr_in + (size_t)b * 3 * g.n;
  if constexpr (kGlobalState) {
    const staging::Piece in[] = {
        {row_of, g.idx_row + so, 4 * TC},
        {part_of, g.idx_part + so, 4 * TC},
        {nrmT, g.normalT + 3 * so, 12 * TC},
        {kr_s, g.kred + so, 4 * TC},
        {mr_s, g.imr + so, 4 * TC},
        {mp_s, g.imp + so, 4 * TC}};
    staging::load(in, bar);
    friction::copy_state(fr, state_in, g.n);   // seen after the sync below
  } else {
    const staging::Piece in[] = {
        {fr, state_in, 12 * g.n},
        {row_of, g.idx_row + so, 4 * TC},
        {part_of, g.idx_part + so, 4 * TC},
        {nrmT, g.normalT + 3 * so, 12 * TC},
        {kr_s, g.kred + so, 4 * TC},
        {mr_s, g.imr + so, 4 * TC},
        {mp_s, g.imp + so, 4 * TC}};
    staging::load(in, bar);
  }
  for (int i = threadIdx.x; i <= L; i += kThreads) {
    ls[i] = g.layer_start[i];
    if (i < L) cnt[i] = g.counts[b * L + i];
  }
  __syncthreads();
  friction::zero_inactive(vals, 6, cnt, ls, L, TC);   // while copies land
  staging::wait(bar);

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
  if constexpr (kGlobalState) {
    const staging::Piece out[] = {
        {vals_out + (size_t)b * 6 * TC, vals, 24 * TC}};
    staging::store(out);
  } else {
    const staging::Piece out[] = {
        {fr_out + (size_t)b * 3 * g.n, fr, 12 * g.n},
        {vals_out + (size_t)b * 6 * TC, vals, 24 * TC}};
    staging::store(out);
  }
}

// the streamed-slot route's force buffer's bytes a slot: the force beside
// its row index
constexpr int kForceBytes = 16;

// A slot's data: its vertices, normal and masses.
struct Slot {
  int row, part;
  float nrm[3];
  float kr, mr, mp;
};

// Slot t of the sample at slot offset so, from global memory.
__device__ __forceinline__ void load_slot(Slot& x,
                                          const friction::SweepGeom& g,
                                          size_t so, int t) {
  x.row = g.idx_row[so + t];
  x.part = g.idx_part[so + t];
#pragma unroll
  for (int c = 0; c < 3; ++c) x.nrm[c] = g.normalT[3 * so + c * g.TC + t];
  x.kr = g.kred[so + t];
  x.mr = g.imr[so + t];
  x.mp = g.imp[so + t];
}

// The streamed-slot route (see the header).  scratch: (B, max_c_pad - buf)
// float4, the forces of slots past the force buffer (null when no layer is
// wider than it).
template <bool kGlobalState>
__global__ void __launch_bounds__(kStreamThreads)
friction_kernel_stream(const friction::SweepGeom g,
                       const float* __restrict__ fr_in, float* fr_out,
                       float* __restrict__ vals_out,
                       float4* __restrict__ scratch,
                       unsigned long long* launches) {
  extern __shared__ __align__(16) unsigned char smem[];
  count_launch(launches);
  const friction::Smem m = friction::stream_layout(
      g, kGlobalState ? 0 : g.n, kForceBytes, g.fwd_buf);
  const int b = blockIdx.x, TC = g.TC, L = g.L;
  const size_t so = (size_t)b * TC;   // slot offset of this sample
  float* vals = vals_out + 6 * so;    // (6, TC)
  int* cnt = reinterpret_cast<int*>(smem + m.ints);
  int* ls = cnt + L;
  for (int i = threadIdx.x; i <= L; i += blockDim.x) {
    ls[i] = g.layer_start[i];
    if (i < L) cnt[i] = g.counts[b * L + i];
  }
  if (blockIdx.y > 0) {
    // a zeroing block: its part of the sample's inactive vals, then done
    __syncthreads();
    friction::zero_inactive_stream(vals, 6, cnt, ls, L, TC, TC,
                                   blockIdx.y - 1, gridDim.y - 1);
    return;
  }
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);   // the state's
  float* fr = kGlobalState ? fr_out + (size_t)b * 3 * g.n   // (n, 3)
                           : reinterpret_cast<float*>(smem + m.state);
  const float* state_in = fr_in + (size_t)b * 3 * g.n;
  const int F = g.fwd_buf;
  float4* fbuf = reinterpret_cast<float4*>(smem + m.fbuf);
  float4* fscr = scratch ? scratch + (size_t)b * (g.max_c_pad - F) : nullptr;
  if constexpr (kGlobalState) {
    friction::copy_state(fr, state_in, g.n);   // seen after the sync below
  } else {
    const staging::Piece in[] = {{fr, state_in, 12 * g.n}};
    staging::load(in, bar);
  }
  __syncthreads();   // the counts are staged
  if constexpr (!kGlobalState) staging::wait(bar);

  // slot `slot`'s force from its data, beside its row index; its q and p
  // to vals
  const auto force = [&](int slot, const Slot& x) {
    float q[3], p[3], d[3], r[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q[c] = fr[3 * x.row + c];
      p[c] = fr[3 * x.part + c];
      d[c] = q[c] * x.mr - p[c] * x.mp;
    }
    friction::dry_friction(x.nrm, d, r);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      vals[c * TC + slot] = q[c];
      vals[(3 + c) * TC + slot] = p[c];
    }
    return make_float4(x.kr * r[0], x.kr * r[1], x.kr * r[2],
                       __int_as_float(x.row));
  };
  const auto add = [&](const float4& f) {
    float* y = fr + 3 * __float_as_int(f.w);
    y[0] += f.x;
    y[1] += f.y;
    y[2] += f.z;
  };
  const auto wide = [&](int l) {
    const int c_l = cnt[l], start = ls[l];
    __syncthreads();   // the earlier layers' adds are visible
    for (int s = threadIdx.x; s < c_l; s += blockDim.x) {
      Slot x;
      load_slot(x, g, so, start + s);
      const float4 f = force(start + s, x);
      if (s < F)
        fbuf[s] = f;
      else
        fscr[s - F] = f;
    }
    __syncthreads();   // every read of the pre-layer state is done
    for (int s = threadIdx.x; s < c_l; s += blockDim.x)
      add(s < F ? fbuf[s] : fscr[s - F]);
  };
  // warp 0 on a narrow layer: lane s slot s, its force in its registers
  const auto narrow = [&](int l, const Slot& x) {
    const bool on = threadIdx.x < cnt[l];
    __syncwarp();   // the previous layer's adds are visible
    float4 f;
    if (on) f = force(ls[l] + threadIdx.x, x);
    __syncwarp();   // every read of the pre-layer state
    if (on) add(f);
  };
  const auto load = [&](int l, Slot& x) {
    if (threadIdx.x < cnt[l]) load_slot(x, g, so, ls[l] + threadIdx.x);
  };
  friction::chain<Slot>(cnt, L, 1, wide, narrow, load);
  if constexpr (!kGlobalState) {
    const staging::Piece out[] = {
        {fr_out + (size_t)b * 3 * g.n, fr, 12 * g.n}};
    staging::store(out);
  }   // else the state is in place
}

template <bool kGlobalState>
int init(int max_smem) {
  return (int)cudaFuncSetAttribute(friction_kernel<kGlobalState>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   max_smem);
}

template <bool kGlobalState>
int init_stream(int max_smem) {
  return (int)cudaFuncSetAttribute(
      friction_kernel_stream<kGlobalState>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
}

bool geom_ok(const friction::SweepGeom* g) {
  return g->B >= 1 && g->n >= 1 && g->L >= 1 && g->TC >= 1 &&
         g->max_c_pad >= 1;
}

template <bool kGlobalState>
int launch(const friction::SweepGeom* g, const float* fr_in, float* fr_out,
           float* vals, unsigned long long* launches, void* stream) {
  if (!geom_ok(g) || fr_in == fr_out || !launches)
    return (int)cudaErrorInvalidValue;
  const int smem =
      friction::smem_layout(*g, kGlobalState ? 0 : g->n, 8, 6, 1).bytes;
  friction_kernel<kGlobalState>
      <<<g->B, kThreads, smem, (cudaStream_t)stream>>>(*g, fr_in, fr_out,
                                                         vals, launches);
  return (int)cudaGetLastError();
}

template <bool kGlobalState>
int launch_stream(const friction::SweepGeom* g, const float* fr_in,
                  float* fr_out, float* vals, float* scratch,
                  unsigned long long* launches, void* stream) {
  if (!geom_ok(g) || fr_in == fr_out || !launches ||
      !friction::buf_ok(g->fwd_buf, g->max_c_pad, scratch))
    return (int)cudaErrorInvalidValue;
  const int smem = friction::stream_layout(*g, kGlobalState ? 0 : g->n,
                                           kForceBytes, g->fwd_buf)
                       .bytes;
  friction_kernel_stream<kGlobalState>
      <<<dim3(g->B, 1 + (friction::kZeroBlocks + g->B - 1) / g->B),
         kStreamThreads, smem,
         (cudaStream_t)stream>>>(*g, fr_in, fr_out, vals,
                                 reinterpret_cast<float4*>(scratch),
                                 launches);
  return (int)cudaGetLastError();
}

}  // namespace

// Called once when the library is loaded: lets a launch use up to
// max_smem bytes of dynamic shared memory (above the 48 KB default).
extern "C" int friction_fwd_init(int max_smem) { return init<false>(max_smem); }
extern "C" int friction_fwd_global_init(int max_smem) {
  return init<true>(max_smem);
}
extern "C" int friction_fwd_stream_init(int max_smem) {
  return init_stream<false>(max_smem);
}
extern "C" int friction_fwd_global_stream_init(int max_smem) {
  return init_stream<true>(max_smem);
}

// g: the step's slot operands; fr_in / fr_out (B, n, 3) f32, not the same
// buffer; vals (B, 6, TC) f32; launches the kernel's launch count (device
// memory, core/launch_count.py), one added per launch.  The shared memory
// it needs, friction::smem_layout(g, n, 8, 6, 1), must not exceed what
// friction_fwd_init allowed.
extern "C" int friction_fwd(const friction::SweepGeom* g, const float* fr_in,
                            float* fr_out, float* vals,
                            unsigned long long* launches, void* stream) {
  return launch<false>(g, fr_in, fr_out, vals, launches, stream);
}

// The global-state route, the same arguments; its shared memory,
// friction::smem_layout(g, 0, 8, 6, 1), holds no state.
extern "C" int friction_fwd_global(const friction::SweepGeom* g,
                                   const float* fr_in, float* fr_out,
                                   float* vals, unsigned long long* launches,
                                   void* stream) {
  return launch<true>(g, fr_in, fr_out, vals, launches, stream);
}

// The streamed-slot routes, with the state in shared memory
// (friction::stream_layout(g, n, 16, fwd_buf)) or in fr_out (the same with
// n_state 0); vals 16-byte aligned, its rows a multiple of 4 floats; scratch (B, max_c_pad - fwd_buf, 4) f32 the forces of
// slots past the force buffer, null when fwd_buf >= max_c_pad.
extern "C" int friction_fwd_stream(const friction::SweepGeom* g,
                                   const float* fr_in, float* fr_out,
                                   float* vals, float* scratch,
                                   unsigned long long* launches,
                                   void* stream) {
  return launch_stream<false>(g, fr_in, fr_out, vals, scratch, launches,
                              stream);
}
extern "C" int friction_fwd_global_stream(const friction::SweepGeom* g,
                                          const float* fr_in, float* fr_out,
                                          float* vals, float* scratch,
                                          unsigned long long* launches,
                                          void* stream) {
  return launch_stream<true>(g, fr_in, fr_out, vals, scratch, launches,
                             stream);
}
