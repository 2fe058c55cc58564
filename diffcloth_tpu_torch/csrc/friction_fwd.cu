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
#include <cuda_runtime.h>

#include "friction_common.cuh"
#include "staging.cuh"

namespace {

using friction::kThreads;

// kGlobalState: the state lives in fr_out (global memory) instead of
// shared memory.
template <bool kGlobalState>
__global__ void __launch_bounds__(kThreads)
friction_kernel(const friction::SweepGeom g, const float* __restrict__ fr_in,
                float* fr_out, float* __restrict__ vals_out) {
  extern __shared__ __align__(16) unsigned char smem[];
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

template <bool kGlobalState>
int init(int max_smem) {
  return (int)cudaFuncSetAttribute(friction_kernel<kGlobalState>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   max_smem);
}

template <bool kGlobalState>
int launch(const friction::SweepGeom* g, const float* fr_in, float* fr_out,
           float* vals, void* stream) {
  if (g->B < 1 || g->n < 1 || g->L < 1 || g->TC < 1 || g->max_c_pad < 1 ||
      fr_in == fr_out)
    return (int)cudaErrorInvalidValue;
  const int smem =
      friction::smem_layout(*g, kGlobalState ? 0 : g->n, 8, 6, 1).bytes;
  friction_kernel<kGlobalState>
      <<<g->B, kThreads, smem, (cudaStream_t)stream>>>(*g, fr_in, fr_out,
                                                         vals);
  return (int)cudaGetLastError();
}

}  // namespace

// Called once when the library is loaded: lets a launch use up to
// max_smem bytes of dynamic shared memory (above the 48 KB default).
extern "C" int friction_fwd_init(int max_smem) { return init<false>(max_smem); }
extern "C" int friction_fwd_global_init(int max_smem) {
  return init<true>(max_smem);
}

// g: the step's slot operands; fr_in / fr_out (B, n, 3) f32, not the same
// buffer; vals (B, 6, TC) f32.  The shared memory it needs,
// friction::smem_layout(g, n, 8, 6, 1), must not exceed what
// friction_fwd_init allowed.
extern "C" int friction_fwd(const friction::SweepGeom* g, const float* fr_in,
                            float* fr_out, float* vals, void* stream) {
  return launch<false>(g, fr_in, fr_out, vals, stream);
}

// The global-state route, the same arguments; its shared memory,
// friction::smem_layout(g, 0, 8, 6, 1), holds no state.
extern "C" int friction_fwd_global(const friction::SweepGeom* g,
                                   const float* fr_in, float* fr_out,
                                   float* vals, void* stream) {
  return launch<true>(g, fr_in, fr_out, vals, stream);
}
