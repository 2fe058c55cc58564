// Swept sphere-sphere self-collision detection: per-row partner tables.
//
// Replaces the Pallas TPU kernel diffcloth_tpu/core/selfcol_pallas.py
// `_kernel` (launched by `_detect_partners_grid`), symmetric mode.
//
// Semantics (identical to the TPU kernel, overflow rows included): pair
// (i, j) hits when min(|x_i - x_j|^2, |(x+hv)_i - (x+hv)_j|^2) < (r_i + r_j)^2
// and allowed[i][j] > 0; a NaN in either distance is no hit (the min
// propagates NaN, as torch.minimum does).  Columns are visited in 512-wide
// segments in order.  Within a segment the row keeps its hits by ascending
// (d^2, column) and appends the first min(hits, K - count) of them after
// the slots it already holds.  The count then grows by those plus
// max(hits - K, 0): the TPU kernel's count, which equals the row's true
// hit count except when a row's hits straddle segments (then it may stop
// at K; the JAX package's tests and flags inherit that).
//
// Output (B, n_pad, K + 1) int32: cols 0..K-1 partner index (-1 empty),
// col K the count (> K means overflow).
//
// What bounds it on the H100: the all-pairs hit test, B * n_pad^2 pairs of
// 20 f32 operations each.  Built with --fmad=false (so that d^2 rounds as
// the plain version computes it), every operation is its own instruction:
// at 128 f32 lanes x 132 SMs x 1.98 GHz = 33.5e12 instructions/s,
// B = 32, n_pad = 1024 takes at least about 0.020 ms, twice the FLOP
// bound that counts a multiply-add as two operations.  The compiled step
// (16 pairs per lane) is 378 instructions: those 320, 16 selects
// gathering the hit bits, 7 shared-memory loads and 35 others, so
// the loop alone needs about 0.024 ms at one instruction per cycle per
// scheduler.  Beside it, every block reads its rows of the int8
// admissibility table and the sample's geometry from L2.
//
// Design:
// - A block is 4 warps on 16 rows of one sample; each warp holds 4 rows'
//   geometry (7 values each) in every lane's registers, and its 32 lanes
//   split the columns: lane l takes columns 4l..4l+3 of every 128.  At
//   B = 32, n_pad = 1024 that is 2048 blocks, 8192 warps, 20 resident per
//   SM (93 registers a thread, no local memory).
// - The sample's geometry is staged one 512-column segment at a time by TMA
//   bulk copies (staging.cuh), double-buffered on two mbarriers, so any
//   n_pad fits; one __syncthreads() per segment, none inside it.  A lane
//   reads 4 columns of one geometry row with one 16-byte shared-memory
//   load and uses them for its 4 rows: 7 loads per 16 pairs.
// - The common path has no branch: 16 hit predicates go into a bit mask,
//   ANDed with the admissibility bytes (one coalesced 4-byte load per row:
//   a warp reads 128 consecutive bytes of the row).  Only a warp-uniform
//   __any_sync enters the hit path (6 % of the warps' steps at
//   chip_smoke.py's phase 2 input).
// - Exact selection at a cost that grows with the hits: the hit path
//   counts, ORs the lanes' masks and, for each (row, column) some lane hit,
//   appends the lanes' (d^2, column) to the row's list in shared memory (a
//   ballot gives each lane its place).  A list about to pass 64 entries is
//   cut to its K - count smallest by ranking, so rows with any number of
//   hits stay exact.  At the segment's end each row with hits ranks its
//   list by (d^2, column) (column as the explicit tie-break: lanes
//   interleave, so a later column of one lane can tie an earlier column of
//   another) and lane s takes slot s.  Slots, counts and lists live in
//   shared memory, the per-row counters in bytes of three registers.
// - K past 32 (the JAX package's kernel takes up to 127, SLOT_COLS = 128):
//   a second instantiation, kMaxK = 128, in which lane s takes slots s,
//   s + 32, s + 64 and s + 96, a row's list holds 160 candidates and each
//   lane ranks five of them when it is cut; the same order and counts.
//   K <= 32 launches the kMaxK = 32 instantiation, today's kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_count.cuh"
#include "staging.cuh"

namespace {

constexpr int kSegment = 512;   // column segment of the TPU kernel (BJ)
constexpr int kLargestK = 127;  // the JAX kernel's bound (SLOT_COLS - 1)
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;   // rows held in each lane's registers
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kColsPerStep = 32 * 4;   // a warp's columns per step
constexpr int kGeomRows = 7;    // x, y, z, (x+hv) x, y, z, r
static_assert(kRowsPerWarp <= 4, "per-row counters are bytes of one word");

// The instantiation for K up to kMaxK (32: one slot per lane; 128: four).
template <int kMaxK>
struct Cfg {
  static constexpr int kCap = kMaxK + 32;   // candidates a row's list holds
  static constexpr int kRank = kCap / 32;   // entries each lane ranks
  static constexpr int kSlotsPerLane = kMaxK / 32;
  // resident blocks per SM: 5 (<= 102 registers) at K <= 32
  static constexpr int kMinBlocks = kMaxK == 32 ? 5 : 3;
  static_assert(kCap < 256, "fills are bytes");
  static_assert(kMaxK % 32 == 0, "whole slots per lane");
};

template <int kMaxK>
struct Shared {
  float geom[2][kGeomRows][kSegment];   // double-buffered segments
  float cand_d2[kWarps][kRowsPerWarp][Cfg<kMaxK>::kCap];
  int cand_col[kWarps][kRowsPerWarp][Cfg<kMaxK>::kCap];
  int slot[kWarps][kRowsPerWarp][kMaxK];
  int count[kWarps][kRowsPerWarp];
  float row_geom[kWarps][kRowsPerWarp][6];   // for the hit path
  uint64_t bar[2];
};

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned byte_of(unsigned w, int r) {
  return (w >> (8 * r)) & 0xFFu;
}

// min that propagates NaN, as torch.minimum and jnp.minimum do
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// d^2 of rows xi and xj (x, y, z, then x + h v) in the plain version's
// order: x, y, z summed left to right, for x and for x + h v, then their
// min
__device__ __forceinline__ float pair_d2(const float (&xi)[6],
                                         const float (&xj)[6]) {
  float d = xi[0] - xj[0];
  float a = d * d;
  d = xi[1] - xj[1];
  a = a + d * d;
  d = xi[2] - xj[2];
  a = a + d * d;
  d = xi[3] - xj[3];
  float b = d * d;
  d = xi[4] - xj[4];
  b = b + d * d;
  d = xi[5] - xj[5];
  b = b + d * d;
  return min_nan(a, b);
}

// A warp's candidate list of one row, entries [0, fill) with distinct
// columns: its `keep` smallest by (d^2, column) move to [0, keep) in that
// order and the rest are dropped.  Each lane ranks kRank entries (two at
// K <= 32) against the whole list.  Returns the entries kept.
template <int kRank>
__device__ __forceinline__ int keep_smallest(float* d2s, int* cols, int fill,
                                             int keep, int lane) {
  __syncwarp();
  float d2[kRank];
  int col[kRank], rank[kRank];
#pragma unroll
  for (int q = 0; q < kRank; ++q) {
    const int e = lane + 32 * q;
    d2[q] = e < fill ? d2s[e] : 0.f;
    col[q] = e < fill ? cols[e] : 0;
    rank[q] = 0;
  }
  for (int j = 0; j < fill; ++j) {
    const float dj = d2s[j];
    const int cj = cols[j];
#pragma unroll
    for (int q = 0; q < kRank; ++q)
      rank[q] += (dj < d2[q]) || (dj == d2[q] && cj < col[q]);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kRank; ++q) {
    const int e = lane + 32 * q;
    if (e < fill && rank[q] < keep) {
      d2s[rank[q]] = d2[q];
      cols[rank[q]] = col[q];
    }
  }
  __syncwarp();
  return min(fill, keep);
}

// One thread: start the bulk copies of segment `seg`'s geometry into its
// buffer, on that buffer's barrier.
template <int kMaxK>
__device__ __forceinline__ void stage_segment(Shared<kMaxK>& sm,
                                              const float* g,
                                              int n_pad, int seg) {
  staging::Piece p[kGeomRows];
#pragma unroll
  for (int c = 0; c < kGeomRows; ++c)
    p[c] = {sm.geom[seg & 1][c],
            g + (size_t)c * n_pad + (size_t)seg * kSegment,
            kSegment * (int)sizeof(float)};
  staging::arm(p, &sm.bar[seg & 1]);
}

template <int kMaxK>
__global__ void __launch_bounds__(kThreads, Cfg<kMaxK>::kMinBlocks)
detect_kernel(const float* __restrict__ geom,
              const int8_t* __restrict__ allowed, int* __restrict__ out,
              int n_pad, int k, unsigned long long* launches) {
  using C = Cfg<kMaxK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  count_launch(launches);
  Shared<kMaxK>& sm = *reinterpret_cast<Shared<kMaxK>*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const float* g = geom + (size_t)blockIdx.y * 8 * n_pad;
  const int n_seg = n_pad / kSegment;
  const unsigned lanes_below = (1u << lane) - 1u;

  if (threadIdx.x == 0) {
    staging::init(&sm.bar[0]);
    staging::init(&sm.bar[1]);
    stage_segment(sm, g, n_pad, 0);
  }

  float xi[kRowsPerWarp][6], ri[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < 6; ++c) xi[r][c] = g[(size_t)c * n_pad + row0 + r];
    ri[r] = g[(size_t)6 * n_pad + row0 + r];
#pragma unroll
    for (int q = 0; q < C::kSlotsPerLane; ++q)
      sm.slot[warp][r][lane + 32 * q] = -1;
  }
  if (lane < kRowsPerWarp) {
    sm.count[warp][lane] = 0;
#pragma unroll
    for (int c = 0; c < 6; ++c)
      sm.row_geom[warp][lane][c] = g[(size_t)c * n_pad + row0 + lane];
  }

  for (int seg = 0; seg < n_seg; ++seg) {
    // the barriers' init is visible, and every warp is done with the
    // buffer the next segment goes into
    __syncthreads();
    if (threadIdx.x == 0 && seg + 1 < n_seg)
      stage_segment(sm, g, n_pad, seg + 1);
    staging::wait(&sm.bar[seg & 1], (seg >> 1) & 1);
    const float* sg = &sm.geom[seg & 1][0][0];
    const int col0 = seg * kSegment;
    // per-row bytes: slots the row still takes, list entries, and this
    // lane's hits in the segment (at most 16)
    unsigned keeps = 0, fills = 0, hits = 0;
    // bits 8u + r: of rows that still take slots; of pairs hit in the
    // segment by some lane
    unsigned taking = 0, seg_hits = 0;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int keep = max(k - sm.count[warp][r], 0);
      keeps |= (unsigned)keep << (8 * r);
      if (keep > 0) taking |= 0x01010101u << r;
    }
    // this lane's admissibility words: row r's at adm_w[r * n_pad / 4],
    // the next step's 32 words on
    const unsigned* adm_w = reinterpret_cast<const unsigned*>(
        allowed + (size_t)row0 * n_pad + col0) + lane;

#pragma unroll 1
    for (int c0 = lane * 4; c0 < kSegment;
         c0 += kColsPerStep, adm_w += kColsPerStep / 4) {
      float4 cg[kGeomRows];
#pragma unroll
      for (int c = 0; c < kGeomRows; ++c)
        cg[c] = *reinterpret_cast<const float4*>(sg + c * kSegment + c0);
      // bit 8u + r: pair (row0 + r, col0 + c0 + u) is admissible
      unsigned adm = 0;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const unsigned w = __ldg(adm_w + r * (n_pad / 4));
        // bit 7 of each byte > 0 as int8: low 7 bits nonzero, sign clear
        const unsigned pos =
            ((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) & ~w & 0x80808080u;
        adm |= pos >> (7 - r);
      }
      unsigned hm = 0;   // bit 8u + r: the pair hits
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float xj[6] = {lane_of(cg[0], u), lane_of(cg[1], u),
                             lane_of(cg[2], u), lane_of(cg[3], u),
                             lane_of(cg[4], u), lane_of(cg[5], u)};
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float d2 = pair_d2(xi[r], xj);
          const float reach = ri[r] + lane_of(cg[6], u);
          if (d2 < reach * reach) hm |= 1u << (8 * u + r);
        }
      }
      hm &= adm;
      if (!__any_sync(0xffffffffu, hm != 0)) continue;

      // hit path: count, then append each (row, column u) that some lane
      // hit to the row's list, one ballot each; operands are read again
      // from shared memory
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        hits += (unsigned)__popc((hm >> r) & 0x01010101u) << (8 * r);
      unsigned todo = __reduce_or_sync(0xffffffffu, hm);
      seg_hits |= todo;
      todo &= taking;
      while (todo) {
        const int b = __ffs(todo) - 1;
        todo &= todo - 1;
        const int r = b & 7, u = b >> 3;
        const bool hit = (hm >> b) & 1u;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        float* d2s = sm.cand_d2[warp][r];
        int* cols = sm.cand_col[warp][r];
        int fill = byte_of(fills, r);
        if (fill + __popc(m) > C::kCap)
          fill = keep_smallest<C::kRank>(d2s, cols, fill, byte_of(keeps, r),
                                         lane);
        if (hit) {
          float xr[6], xc[6];
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            xr[c] = sm.row_geom[warp][r][c];
            xc[c] = sg[c * kSegment + c0 + u];
          }
          const int e = fill + __popc(m & lanes_below);
          d2s[e] = pair_d2(xr, xc);
          cols[e] = col0 + c0 + u;
        }
        fill += __popc(m);
        fills = (fills & ~(0xFFu << (8 * r))) | ((unsigned)fill << (8 * r));
      }
    }

    // the segment's merge, for the rows with hits: min(hits, keep)
    // smallest after the held slots
    unsigned rows = seg_hits | seg_hits >> 8 | seg_hits >> 16 | seg_hits >> 24;
    rows &= (1u << kRowsPerWarp) - 1u;
    while (rows) {
      const int r = __ffs(rows) - 1;
      rows &= rows - 1;
      const int h = __reduce_add_sync(0xffffffffu, (int)byte_of(hits, r));
      const int count = sm.count[warp][r];
      const int keep = byte_of(keeps, r);
      int take = 0;
      if (keep > 0) {
        // fill >= min(h, keep): a list is only cut to keep entries
        take = keep_smallest<C::kRank>(sm.cand_d2[warp][r],
                                       sm.cand_col[warp][r],
                                       byte_of(fills, r), keep, lane);
#pragma unroll
        for (int q = 0; q < C::kSlotsPerLane; ++q) {
          const int s = lane + 32 * q - count;
          if (s >= 0 && s < take)
            sm.slot[warp][r][lane + 32 * q] = sm.cand_col[warp][r][s];
        }
      }
      __syncwarp();
      if (lane == 0) sm.count[warp][r] = count + take + max(h - k, 0);
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    int* o = out + ((size_t)blockIdx.y * n_pad + row0 + r) * (k + 1);
#pragma unroll
    for (int q = 0; q < C::kSlotsPerLane; ++q)
      if (lane + 32 * q < k) o[lane + 32 * q] = sm.slot[warp][r][lane + 32 * q];
    if (lane == 0) o[k] = sm.count[warp][r];
  }
}

}  // namespace

namespace {

template <int kMaxK>
int init_one() {
  const int smem = (int)sizeof(Shared<kMaxK>);
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      detect_kernel<kMaxK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
}

template <int kMaxK>
int launch(const float* geom, const int8_t* allowed, int* out, int B,
           int n_pad, int k, unsigned long long* launches, void* stream) {
  const int smem = (int)sizeof(Shared<kMaxK>);
  const dim3 grid(n_pad / kRowsPerBlock, B);
  detect_kernel<kMaxK><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      geom, allowed, out, n_pad, k, launches);
  return (int)cudaGetLastError();
}

}  // namespace

// Called once when the library is loaded: lets a launch use the kernel's
// shared memory (above the 48 KB default when it is larger), so that a
// launch, which may sit in a captured graph, sets no attribute.
extern "C" int selfcol_detect_init() {
  const int err = init_one<32>();
  return err != (int)cudaSuccess ? err : init_one<128>();
}

// geom (B, 8, n_pad) f32 rows [x, y, z, x+hv, y+hv, z+hv, r, pad], 16-byte
// aligned; allowed (n_pad, n_pad) int8, 16-byte aligned; out (B, n_pad,
// k + 1) int32, 1 <= k <= 127; launches the kernel's launch count (device
// memory, core/launch_count.py), one added per launch.  selfcol_detect_init
// must have run.  Returns the launch's cudaError_t.
extern "C" int selfcol_detect(const float* geom, const int8_t* allowed,
                              int* out, int B, int n_pad, int k,
                              unsigned long long* launches, void* stream) {
  if (!launches || B < 1 || B > 65535 || k < 1 || k > kLargestK ||
      n_pad < kSegment ||
      n_pad % kSegment || reinterpret_cast<uintptr_t>(geom) % 16 ||
      reinterpret_cast<uintptr_t>(allowed) % 16)
    return (int)cudaErrorInvalidValue;
  if (k <= 32)
    return launch<32>(geom, allowed, out, B, n_pad, k, launches, stream);
  return launch<128>(geom, allowed, out, B, n_pad, k, launches, stream);
}
