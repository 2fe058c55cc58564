// Batched least squares min |b - H y| for the adjoint's GMRES cycles: the
// port's counterpart of `jnp.linalg.lstsq` on the (M+1, M) Hessenberg
// (diffcloth_tpu/core/step.py:136), which the JAX package computes with a
// library call inside its jitted cycle.  PyTorch's SVD and least-squares
// routines on the card read results back to the host (and so cannot sit in
// a captured graph), hence this kernel.
//
// One block per episode, in f64 whatever the input type: a one-sided
// (Hestenes) Jacobi SVD of H in shared memory, then the truncated-SVD
// solution with the cutoff of gelsd / jnp.linalg.lstsq: singular values at
// or below rcond * sigma_max are dropped.  Columns are rotated in pairs,
// one warp per pair and one lane per row, in round-robin order (every pair
// once per sweep); sweeps repeat until none rotates.  An episode whose H or
// b holds a non-finite value gets y = NaN.
#include <cuda_runtime.h>

#include <cmath>

#include "launch_count.cuh"

namespace {

constexpr int kMax = 32;        // rows and (padded) columns at most
constexpr int kMaxSweeps = 60;
constexpr double kTol = 1e-15;  // relative size of a column pair's product
// a column of squared norm below kTiny |H|_F^2 is rounding noise of a rank
// deficiency (a happy breakdown): it is not rotated, so the sweeps end
constexpr double kTiny = 1e-32;

__device__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// position idx of round r of a round-robin over c2 players: player 0 stays,
// the others rotate
__device__ int player(int idx, int r, int c2) {
  return idx == 0 ? 0 : 1 + (idx - 1 + r) % (c2 - 1);
}

template <typename T>
__global__ void lstsq_kernel(const T* __restrict__ H, const T* __restrict__ b,
                             T* __restrict__ y, int rows, int cols,
                             double rcond, unsigned long long* launches) {
  count_launch(launches);
  __shared__ double A[kMax][kMax];   // A[column][row]
  __shared__ double V[kMax][kMax];   // V[column][row]
  __shared__ double rhs[kMax];
  __shared__ double sig[kMax], coef[kMax];
  __shared__ double part[kMax];
  const int ep = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int c2 = (cols + 1) & ~1;
  const T* h = H + (size_t)ep * rows * cols;
  int bad = 0;
  double sq = 0.0;
  for (int i = threadIdx.x; i < kMax * kMax; i += blockDim.x) {
    const int c = i / kMax, r = i % kMax;
    double a = 0.0;
    if (c < cols && r < rows) {
      a = (double)h[r * cols + c];
      bad |= !isfinite(a);
    }
    A[c][r] = a;
    sq += a * a;
    V[c][r] = (c == r && c < c2) ? 1.0 : 0.0;
  }
  if (threadIdx.x < kMax) {
    double v = 0.0;
    if (threadIdx.x < rows) {
      v = (double)b[(size_t)ep * rows + threadIdx.x];
      bad |= !isfinite(v);
    }
    rhs[threadIdx.x] = v;
  }
  sq = warp_sum(sq);
  if (lane == 0) part[warp] = sq;
  if (__syncthreads_or(bad)) {
    if (threadIdx.x < cols) y[(size_t)ep * cols + threadIdx.x] = (T)NAN;
    return;
  }
  double frob2 = 0.0;
  for (int w = 0; w < n_warps; ++w) frob2 += part[w];
  const double tiny = kTiny * frob2;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    int rotated = 0;
    for (int r = 0; r < c2 - 1; ++r) {
      if (warp < c2 / 2) {
        const int p = player(warp, r, c2), q = player(c2 - 1 - warp, r, c2);
        const double ap = A[p][lane], aq = A[q][lane];
        const double alpha = warp_sum(ap * ap), beta = warp_sum(aq * aq);
        const double gamma = warp_sum(ap * aq);
        const double zeta = (beta - alpha) / (2.0 * gamma);
        const double t =
            copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
        if (fmin(alpha, beta) > tiny && fabs(gamma) > kTol * sqrt(alpha * beta)
            && t != 0.0) {
          const double c = 1.0 / sqrt(1.0 + t * t), s = c * t;
          A[p][lane] = c * ap - s * aq;
          A[q][lane] = s * ap + c * aq;
          const double vp = V[p][lane], vq = V[q][lane];
          V[p][lane] = c * vp - s * vq;
          V[q][lane] = s * vp + c * vq;
          rotated = 1;
        }
      }
      __syncthreads();
    }
    if (!__syncthreads_or(rotated)) break;
  }
  // sigma_c = |A_c|; the solution sums (u_c . b / sigma_c) v_c over the
  // columns above the cutoff, u_c = A_c / sigma_c
  for (int c = warp; c < c2; c += n_warps) {
    const double a = A[c][lane];
    const double s2 = warp_sum(a * a), ub = warp_sum(a * rhs[lane]);
    if (lane == 0) {
      sig[c] = sqrt(s2);
      coef[c] = s2 > 0.0 ? ub / s2 : 0.0;
    }
  }
  __syncthreads();
  if (threadIdx.x < cols) {
    double smax = 0.0;
    for (int c = 0; c < c2; ++c) smax = fmax(smax, sig[c]);
    const double cut = rcond * smax;
    double acc = 0.0;
    for (int c = 0; c < c2; ++c)
      if (sig[c] > cut) acc += coef[c] * V[c][threadIdx.x];
    y[(size_t)ep * cols + threadIdx.x] = (T)acc;
  }
}

}  // namespace

// H (B, rows, cols) and b (B, rows), row-major, f32 (f64 = 0) or f64 (f64 =
// 1); y (B, cols) of the same type.  rows, cols <= 32.  launches: the
// kernel's launch count (device memory, core/launch_count.py), one added
// per launch.  Returns the launch's cudaError_t.
extern "C" int hessenberg_lstsq(const void* H, const void* b, void* y, int B,
                                int rows, int cols, int f64, double rcond,
                                unsigned long long* launches, void* stream) {
  if (!launches || B < 1 || rows < 1 || cols < 1 || rows > kMax ||
      cols > kMax)
    return (int)cudaErrorInvalidValue;
  const int threads = 16 * ((cols + 1) & ~1);   // a warp per column pair
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    lstsq_kernel<double><<<B, threads, 0, s>>>(
        (const double*)H, (const double*)b, (double*)y, rows, cols, rcond,
        launches);
  else
    lstsq_kernel<float><<<B, threads, 0, s>>>(
        (const float*)H, (const float*)b, (float*)y, rows, cols, rcond,
        launches);
  return (int)cudaGetLastError();
}
