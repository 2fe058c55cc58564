// Per-slot dry-friction math shared by the forward and backward sweeps
// (csrc/friction_fwd.cu, csrc/friction_bwd.cu): the Signorini-Coulomb
// take-off / stick / slide split with mu = 0.1 (friction_pallas.py
// `_fric_cases`, `_dff_T`, `_dff_JT`), op for op as the plain PyTorch
// versions in core/friction_cuda.py compute it: three-term sums left to
// right, and the kernels are compiled with --fmad=false.
#pragma once
#include <math.h>

namespace friction {

constexpr float kMu = 0.1f;     // cloth-cloth friction (Simulation.cpp:666)
constexpr float kEps = 1e-12f;  // safe_norm guard (constraints.EPS)

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
