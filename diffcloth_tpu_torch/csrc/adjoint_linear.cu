// The adjoint's linearized K map: the per-row and per-particle Jacobians of
// a step's K(v) = b~(x_n + h v) + r(b~ - C v) at its v_new, made once per
// adjoint program, and the kernels of a fixed-point trip that apply their
// transpose (core/adjoint_linear.py).
//
// Replaces no TPU kernel: the JAX package (diffcloth_tpu/core/step.py
// :683-692) takes (dK/dv)^T u as `jax.vjp` of K, which XLA fuses into the
// trip's program.  The port used to recompute K under autograd for every
// trip (its dense products, projections and a forward friction sweep) and
// take `torch.autograd.grad` of it; these kernels apply the same transposed
// linearization from Jacobians saved once, with the constraint operators'
// GEMMs left to cuBLAS in full f32 (core/step.py, `kdv`).
//
//   kdv_linearize  per triangle the 6x6 Jacobian of the co-rotational
//                  projection (forward-mode, six unit tangents), per bending
//                  and spring row (y^, scale / |y|), per obstacle particle
//                  the 3x3 Jacobian of the dry friction at the step's frozen
//                  contact (take-off, stick or slide);
//   kdv_pre        g = e + J_obs^T (u + e), z = u + g, with e the friction
//                  sweep's transposed product less u (in f32, as autograd of
//                  the sweep's casts gives it), written in the layout the
//                  constraint GEMM reads;
//   kdv_rows       q_t = h^2 k_t (J_t^T (A_t z) - A_t g) per constraint row;
//   trip_update    the fixed point's masked convergence update: per episode
//                  |lam' - lam|, |lam'|, the done / bad / iteration flags and
//                  lam <- lam' where the episode is active.
//
// What bounds them on the H100: latency.  At the sphere's shapes (B = 16,
// n = 625, 1152 triangles) a trip's kernels move about 3 MB (the stretch
// Jacobians, 2.6 MB, are the bulk; they stay in the 50 MB L2) and do a few
// MFLOP: their byte bound is about a microsecond, below a launch.  Design:
// one thread per (item, episode), no shared memory but the update's
// reduction, coalesced along the items; templated on the simulation dtype
// (float or double), every product in it (no TF32, no tensor cores).
// Compiled with --fmad=false, so each product and sum rounds as in the
// plain PyTorch versions, which are written op for op in the same order.
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr double kEps = 1e-12;   // constraints.EPS, the safe_norm guard

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> ld3(const T* p) {
  return {p[0], p[1], p[2]};
}

template <typename T>
__device__ __forceinline__ void st3(T* p, V3<T> v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

template <typename T>
__device__ __forceinline__ V3<T> add(V3<T> a, V3<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

template <typename T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

template <typename T>
__device__ __forceinline__ V3<T> scale(V3<T> a, T s) {
  return {a.x * s, a.y * s, a.z * s};
}

template <typename T>
__device__ __forceinline__ V3<T> divide(V3<T> a, T s) {
  return {a.x / s, a.y / s, a.z / s};
}

// safe_norm: |v| where |v|^2 > eps^2, else eps
template <typename T>
__device__ __forceinline__ T safe_norm(T n2, bool* safe) {
  const T eps = (T)kEps;
  *safe = n2 > (T)(kEps * kEps);
  return *safe ? sqrt(n2) : eps;
}

// The 6x6 Jacobian of sw * corot_project_cols(a, b) (dense_ops.py) in
// (a, b): column j the forward-mode tangent of unit direction j.  J is
// written row-major, J[6 i + j] = d out_i / d in_j, out = (c0, c1) * sw.
template <typename T>
__device__ void corot_jacobian(V3<T> a, V3<T> b, T sw, T* J) {
  bool sa, sb;
  const T na = safe_norm(dot(a, a), &sa);
  const V3<T> q0 = divide(a, na);
  const T dq = dot(b, q0);
  const V3<T> bp = sub(b, scale(q0, dq));
  const T nb = safe_norm(dot(bp, bp), &sb);
  const V3<T> q1 = divide(bp, nb);
  const T tr = na + nb;
  const T rn = sqrt(tr * tr + dq * dq + (T)kEps);
  const V3<T> c0 = divide(sub(scale(q0, tr), scale(q1, dq)), rn);
  const V3<T> c1 = divide(add(scale(q0, dq), scale(q1, tr)), rn);
  for (int j = 0; j < 6; ++j) {
    const T one = (T)1, zero = (T)0;
    const V3<T> da = {j == 0 ? one : zero, j == 1 ? one : zero,
                      j == 2 ? one : zero};
    const V3<T> db = {j == 3 ? one : zero, j == 4 ? one : zero,
                      j == 5 ? one : zero};
    const T dna = sa ? dot(a, da) / na : zero;
    const V3<T> dq0 = divide(sub(da, scale(q0, dna)), na);
    const T ddq = dot(db, q0) + dot(b, dq0);
    const V3<T> dbp = sub(sub(db, scale(q0, ddq)), scale(dq0, dq));
    const T dnb = sb ? dot(bp, dbp) / nb : zero;
    const V3<T> dq1 = divide(sub(dbp, scale(q1, dnb)), nb);
    const T dtr = dna + dnb;
    const T drn = (tr * dtr + dq * ddq) / rn;
    const V3<T> t0 = sub(
        divide(sub(add(scale(dq0, tr), scale(q0, dtr)),
                   add(scale(dq1, dq), scale(q1, ddq))), rn),
        scale(c0, drn / rn));
    const V3<T> t1 = sub(
        divide(add(add(scale(dq0, dq), scale(q0, ddq)),
                   add(scale(dq1, tr), scale(q1, dtr))), rn),
        scale(c1, drn / rn));
    J[0 * 6 + j] = t0.x * sw;
    J[1 * 6 + j] = t0.y * sw;
    J[2 * 6 + j] = t0.z * sw;
    J[3 * 6 + j] = t1.x * sw;
    J[4 * 6 + j] = t1.y * sw;
    J[5 * 6 + j] = t1.z * sw;
  }
}

// (y^, c) of p = s y / |y|: dp/dy = c (I - y^ y^T); a degenerate row
// (|y| <= eps) has y^ = 0 and c = s / eps
template <typename T>
__device__ void unit_jacobian(V3<T> y, T s, T* out) {
  bool safe;
  const T en = safe_norm(dot(y, y), &safe);
  const V3<T> u = safe ? divide(y, en) : V3<T>{(T)0, (T)0, (T)0};
  out[0] = u.x;
  out[1] = u.y;
  out[2] = u.z;
  out[3] = s / en;
}

struct Strides {
  long long a, b, c;   // of the three leading logical dims
};

template <typename T>
struct LinArgs {
  const T* y;          // (B, R, 3) logical, strides (b, r)
  Strides ys;
  const T* tri_sw;     // (T,)
  const T* b_scale;    // (Bn,)
  const T* sp_l0;      // (S,)
  T* jac;              // (B, JW)
  int B, T_, Bn, F, S, split, JW;
  // obstacles (jobs null: none)
  int n, P;
  const T* f;          // (B, n, 3)
  const T* m;          // (B, n)
  const T* normal;     // (B, n, 3)
  const T* v_out;      // (B, n, 3)
  const unsigned char* mask;   // (B, n) bool
  const long long* prim_id;    // (B, n) int64
  const T* mu;         // (B, P)
  T* jobs;             // (B, n, 9), row-major 3x3
};

// dr/dd of contact.dry_friction_force at d = f - m v_out (the particle's
// frozen normal and coefficient): 0 off contact or on take-off, -I on
// stick, on slide
//   -n n^T - mu sgn(sd) t n^T - (mu |sd| / |fT|) (I - t t^T) (I - n n^T)
// (the t t^T term only where |fT| is above the guard, as safe_norm's
// derivative gives it)
template <typename T>
__device__ void obstacle_jacobian(V3<T> d, V3<T> nr, T mu, bool on, T* J) {
  for (int k = 0; k < 9; ++k) J[k] = (T)0;
  const T sd = dot(d, nr);
  if (!on || !(sd < (T)0)) return;
  const V3<T> fT = sub(d, scale(nr, sd));
  bool safe;
  const T tn = safe_norm(dot(fT, fT), &safe);
  const V3<T> th = divide(fT, tn);
  const T slide = mu * fabs(sd);
  if (tn <= slide) {
    J[0] = J[4] = J[8] = (T)-1;
    return;
  }
  const T sg = sd > (T)0 ? (T)1 : (sd < (T)0 ? (T)-1 : (T)0);
  const T c = slide / tn;
  const T n_[3] = {nr.x, nr.y, nr.z}, t_[3] = {th.x, th.y, th.z};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      // (I - t t^T)(I - n n^T), entry (i, j)
      T pij = (i == j ? (T)1 : (T)0) - n_[i] * n_[j];
      if (safe) {
        T tp = (T)0;    // (t^T (I - n n^T))_j
        for (int k = 0; k < 3; ++k)
          tp = tp + t_[k] * ((k == j ? (T)1 : (T)0) - n_[k] * n_[j]);
        pij = pij - t_[i] * tp;
      }
      J[3 * i + j] = (-(n_[i] * n_[j]) - (mu * sg) * (t_[i] * n_[j])) -
                     c * pij;
    }
  }
}

template <typename T>
__global__ void linearize_kernel(LinArgs<T> a, unsigned long long* count) {
  count_launch(count);
  const int b = blockIdx.y;
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  const int T_ = a.T_, Bn = a.Bn, S = a.S;
  T* jac = a.jac + (long long)b * a.JW;
  const T* yb = a.y + (long long)b * a.ys.a;
  auto row = [&](int r) { return ld3(yb + (long long)r * a.ys.b); };
  if (item < T_) {
    const int ra = a.split ? item : 2 * item;
    const int rb = a.split ? T_ + item : 2 * item + 1;
    corot_jacobian(row(ra), row(rb), a.tri_sw[item], jac + 36 * item);
  } else if (item < T_ + Bn) {
    const int r = item - T_;
    unit_jacobian(row(2 * T_ + r), a.b_scale[r], jac + 36 * T_ + 4 * r);
  } else if (item < T_ + Bn + S) {
    const int r = item - T_ - Bn;
    unit_jacobian(row(2 * T_ + Bn + a.F + r), a.sp_l0[r],
                  jac + 36 * T_ + 4 * Bn + 4 * r);
  } else if (a.jobs && item < T_ + Bn + S + a.n) {
    const int i = item - T_ - Bn - S;
    const long long p = (long long)b * a.n + i;
    const V3<T> f = ld3(a.f + 3 * p), vo = ld3(a.v_out + 3 * p);
    const T m = a.m[p];
    const V3<T> d = sub(f, scale(vo, m));
    const T mu = a.mu[(long long)b * a.P + a.prim_id[p]];
    obstacle_jacobian(d, ld3(a.normal + 3 * p), mu, a.mask[p] != 0,
                      a.jobs + 9 * p);
  }
}

template <typename T>
__global__ void pre_kernel(const T* __restrict__ u, const float* __restrict__ s,
                           const T* __restrict__ jobs, T* __restrict__ zg,
                           Strides zs, int H, int B, int n,
                           unsigned long long* count) {
  count_launch(count);
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long p = (long long)b * n + i;
  const V3<T> uu = ld3(u + 3 * p);
  V3<T> e = {(T)0, (T)0, (T)0};
  if (s) {
    // autograd of the sweep's casts: (s - u_f32) in f32, then the dtype
    const V3<float> ss = ld3(s + 3 * p);
    e = {(T)(ss.x - (float)uu.x), (T)(ss.y - (float)uu.y),
         (T)(ss.z - (float)uu.z)};
  }
  V3<T> g = e;
  if (jobs) {
    const V3<T> v = add(uu, e);
    const T* J = jobs + 9 * p;
    const V3<T> jt = {J[0] * v.x + J[3] * v.y + J[6] * v.z,
                      J[1] * v.x + J[4] * v.y + J[7] * v.z,
                      J[2] * v.x + J[5] * v.y + J[8] * v.z};
    g = add(e, jt);
  }
  T* z = zg + (long long)i * zs.c + (long long)b * zs.b;
  st3(z, add(uu, g));
  if (H == 2) st3(z + zs.a, g);
}

template <typename T>
__global__ void rows_kernel(const T* __restrict__ y, Strides ys,
                            const T* __restrict__ jac, const T* __restrict__ k,
                            T h2, T* __restrict__ q, Strides qs, int H, int B,
                            int T_, int Bn, int F, int S, int split,
                            int JW, unsigned long long* count) {
  count_launch(count);
  const int b = blockIdx.y;
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  const T* yz = y + (long long)b * ys.b;
  const T* jb = jac + (long long)b * JW;
  T* qb = q + (long long)b * qs.a;
  auto z_of = [&](int r) { return ld3(yz + (long long)r * ys.c); };
  auto g_of = [&](int r) {
    return H == 2 ? ld3(yz + ys.a + (long long)r * ys.c)
                  : V3<T>{(T)0, (T)0, (T)0};
  };
  auto put = [&](int r, V3<T> v) { st3(qb + (long long)r * qs.b, v); };
  if (item < T_) {
    const int ra = split ? item : 2 * item;
    const int rb = split ? T_ + item : 2 * item + 1;
    const V3<T> za = z_of(ra), zb = z_of(rb);
    const T in[6] = {za.x, za.y, za.z, zb.x, zb.y, zb.z};
    const T* J = jb + 36 * item;
    T out[6];
    for (int j = 0; j < 6; ++j) {
      T acc = J[j] * in[0];
      for (int i = 1; i < 6; ++i) acc = acc + J[6 * i + j] * in[i];
      out[j] = acc;
    }
    const T kh = h2 * k[4 * b + 2];
    const V3<T> ga = g_of(ra), gb = g_of(rb);
    put(ra, scale(sub(V3<T>{out[0], out[1], out[2]}, ga), kh));
    put(rb, scale(sub(V3<T>{out[3], out[4], out[5]}, gb), kh));
  } else if (item < T_ + Bn + S) {
    const bool bend = item < T_ + Bn;
    const int r = bend ? 2 * T_ + (item - T_)
                       : 2 * T_ + Bn + F + (item - T_ - Bn);
    const T* c = jb + 36 * T_ + 4 * (item - T_);
    const V3<T> z = z_of(r), uh = {c[0], c[1], c[2]};
    const V3<T> jz = scale(sub(z, scale(uh, dot(uh, z))), c[3]);
    const T kh = h2 * k[4 * b + (bend ? 3 : 0)];
    put(r, scale(sub(jz, g_of(r)), kh));
  } else if (item < T_ + Bn + S + F) {
    const int r = 2 * T_ + Bn + (item - T_ - Bn - S);
    const T kh = h2 * k[4 * b + 1];
    const V3<T> g = g_of(r);
    put(r, scale(V3<T>{-g.x, -g.y, -g.z}, kh));
  }
}

constexpr int kUpdateThreads = 256;

template <typename T>
__device__ T block_sum(T v, T* part) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  T s = (T)0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kUpdateThreads / 32; ++w) s = s + part[w];
  return s;     // on thread 0
}

template <typename T>
__global__ void update_kernel(T* __restrict__ lam, const T* __restrict__ nxt,
                              Strides ns, const T* __restrict__ w_norm,
                              int* __restrict__ it, bool* __restrict__ done,
                              bool* __restrict__ bad, bool* __restrict__ go,
                              T eps, T nh, int n, unsigned long long* count) {
  count_launch(count);
  __shared__ T part[2][kUpdateThreads / 32];
  __shared__ bool act_s;
  const int b = blockIdx.x;
  const bool act = !(done[b] || bad[b]);
  T* lb = lam + (long long)b * n * 3;
  const T* nb = nxt + (long long)b * ns.a;
  T s1 = (T)0, s2 = (T)0;
  for (int e = threadIdx.x; e < 3 * n; e += kUpdateThreads) {
    const int i = e / 3, c = e - 3 * i;
    const T x = nb[(long long)i * ns.b + c];
    const T d = x - lb[e];
    s1 = s1 + d * d;
    s2 = s2 + x * x;
  }
  s1 = block_sum(s1, part[0]);
  s2 = block_sum(s2, part[1]);
  if (threadIdx.x == 0) {
    const T delta = sqrt(s1) / nh;
    const bool bad_k = !isfinite(delta) ||
                       sqrt(s2) > (T)1e8 * (w_norm[b] + (T)1e-30);
    if (act) {
      it[b] += 1;
      done[b] = delta < eps;
      bad[b] = bad_k;
    }
    go[b] = !(done[b] || bad[b]);
    act_s = act;
  }
  __syncthreads();
  if (!act_s) return;
  for (int e = threadIdx.x; e < 3 * n; e += kUpdateThreads) {
    const int i = e / 3, c = e - 3 * i;
    lb[e] = nb[(long long)i * ns.b + c];
  }
}

constexpr int kThreads = 128;

dim3 grid_of(int items, int B) {
  return dim3((unsigned)((items + kThreads - 1) / kThreads), (unsigned)B);
}

template <typename T>
int launch_linearize(const LinArgs<T>& a, unsigned long long* count,
                     cudaStream_t s) {
  const int items = a.T_ + a.Bn + a.S + (a.jobs ? a.n : 0);
  if (items > 0)
    linearize_kernel<T><<<grid_of(items, a.B), kThreads, 0, s>>>(a, count);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y: the rows (B, R, 3) at x_n + h v_new, strides (batch, row) in elements;
// jac (B, 36 T + 4 Bn + 4 S); jobs null for a step without obstacles
int kdv_linearize(int f64, const void* y, long long y_sb, long long y_sr,
                  const void* tri_sw, const void* b_scale, const void* sp_l0,
                  int B, int T_, int Bn, int F, int S, int split, void* jac,
                  int n, int P, const void* f, const void* m,
                  const void* normal, const void* v_out, const void* mask,
                  const void* prim_id, const void* mu, void* jobs,
                  unsigned long long* count, void* stream) {
  if (!count || B < 1 || T_ < 0 || Bn < 0 || F < 0 || S < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  const int JW = 36 * T_ + 4 * Bn + 4 * S;
  const Strides ys = {y_sb, y_sr, 0};
  cudaStream_t s = (cudaStream_t)stream;
#define KDV_ARGS(T)                                                          \
  LinArgs<T> a = {(const T*)y, ys, (const T*)tri_sw, (const T*)b_scale,      \
                  (const T*)sp_l0, (T*)jac, B, T_, Bn, F, S, split, JW, n,   \
                  P, (const T*)f, (const T*)m, (const T*)normal,             \
                  (const T*)v_out, (const unsigned char*)mask,               \
                  (const long long*)prim_id, (const T*)mu, (T*)jobs};
  if (f64) {
    KDV_ARGS(double)
    return launch_linearize(a, count, s);
  }
  KDV_ARGS(float)
  return launch_linearize(a, count, s);
#undef KDV_ARGS
}

// u (B, n, 3) contiguous; s (B, n, 3) f32 or null; jobs (B, n, 9) or null;
// zg the (H, B, n, 3) logical output, strides (half, batch, particle)
int kdv_pre(int f64, const void* u, const void* s, const void* jobs, void* zg,
            long long z_sh, long long z_sb, long long z_sn, int H, int B,
            int n, unsigned long long* count, void* stream) {
  if (!count || B < 1 || n < 1 || (H != 1 && H != 2))
    return (int)cudaErrorInvalidValue;
  const Strides zs = {z_sh, z_sb, z_sn};
  const dim3 grid = grid_of(n, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    pre_kernel<double><<<grid, kThreads, 0, st>>>(
        (const double*)u, (const float*)s, (const double*)jobs, (double*)zg,
        zs, H, B, n, count);
  else
    pre_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)u, (const float*)s, (const float*)jobs, (float*)zg, zs,
        H, B, n, count);
  return (int)cudaGetLastError();
}

// y the (H, B, R, 3) logical rows of [z | g], strides (half, batch, row);
// k (B, 4) contiguous; q the (B, R, 3) logical output, strides (batch, row)
int kdv_rows(int f64, const void* y, long long y_sh, long long y_sb,
             long long y_sr, const void* jac, const void* k, double h2,
             void* q, long long q_sb, long long q_sr, int H, int B, int T_,
             int Bn, int F, int S, int split, unsigned long long* count,
             void* stream) {
  if (!count || B < 1 || (H != 1 && H != 2))
    return (int)cudaErrorInvalidValue;
  const int items = T_ + Bn + S + F;
  if (items == 0) return 0;
  const int JW = 36 * T_ + 4 * Bn + 4 * S;
  const Strides ys = {y_sh, y_sb, y_sr}, qs = {q_sb, q_sr, 0};
  const dim3 grid = grid_of(items, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    rows_kernel<double><<<grid, kThreads, 0, st>>>(
        (const double*)y, ys, (const double*)jac, (const double*)k, h2,
        (double*)q, qs, H, B, T_, Bn, F, S, split, JW, count);
  else
    rows_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)y, ys, (const float*)jac, (const float*)k, (float)h2,
        (float*)q, qs, H, B, T_, Bn, F, S, split, JW, count);
  return (int)cudaGetLastError();
}

// lam (B, n, 3) contiguous, updated in place; nxt (B, n, 3) logical,
// strides (batch, particle), its last stride 1; it int32, done / bad / go
// bool, each (B,)
int trip_update(int f64, void* lam, const void* nxt, long long n_sb,
                long long n_sn, const void* w_norm, void* it, void* done,
                void* bad, void* go, double eps, double nh, int B, int n,
                unsigned long long* count, void* stream) {
  if (!count || B < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const Strides ns = {n_sb, n_sn, 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    update_kernel<double><<<B, kUpdateThreads, 0, st>>>(
        (double*)lam, (const double*)nxt, ns, (const double*)w_norm,
        (int*)it, (bool*)done, (bool*)bad, (bool*)go, eps, nh, n, count);
  else
    update_kernel<float><<<B, kUpdateThreads, 0, st>>>(
        (float*)lam, (const float*)nxt, ns, (const float*)w_norm, (int*)it,
        (bool*)done, (bool*)bad, (bool*)go, (float)eps, (float)nh, n,
        count);
  return (int)cudaGetLastError();
}

}  // extern "C"
