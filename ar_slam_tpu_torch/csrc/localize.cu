// K5: the pose-only LM of localize, every iteration inside one kernel.
//
// Replaces no Pallas kernel.  The JAX package runs localization as one
// jitted program whose lax.while_loop iterates on the device
// (ar_slam_tpu/solve/localize.py localize_kernel); the port stepped the
// same loop from the host, one replay of a chain of some hundred small
// PyTorch kernels (two jet residual passes, a batched product, a batched
// solve, the trust-region update) and one blocking flag read an
// iteration.  Here the loop runs on the card, from the state
// localize_init returns, to the same stopping tests.
//
// Bound on the H100: latency, not bytes or operations.  A call reads a
// few KB (4 queries of at most 16 blocks of 8 residuals, 6 unknowns a
// query) and does a few hundred thousand operations over ~20 iterations;
// what costs is each iteration's chain of dependent steps.  So the
// design keeps everything of a query in one block and on chip:
//
//   one block per query (the queries are independent: each freezes on its
//   own convergence flag, as in the torch loop);
//   one thread per (tag block, corner), striding when K * 4 exceeds the
//   block: a thread projects its corner with a forward-mode dual number of
//   6 tangents, arithmetic op for op core/projection.py project_corners
//   (the series branches of axis_angle_rotate, the sign-preserving depth
//   clamp, the optional radial terms); padded tag blocks add exact zeros;
//   the 21 unique entries of J^T J, the 6 of J^T r and the cost reduced by
//   warp shuffles and one shared-memory pass;
//   thread 0 solves the damped 6x6 system by LU with partial pivoting and
//   runs the acceptance, the damping update and the three-way exit of
//   solve/localize.py localize_iteration, term for term; a singular or
//   non-finite system gives a rejected step, as the torch stage's NaN
//   does;
//   a values-only pass at the proposal gives the new cost; the model's
//   sum (J step)^2 uses the Jacobian kept in registers (a thread's first
//   corner; a later stride recomputes it, bit for bit the same).
//
// Launch rules: runs on the caller's stream, allocates nothing, updates
// pose, lam, nu, cost, it and conv in place, returns the launch error.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSums = 28;  // J^T J's upper triangle (21), J^T r (6), cost

// a value and its derivatives with respect to the query's 6 pose unknowns
// (core/jet.py's Jet with n = 6)
template <typename T>
struct Jet {
  T v;
  T d[6];
};

template <typename T>
struct Id {
  typedef T type;
};

#define JET_LOOP _Pragma("unroll") for (int i = 0; i < 6; ++i)

template <typename T>
__device__ __forceinline__ T val(T x) { return x; }
template <typename T>
__device__ __forceinline__ T val(const Jet<T>& x) { return x.v; }

template <typename T>
__device__ __forceinline__ void set_const(T& x, T v) { x = v; }
template <typename T>
__device__ __forceinline__ void set_const(Jet<T>& x, T v) {
  x.v = v;
  JET_LOOP x.d[i] = T(0);
}

template <typename T>
__device__ __forceinline__ Jet<T> operator+(const Jet<T>& a, const Jet<T>& b) {
  Jet<T> r;
  r.v = a.v + b.v;
  JET_LOOP r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <typename T>
__device__ __forceinline__ Jet<T> operator+(const Jet<T>& a,
                                            typename Id<T>::type b) {
  Jet<T> r = a;
  r.v = a.v + b;
  return r;
}
template <typename T>
__device__ __forceinline__ Jet<T> operator+(typename Id<T>::type a,
                                            const Jet<T>& b) {
  Jet<T> r = b;
  r.v = a + b.v;
  return r;
}
template <typename T>
__device__ __forceinline__ Jet<T> operator-(const Jet<T>& a, const Jet<T>& b) {
  Jet<T> r;
  r.v = a.v - b.v;
  JET_LOOP r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <typename T>
__device__ __forceinline__ Jet<T> operator-(const Jet<T>& a,
                                            typename Id<T>::type b) {
  Jet<T> r = a;
  r.v = a.v - b;
  return r;
}
template <typename T>
__device__ __forceinline__ Jet<T> operator-(typename Id<T>::type a,
                                            const Jet<T>& b) {
  Jet<T> r;
  r.v = a - b.v;
  JET_LOOP r.d[i] = -b.d[i];
  return r;
}
template <typename T>
__device__ __forceinline__ Jet<T> operator*(const Jet<T>& a, const Jet<T>& b) {
  Jet<T> r;
  r.v = a.v * b.v;
  JET_LOOP r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <typename T>
__device__ __forceinline__ Jet<T> operator*(const Jet<T>& a,
                                            typename Id<T>::type b) {
  Jet<T> r;
  r.v = a.v * b;
  JET_LOOP r.d[i] = a.d[i] * b;
  return r;
}
template <typename T>
__device__ __forceinline__ Jet<T> operator*(typename Id<T>::type a,
                                            const Jet<T>& b) {
  Jet<T> r;
  r.v = a * b.v;
  JET_LOOP r.d[i] = a * b.d[i];
  return r;
}
template <typename T>
__device__ __forceinline__ Jet<T> operator/(const Jet<T>& a, const Jet<T>& b) {
  Jet<T> r;
  r.v = a.v / b.v;
  JET_LOOP r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}
template <typename T>
__device__ __forceinline__ Jet<T> operator/(const Jet<T>& a,
                                            typename Id<T>::type b) {
  Jet<T> r;
  r.v = a.v / b;
  JET_LOOP r.d[i] = a.d[i] / b;
  return r;
}

template <typename T>
__device__ __forceinline__ T jsqrt(T x) { return sqrt(x); }
template <typename T>
__device__ __forceinline__ Jet<T> jsqrt(const Jet<T>& x) {
  Jet<T> r;
  r.v = sqrt(x.v);
  const T den = T(2) * r.v;
  JET_LOOP r.d[i] = x.d[i] / den;
  return r;
}
template <typename T>
__device__ __forceinline__ T jsin(T x) { return sin(x); }
template <typename T>
__device__ __forceinline__ Jet<T> jsin(const Jet<T>& x) {
  Jet<T> r;
  r.v = sin(x.v);
  const T c = cos(x.v);
  JET_LOOP r.d[i] = c * x.d[i];
  return r;
}
template <typename T>
__device__ __forceinline__ T jcos(T x) { return cos(x); }
template <typename T>
__device__ __forceinline__ Jet<T> jcos(const Jet<T>& x) {
  Jet<T> r;
  r.v = cos(x.v);
  const T s = -sin(x.v);
  JET_LOOP r.d[i] = s * x.d[i];
  return r;
}

// R(aa) p = p cos t + (aa x p) sin(t)/t + aa (aa . p) (1 - cos t)/t^2, each
// ratio on its series below theta^2 = 1e-12 (core/lie.py axis_angle_rotate)
template <typename T, typename N>
__device__ __forceinline__ void rotate(const N aa[3], const N p[3], N out[3]) {
  const N t2 = aa[0] * aa[0] + aa[1] * aa[1] + aa[2] * aa[2];
  N cos_t, sinc, omc;
  if (val(t2) < T(1e-12)) {
    cos_t = T(1) - t2 / T(2) + t2 * t2 / T(24);
    sinc = T(1) - t2 / T(6) + t2 * t2 / T(120);
    omc = T(0.5) - t2 / T(24) + t2 * t2 / T(720);
  } else {
    const N th = jsqrt(t2);
    const N c = jcos(th);
    cos_t = c;
    sinc = jsin(th) / th;
    omc = (T(1) - c) / t2;
  }
  const N dot = aa[0] * p[0] + aa[1] * p[1] + aa[2] * p[2];
  const N cr[3] = {aa[1] * p[2] - aa[2] * p[1], aa[2] * p[0] - aa[0] * p[2],
                   aa[0] * p[1] - aa[1] * p[0]};
  const N w = dot * omc;
#pragma unroll
  for (int j = 0; j < 3; ++j) out[j] = p[j] * cos_t + cr[j] * sinc + aa[j] * w;
}

// the (x, y) residual of one corner of one tag block at the capture's
// inverse pose (values, or jets of the 6 unknowns): project_corners and
// block_residual of core/projection.py
template <typename T, typename N, bool kDist>
__device__ __forceinline__ void corner_residual(const T* cam, const N pose[6],
                                                const T* tag, T hx, T hy,
                                                T ox, T oy, N& rx, N& ry) {
  const T ta[3] = {tag[3], tag[4], tag[5]};
  const T pl[3] = {hx, hy, T(0)};
  T w[3];
  rotate<T, T>(ta, pl, w);
  const N pw[3] = {w[0] + tag[0] + pose[0], w[1] + tag[1] + pose[1],
                   w[2] + tag[2] + pose[2]};
  const N aa[3] = {pose[3], pose[4], pose[5]};
  N c[3];
  rotate<T, N>(aa, pw, c);
  // sign-preserving depth clamp (torch.where over float32 constants)
  N z = c[2];
  const T zv = val(z);
  if (fabs(zv) < T(1e-9)) set_const(z, zv < T(0) ? -T(1e-9f) : T(1e-9f));
  N x = c[0] / z;
  N y = c[1] / z;
  if (kDist) {
    const N r2 = x * x + y * y;
    const N f = T(1) + r2 * (cam[1] + cam[2] * r2);
    x = x * f;
    y = y * f;
  }
  rx = cam[0] * x - ox;
  ry = cam[0] * y - oy;
}

// sums v over the block: the total in thread 0's v
template <typename T, int kN>
__device__ __forceinline__ void block_sum(T* v, T (*sh)[kSums]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int n = 0; n < kN; ++n) v[n] += __shfl_down_sync(kFull, v[n], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < kN; ++n) sh[warp][n] = v[n];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      T s = sh[0][n];
      for (int w = 1; w < kWarps; ++w) s += sh[w][n];
      v[n] = s;
    }
  }
}

// x = A^-1 b by LU with partial pivoting (the first largest pivot of a
// column); false where a pivot is exactly zero
template <typename T>
__device__ bool lu_solve(T a[6][6], T b[6], T x[6]) {
  bool ok = true;
  for (int j = 0; j < 6; ++j) {
    int p = j;
    T m = fabs(a[j][j]);
    for (int i = j + 1; i < 6; ++i) {
      if (fabs(a[i][j]) > m) {
        m = fabs(a[i][j]);
        p = i;
      }
    }
    if (p != j) {
      for (int c = 0; c < 6; ++c) {
        const T t = a[j][c];
        a[j][c] = a[p][c];
        a[p][c] = t;
      }
      const T t = b[j];
      b[j] = b[p];
      b[p] = t;
    }
    if (a[j][j] == T(0)) ok = false;
    for (int i = j + 1; i < 6; ++i) {
      const T l = a[i][j] / a[j][j];
      for (int c = j + 1; c < 6; ++c) a[i][c] -= l * a[j][c];
      b[i] -= l * b[j];
    }
  }
  for (int i = 5; i >= 0; --i) {
    T s = b[i];
    for (int c = i + 1; c < 6; ++c) s -= a[i][c] * x[c];
    x[i] = s / a[i][i];
  }
  return ok;
}

template <typename T>
struct Config {
  T half;  // half the tag side
  T mrd, ftol, ptol, min_lam, max_lam, stall;
  int max_it;
};

// one block per query: its LM from localize_init's state to convergence or
// max_iterations
template <typename T, bool kDist>
__global__ void __launch_bounds__(kThreads)
    localize_lm(const T* __restrict__ camera, const T* __restrict__ corners,
                const T* __restrict__ tps, const T* __restrict__ maskf,
                T* pose, T* lam, T* nu, T* cost, long long* it,
                unsigned char* conv, int k, Config<T> cfg) {
  __shared__ T sh[kWarps][kSums];
  __shared__ T s_pose[6], s_new[6], s_step[6];
  __shared__ T s_cost, s_lam, s_nu;
  __shared__ long long s_it;
  __shared__ int s_conv;
  const int q = blockIdx.x, tid = threadIdx.x;
  const T cam[3] = {camera[0], camera[1], camera[2]};
  const T* crn = corners + (size_t)q * k * 8;
  const T* tag = tps + (size_t)q * k * 6;
  const T* mask = maskf + (size_t)q * k;
  if (tid == 0) {
    for (int i = 0; i < 6; ++i) s_pose[i] = pose[q * 6 + i];
    s_cost = cost[q];
    s_lam = lam[q];
    s_nu = nu[q];
    s_it = it[q];
    s_conv = conv[q] != 0;
  }
  __syncthreads();
  const int items = 4 * k;
  T jc[2][6];  // the Jacobian rows of this thread's first corner
  T g[6], step[6], new_pose[6];  // thread 0's
  bool ok = true;                // thread 0's: the step is finite
  Jet<T> jp[6];  // the pose as the 6 unknowns (core/jet.py variables)
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    jp[i].v = s_pose[i];
#pragma unroll
    for (int j = 0; j < 6; ++j) jp[i].d[j] = T(i == j);
  }
  while (!s_conv && s_it < cfg.max_it) {
    // the residuals' normal equations at the current pose
    T acc[kSums];
#pragma unroll
    for (int n = 0; n < kSums; ++n) acc[n] = T(0);
    for (int item = tid, s = 0; item < items; item += kThreads, ++s) {
      const int b = item >> 2, c = item & 3;
      if (!(mask[b] > T(0))) continue;
      const T sx = (c == 1 || c == 2) ? T(1) : T(-1);
      const T sy = (c >= 2) ? T(1) : T(-1);
      Jet<T> rx, ry;
      corner_residual<T, Jet<T>, kDist>(cam, jp, tag + b * 6, sx * cfg.half,
                                        sy * cfg.half, crn[b * 8 + 2 * c],
                                        crn[b * 8 + 2 * c + 1], rx, ry);
      if (s == 0) {
        JET_LOOP {
          jc[0][i] = rx.d[i];
          jc[1][i] = ry.d[i];
        }
      }
      int n = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int e = a; e < 6; ++e, ++n)
          acc[n] += rx.d[a] * rx.d[e] + ry.d[a] * ry.d[e];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += rx.d[a] * rx.v + ry.d[a] * ry.v;
      acc[27] += rx.v * rx.v + ry.v * ry.v;
    }
    block_sum<T, kSums>(acc, sh);
    if (tid == 0) {
      // the damped system h + lam diag(clamp(diag h, 1e-6, 1e32))
      T a[6][6], rhs[6];
      int n = 0;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
#pragma unroll
        for (int e = r; e < 6; ++e, ++n) a[r][e] = a[e][r] = acc[n];
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        const T hd = a[r][r];
        const T dd = hd < T(1e-6) ? T(1e-6) : (hd > T(1e32) ? T(1e32) : hd);
        a[r][r] = hd + s_lam * dd;
        g[r] = acc[21 + r];
        rhs[r] = g[r];
      }
      T x[6];
      ok = lu_solve(a, rhs, x);
      for (int r = 0; r < 6; ++r) {
        step[r] = -x[r];
        ok = ok && isfinite(step[r]);
        new_pose[r] = s_pose[r] + step[r];
        s_step[r] = step[r];
        s_new[r] = new_pose[r];
      }
    }
    __syncthreads();
    // the cost at the proposal and the model's sum (J step)^2
    T acc2[2] = {T(0), T(0)};
    for (int item = tid, s = 0; item < items; item += kThreads, ++s) {
      const int b = item >> 2, c = item & 3;
      if (!(mask[b] > T(0))) continue;
      const T sx = (c == 1 || c == 2) ? T(1) : T(-1);
      const T sy = (c >= 2) ? T(1) : T(-1);
      const T hx = sx * cfg.half, hy = sy * cfg.half;
      const T ox = crn[b * 8 + 2 * c], oy = crn[b * 8 + 2 * c + 1];
      T nx, ny;
      corner_residual<T, T, kDist>(cam, s_new, tag + b * 6, hx, hy, ox, oy,
                                   nx, ny);
      T jx[6], jy[6];
      if (s == 0) {
        JET_LOOP {
          jx[i] = jc[0][i];
          jy[i] = jc[1][i];
        }
      } else {
        Jet<T> rx, ry;
        corner_residual<T, Jet<T>, kDist>(cam, jp, tag + b * 6, hx, hy, ox,
                                          oy, rx, ry);
        JET_LOOP {
          jx[i] = rx.d[i];
          jy[i] = ry.d[i];
        }
      }
      T sx2 = T(0), sy2 = T(0);
      JET_LOOP {
        sx2 += jx[i] * s_step[i];
        sy2 += jy[i] * s_step[i];
      }
      acc2[0] += nx * nx + ny * ny;
      acc2[1] += sx2 * sx2 + sy2 * sy2;
    }
    block_sum<T, 2>(acc2, sh);
    if (tid == 0) {
      // localize_iteration's acceptance, damping and exit, term for term
      const T cost0 = s_cost, lam0 = s_lam, nu0 = s_nu;
      const T new_cost = T(0.5) * acc2[0];
      T gs = T(0);
      for (int r = 0; r < 6; ++r) gs += g[r] * step[r];
      const T model = -gs - T(0.5) * acc2[1];
      const T rho = (cost0 - new_cost) / (model < T(1e-30) ? T(1e-30) : model);
      // a singular or non-finite system: rejected, as the torch stage's NaN
      const bool accept = ok && rho > cfg.mrd;
      const T u = T(2) * rho - T(1);
      T shrink = T(1) - u * u * u;
      shrink = shrink < T(1.0 / 3.0) ? T(1.0 / 3.0) : shrink;
      T lam_acc = lam0 * shrink;
      lam_acc = lam_acc < cfg.min_lam ? cfg.min_lam
                                      : (lam_acc > cfg.max_lam ? cfg.max_lam
                                                               : lam_acc);
      T lam_rej = lam0 * nu0;
      lam_rej = lam_rej > cfg.max_lam ? cfg.max_lam : lam_rej;
      const bool f_conv = fabs(cost0 - new_cost) <= cfg.ftol * cost0;
      T ss = T(0), xx = T(0);
      for (int r = 0; r < 6; ++r) {
        ss += step[r] * step[r];
        xx += s_pose[r] * s_pose[r];
      }
      const bool p_conv = sqrt(ss) <= cfg.ptol * (sqrt(xx) + cfg.ptol);
      const bool stalled = !accept && lam0 >= cfg.stall;
      if (accept) {
        for (int r = 0; r < 6; ++r) s_pose[r] = new_pose[r];
        s_cost = new_cost;
        s_lam = lam_acc;
        s_nu = T(2);
      } else {
        s_lam = lam_rej;
        s_nu = nu0 * T(2);
      }
      s_it += 1;
      s_conv = (accept && (f_conv || p_conv)) || stalled;
    }
    __syncthreads();
    for (int i = 0; i < 6; ++i) jp[i].v = s_pose[i];
  }
  if (tid == 0) {
    for (int i = 0; i < 6; ++i) pose[q * 6 + i] = s_pose[i];
    cost[q] = s_cost;
    lam[q] = s_lam;
    nu[q] = s_nu;
    it[q] = s_it;
    conv[q] = (unsigned char)(s_conv != 0);
  }
}

template <typename T, bool kDist>
int launch(const void* camera, const void* corners, const void* tps,
           const void* maskf, void* pose, void* lam, void* nu, void* cost,
           void* it, void* conv, int q, int k, const Config<T>& cfg,
           cudaStream_t s) {
  localize_lm<T, kDist><<<q, kThreads, 0, s>>>(
      (const T*)camera, (const T*)corners, (const T*)tps, (const T*)maskf,
      (T*)pose, (T*)lam, (T*)nu, (T*)cost, (long long*)it,
      (unsigned char*)conv, k, cfg);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* camera, const void* corners, const void* tps,
             const void* maskf, void* pose, void* lam, void* nu, void* cost,
             void* it, void* conv, int q, int k, int distortion,
             double aruco_size, int max_iterations, double mrd, double ftol,
             double ptol, double min_lam, double max_lam, double stall,
             cudaStream_t s) {
  // the tolerances as the torch stage meets them: Python floats against
  // tensors of the state's dtype
  Config<T> cfg;
  cfg.half = T(0.5 * aruco_size);
  cfg.mrd = T(mrd);
  cfg.ftol = T(ftol);
  cfg.ptol = T(ptol);
  cfg.min_lam = T(min_lam);
  cfg.max_lam = T(max_lam);
  cfg.stall = T(stall);
  cfg.max_it = max_iterations;
  return distortion
             ? launch<T, true>(camera, corners, tps, maskf, pose, lam, nu,
                               cost, it, conv, q, k, cfg, s)
             : launch<T, false>(camera, corners, tps, maskf, pose, lam, nu,
                                cost, it, conv, q, k, cfg, s);
}

}  // namespace

// camera (3,), corners (Q, K, 4, 2), tps (Q, K, 6), maskf (Q, K), pose
// (Q, 6), lam / nu / cost (Q,) of one float type (is_double), it (Q,)
// int64, conv (Q,) bool: localize_init's state, updated in place
extern "C" int arslam_localize_lm(const void* camera, const void* corners,
                                  const void* tps, const void* maskf,
                                  void* pose, void* lam, void* nu, void* cost,
                                  void* it, void* conv, int q, int k,
                                  int is_double, int distortion,
                                  double aruco_size, int max_iterations,
                                  double min_relative_decrease,
                                  double function_tolerance,
                                  double parameter_tolerance,
                                  double min_lambda, double max_lambda,
                                  double stall_lambda, void* stream) {
  if (q < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (q == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return is_double
             ? dispatch<double>(camera, corners, tps, maskf, pose, lam, nu,
                                cost, it, conv, q, k, distortion, aruco_size,
                                max_iterations, min_relative_decrease,
                                function_tolerance, parameter_tolerance,
                                min_lambda, max_lambda, stall_lambda, s)
             : dispatch<float>(camera, corners, tps, maskf, pose, lam, nu,
                               cost, it, conv, q, k, distortion, aruco_size,
                               max_iterations, min_relative_decrease,
                               function_tolerance, parameter_tolerance,
                               min_lambda, max_lambda, stall_lambda, s);
}
