// K4: extreme-point quads of the top-K components of each label plane.
//
// Replaces the Pallas kernel of ar_slam_tpu/detect/pallas_extract.py
// (_extract_kernel behind extreme_quads_pallas).  One block per
// (image, candidate root):
//
//   sweep 0 (whole plane): area, integer sums of x and y, row extent;
//   sweep 1: A = member pixel farthest from the centroid;
//   sweep 2: C = member pixel farthest from A;
//   sweep 3: B, D = members of largest / smallest signed distance from AC.
//
// Sweeps 1-3 visit only rows [ymin, ymax].  Each sweep is a block argmax
// whose key is (score, lowest linear index), the tie-break of jnp.argmax.
// Scores are float32 with every product and sum rounded separately (no FMA
// contraction), as the reference and the plain version compute them; the
// coordinate sums are integers, so the centroid is exact wherever the
// float32 sums of the reference are (sums below 2^24).  An empty slot
// (root 2^30) gives (0, 0) for all four points.
//
// Bound on the H100: reading the label plane (783 KB per image at the main
// path's shape) once per candidate in sweep 0 -- 64 candidates re-read it
// from L2.  Sweeps 1-3 touch only the component's row band, which for
// marker-sized components is a few percent of the plane.
//
// Launch rules: runs on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Best {
  float score;
  int lin;
};

__device__ __forceinline__ Best empty_best() {
  return Best{__int_as_float(0xff800000), INT_MAX};  // (-inf, no pixel)
}

__device__ __forceinline__ bool better(float s, int l, const Best& b) {
  return s > b.score || (s == b.score && l < b.lin);
}

__device__ Best block_argmax(Best v, Best* smem) {
  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_down_sync(0xffffffffu, v.score, off);
    const int l = __shfl_down_sync(0xffffffffu, v.lin, off);
    if (better(s, l, v)) v = {s, l};
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? smem[lane] : empty_best();
    for (int off = 16; off > 0; off >>= 1) {
      const float s = __shfl_down_sync(0xffffffffu, v.score, off);
      const int l = __shfl_down_sync(0xffffffffu, v.lin, off);
      if (better(s, l, v)) v = {s, l};
    }
    if (lane == 0) smem[0] = v;
  }
  __syncthreads();
  const Best out = smem[0];
  __syncthreads();
  return out;
}

template <typename T, typename Op>
__device__ T block_reduce(T v, T* smem, Op op) {
  for (int off = 16; off > 0; off >>= 1)
    v = op(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  T out = smem[0];
  for (int i = 1; i < kWarps; ++i) out = op(out, smem[i]);
  __syncthreads();
  return out;
}

struct Add {
  __device__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};
struct Min {
  __device__ long long operator()(long long a, long long b) const {
    return a < b ? a : b;
  }
};
struct Max {
  __device__ long long operator()(long long a, long long b) const {
    return a > b ? a : b;
  }
};

// Scores, each operation rounded on its own (no FMA contraction).
__device__ __forceinline__ float sq_dist(float x, float y, float px, float py) {
  const float dx = __fsub_rn(x, px), dy = __fsub_rn(y, py);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float side(float x, float y, float ax, float ay,
                                      float nx, float ny) {
  return __fadd_rn(__fmul_rn(nx, __fsub_rn(x, ax)),
                   __fmul_rn(ny, __fsub_rn(y, ay)));
}

// mode 0: distance from (px, py); 1: +side of line; 2: -side of line.
__device__ Best sweep(const int* lab, int root, int w, int y0, int y1,
                      int mode, float px, float py, float nx, float ny,
                      Best* smem) {
  Best b = empty_best();
  const int lo = y0 * w, hi = (y1 + 1) * w;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    if (lab[i] != root) continue;
    const float x = (float)(i % w), y = (float)(i / w);
    float s;
    if (mode == 0)
      s = sq_dist(x, y, px, py);
    else if (mode == 1)
      s = side(x, y, px, py, nx, ny);
    else
      s = -side(x, y, px, py, nx, ny);
    if (better(s, i, b)) b = {s, i};
  }
  return block_argmax(b, smem);
}

__global__ void extract(const int* __restrict__ labels,
                        const int* __restrict__ roots, float* __restrict__ out,
                        int h, int w, int k) {
  __shared__ long long red[kWarps];
  __shared__ Best best[kWarps];
  const int n = blockIdx.y, c = blockIdx.x;
  const int root = roots[n * k + c];
  float* o = out + ((long long)n * k + c) * 8;
  if (root == kBig) {
    if (threadIdx.x < 8) o[threadIdx.x] = 0.0f;
    return;
  }
  const int* lab = labels + (long long)n * h * w;

  long long area = 0, sx = 0, sy = 0, ymin = LLONG_MAX, ymax = -1;
  for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
    if (lab[i] != root) continue;
    const int y = i / w;
    area += 1;
    sx += i % w;
    sy += y;
    ymin = y < ymin ? y : ymin;
    ymax = y > ymax ? y : ymax;
  }
  area = block_reduce(area, red, Add());
  sx = block_reduce(sx, red, Add());
  sy = block_reduce(sy, red, Add());
  ymin = block_reduce(ymin, red, Min());
  ymax = block_reduce(ymax, red, Max());
  if (area == 0) {  // a root absent from the plane: same as an empty slot
    if (threadIdx.x < 8) o[threadIdx.x] = 0.0f;
    return;
  }
  const float cx = __fdiv_rn((float)sx, (float)area);
  const float cy = __fdiv_rn((float)sy, (float)area);
  const int y0 = (int)ymin, y1 = (int)ymax;

  const Best a = sweep(lab, root, w, y0, y1, 0, cx, cy, 0.f, 0.f, best);
  const float ax = (float)(a.lin % w), ay = (float)(a.lin / w);
  const Best cc = sweep(lab, root, w, y0, y1, 0, ax, ay, 0.f, 0.f, best);
  const float ccx = (float)(cc.lin % w), ccy = (float)(cc.lin / w);
  const float nx = -__fsub_rn(ccy, ay), ny = __fsub_rn(ccx, ax);
  const Best b = sweep(lab, root, w, y0, y1, 1, ax, ay, nx, ny, best);
  const Best d = sweep(lab, root, w, y0, y1, 2, ax, ay, nx, ny, best);
  if (threadIdx.x == 0) {
    o[0] = ax;
    o[1] = ay;
    o[2] = (float)(b.lin % w);
    o[3] = (float)(b.lin / w);
    o[4] = ccx;
    o[5] = ccy;
    o[6] = (float)(d.lin % w);
    o[7] = (float)(d.lin / w);
  }
}

}  // namespace

// labels: (n, h, w) int32; roots: (n, k) int32; out: (n, k, 4, 2) float32.
extern "C" int arslam_extract(const int* labels, const int* roots, float* out,
                              int n, int h, int w, int k, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || k <= 0 || n > 65535 ||
      (long long)h * w >= kBig)
    return (int)cudaErrorInvalidValue;
  extract<<<dim3(k, n), kThreads, 0, (cudaStream_t)stream>>>(labels, roots,
                                                             out, h, w, k);
  return (int)cudaGetLastError();
}
