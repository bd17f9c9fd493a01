// K1: edge-clamped win x win box sums of an (N, H, W) float32 batch.
//
// Replaces the Pallas prefix-sum kernels of ar_slam_tpu/detect/pallas_box.py
// (_row_kernel / _col_kernel behind box_sum_batch), which form each output
// as the difference of two inclusive prefix sums.  Here every output is a
// DIRECT sum of its win taps, rows first and then columns, so no prefix of
// ~1e10-1e12 is cancelled in float32 (the corner-refine field maps reach
// ~1e7 per pixel).  The function is the same as box_sum_batch's.
//
// Bound on the H100: memory traffic (one read + one write of the plane per
// pass, <= 23 adds per output).  Each block stages its tile plus the
// window's halo in shared memory once, so every input element is read from
// device memory about once per pass.
//
// Launch rules: runs on the caller's stream, allocates nothing (the caller
// passes the intermediate and output buffers), returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kRowTile = 256;   // outputs per block in the row pass
constexpr int kMaxRadius = 32;  // win <= 65
constexpr int kColW = 32;       // columns per block in the column pass
constexpr int kColH = 64;       // output rows per block in the column pass
constexpr int kColThreadsY = 8;

__global__ void box_rows(const float* __restrict__ in, float* __restrict__ out,
                         long long n_rows, int w, int r) {
  __shared__ float tile[kRowTile + 2 * kMaxRadius];
  const int x0 = blockIdx.x * kRowTile;
  const int taps = 2 * r + 1;
  for (long long row = blockIdx.y; row < n_rows; row += gridDim.y) {
    const float* src = in + row * w;
    for (int i = threadIdx.x; i < kRowTile + 2 * r; i += blockDim.x) {
      int x = x0 - r + i;
      x = x < 0 ? 0 : (x >= w ? w - 1 : x);
      tile[i] = src[x];
    }
    __syncthreads();
    const int x = x0 + threadIdx.x;
    if (x < w) {
      float s = 0.0f;
      for (int k = 0; k < taps; ++k) s += tile[threadIdx.x + k];
      out[row * w + x] = s;
    }
    __syncthreads();
  }
}

__global__ void box_cols(const float* __restrict__ in, float* __restrict__ out,
                         int h, int w, int r) {
  __shared__ float tile[kColH + 2 * kMaxRadius][kColW];
  const long long plane = (long long)blockIdx.z * h * w;
  const int x = blockIdx.x * kColW + threadIdx.x;
  const int y0 = blockIdx.y * kColH;
  const int taps = 2 * r + 1;
  for (int i = threadIdx.y; i < kColH + 2 * r; i += blockDim.y) {
    int y = y0 - r + i;
    y = y < 0 ? 0 : (y >= h ? h - 1 : y);
    tile[i][threadIdx.x] = x < w ? in[plane + (long long)y * w + x] : 0.0f;
  }
  __syncthreads();
  if (x >= w) return;
  for (int j = threadIdx.y; j < kColH && y0 + j < h; j += blockDim.y) {
    float s = 0.0f;
    for (int k = 0; k < taps; ++k) s += tile[j + k][threadIdx.x];
    out[plane + (long long)(y0 + j) * w + x] = s;
  }
}

}  // namespace

extern "C" int arslam_box_max_radius() { return kMaxRadius; }

// in, out: (n, h, w) float32; tmp: (n, h, w) float32 scratch.
extern "C" int arslam_box_sum(const float* in, float* tmp, float* out, int n,
                              int h, int w, int win, void* stream) {
  const int r = win / 2;
  if (win % 2 == 0 || r > kMaxRadius || n <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_rows = (long long)n * h;
  dim3 grid_r((w + kRowTile - 1) / kRowTile,
              (unsigned)(n_rows < 65535 ? n_rows : 65535));
  box_rows<<<grid_r, kRowTile, 0, s>>>(in, tmp, n_rows, w, r);
  dim3 grid_c((w + kColW - 1) / kColW, (h + kColH - 1) / kColH, n);
  box_cols<<<grid_c, dim3(kColW, kColThreadsY), 0, s>>>(tmp, out, h, w, r);
  return (int)cudaGetLastError();
}
