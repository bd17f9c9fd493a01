// K1: edge-clamped win x win box sums, in the two uses of the detection
// path.
//
// Replaces the Pallas prefix-sum kernels of ar_slam_tpu/detect/pallas_box.py
// (_row_kernel / _col_kernel behind box_sum_batch), which form each output
// as the difference of two inclusive float32 prefix sums.  The reference
// uses them (a) for the adaptive threshold of the uint8 frames at each
// window and (b) for the five corner-refine field maps at window 11.
//
// (a) threshold_tile: the frames stay uint8 on the card.  One launch reads
//     every frame once and writes the decimated binary planes of every
//     window: dark where float(pixel) < float(sum) / float(win^2) - c (the
//     reference's float32 compare, IEEE division), then count-pooled d x d
//     (dark iff >= (d^2 + 1) / 2 of the d x d pixels, zero outside the
//     frame).  A block stages a 64 x 256 tile plus the largest window's
//     halo in shared memory and, window by window, forms exact integer box
//     sums as sliding sums (add the entering tap, subtract the leaving one;
//     a direct sum would cost 78 adds a pixel at windows 3/13/23): column
//     sums walking down the tile, then row sums walking along it, the
//     compare and the pool in registers.  Integer sums equal the float32
//     direct sums of the plain version, which are exact on integer frames
//     (every partial sum <= 65^2 * 255 < 2^24).  The compare is monotone
//     in the sum, so it is a table: pixel value p is dark iff its sum
//     reaches dark_from[p], the least sum that passes the float32 compare
//     (built on the host, detect/box.py:threshold_table); a lookup in
//     shared memory replaces ~20 instructions of IEEE division a pixel.
// (b) box_tile: float32 planes (the field maps, ~1e7 a pixel).  Every
//     output is a DIRECT sum of its taps, rows first and then columns, in
//     the plain version's order, so the kernel equals box_sum_plain bit for
//     bit and no prefix is cancelled.  A block stages a 32 x 128 tile plus
//     halo and its row sums in shared memory: one pass, no scratch plane.
//
// Bound on the H100: memory traffic (each input read once, each output
// written once); tiles are read from device memory about once, the halos
// mostly from L2.  (a) does ~40 integer operations a pixel.
//
// Launch rules: run on the caller's stream, allocate nothing, return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRadius = 32;  // win <= 65
constexpr int kMaxWindows = 8;
constexpr int kSumTileW = 128, kSumTileH = 32, kSumThreads = 256;
constexpr int kSumPitchH = kSumTileW + 1;  // row-sum pitch (odd)
constexpr int kRun = 8;  // consecutive outputs a thread sums
constexpr int kThrTileW = 256, kThrTileH = 64, kThrSegments = 8;
constexpr int kThrThreads = 320;  // a column walker per halo'd tile column
constexpr size_t kMaxSmem = 227 * 1024;

struct Windows {
  int n;
  int r[kMaxWindows];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// tile pitches: odd, so the lanes of a warp (consecutive rows in the row
// pass, consecutive columns in the column pass) hit distinct banks
__host__ __device__ inline int sum_pitch(int r) {
  return (kSumTileW + 2 * r) | 1;
}

size_t sum_smem_bytes(int r) {
  const int rows = kSumTileH + 2 * r;
  return (size_t)rows * (sum_pitch(r) + kSumPitchH) * sizeof(float);
}

// kRun consecutive direct sums of win taps along a line of stride ``step``,
// each as ((t[i] + t[i + 1]) + ...) in tap order; the taps slide through
// registers, so each is read from shared memory once
__device__ __forceinline__ void run_sums(const float* t, int step, int win,
                                         float* s) {
  float v[kRun];
#pragma unroll
  for (int u = 0; u < kRun; ++u) s[u] = v[u] = t[u * step];
  for (int k = 1; k < win; ++k) {
#pragma unroll
    for (int u = 0; u + 1 < kRun; ++u) v[u] = v[u + 1];
    v[kRun - 1] = t[(k + kRun - 1) * step];
#pragma unroll
    for (int u = 0; u < kRun; ++u) s[u] += v[u];
  }
}

__global__ void __launch_bounds__(kSumThreads)
    box_tile(const float* __restrict__ in, float* __restrict__ out, int h,
             int w, int r) {
  extern __shared__ float smem[];
  const int win = 2 * r + 1, pitch = sum_pitch(r);
  const int rows = kSumTileH + 2 * r;
  float* tile = smem;                // rows x pitch: the clamped input
  float* hsum = smem + rows * pitch;  // rows x kSumPitchH: row sums
  const int x0 = blockIdx.x * kSumTileW, y0 = blockIdx.y * kSumTileH;
  const size_t plane = (size_t)blockIdx.z * h * w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < rows; i += kSumThreads / 32) {
    const float* src = in + plane + (size_t)clampi(y0 - r + i, 0, h - 1) * w;
    for (int c = lane; c < kSumTileW + 2 * r; c += 32)
      tile[i * pitch + c] = src[clampi(x0 - r + c, 0, w - 1)];
  }
  __syncthreads();
  float s[kRun];
  for (int task = threadIdx.x; task < rows * (kSumTileW / kRun);
       task += kSumThreads) {
    const int i = task % rows, x = task / rows * kRun;
    run_sums(tile + i * pitch + x, 1, win, s);
#pragma unroll
    for (int u = 0; u < kRun; ++u) hsum[i * kSumPitchH + x + u] = s[u];
  }
  __syncthreads();
  for (int task = threadIdx.x; task < kSumTileW * (kSumTileH / kRun);
       task += kSumThreads) {
    const int x = task % kSumTileW, y = task / kSumTileW * kRun;
    run_sums(hsum + y * kSumPitchH + x, kSumPitchH, win, s);
    if (x0 + x >= w) continue;
#pragma unroll
    for (int u = 0; u < kRun; ++u)
      if (y0 + y + u < h)
        out[plane + (size_t)(y0 + y + u) * w + x0 + x] = s[u];
  }
}

// Shared-memory layout of threshold_tile for decimation d, halo R and nw
// windows: the compare tables, the uint8 input tile (pitch = 2 mod 4
// bytes), the uint16 column
// sums (odd pitch) and the uint8 pooled counts of every window (pitch an
// odd number of words), so the lanes of a warp, which own consecutive
// decimated rows, hit distinct banks.
struct ThrLayout {
  int th, tw, thd, twd, rows, pw, pin, pv, po;
  size_t t_off, v_off, o_off, bytes;
};

__host__ __device__ inline ThrLayout thr_layout(int d, int R, int nw) {
  ThrLayout L;
  L.th = kThrTileH / d * d;
  L.tw = kThrTileW / d * d;
  L.thd = L.th / d;
  L.twd = L.tw / d;
  L.rows = L.th + 2 * R;
  L.pw = L.tw + 2 * R;
  L.pin = (L.pw + 3) / 4 * 4 + 2;
  L.pv = L.pw | 1;
  L.po = (L.twd + 3) / 4 * 4;
  if ((L.po / 4) % 2 == 0) L.po += 4;
  L.t_off = (size_t)nw * 256 * sizeof(int);
  L.v_off = L.t_off + ((size_t)L.rows * L.pin + 3) / 4 * 4;
  L.o_off = L.v_off + ((size_t)L.th * L.pv * sizeof(uint16_t) + 3) / 4 * 4;
  L.bytes = L.o_off + (size_t)nw * L.thd * L.po;
  return L;
}

// Sums of win consecutive rows (stride pin) of one column of the tile,
// sliding down it: v[y * pv] = t[y * pin] + ... + t[(y + win - 1) * pin]
// for y < th
__device__ __forceinline__ void column_sums(const uint8_t* __restrict__ t,
                                            uint16_t* __restrict__ v,
                                            int pin, int pv, int th,
                                            int win) {
  int s = 0;
  for (int i = 0; i + 1 < win; ++i) s += t[i * pin];
#pragma unroll 4
  for (int y = 0; y < th; ++y) {
    s += t[(y + win - 1) * pin];
    v[y * pv] = (uint16_t)s;
    s -= t[y * pin];
  }
}

// One tile row: the row sums of the column sums vr over [x - r, x + r],
// sliding along decimated columns [xd0, xd1); pixel x (value ir[x]) is dark
// iff its sum reaches dark[ir[x]]; o[xd] += the dark pixels of its d
// columns inside the frame (x < x_end).  kD > 0 fixes d at compile time
// (the default decimation 2), so the inner loop unrolls: 1.6x faster at
// 12 MP than the loop over a runtime d.
template <int kD>
__device__ __forceinline__ void dark_counts(
    const uint16_t* __restrict__ vr, const uint8_t* __restrict__ ir,
    const int* __restrict__ dark, uint8_t* __restrict__ o, int xd0, int xd1,
    int d_arg, int r, int x_end) {
  const int d = kD > 0 ? kD : d_arg;
  int s = 0;
  for (int k = xd0 * d - r; k < xd0 * d + r; ++k) s += vr[k];
#pragma unroll 4
  for (int xd = xd0; xd < xd1; ++xd) {
    int cnt = 0;
#pragma unroll
    for (int x = xd * d; x < xd * d + d; ++x) {
      s += vr[x + r];
      cnt += x < x_end && s >= dark[ir[x]];
      s -= vr[x - r];
    }
    o[xd] += cnt;
  }
}

__global__ void __launch_bounds__(kThrThreads)
    threshold_tile(const uint8_t* __restrict__ frames,
                   const int* __restrict__ dark_from,
                   uint8_t* __restrict__ out, Windows wins, int R, int n,
                   int h, int w, int d, int hd, int wd) {
  extern __shared__ __align__(16) uint8_t smem_b[];
  const ThrLayout L = thr_layout(d, R, wins.n);
  int* thr_s = (int*)smem_b;
  uint8_t* in_s = smem_b + L.t_off;
  uint16_t* v_s = (uint16_t*)(smem_b + L.v_off);
  uint8_t* o_s = smem_b + L.o_off;
  const int x0 = blockIdx.x * L.tw, y0 = blockIdx.y * L.th;
  const int img = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < wins.n * 256; i += kThrThreads)
    thr_s[i] = dark_from[i];
  const uint8_t* src = frames + (size_t)img * h * w;
  for (int i = warp; i < L.rows; i += kThrThreads / 32) {
    const uint8_t* row = src + (size_t)clampi(y0 - R + i, 0, h - 1) * w;
    for (int col = lane; col < L.pw; col += 32)
      in_s[i * L.pin + col] = row[clampi(x0 - R + col, 0, w - 1)];
  }
  __syncthreads();

  const int need = (d * d + 1) / 2;
  const int seg = (L.twd + kThrSegments - 1) / kThrSegments;
  const int x_end = min(L.tw, w - x0);  // columns inside the frame
  for (int wi = 0; wi < wins.n; ++wi) {
    const int r = wins.r[wi];
    const int* dark = thr_s + wi * 256;
    // column sums of rows y - r .. y + r, for every tile row y and halo'd
    // column, sliding down the tile
    for (int col = tid; col < L.pw; col += kThrThreads)
      column_sums(in_s + (R - r) * L.pin + col, v_s + col, L.pin, L.pv, L.th,
                  2 * r + 1);
    __syncthreads();
    // row sums sliding along a segment of each row, the compare (a pixel
    // p is dark iff its sum reaches dark[p]), and the d x d count of each
    // decimated pixel; a task owns one decimated row of one segment
    uint8_t* o_w = o_s + (size_t)wi * L.thd * L.po;
    for (int task = tid; task < L.thd * kThrSegments; task += kThrThreads) {
      const int yd = task % L.thd, g = task / L.thd;
      const int xd0 = g * seg, xd1 = min(L.twd, xd0 + seg);
      uint8_t* o = o_w + yd * L.po;
      for (int xd = xd0; xd < xd1; ++xd) o[xd] = 0;
      for (int j = 0; j < d && y0 + yd * d + j < h; ++j) {
        const int y = yd * d + j;
        const uint16_t* vr = v_s + y * L.pv + R;
        const uint8_t* ir = in_s + (y + R) * L.pin + R;
        if (d == 2)
          dark_counts<2>(vr, ir, dark, o, xd0, xd1, d, r, x_end);
        else
          dark_counts<0>(vr, ir, dark, o, xd0, xd1, d, r, x_end);
      }
      for (int xd = xd0; xd < xd1; ++xd) o[xd] = o[xd] >= need;
    }
    __syncthreads();
  }

  // the planes of every window, window-major: out[wi * n + img]
  const int yd0 = blockIdx.y * L.thd, xd0 = blockIdx.x * L.twd;
  for (int wi = 0; wi < wins.n; ++wi) {
    uint8_t* dst = out + ((size_t)wi * n + img) * hd * wd;
    for (int yd = warp; yd < L.thd && yd0 + yd < hd; yd += kThrThreads / 32)
      for (int xd = lane; xd < L.twd && xd0 + xd < wd; xd += 32)
        dst[(size_t)(yd0 + yd) * wd + xd0 + xd] =
            o_s[((size_t)wi * L.thd + yd) * L.po + xd];
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int arslam_box_max_radius() { return kMaxRadius; }

extern "C" int arslam_threshold_max_windows() { return kMaxWindows; }

// in, out: (n, h, w) float32; out = edge-clamped win x win sums.
extern "C" int arslam_box_sum(const float* in, float* out, int n, int h,
                              int w, int win, void* stream) {
  const int r = win / 2;
  if (win % 2 == 0 || r > kMaxRadius || n <= 0 || n > 65535 || h <= 0 ||
      w <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sum_smem_bytes(r);
  cudaError_t rc = allow_smem((const void*)box_tile, smem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((w + kSumTileW - 1) / kSumTileW,
                  (h + kSumTileH - 1) / kSumTileH, n);
  box_tile<<<grid, kSumThreads, smem, (cudaStream_t)stream>>>(in, out, h, w,
                                                              r);
  return (int)cudaGetLastError();
}

// frames: (n, h, w) uint8; wins: nw odd window sizes (host memory);
// dark_from: (nw, 256) int32 on the card, the least window sum at which a
// pixel of each value is dark (see threshold_table in detect/box.py);
// out: (nw * n, ceil(h / d), ceil(w / d)) bool, window-major.
extern "C" int arslam_threshold(const uint8_t* frames, const int* dark_from,
                                uint8_t* out, int n, int h, int w,
                                const int* wins, int nw, int d,
                                void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || w <= 0 || nw <= 0 ||
      nw > kMaxWindows || d <= 0 || d * d > 255 || d > kThrTileH)
    return (int)cudaErrorInvalidValue;
  Windows ws;
  ws.n = nw;
  int R = 0;
  for (int i = 0; i < nw; ++i) {
    if (wins[i] % 2 == 0 || wins[i] / 2 > kMaxRadius)
      return (int)cudaErrorInvalidValue;
    ws.r[i] = wins[i] / 2;
    R = ws.r[i] > R ? ws.r[i] : R;
  }
  const ThrLayout L = thr_layout(d, R, nw);
  if (L.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t rc = allow_smem((const void*)threshold_tile, L.bytes);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((w + L.tw - 1) / L.tw, (h + L.th - 1) / L.th, n);
  threshold_tile<<<grid, kThrThreads, L.bytes, (cudaStream_t)stream>>>(
      frames, dark_from, out, ws, R, n, h, w, d, (h + d - 1) / d,
      (w + d - 1) / d);
  return (int)cudaGetLastError();
}
