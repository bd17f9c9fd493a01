// K3: capped 8-connected component labelling of an (N, H, W) binary batch
// by rounds of (3x3 min-pool -> row run-min -> column run-min).
//
// Replaces the strip-scan Pallas kernels of ar_slam_tpu/detect/pallas_ccl.py
// (_row_kernel / _col_kernel through _scan_pass, driven by
// connected_components_pallas_batch), which the reference runs when the
// padded decimated plane exceeds FUSED_CCL_PIXEL_LIMIT.  There a round is an
// XLA 3x3 min-pool, a Pallas pass of segmented min scans along every row and
// one along every column; an XLA while_loop repeats rounds until nothing
// changes or ``iters`` rounds have run.  This kernel keeps the round cap,
// so it must reproduce the reference's labels bit for bit also where the
// cap cuts a serpentine short.  That holds only if each round is Jacobi
// (unlike K2's Gauss-Seidel round): every stage reads the whole output of
// the stage before it.  So a round is two launches:
//
//   strip_row: one warp per row, 8 rows a block.  It reads rows y-1, y, y+1
//              of the labels (coalesced, 8 steps of 32 pixels in flight per
//              lane; the neighbours' rows come from L1/L2) into their
//              vertical min in a shared-memory row, takes the horizontal min
//              over each lane's segment (the 3x3 min-pool of the
//              foreground), then replaces every foreground run by its
//              minimum -> scratch;
//   strip_col: one block per strip of up to 16 columns, holding the strip's
//              full height in shared memory (loaded with cp.async, so every
//              copy of a thread is in flight at once), one warp per column;
//              replaces every run of each column by its minimum -> labels.
//
// Both stages do the run-min as a warp-level segmented scan (run_min_line,
// ccl_lines.cuh):
// each lane owns a contiguous segment of the line, reduces it to a summary
// (min of its leading run, min of its trailing run, whether it is all
// foreground), the 32 summaries are scanned forward and backward by
// shuffles, and each lane sweeps its segment once each way with the carries
// it received.  No __syncthreads ladder: segments have odd lengths and the
// column tile an odd row pitch, so the lanes' walks hit 32 distinct banks.
//
// No host read per round.  The wrapper enqueues all ``iters`` rounds at
// once.  ``flags`` holds one int per (round, plane), zeroed by the init
// kernel; a stage that changes a plane's labels sets its flag, and every
// block of round r+1 whose plane did not change in round r returns at once.
// Labels only decrease and a converged plane stays fixed, so this per-plane
// exit gives exactly the labels of the reference's batch-global loop.  The
// flags stay on the card: the rounds a plane ran are 1 + its changing rounds
// (capped at iters), read only when the caller asks.  A round changes a
// plane iff the pool lowers a label or two neighbouring foreground pixels
// still differ along a row or a column, which each stage sees locally.
//
// Labels are linear indices in the true width (y * W + x): order-preserving
// and equal to the reference's padded-width labels after its remap, since
// the min of a set of pixels is the same pixel in either numbering.
// Background is 2^30 throughout, so foreground is "label < 2^30" and the
// kernels need no separate mask.
//
// Bound on the H100: device memory.  Each stage reads and writes one int32
// per pixel of a running plane, so a round of the whole batch moves 4 x 4 B
// per pixel (0.35 ms at (24, 1512, 2016)); the stages run at about half of
// that rate.  One plane's labels and scratch (24 MB at 1512x2016) would fit
// the 50 MB L2; a schedule that keeps a plane's rounds there is the next
// lever.
//
// Launch rules: runs on the caller's stream, allocates nothing (scratch and
// flags come from the caller), returns the first launch error.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ccl_lines.cuh"

namespace {

constexpr int kInitThreads = 256;
constexpr int kRowWarps = 8;   // rows (one warp each) per strip_row block
constexpr int kRowBatch = 8;   // row steps of 32 pixels a lane loads at once
constexpr int kColStrip = 16;  // columns per strip_col block, at most
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ inline size_t row_smem_bytes(int warps, int w) {
  return (size_t)warps * 32 * lane_segment(w) * sizeof(int);
}

// column tile: h rows of cb columns at an odd row pitch
__host__ __device__ inline size_t col_smem_bytes(int h, int cb) {
  return (size_t)h * (cb | 1) * sizeof(int);
}

__global__ void strip_init(const uint8_t* __restrict__ fg,
                           int* __restrict__ lab, int* __restrict__ flags,
                           long long total, int hw, int n_flags) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x)
    lab[i] = fg[i] ? (int)(i % hw) : kBig;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < n_flags; i += blockDim.x) flags[i] = 0;
}

__global__ void strip_row(const int* __restrict__ lab,
                          int* __restrict__ scratch, int* __restrict__ flags,
                          int round, int n, int h, int w) {
  extern __shared__ int smem[];
  const int plane = blockIdx.y;
  if (round > 0 && !flags[(round - 1) * n + plane]) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int y = blockIdx.x * (blockDim.x / 32) + warp;
  if (y >= h) return;
  const int seg = lane_segment(w);
  int* p = smem + warp * 32 * seg;
  const long long off = ((long long)plane * h + y) * w;
  const int* row = lab + off;
  const int* up = y > 0 ? row - w : row;  // a missing row repeats row y,
  const int* dn = y + 1 < h ? row + w : row;  // which leaves the min as is

  // vertical min of rows y-1..y+1, kRowBatch steps of 32 pixels in flight
  // per lane; a background centre is marked by the sign bit.  ``lowered``:
  // the pool lowers a label (its vertical part here, where the centre is
  // still known; the horizontal part below, where the centre equals its
  // vertical min or was flagged already)
  bool lowered = false;
  for (int x0 = lane; x0 < w; x0 += 32 * kRowBatch) {
    int c[kRowBatch], a[kRowBatch], b[kRowBatch];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int x = x0 + 32 * u;
      c[u] = x < w ? row[x] : kBig;
      a[u] = x < w ? up[x] : kBig;
      b[u] = x < w ? dn[x] : kBig;
    }
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int x = x0 + 32 * u;
      const int v = min(c[u], min(a[u], b[u]));
      lowered |= c[u] < kBig && v < c[u];
      if (x < w) p[x] = c[u] < kBig ? v : (v | kBgMark);
    }
  }
  __syncwarp();
  // horizontal min over each lane's segment, in place (its two outside
  // neighbours read before anyone writes): the 3x3 min-pool of the
  // foreground
  lowered |= pool_line_h(p, w, seg, lane);
  __syncwarp();
  const bool diff = run_min_line(p, 1, w, seg, lane);
  __syncwarp();
  int* d = scratch + off;
  for (int x = lane; x < w; x += 32) d[x] = p[x];
  if ((__any_sync(kFull, lowered) || diff) && lane == 0)
    flags[round * n + plane] = 1;
}

__global__ void strip_col(const int* __restrict__ scratch,
                          int* __restrict__ lab, int* __restrict__ flags,
                          int round, int n, int h, int w, int cb) {
  extern __shared__ int tile[];
  const int plane = blockIdx.y;
  if (round > 0 && !flags[(round - 1) * n + plane]) return;
  const int pitch = cb | 1, shift = __ffs(cb) - 1;
  const int x0 = blockIdx.x * cb;
  const long long off = (long long)plane * h * w;
  const int* s = scratch + off;
  // the strip's columns, every row, copied asynchronously (no register
  // round trip, so every copy of a thread is in flight at once)
  for (int i = threadIdx.x; i < h * cb; i += blockDim.x) {
    const int y = i >> shift, c = i & (cb - 1), x = x0 + c;
    if (x < w)
      __pipeline_memcpy_async(tile + y * pitch + c, s + (long long)y * w + x,
                              sizeof(int));
    else
      tile[y * pitch + c] = kBig;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int col = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool diff = run_min_line(tile + col, pitch, h, lane_segment(h), lane);
  int* l = lab + off;
  if (__syncthreads_or(diff && lane == 0) && threadIdx.x == 0)
    flags[round * n + plane] = 1;
  for (int i = threadIdx.x; i < h * cb; i += blockDim.x) {
    const int y = i >> shift, c = i & (cb - 1), x = x0 + c;
    if (x < w) l[(long long)y * w + x] = tile[y * pitch + c];
  }
}

int column_strip(int h) {
  int cb = kColStrip;
  while (cb > 1 && col_smem_bytes(h, cb) > kMaxSmem) cb >>= 1;
  return cb;
}

int row_warps(int w) {
  int warps = kRowWarps;
  while (warps > 1 && row_smem_bytes(warps, w) > kMaxSmem) warps >>= 1;
  return warps;
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// fg: (n, h, w) uint8 (0/1) -> labels: (n, h, w) int32 after at most
// ``iters`` Jacobi rounds, through scratch of the same shape; flags:
// (iters, n) int32, flags[r * n + p] = 1 iff round r changed plane p.
// Enqueues 1 + 2 x iters kernels and reads nothing back.
extern "C" int arslam_ccl_strip(const uint8_t* fg, int* labels, int* scratch,
                                int* flags, int n, int h, int w, int iters,
                                void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || iters < 0 || n > 65535 ||
      (long long)h * w >= kBig ||
      row_smem_bytes(1, w) > kMaxSmem || col_smem_bytes(h, 1) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int warps = row_warps(w), cb = column_strip(h);
  const size_t row_smem = row_smem_bytes(warps, w);
  const size_t col_smem = col_smem_bytes(h, cb);
  cudaError_t rc = allow_smem((const void*)strip_row, row_smem);
  if (rc == cudaSuccess) rc = allow_smem((const void*)strip_col, col_smem);
  if (rc != cudaSuccess) return (int)rc;

  const long long total = (long long)n * h * w;
  long long blocks = (total + kInitThreads - 1) / kInitThreads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  strip_init<<<(unsigned)blocks, kInitThreads, 0, s>>>(fg, labels, flags,
                                                       total, h * w,
                                                       iters * n);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  const dim3 row_grid((h + warps - 1) / warps, n);
  const dim3 col_grid((w + cb - 1) / cb, n);
  for (int r = 0; r < iters; ++r) {
    strip_row<<<row_grid, warps * 32, row_smem, s>>>(labels, scratch, flags,
                                                     r, n, h, w);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
    strip_col<<<col_grid, cb * 32, col_smem, s>>>(scratch, labels, flags, r,
                                                  n, h, w, cb);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  }
  return 0;
}
