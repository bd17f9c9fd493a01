// K3: capped 8-connected component labelling of an (N, H, W) binary batch
// by rounds of (3x3 min-pool -> row run-min -> column run-min).
//
// Replaces the strip-scan Pallas kernels of ar_slam_tpu/detect/pallas_ccl.py
// (_row_kernel / _col_kernel through _scan_pass, driven by
// connected_components_pallas_batch), which the reference runs when the
// padded decimated plane exceeds FUSED_CCL_PIXEL_LIMIT.  There a round is an
// XLA 3x3 min-pool, a Pallas pass of segmented min scans along every row
// (strips of 128 rows in VMEM) and one along every column (strips of 256
// columns); the XLA while_loop repeats rounds until nothing changes or
// ``iters`` rounds have run.  Unlike K2 (union-find, always fully resolved)
// this kernel keeps the round cap, so it must reproduce the reference's
// labels bit for bit also where the cap cuts a serpentine short.  That holds
// only if each round is Jacobi: every stage reads the whole output of the
// stage before it.  So a round is two launches on ping-pong buffers:
//
//   strip_pool_row: one block per (row, image); stages rows y-1, y, y+1 of
//                   the previous round's labels in shared memory, min-pools
//                   them (foreground only), then takes the min over every
//                   full foreground run of the row, both directions, by
//                   log-step doubling in shared memory -> scratch;
//   strip_col:      one thread per (column, image); walks down the column of
//                   scratch writing the run prefix minimum in place, then up,
//                   spreading each run's minimum (its last prefix) and
//                   writing the new labels; a thread whose column changed
//                   sets the device flag ``changed``.
//
// Neighbouring threads of strip_col own neighbouring columns, so each row
// step of the walk is one coalesced access per warp.  The host reads the
// flag once per round and stops at no change or at ``iters`` rounds.  The
// reference's loop is batch-global; labels only decrease and a converged
// plane stays fixed, so stopping the whole batch on "no plane changed"
// gives the same labels as it does.
//
// Labels are linear indices in the true width (y * W + x): order-preserving
// and equal to the reference's padded-width labels after its remap, since
// the min of a set of pixels is the same pixel in either numbering.
// Background is 2^30 throughout, so foreground is "label < 2^30" and the
// kernels need no separate mask.
//
// Bound on the H100: device memory.  A stage reads and writes one int32 per
// pixel (the pool's three-row halo is served from L1/L2), so a round moves
// about 2 x 2 x 4 B per pixel; the column walk's two passes over scratch
// stay in the 50 MB L2 only for small batches.  Speed (persistent blocks,
// warp-level scans, TMA) is later work; this version is simple and exact.
//
// Launch rules: runs on the caller's stream, allocates nothing (scratch and
// the flag come from the caller), returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kRowThreads = 256;
constexpr int kColThreads = 128;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void strip_init(const uint8_t* __restrict__ fg,
                           int* __restrict__ lab, long long total, int hw) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x)
    lab[i] = fg[i] ? (int)(i % hw) : kBig;
}

// Shared memory: rows (3w int) | va, vb (w int each) | ra, rb (w bytes each)
__host__ __device__ inline size_t row_smem_bytes(int w) {
  return (size_t)w * (5 * sizeof(int) + 2);
}

__global__ void strip_pool_row(const int* __restrict__ src,
                               int* __restrict__ dst, int h, int w) {
  extern __shared__ int smem[];
  int* rows = smem;
  int* va = rows + 3 * w;
  int* vb = va + w;
  uint8_t* ra = reinterpret_cast<uint8_t*>(vb + w);
  uint8_t* rb = ra + w;
  const int y = blockIdx.x;
  const long long plane = (long long)blockIdx.y * h * w;
  const int* s = src + plane;

  for (int i = threadIdx.x; i < 3 * w; i += blockDim.x) {
    const int r = y - 1 + i / w;
    rows[i] = (r >= 0 && r < h) ? s[(long long)r * w + i % w] : kBig;
  }
  __syncthreads();
  // 3x3 min-pool, kept on foreground (label < 2^30) only
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    int v = rows[w + x];
    if (v < kBig) {
      for (int dy = 0; dy < 3; ++dy) {
        const int* r = rows + dy * w;
        v = min(v, r[x]);
        if (x > 0) v = min(v, r[x - 1]);
        if (x + 1 < w) v = min(v, r[x + 1]);
      }
    }
    va[x] = v;
  }
  __syncthreads();

  // forward, then backward segmented min scans (log-step doubling); the
  // backward scan of the forward prefixes is the full-run minimum
  int* vin = va;
  int* vout = vb;
  uint8_t* rin = ra;
  uint8_t* rout = rb;
  for (int dir = 1; dir >= -1; dir -= 2) {
    for (int x = threadIdx.x; x < w; x += blockDim.x) rin[x] = vin[x] < kBig;
    __syncthreads();
    for (int span = 1; span < w; span <<= 1) {
      for (int x = threadIdx.x; x < w; x += blockDim.x) {
        const int xs = x - dir * span;
        const bool inside = xs >= 0 && xs < w;
        int v = vin[x];
        const uint8_t r = rin[x];
        if (r && inside) v = min(v, vin[xs]);
        vout[x] = v;
        rout[x] = r && inside && rin[xs];
      }
      __syncthreads();
      int* tv = vin;
      vin = vout;
      vout = tv;
      uint8_t* tr = rin;
      rin = rout;
      rout = tr;
    }
  }
  int* d = dst + plane + (long long)y * w;
  for (int x = threadIdx.x; x < w; x += blockDim.x) d[x] = vin[x];
}

__global__ void strip_col(int* __restrict__ scratch, int* __restrict__ lab,
                          int* __restrict__ changed, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const long long plane = (long long)blockIdx.y * h * w;
  int* s = scratch + plane + x;
  int* l = lab + plane + x;
  int carry = kBig;
  for (int y = 0; y < h; ++y) {  // down: run prefix minima, in place
    const int v = s[(long long)y * w];
    if (v < kBig) {
      carry = min(carry, v);
      s[(long long)y * w] = carry;
    } else {
      carry = kBig;
    }
  }
  bool any = false;
  carry = kBig;
  for (int y = h - 1; y >= 0; --y) {  // up: spread each run's last prefix
    const int v = s[(long long)y * w];
    if (v < kBig) {
      carry = min(carry, v);
      if (l[(long long)y * w] != carry) {
        any = true;
        l[(long long)y * w] = carry;
      }
    } else {
      carry = kBig;
    }
  }
  if (any) *changed = 1;
}

int check_shape(int n, int h, int w) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535 || (long long)h * w >= kBig ||
      row_smem_bytes(w) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// fg: (n, h, w) uint8 (0/1) -> labels: (n, h, w) int32 initial labels.
extern "C" int arslam_ccl_strip_init(const uint8_t* fg, int* labels, int n,
                                     int h, int w, void* stream) {
  if (int rc = check_shape(n, h, w)) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)n * h * w;
  long long blocks = (total + kRowThreads - 1) / kRowThreads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  strip_init<<<(unsigned)blocks, kRowThreads, 0, s>>>(fg, labels, total,
                                                      h * w);
  return (int)cudaGetLastError();
}

// One Jacobi round on labels (n, h, w) int32, in place, through scratch of
// the same shape; *changed (device int32) ends 1 if any label changed, else 0.
extern "C" int arslam_ccl_strip_round(int* labels, int* scratch, int* changed,
                                      int n, int h, int w, void* stream) {
  if (int rc = check_shape(n, h, w)) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = row_smem_bytes(w);
  if (smem > kDefaultSmem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        strip_pool_row, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  cudaError_t rc = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (rc != cudaSuccess) return (int)rc;
  strip_pool_row<<<dim3(h, n), kRowThreads, smem, s>>>(labels, scratch, h, w);
  strip_col<<<dim3((w + kColThreads - 1) / kColThreads, n), kColThreads, 0,
              s>>>(scratch, labels, changed, h, w);
  return (int)cudaGetLastError();
}
