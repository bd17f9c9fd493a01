// K2: 8-connected component labelling of an (N, H, W) binary batch.
//
// Replaces the fused Pallas CCL of ar_slam_tpu/detect/pallas_ccl.py
// (_ccl_fused_kernel behind connected_components_fused_batch).  The TPU
// kernel keeps the whole label plane resident in VMEM and iterates a
// 3x3 min-pool + segmented row/column min scans to a fixpoint.  That does
// not carry over: a 384x512 int32 plane is 768 KB, an H100 SM has 228 KB of
// shared memory.  This is a union-find labelling instead (Playne-Hawick):
//
//   1. init:    parent[i] = i on foreground, 2^30 on background;
//   2. merge:   each foreground pixel unites with its W, NW, N and NE
//               neighbours (the other four are covered by symmetry); a
//               union always links the LARGER root under the smaller one
//               with atomicMin, so every parent pointer points downwards;
//   3. flatten: every foreground pixel takes its root (path compression).
//
// Parents only ever point to smaller indices, so the surviving root of a
// component is its minimum linear index: the same label the reference
// computes.  Labels are linear indices in the true width (y * W + x), which
// is what the reference's padded-frame remap produces, so no remap is
// needed.  Union-find always resolves fully; the reference stops after
// ccl_iters rounds (a deliberate divergence only on shapes that need more).
//
// Bound on the H100: latency of the dependent parent-pointer reads in
// find() (random access, L2-resident at these plane sizes).  Merging only
// four neighbours per pixel halves the unions, and the flatten pass is one
// short pointer walk per pixel.
//
// Launch rules: runs on the caller's stream, allocates nothing (labels is
// the union-find forest itself), returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kThreads = 256;

__device__ __forceinline__ int find_root(const int* parent, int x) {
  const volatile int* p = parent;
  int up = p[x];
  while (up != x) {
    x = up;
    up = p[x];
  }
  return x;
}

__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    // a > b: hang root a under b.  If a stopped being a root meanwhile,
    // atomicMin may replace its link; unite what it pointed to with b too,
    // so no connection is lost.
    const int old = atomicMin(parent + a, b);
    if (old == a) return;
    a = old;
  }
}

__global__ void ccl_init(const uint8_t* __restrict__ fg, int* __restrict__ lab,
                         long long total, int hw) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x)
    lab[i] = fg[i] ? (int)(i % hw) : kBig;
}

__global__ void ccl_merge(const uint8_t* __restrict__ fg, int* lab,
                          long long total, int h, int w) {
  const int hw = h * w;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (!fg[i]) continue;
    const long long base = i - i % hw;
    const int p = (int)(i - base);
    const int y = p / w, x = p % w;
    const uint8_t* f = fg + base;
    int* parent = lab + base;
    if (x > 0 && f[p - 1]) unite(parent, p, p - 1);
    if (y > 0) {
      const int up = p - w;
      if (x > 0 && f[up - 1]) unite(parent, p, up - 1);
      if (f[up]) unite(parent, p, up);
      if (x + 1 < w && f[up + 1]) unite(parent, p, up + 1);
    }
  }
}

__global__ void ccl_flatten(const uint8_t* __restrict__ fg, int* lab,
                            long long total, int hw) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (!fg[i]) continue;
    const long long base = i - i % hw;
    lab[i] = find_root(lab + base, (int)(i - base));
  }
}

}  // namespace

// fg: (n, h, w) uint8 (0/1); labels: (n, h, w) int32 output.
extern "C" int arslam_ccl(const uint8_t* fg, int* labels, int n, int h, int w,
                          void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || (long long)h * w >= kBig)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)n * h * w;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  ccl_init<<<(unsigned)blocks, kThreads, 0, s>>>(fg, labels, total, h * w);
  ccl_merge<<<(unsigned)blocks, kThreads, 0, s>>>(fg, labels, total, h, w);
  ccl_flatten<<<(unsigned)blocks, kThreads, 0, s>>>(fg, labels, total, h * w);
  return (int)cudaGetLastError();
}
