// K4: extreme-point quads of the top-K components of each label plane.
//
// Replaces the Pallas kernel of ar_slam_tpu/detect/pallas_extract.py
// (_extract_kernel behind extreme_quads_pallas), which runs one grid step
// per (image, candidate root) and sweeps the whole VMEM-resident plane for
// each.  Per slot:
//
//   area, integer sums of x and y, bounding box;
//   A = member pixel farthest from the centroid;
//   C = member pixel farthest from A;
//   B, D = members of largest / smallest signed distance from line AC.
//
// Bound on the H100: reading the label planes once (0.29 GB, 0.09 ms at the
// main path's (24, 1512, 2016)).  So the work is split by what it must read
// (the one pass reads at about half the memory rate; the sweeps re-read
// each box three times; on small planes the six launches lead):
//
//   quad_stats: one pass over each plane for all K roots.  A block stages
//               the plane's roots in shared memory, sorted (stable, so the
//               lowest position of a root is its first slot); each warp
//               walks a contiguous range of rows, each lane 16 neighbouring
//               pixels a step, keeping running sums for the component it
//               is in and looking a label up by binary search only where a
//               run ends.  Sums go to 32-bit shared-memory atomics (64-bit
//               ones compile to compare-and-swap loops), then to global
//               ones.  Integer sums keep the centroid exactly as before.
//   quad_plan:  one block: tiles of 8192 bounding-box pixels per slot and
//               their prefix, so a large component spreads over many
//               blocks and a small one takes one tile;
//   quad_sweep: three launches (A, C, then B and D), each over every
//               slot's bounding box only.  The argmax key (score
//               descending, lowest linear index) is packed into one
//               order-preserving 64-bit word for atomicMax: the float's
//               bits flipped for order, then ~index.  Scores get +0.0f
//               first: bit order puts -0.0 below +0.0, where the float
//               compare of the reference calls them equal and lets the
//               lower index win (B and D's side distances produce both);
//   quad_finish: decodes the keys into (N, K, 4, 2).
//
// Scores are float32 with every product and sum rounded separately (no FMA
// contraction), as the reference and the plain version compute them; the
// centroid is exact wherever the float32 sums of the reference are (sums
// below 2^24).  A slot whose root is 2^30 (empty) or absent from the plane
// gives (0, 0) for all four points; a root held by several slots fills each
// from its first slot's sweeps.
//
// Launch rules: runs on the caller's stream, allocates nothing (the
// workspace comes from the caller), returns the first launch error.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanePixels = 16;  // pixels of a row a lane takes per step
constexpr int kRowStep = 32 * kLanePixels;
constexpr int kMaxStatBlocks = 64;  // quad_stats blocks per plane, at most
constexpr int kTileCells = 8192;    // bounding-box pixels per sweep tile
constexpr int kSweepBlocks = 132 * 4;
constexpr int kPlanThreads = 1024;

// per-slot workspace, u64 words: sums, the box (encoded so that every field
// starts at 0 and grows by atomicMax), the first slot holding the same
// root, and the argmax keys
enum { kArea, kSx, kSy, kTop, kBottom, kLeft, kRight, kFirst, kKeyA, kKeyC,
       kKeyB, kKeyD, kWs };
// per-root accumulators of a quad_stats block, all 32-bit (64-bit shared
// atomics compile to compare-and-swap loops): the coordinate sums as low
// and high words, the rest as in ws
enum { kAccXLo, kAccXHi, kAccYLo, kAccYHi, kAccArea, kAccTop, kAccBottom,
       kAccLeft, kAccRight, kAcc };

// adds a 64-bit value to the (low, high) word pair at a, carrying by hand
__device__ __forceinline__ void add_u64(unsigned* a, u64 v) {
  const unsigned lo = (unsigned)v, old = atomicAdd(a, lo);
  const unsigned hi = (unsigned)(v >> 32) + (old + lo < old ? 1u : 0u);
  if (hi) atomicAdd(a + 1, hi);
}

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }

// (score, lowest linear index) as one order-preserving word; 0 = no pixel
__device__ __forceinline__ u64 key(float s, int lin) {
  unsigned b = __float_as_uint(__fadd_rn(s, 0.0f));  // -0.0 -> +0.0
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((u64)b << 32) | (unsigned)~lin;
}

__device__ __forceinline__ int key_lin(u64 k) { return ~(int)(unsigned)k; }

// Scores, each operation rounded on its own (no FMA contraction).
__device__ __forceinline__ float sq_dist(float x, float y, float px,
                                         float py) {
  const float dx = __fsub_rn(x, px), dy = __fsub_rn(y, py);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float side(float x, float y, float ax, float ay,
                                      float nx, float ny) {
  return __fadd_rn(__fmul_rn(nx, __fsub_rn(x, ax)),
                   __fmul_rn(ny, __fsub_rn(y, ay)));
}

__global__ void quad_stats(const int* __restrict__ labels,
                           const int* __restrict__ roots,
                           u64* __restrict__ ws, int h, int w, int k) {
  __shared__ int s_root[kMaxK];  // the plane's roots, ascending (stable)
  __shared__ int s_slot[kMaxK];  // the slot of each
  __shared__ int s_in[kMaxK];    // the roots in slot order
  __shared__ unsigned s_acc[kMaxK][kAcc];
  const int plane = blockIdx.y;
  const int* r = roots + (long long)plane * k;
  for (int t = threadIdx.x; t < k; t += blockDim.x) s_in[t] = r[t];
  for (int i = threadIdx.x; i < k * kAcc; i += blockDim.x)
    (&s_acc[0][0])[i] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const int v = s_in[t];
    int rank = 0;
    for (int j = 0; j < k; ++j) {
      const int u = s_in[j];
      rank += u < v || (u == v && j < t);
    }
    s_root[rank] = v;
    s_slot[rank] = t;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* lab = labels + (long long)plane * h * w;
  // the first slot of each root, for the kernels after this one
  if (blockIdx.x == 0)
    for (int t = threadIdx.x; t < k; t += blockDim.x) {
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_root[mid] < s_in[t]) lo = mid + 1; else hi = mid;
      }
      ws[((long long)plane * k + t) * kWs + kFirst] = s_slot[lo];
    }

  // each warp walks a contiguous range of row steps (512 pixels of a row,
  // lane l taking the 16 pixels from 16 l on, as four int4 loads where the
  // width allows), so a lane's label changes only where a run ends
  const int steps = (w + kRowStep - 1) / kRowStep;
  const long long n_steps = (long long)h * steps;
  const long long warps = (long long)gridDim.x * kWarps;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  const long long g0 = n_steps * gw / warps, g1 = n_steps * (gw + 1) / warps;
  int cur = -1, slot = -1;  // label of the running sums, its sorted position
  unsigned area = 0;
  u64 sx = 0, sy = 0;
  unsigned top = 0, bottom = 0, left = 0, right = 0;  // encoded as in ws
  auto flush = [&]() {
    if (slot >= 0 && area) {
      unsigned* a = s_acc[slot];
      add_u64(a + kAccXLo, sx);
      add_u64(a + kAccYLo, sy);
      atomicAdd(a + kAccArea, area);
      atomicMax(a + kAccTop, top);
      atomicMax(a + kAccBottom, bottom);
      atomicMax(a + kAccLeft, left);
      atomicMax(a + kAccRight, right);
    }
    area = top = bottom = left = right = 0;
    sx = sy = 0;
  };
  const bool vec = w % 4 == 0;  // rows start 16-byte aligned
  for (long long g = g0; g < g1; ++g) {
    const int y = (int)(g / steps);
    const int xs = (int)(g - (long long)y * steps) * kRowStep +
                   lane * kLanePixels;
    const int* row = lab + (long long)y * w;
    int vals[kLanePixels];
    if (vec && xs + kLanePixels <= w) {
      const int4* q = reinterpret_cast<const int4*>(row + xs);
#pragma unroll
      for (int j = 0; j < kLanePixels / 4; ++j) {
        const int4 t = q[j];
        vals[4 * j] = t.x;
        vals[4 * j + 1] = t.y;
        vals[4 * j + 2] = t.z;
        vals[4 * j + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLanePixels; ++j)
        vals[j] = xs + j < w ? row[xs + j] : kBig;
    }
#pragma unroll
    for (int j = 0; j < kLanePixels; ++j) {
      const int v = vals[j];
      if (v >= kBig) continue;
      if (v != cur) {
        flush();
        cur = v;
        int lo = 0, hi = k;  // lower bound of v among the sorted roots
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_root[mid] < v) lo = mid + 1; else hi = mid;
        }
        slot = lo < k && s_root[lo] == v ? lo : -1;
      }
      if (slot < 0) continue;
      const int x = xs + j;
      area += 1;
      sx += x;
      sy += y;
      top = max(top, (unsigned)(h - y));
      bottom = max(bottom, (unsigned)(y + 1));
      left = max(left, (unsigned)(w - x));
      right = max(right, (unsigned)(x + 1));
    }
  }
  // the lanes' last runs, combined across the lanes of each root first:
  // they often share one (a warp that ends inside a large component)
  if (!area) slot = -1;
  const unsigned peers = __match_any_sync(kFull, slot);
  const int leader = __ffs(peers) - 1;
  for (int src = 0; src < 32; ++src) {
    const unsigned a = __shfl_sync(kFull, area, src);
    const u64 px = __shfl_sync(kFull, sx, src);
    const u64 py = __shfl_sync(kFull, sy, src);
    const unsigned t = __shfl_sync(kFull, top, src);
    const unsigned b = __shfl_sync(kFull, bottom, src);
    const unsigned l = __shfl_sync(kFull, left, src);
    const unsigned rr = __shfl_sync(kFull, right, src);
    if (lane == leader && src != lane && ((peers >> src) & 1u)) {
      area += a;
      sx += px;
      sy += py;
      top = max(top, t);
      bottom = max(bottom, b);
      left = max(left, l);
      right = max(right, rr);
    }
  }
  if (lane == leader) flush();
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const unsigned* a = s_acc[i];
    if (!a[kAccArea]) continue;
    u64* o = ws + ((long long)plane * k + s_slot[i]) * kWs;
    atomicAdd(o + kArea, (u64)a[kAccArea]);
    atomicAdd(o + kSx, ((u64)a[kAccXHi] << 32) | a[kAccXLo]);
    atomicAdd(o + kSy, ((u64)a[kAccYHi] << 32) | a[kAccYLo]);
    atomicMax(o + kTop, (u64)a[kAccTop]);
    atomicMax(o + kBottom, (u64)a[kAccBottom]);
    atomicMax(o + kLeft, (u64)a[kAccLeft]);
    atomicMax(o + kRight, (u64)a[kAccRight]);
  }
}

// sweep tiles of slot i: 0 for an empty slot, a later copy of a root, or a
// root absent from the plane
__device__ int slot_tiles(const int* roots, const u64* ws, int i, int k,
                          int h, int w) {
  const u64* s = ws + (long long)i * kWs;
  if (roots[i] == kBig || (int)s[kFirst] != i % k || !s[kArea]) return 0;
  const long long cells =
      (long long)((int)s[kBottom] - (h - (int)s[kTop])) *
      ((int)s[kRight] - (w - (int)s[kLeft]));
  return (int)((cells + kTileCells - 1) / kTileCells);
}

__global__ void quad_plan(const int* __restrict__ roots,
                          const u64* __restrict__ ws,
                          int* __restrict__ tile_start, int n, int h, int w,
                          int k) {
  __shared__ int part[kPlanThreads];
  const int total = n * k;
  const int per = (total + blockDim.x - 1) / blockDim.x;
  const int i0 = min((int)threadIdx.x * per, total), i1 = min(i0 + per, total);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += slot_tiles(roots, ws, i, k, h, w);
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {  // inclusive scan
    const int add = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += add;
    __syncthreads();
  }
  int run = part[threadIdx.x] - sum;
  for (int i = i0; i < i1; ++i) {
    tile_start[i] = run;
    run += slot_tiles(roots, ws, i, k, h, w);
  }
  if (threadIdx.x == blockDim.x - 1) tile_start[total] = run;
}

__device__ u64 block_max(u64 v, u64* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = umax(v, __shfl_down_sync(kFull, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 1; i < kWarps; ++i) v = umax(v, red[i]);
  __syncthreads();
  return v;  // in thread 0
}

// phase 0: key A (distance from the centroid); 1: key C (distance from A);
// 2: keys B and D (signed distance from line AC, largest and smallest)
__global__ void quad_sweep(const int* __restrict__ labels,
                           const int* __restrict__ roots,
                           u64* __restrict__ ws,
                           const int* __restrict__ tile_start, int n, int h,
                           int w, int k, int phase) {
  __shared__ u64 red[2][kWarps];
  const int slots = n * k;
  const int tiles = tile_start[slots];
  const int per = (tiles + gridDim.x - 1) / gridDim.x;
  const int t0 = blockIdx.x * per, t1 = min(t0 + per, tiles);
  if (t0 >= t1) return;
  int lo = 0, hi = slots;  // the slot whose tiles hold t0
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_start[mid] <= t0) lo = mid; else hi = mid;
  }
  for (int t = t0; t < t1; ++t) {
    while (tile_start[lo + 1] <= t) ++lo;  // the block's tiles are in order
    const int root = roots[lo];
    u64* s = ws + (long long)lo * kWs;
    const int* lab = labels + (long long)(lo / k) * h * w;
    const int y0 = h - (int)s[kTop], x0 = w - (int)s[kLeft];
    const int bw = (int)s[kRight] - x0;
    const int cells = ((int)s[kBottom] - y0) * bw;
    float px, py, nx = 0.0f, ny = 0.0f;
    if (phase == 0) {
      const float area = (float)s[kArea];
      px = __fdiv_rn((float)s[kSx], area);
      py = __fdiv_rn((float)s[kSy], area);
    } else {
      const int a = key_lin(s[kKeyA]);
      px = (float)(a % w);
      py = (float)(a / w);
      if (phase == 2) {
        const int c = key_lin(s[kKeyC]);
        nx = -__fsub_rn((float)(c / w), py);
        ny = __fsub_rn((float)(c % w), px);
      }
    }
    u64 best = 0, best2 = 0;
    const int c0 = (t - tile_start[lo]) * kTileCells + threadIdx.x;
    const int c1 = min(c0 - (int)threadIdx.x + kTileCells, cells);
    // (y, x) of cell c, stepped by blockDim.x cells without a division
    const int dy = blockDim.x / bw, dx = blockDim.x % bw;
    int y = y0 + c0 / bw, x = x0 + c0 % bw;
    for (int c = c0; c < c1; c += blockDim.x) {
      const int lin = y * w + x;
      const float fx = (float)x, fy = (float)y;
      x += dx;
      y += dy;
      if (x >= x0 + bw) {
        x -= bw;
        ++y;
      }
      if (lab[lin] != root) continue;
      if (phase < 2) {
        best = umax(best, key(sq_dist(fx, fy, px, py), lin));
      } else {
        const float sd = side(fx, fy, px, py, nx, ny);
        best = umax(best, key(sd, lin));
        best2 = umax(best2, key(-sd, lin));
      }
    }
    best = block_max(best, red[0]);
    if (phase == 2) best2 = block_max(best2, red[1]);
    if (threadIdx.x == 0) {
      atomicMax(s + (phase == 0 ? kKeyA : phase == 1 ? kKeyC : kKeyB), best);
      if (phase == 2) atomicMax(s + kKeyD, best2);
    }
  }
}

__global__ void quad_finish(const int* __restrict__ roots,
                            const u64* __restrict__ ws,
                            float* __restrict__ out, int n, int w, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * k) return;
  const int slot = i % k;
  float* o = out + (long long)i * 8;
  const u64* s = ws + (long long)i * kWs;
  if (roots[i] != kBig) s += ((long long)s[kFirst] - slot) * kWs;
  if (roots[i] == kBig || !s[kArea]) {
    for (int j = 0; j < 8; ++j) o[j] = 0.0f;
    return;
  }
  const int pts[4] = {key_lin(s[kKeyA]), key_lin(s[kKeyB]),
                      key_lin(s[kKeyC]), key_lin(s[kKeyD])};
  for (int j = 0; j < 4; ++j) {
    o[2 * j] = (float)(pts[j] % w);
    o[2 * j + 1] = (float)(pts[j] / w);
  }
}

}  // namespace

// labels: (n, h, w) int32; roots: (n, k) int32; out: (n, k, 4, 2) float32;
// ws: n * k * 12 u64 and tile_start: n * k + 1 int32 of scratch.
extern "C" int arslam_extract(const int* labels, const int* roots, float* out,
                              void* ws, int* tile_start, int n, int h, int w,
                              int k, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || k <= 0 || k > kMaxK || n > 65535 ||
      (long long)h * w >= kBig)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  u64* acc = (u64*)ws;
  cudaError_t rc = cudaMemsetAsync(acc, 0, sizeof(u64) * kWs * n * k, s);
  if (rc != cudaSuccess) return (int)rc;
  const long long steps = (long long)h * ((w + kRowStep - 1) / kRowStep);
  long long blocks = (steps + 4 * kWarps - 1) / (4 * kWarps);
  blocks = blocks < 1 ? 1 : blocks > kMaxStatBlocks ? kMaxStatBlocks : blocks;
  quad_stats<<<dim3((unsigned)blocks, n), kThreads, 0, s>>>(labels, roots, acc,
                                                          h, w, k);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  quad_plan<<<1, kPlanThreads, 0, s>>>(roots, acc, tile_start, n, h, w, k);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  for (int phase = 0; phase < 3; ++phase) {
    quad_sweep<<<kSweepBlocks, kThreads, 0, s>>>(labels, roots, acc,
                                                 tile_start, n, h, w, k,
                                                 phase);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  }
  quad_finish<<<(n * k + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      roots, acc, out, n, w, k);
  return (int)cudaGetLastError();
}
