// K6: the run scores of top-K component ranking, one pass over the sorted
// label rows.
//
// Replaces the two lax.cummax scans of ar_slam_tpu/detect/tpu_detect.py
// _top_k_components (XLA), and the elementwise chain around them.
// PyTorch's torch.cummax there gives a row to a block, or a few, and walks
// it chunk by chunk, so its time is set by the row's length (~4.4 ms for
// the 3 to 24 rows of 762 048 cells of a 12 MP detection).
//
// Input: each row of s (B, P) int32 holds a plane's pooled labels sorted
// ascending (stable); sp (B, P) int64 the grid position of each, in
// [0, P).  A run of equal labels is one component.  At cell i of a row:
//
//   start(i) = i == 0 || s[i] != s[i-1],  end(i) = i == P-1 || s[i] != s[i+1];
//   first    = the largest sp[j] over the starts j <= i (the reference's
//              cummax: not always the run's own first position, since a
//              lower label may first appear later in the grid);
//   area     = i - (the last start <= i) + 1 at an end with s[i] != 2^30,
//              else 0;
//   span     = floor(sp[i] / grid_w) - floor(first / grid_w) + 1;
//   fill     = area / max(span * span, 1);
//   score    = area * (2 - min(fill, 1)), or, with max_area, where
//              !(area <= max_area): 0.5 + area / (2P + 1).
//
// Written: score and area (float32) at every cell, as the plain chain
// (detect/rank.py run_scores_plain) does.  Every float operation is
// rounded on its own (no FMA, IEEE division), the integers converted to
// float32 to nearest, as the chain computes them on the CPU.
//
// Design: one thread takes 8 neighbouring cells, a block a tile of 2048
// cells, the grid every tile of every row, so the grid grows with the work
// whatever the number of rows.  Both running values are prefix maxima
// over the row's starts (the last start is the largest start position),
// so a tile needs only the maxima over the tiles before it in its row, by
// a decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016): a block takes the next tile in
// start order (an atomic counter; the tiles of all rows interleaved, so
// that few tiles of a row run at once), publishes its tile's two maxima as
// soon as it has read its cells, then reads the words of the 256 tiles
// before it at a time, back to the nearest one that holds its whole
// prefix, and publishes its own prefix.  Every tile waited on has started
// and publishes before it waits on anything.  A tile's word packs a
// status and both maxima (each + 1 in 31 bits: rows under 2^31 cells).
// The cells are read once and the outputs written once, both through
// shared memory so that a warp's accesses are contiguous.  On an H100 at
// 12 x 762 048: 0.110 ms, 0.093 without the look-back, against 0.099 for
// a copy of the inputs; tiles in row order with a warp's look-back of 32
// took 0.135 (~400 tiles of a row at once, each looking back ~200).
//
// Launch rules: runs on the caller's stream, allocates nothing (the
// workspace comes from the caller and is cleared here), returns the first
// launch error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // cells a thread
constexpr int kTile = kThreads * kItems;   // cells a block
// a tile's word: status (2 bits), last start + 1, largest position + 1
constexpr int kStatus = 62;
constexpr u64 kAggregate = 1ull << kStatus;  // the tile's own maxima
constexpr u64 kPrefix = 2ull << kStatus;     // the maxima up to its end
constexpr u64 kField = (1ull << 31) - 1;

__device__ __forceinline__ u64 load_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

// torch.div(..., rounding_mode="floor") on int64
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ u64 pack(u64 status, long long pos,
                                    long long gp) {
  return status | ((u64)(pos + 1) << 31) | (u64)(gp + 1);
}

__global__ void __launch_bounds__(kThreads)
    run_scores(const int* __restrict__ s, const long long* __restrict__ sp,
               float* __restrict__ score, float* __restrict__ area,
               u64* __restrict__ flags, u64* __restrict__ next_tile,
               int rows, long long p, int tiles, long long grid_w,
               int has_max, float max_area, float demote_den) {
  __shared__ int s_tile;
  __shared__ long long s_a[kWarps], s_b[kWarps];
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(next_tile, 1ull);
  __syncthreads();
  // tiles in start order, column-major: a row's tiles spread over the
  // launch, so few of them run at once and the look-back stays short
  const int row = s_tile % rows, t = s_tile / rows;
  const long long base = (long long)row * p;
  u64* const wrow = flags + (long long)row * tiles;  // the row's words
  const long long i0 = (long long)t * kTile + (long long)threadIdx.x * kItems;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the tile through shared memory, so that every global access of a warp
  // is 512 contiguous bytes; the outputs leave the same way
  __shared__ __align__(16) long long s_g[kTile];  // then score and area
  __shared__ __align__(16) int s_v[kTile];
  const long long t0 = base + (long long)t * kTile;
  const bool vec = (long long)(t + 1) * kTile <= p && t0 % 4 == 0 &&
                   ((uintptr_t)s % 16) == 0 && ((uintptr_t)sp % 16) == 0 &&
                   ((uintptr_t)score % 16) == 0 && ((uintptr_t)area % 16) == 0;
  int v[kItems];
  long long g[kItems];
  int prev = 0, next = 0;
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(s + t0);
    const longlong2* g2 = reinterpret_cast<const longlong2*>(sp + t0);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q)
      reinterpret_cast<int4*>(s_v)[q * kThreads + threadIdx.x] =
          s4[q * kThreads + threadIdx.x];
#pragma unroll
    for (int q = 0; q < kItems / 2; ++q)
      reinterpret_cast<longlong2*>(s_g)[q * kThreads + threadIdx.x] =
          g2[q * kThreads + threadIdx.x];
    if (threadIdx.x == 0 && t > 0) prev = s[t0 - 1];
    if (threadIdx.x == kThreads - 1 && i0 + kItems < p)
      next = s[base + i0 + kItems];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 x =
          reinterpret_cast<const int4*>(s_v)[threadIdx.x * kItems / 4 + q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int q = 0; q < kItems / 2; ++q) {
      const longlong2 x = reinterpret_cast<const longlong2*>(
          s_g)[threadIdx.x * kItems / 2 + q];
      g[2 * q] = x.x;
      g[2 * q + 1] = x.y;
    }
    if (threadIdx.x > 0) prev = s_v[threadIdx.x * kItems - 1];
    if (threadIdx.x < kThreads - 1) next = s_v[threadIdx.x * kItems + kItems];
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool in = i0 + k < p;
      v[k] = in ? s[base + i0 + k] : kBig;
      g[k] = in ? sp[base + i0 + k] : -1;
    }
    if (i0 > 0 && i0 < p) prev = s[base + i0 - 1];
    if (i0 + kItems < p) next = s[base + i0 + kItems];
  }

  // the thread's starts: the last one's cell, the largest position
  long long tp = -1, tg = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = i0 + k;
    const bool start = i < p && (i == 0 || v[k] != (k ? v[k - 1] : prev));
    if (start) {
      tp = i;
      tg = lmax(tg, g[k]);
    }
  }

  // inclusive maxima within the warp
  long long ip = tp, ig = tg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long op = __shfl_up_sync(kFull, ip, d);
    const long long og = __shfl_up_sync(kFull, ig, d);
    if (lane >= d) {
      ip = lmax(ip, op);
      ig = lmax(ig, og);
    }
  }
  long long ep = __shfl_up_sync(kFull, ip, 1);
  long long eg = __shfl_up_sync(kFull, ig, 1);
  if (lane == 0) ep = eg = -1;
  if (lane == 31) {
    s_a[warp] = ip;
    s_b[warp] = ig;
  }
  __syncthreads();
  long long ap = -1, ag = -1;  // the tile's
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
      ep = lmax(ep, ap);
      eg = lmax(eg, ag);
    }
    ap = lmax(ap, s_a[w]);
    ag = lmax(ag, s_b[w]);
  }
  if (threadIdx.x == 0)
    store_relaxed(wrow + t, pack(t ? kAggregate : kPrefix, ap, ag));
  // the maxima over the earlier tiles of the row: thread i reads tile
  // j - i, each warp up to its nearest word that holds a prefix, the
  // block up to the nearest warp that found one
  __shared__ long long s_wp[kWarps], s_wg[kWarps];
  __shared__ int s_pre[kWarps];
  long long cp = -1, cg = -1;
  for (int j = t - 1; j >= 0; j -= kThreads) {
    const int jj = j - threadIdx.x;
    u64 w = jj >= 0 ? load_relaxed(wrow + jj) : kPrefix;
    while (__any_sync(kFull, (w >> kStatus) == 0))
      if ((w >> kStatus) == 0) w = load_relaxed(wrow + jj);
    const unsigned prefix = __ballot_sync(kFull, (w >> kStatus) == 2);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    long long wp = -1, wg = -1;
    if (lane <= stop && jj >= 0) {
      wp = (long long)((w >> 31) & kField) - 1;
      wg = (long long)(w & kField) - 1;
    }
    for (int d = 16; d > 0; d >>= 1) {
      wp = lmax(wp, __shfl_xor_sync(kFull, wp, d));
      wg = lmax(wg, __shfl_xor_sync(kFull, wg, d));
    }
    if (lane == 0) {
      s_wp[warp] = wp;
      s_wg[warp] = wg;
      s_pre[warp] = prefix != 0;
    }
    __syncthreads();
    bool found = false;
    for (int w2 = 0; w2 < kWarps && !found; ++w2) {
      cp = lmax(cp, s_wp[w2]);
      cg = lmax(cg, s_wg[w2]);
      found = s_pre[w2];
    }
    __syncthreads();  // s_wp, s_wg, s_pre read by every thread
    if (found) break;
  }
  if (threadIdx.x == 0 && t)
    store_relaxed(wrow + t, pack(kPrefix, lmax(cp, ap), lmax(cg, ag)));
  long long run_p = lmax(ep, cp), run_g = lmax(eg, cg);

  float sc[kItems], ar[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = i0 + k;
    const int nx = k + 1 < kItems ? v[k + 1] : next;
    if (i < p && (i == 0 || v[k] != (k ? v[k - 1] : prev))) {
      run_p = i;
      run_g = lmax(run_g, g[k]);
    }
    float a = 0.0f, x = 0.0f;  // 0 * (2 - 0) off the ends
    if (i < p && (i == p - 1 || v[k] != nx) && v[k] != kBig) {
      a = __ll2float_rn(i - run_p + 1);
      const long long span =
          floor_div(g[k], grid_w) - floor_div(run_g, grid_w) + 1;
      long long sq = span * span;
      sq = sq < 1 ? 1 : sq;
      float fill = __fdiv_rn(a, __ll2float_rn(sq));
      fill = fill > 1.0f ? 1.0f : fill;
      x = __fmul_rn(a, __fsub_rn(2.0f, fill));
    }
    if (has_max && !(a <= max_area)) x = __fadd_rn(0.5f, __fdiv_rn(a, demote_den));
    sc[k] = x;
    ar[k] = a;
  }
  if (vec) {
    __syncthreads();  // every thread has read its cells from s_v, s_g
    float4* out = reinterpret_cast<float4*>(s_g);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      out[threadIdx.x * kItems / 4 + q] =
          make_float4(sc[4 * q], sc[4 * q + 1], sc[4 * q + 2], sc[4 * q + 3]);
      out[kTile / 4 + threadIdx.x * kItems / 4 + q] =
          make_float4(ar[4 * q], ar[4 * q + 1], ar[4 * q + 2], ar[4 * q + 3]);
    }
    __syncthreads();
    float4* o = reinterpret_cast<float4*>(score + t0);
    float4* r = reinterpret_cast<float4*>(area + t0);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      o[q * kThreads + threadIdx.x] = out[q * kThreads + threadIdx.x];
      r[q * kThreads + threadIdx.x] = out[kTile / 4 + q * kThreads + threadIdx.x];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (i0 + k < p) {
        score[base + i0 + k] = sc[k];
        area[base + i0 + k] = ar[k];
      }
  }
}

}  // namespace

// The workspace: rows * ceil(p / 2048) + 1 64-bit words.
extern "C" int arslam_run_scores(const int* s, const long long* sp,
                                 float* score, float* area, void* ws,
                                 int rows, int p, int grid_w, int has_max,
                                 double max_area, void* stream) {
  if (rows <= 0 || p <= 0 || grid_w <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (p + (long long)kTile - 1) / kTile;
  if (rows * tiles >= (1ll << 31) || p >= (int)kField)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  u64* flags = (u64*)ws;
  cudaError_t rc = cudaMemsetAsync(
      flags, 0, sizeof(u64) * (rows * tiles + 1), st);
  if (rc != cudaSuccess) return (int)rc;
  // 2P + 1 as the chain's Python float, then float32 as the chain's divide
  const float den = (float)(2.0 * (double)p + 1.0);
  run_scores<<<(unsigned)(rows * tiles), kThreads, 0, st>>>(
      s, sp, score, area, flags, flags + rows * tiles, rows, p, (int)tiles,
      grid_w, has_max, (float)max_area, den);
  return (int)cudaGetLastError();
}
