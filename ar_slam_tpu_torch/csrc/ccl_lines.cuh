// Line operations shared by the CCL kernels K2 (ccl.cu) and K3
// (ccl_strip.cu): one warp pools or run-min-scans one line of int32 labels
// held in shared memory.  Labels are linear indices < 2^30; background is
// 2^30, so foreground is "label < 2^30" and no separate mask is needed.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
// a background centre in a line of vertical minima (the sign bit is free,
// since labels are < 2^30)
constexpr int kBgMark = (int)0x80000000u;

// a lane's share of a line of n elements: odd, so lane i's walk from i * seg
// meets no other lane in a shared-memory bank
__host__ __device__ inline int lane_segment(int n) {
  return ((n + 31) / 32) | 1;
}

// The horizontal half of the 3x3 min-pool, in place: p[i] holds the
// vertical minimum of column i, marked by kBgMark where the centre pixel is
// background; afterwards p[i] is the 3x3 minimum on foreground and kBig on
// background.  Lane l owns [l * seg, l * seg + seg); the two outside
// neighbours are read before anyone writes.  Returns, in this lane, whether
// the horizontal minimum lowered a foreground centre below its vertical
// minimum.
__device__ bool pool_line_h(int* p, int w, int seg, int lane) {
  const int i0 = min(lane * seg, w), i1 = min(i0 + seg, w);
  int left = i0 > 0 ? p[i0 - 1] & ~kBgMark : kBig;
  const int right = i1 < w ? p[i1] & ~kBgMark : kBig;
  bool lowered = false;
  __syncwarp();
  for (int i = i0; i < i1; ++i) {
    const int cur = p[i];
    const int next = i + 1 < i1 ? p[i + 1] & ~kBgMark : right;
    const int v = cur & ~kBgMark;
    const int side = min(left, next);
    lowered |= !(cur & kBgMark) && side < v;
    p[i] = cur & kBgMark ? kBig : min(v, side);
    left = v;
  }
  return lowered;
}

// One warp replaces every foreground run of a line (elements v[i * stride],
// i < n) by the run's minimum.  Lane l owns [l * seg, l * seg + seg).
// Returns, in every lane, whether two neighbouring foreground elements of
// the line differed before the scan (i.e. whether it changed anything).
__device__ bool run_min_line(int* v, int stride, int n, int seg, int lane) {
  const int i0 = min(lane * seg, n), i1 = min(i0 + seg, n);
  // summary: min of the leading run, of the trailing run, all foreground?
  int lead = kBig, trail = kBig, all = 1;
  bool diff = false;
  int prev = i0 > 0 ? v[(i0 - 1) * stride] : kBig;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const int x = v[i * stride];
    if (x < kBig) {
      trail = min(trail, x);
      if (all) lead = x < lead ? x : lead;
      diff |= prev < kBig && prev != x;
    } else {
      trail = kBig;
      all = 0;
    }
    prev = x;
  }
  __syncwarp();  // every lane has read its left neighbour's last element
  // the run reaching into this segment from the left (min of its part left
  // of the segment) and from the right: inclusive scans of the composable
  // maps c -> all ? min(c, m) : m, then shifted by one lane
  int fa = all, fm = trail, ba = all, bm = lead;
  for (int off = 1; off < 32; off <<= 1) {
    const int ua = __shfl_up_sync(kFull, fa, off);
    const int um = __shfl_up_sync(kFull, fm, off);
    const int da = __shfl_down_sync(kFull, ba, off);
    const int dm = __shfl_down_sync(kFull, bm, off);
    if (lane >= off) {
      fm = fa ? min(um, fm) : fm;
      fa = fa && ua;
    }
    if (lane + off < 32) {
      bm = ba ? min(bm, dm) : bm;
      ba = ba && da;
    }
  }
  int left = __shfl_up_sync(kFull, fm, 1);
  int right = __shfl_down_sync(kFull, bm, 1);
  if (lane == 0) left = kBig;
  if (lane == 31) right = kBig;
  int run = left;  // forward: prefix minima of each run
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const int x = v[i * stride];
    run = x < kBig ? min(run, x) : kBig;
    v[i * stride] = run;
  }
  run = right;  // backward: each run's last prefix, i.e. its minimum
#pragma unroll 4
  for (int i = i1 - 1; i >= i0; --i) {
    const int x = v[i * stride];
    run = x < kBig ? min(run, x) : kBig;
    v[i * stride] = run;
  }
  return __any_sync(kFull, diff);
}

}  // namespace
