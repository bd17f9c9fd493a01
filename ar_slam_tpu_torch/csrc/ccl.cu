// K2: 8-connected component labelling of an (N, H, W) binary batch by the
// reference's fused Gauss-Seidel rounds, under its round cap.
//
// Replaces the fused Pallas CCL of ar_slam_tpu/detect/pallas_ccl.py
// (_ccl_fused_kernel behind connected_components_fused_batch), which the
// reference runs on planes up to FUSED_CCL_PIXEL_LIMIT.  There one grid
// step holds one plane in VMEM and runs rounds until a round changes
// nothing or ``iters`` rounds have run.  A round:
//
//   row stage:    the 64-row strips flagged dirty (all in round 0), in order
//                 and in place: 3x3 min-pool of the foreground, then the
//                 min over every full foreground run along each row.  A
//                 strip that changed dirties strips s-1..s+1 for the next
//                 round and flags each 128-wide column group it changed;
//   column stage: each flagged group: the min over every full foreground
//                 run along each column; a change in strip b dirties
//                 b-1..b+1.
//
// The labels under the cap depend on this schedule, flags included, so it
// is kept exactly (detect/ccl.py:fused_plane_plain transcribes it).  The
// in-place order parallelises: a running strip reads its tile before it
// writes it, so every row reads pre-round values except the strip's first
// row, whose pool reads the final row above it (new if strip s-1 ran, old
// if not), and that row is itself computed from pre-round values.  So a
// round is: (1) every running strip's rows from the pre-round plane, each
// strip's first row pooling the recomputed new row above where strip s-1
// ran; (2) the column stage; (3) the flag roll.  A group the row stage did
// not flag has no run to merge (a column run of two pixels would have
// lowered the lower one), so skipping it is exact.
//
// Design for the H100: one launch for the batch, one thread-block cluster
// of up to 8 CTAs per plane (two CTAs fit an SM, so a batch of 24 room-16
// planes is resident at once).  The rows of the dirty strips are dealt to
// all the row warps of the cluster; for the column stage each CTA owns a
// band of rows (strips may span two bands: the flags are ORed in CTA 0).
// The plane lives in device memory, in two buffers (labels and scratch; a
// room-16 batch is 2 x 18.8 MB, inside the 50 MB L2; a plane near the
// 1 M px limit is 4 MB, more than a cluster's shared memory holds): a
// dirty strip's row stage reads its current buffer and writes the other,
// which then becomes current, so nothing is copied; the labels get the
// strips left in scratch at the end.  Every read of the plane bypasses L1
// (ld.global.cg), since other SMs of the cluster write it, and a thread
// keeps 8-16 loads in flight.  The plane's flags (and which buffer holds
// each strip) live in the shared memory of the cluster's CTA 0, read and
// written through distributed shared memory; cluster.sync()
// (release/acquire at cluster scope) separates the stages.  The column
// stage spreads K3's warp scan over the cluster: each CTA summarises each
// flagged column of its band (leading-run min, trailing-run min, all
// foreground), the CTAs read each other's summaries, and each runs the
// min in place up and then down its band with the carries from both
// sides.  Each plane stops on the card at its own fixpoint or at the cap
// and records the rounds it ran; nothing is read back.  Labels are linear
// indices in the true width (y * W + x), which order pixels as the
// reference's padded-width labels do, so every min and flag agrees.
//
// Bound on the H100: latency.  A plane's rounds are a chain: a dirty row
// costs one warp ~45 instructions a pixel (pool, run-min scan, change
// flags) over rows read from L2, and each of a round's three cluster
// barriers waits for the stores before it; the slowest plane alone takes
// about as long as the batch.

// Launch rules: runs on the caller's stream, allocates nothing (the caller
// passes the labels, the scratch plane and the rounds), returns the launch
// error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ccl_lines.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kGroup = 128;     // column-group width (the reference's cstrip)
constexpr int kMaxStrips = 256;
constexpr int kMaxGroups = 64;  // W <= 8192
constexpr int kSumCols = 1024;  // columns summarised per cluster exchange
constexpr int kRowBatch = 8;    // row loads a lane keeps in flight
constexpr int kColBatch = 16;   // column loads a thread keeps in flight
constexpr int kMinBand = 16;    // rows, at least, of a CTA's band
constexpr int kMark = (int)0x80000000u;  // summary: all foreground
constexpr size_t kMaxSmem = 227 * 1024;

// The plane's flags, in the shared memory of the cluster's CTA 0.  Round r
// reads row[r & 1] (its dirty strips) and marks row[~r & 1] and any[r & 1];
// buf[s] says which buffer (0: labels, 1: scratch) holds strip s.
struct Flags {
  int row[2][kMaxStrips];
  int buf[kMaxStrips];
  int col[kMaxGroups];
  int any[2];
};

__device__ __forceinline__ void mark_dirty(Flags* f, int s, int n_rs,
                                           int cur) {
  for (int k = max(s - 1, 0); k <= min(s + 1, n_rs - 1); ++k)
    f->row[cur ^ 1][k] = 1;
  f->any[cur] = 1;
}

// The row stage's value of one row into the warp's line p, and the row's
// old values into the line o: vertical min of rows up, mid, dn (nullptr:
// outside the plane; up_s: the row above is in p already), marked where
// the centre is background, then the horizontal min, then the run-min
// along the row.
__device__ void pool_scan_row(const int* up, bool up_s, const int* mid,
                              const int* dn, int* p, int* o, int w, int seg,
                              int lane) {
  for (int x0 = lane; x0 < w; x0 += 32 * kRowBatch) {
    int c[kRowBatch], a[kRowBatch], b[kRowBatch];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int x = x0 + 32 * u;
      c[u] = x < w ? __ldcg(mid + x) : kBig;
      a[u] = x < w && up && !up_s ? __ldcg(up + x) : kBig;
      b[u] = x < w && dn ? __ldcg(dn + x) : kBig;
    }
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int x = x0 + 32 * u;
      if (x >= w) continue;
      const int v = min(c[u], min(up_s ? p[x] : a[u], b[u]));
      p[x] = c[u] < kBig ? v : (v | kBgMark);
      o[x] = c[u];
    }
  }
  __syncwarp();
  pool_line_h(p, w, seg, lane);
  __syncwarp();
  run_min_line(p, 1, w, seg, lane);
  __syncwarp();
}

// dst[x] = src[x] for x < w, by one warp, loads in flight kRowBatch at a
// time
__device__ void copy_row(const int* __restrict__ src, int* __restrict__ dst,
                         int w, int lane) {
  for (int x0 = lane; x0 < w; x0 += 32 * kRowBatch) {
    int v[kRowBatch];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u)
      v[u] = x0 + 32 * u < w ? __ldcg(src + x0 + 32 * u) : 0;
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u)
      if (x0 + 32 * u < w) dst[x0 + 32 * u] = v[u];
  }
}

// Column passes over n rows of one strip's buffer, from col (row 0, column
// x) at stride w, loads in flight kColBatch at a time; the state runs on
// from strip to strip.

// (leading-run min, trailing-run min, all foreground) of the column
__device__ void summarise(const int* col, int n, int w, int& lead,
                          int& trail, int& all) {
  for (int y = 0; y < n; y += kColBatch) {
    int v[kColBatch];
#pragma unroll
    for (int u = 0; u < kColBatch; ++u)
      v[u] = y + u < n ? __ldcg(col + (size_t)(y + u) * w) : kBig;
#pragma unroll
    for (int u = 0; u < kColBatch; ++u) {
      if (y + u >= n) break;
      if (v[u] < kBig) {
        trail = min(trail, v[u]);
        if (all) lead = min(lead, v[u]);
      } else {
        trail = kBig;
        all = 0;
      }
    }
  }
}

// One way of the in-place run-min: each label becomes the min of ``run``
// (the run reaching in from the previous rows) and itself, walking up
// (step -1, from row n - 1) or down (step 1, from row 0).  Returns whether
// it lowered a label.  Up then down leaves each pixel its run's minimum:
// the up pass leaves each pixel the min of its run from it downward, and
// the down pass the min of those from the run's top, which is the run's
// minimum.
__device__ bool sweep(int* col, int n, int w, int step, int& run) {
  bool lowered = false;
  for (int i = 0; i < n; i += kColBatch) {
    int v[kColBatch];
#pragma unroll
    for (int u = 0; u < kColBatch; ++u) {
      const int y = step > 0 ? i + u : n - 1 - i - u;
      v[u] = i + u < n ? __ldcg(col + (size_t)y * w) : kBig;
    }
#pragma unroll
    for (int u = 0; u < kColBatch; ++u) {
      if (i + u >= n) break;
      if (v[u] == kBig) {
        run = kBig;
      } else if (run < v[u]) {
        col[(size_t)(step > 0 ? i + u : n - 1 - i - u) * w] = run;
        lowered = true;
      } else {
        run = v[u];
      }
    }
  }
  return lowered;
}

__global__ void __launch_bounds__(kThreads, 2)
    ccl_fused(const uint8_t* __restrict__ fg, int* lab_all, int* tmp_all,
              int* __restrict__ rounds, int h, int w, int strip, int iters,
              int row_warps) {
  extern __shared__ int lines[];  // per row warp: the new row, the old row
  __shared__ Flags flags;         // the plane's, in CTA 0
  __shared__ int dirty[kMaxStrips];    // this round's dirty strips, in order
  __shared__ int run_l[kMaxStrips];    // strip s is dirty this round
  __shared__ int buf_l[kMaxStrips];    // the buffer strip s is in
  __shared__ int changed[kMaxStrips];  // strips this CTA changed this stage
  __shared__ int grp[kMaxGroups];      // groups this CTA's rows changed
  __shared__ int dcol[kMaxGroups];     // groups the column stage runs
  __shared__ int2 summ[kSumCols];
  __shared__ int n_dirty, go_on;

  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_rs = (h + strip - 1) / strip, n_cs = (w + kGroup - 1) / kGroup;
  // this CTA's band of rows (column stage) and the strips it overlaps
  const int y_lo = rank * h / n_cta, y_hi = (rank + 1) * h / n_cta;
  const int s0 = y_lo / strip, s1 = (y_hi - 1) / strip + 1;
  const size_t plane = (size_t)blockIdx.y * h * w;
  const uint8_t* f = fg + plane;
  int* const lab = lab_all + plane;
  int* const tmp = tmp_all + plane;
  Flags* f0 = cluster.map_shared_rank(&flags, 0);
  // row y in the buffer its strip is in now
  auto row_of = [&](int y) {
    return (buf_l[y / strip] ? tmp : lab) + (size_t)y * w;
  };

  for (int i = y_lo * w + tid; i < y_hi * w; i += kThreads)
    lab[i] = f[i] ? i : kBig;
  if (rank == 0) {
    for (int i = tid; i < n_rs; i += kThreads) {
      flags.row[0][i] = 1;
      flags.row[1][i] = 0;
      flags.buf[i] = 0;
    }
    for (int i = tid; i < n_cs; i += kThreads) flags.col[i] = 0;
    if (tid == 0) flags.any[0] = flags.any[1] = 0;
  }
  for (int i = tid; i < n_rs; i += kThreads) {
    changed[i] = 0;
    buf_l[i] = 0;
  }
  for (int i = tid; i < n_cs; i += kThreads) grp[i] = 0;
  cluster.sync();

  const int seg = lane_segment(w);
  int* p = lines + warp * 2 * 32 * seg;
  int* o = p + 32 * seg;
  int r = 0;
  while (r < iters) {
    const int cur = r & 1;
    for (int i = tid; i < n_rs; i += kThreads) run_l[i] = f0->row[cur][i];
    __syncthreads();
    if (warp == 0) {  // the dirty strips, in order
      int base = 0;
      for (int c0 = 0; c0 < n_rs; c0 += 32) {
        const bool d = c0 + lane < n_rs && run_l[c0 + lane];
        const unsigned ballot = __ballot_sync(kFull, d);
        if (d) dirty[base + __popc(ballot & ((1u << lane) - 1))] = c0 + lane;
        base += __popc(ballot);
      }
      if (lane == 0) n_dirty = base;
    }
    __syncthreads();

    // (1) row stage: the new value of every row of a dirty strip, into the
    // strip's other buffer; the rows are dealt to every row warp of the
    // cluster, so a round with a few dirty strips is short
    if (warp < row_warps) {
      const int n_rows = n_dirty * strip;
      for (int k = rank * row_warps + warp; k < n_rows;
           k += n_cta * row_warps) {
        const int s = dirty[k / strip], y = s * strip + k % strip;
        if (y >= h) continue;
        const int* row = row_of(y);
        const int* dn = y + 1 < h ? row_of(y + 1) : nullptr;
        bool up_s = false;
        if (y == s * strip && s > 0 && run_l[s - 1]) {
          // strip s-1 ran before this one: pool its final last row, which
          // is recomputed here from pre-round rows into p
          pool_scan_row(y > 1 ? row_of(y - 2) : nullptr, false, row_of(y - 1),
                        row, p, o, w, seg, lane);
          up_s = true;
        }
        pool_scan_row(y > 0 ? row_of(y - 1) : nullptr, up_s, row, dn, p, o, w,
                      seg, lane);
        int* t = (buf_l[s] ? lab : tmp) + (size_t)y * w;
        bool any = false;
        for (int x0 = 0; x0 < w; x0 += 32) {
          const int x = x0 + lane;
          bool ch = false;
          if (x < w) {
            ch = p[x] != o[x];
            t[x] = p[x];
          }
          const unsigned ballot = __ballot_sync(kFull, ch);
          if (ballot && lane == 0) grp[x0 / kGroup] = 1;
          any |= ballot != 0;
        }
        if (any && lane == 0) changed[s] = 1;
        __syncwarp();
      }
    }
    __syncthreads();
    for (int i = tid; i < n_dirty; i += kThreads)
      if (changed[dirty[i]]) {
        mark_dirty(f0, dirty[i], n_rs, cur);
        changed[dirty[i]] = 0;
      }
    for (int i = tid; i < n_cs; i += kThreads)
      if (grp[i]) {
        f0->col[i] = 1;
        grp[i] = 0;
      }
    cluster.sync();  // every pre-round read done; the flags complete

    // the dirty strips now live in their other buffer
    if (rank == 0) {  // no one reads this round's dirty strips or the last
      for (int i = tid; i < n_rs; i += kThreads) {
        flags.buf[i] ^= flags.row[cur][i];
        flags.row[cur][i] = 0;
      }
      if (tid == 0) flags.any[cur ^ 1] = 0;  // round's any-flag again
    }
    for (int i = tid; i < n_rs; i += kThreads) buf_l[i] ^= run_l[i];
    for (int i = tid; i < n_cs; i += kThreads) dcol[i] = f0->col[i];
    __syncthreads();

    // (2) column stage over the flagged groups, kSumCols columns at a time
    for (int cx0 = 0; cx0 < w; cx0 += kSumCols) {
      const int cx1 = min(w, cx0 + kSumCols);
      for (int x = cx0 + tid; x < cx1; x += kThreads) {
        if (!dcol[x / kGroup]) continue;
        int lead = kBig, trail = kBig, all = 1;
        for (int s = s0; s < s1; ++s) {
          const int y = max(s * strip, y_lo);
          summarise(row_of(y) + x, min(s * strip + strip, y_hi) - y, w, lead,
                    trail, all);
        }
        summ[x - cx0] = make_int2(all ? (lead | kMark) : lead, trail);
      }
      cluster.sync();  // every band's summaries written
      if (rank == 0 && cx0 == 0)  // each CTA has its copy of the groups
        for (int i = tid; i < n_cs; i += kThreads) flags.col[i] = 0;
      for (int x = cx0 + tid; x < cx1; x += kThreads) {
        if (!dcol[x / kGroup]) continue;
        int above = kBig, below = kBig;  // the run entering from each side
        for (int k = rank - 1; k >= 0; --k) {
          const int2 sk = cluster.map_shared_rank(summ, k)[x - cx0];
          if (sk.y >= kBig) break;
          above = min(above, sk.y);
          if (!(sk.x & kMark)) break;
        }
        for (int k = rank + 1; k < n_cta; ++k) {
          const int2 sk = cluster.map_shared_rank(summ, k)[x - cx0];
          const int lead = sk.x & ~kMark;
          if (lead >= kBig) break;
          below = min(below, lead);
          if (!(sk.x & kMark)) break;
        }
        for (int s = s1 - 1; s >= s0; --s) {
          const int y = max(s * strip, y_lo);
          if (sweep(row_of(y) + x, min(s * strip + strip, y_hi) - y, w, -1,
                    below))
            changed[s] = 1;
        }
        for (int s = s0; s < s1; ++s) {
          const int y = max(s * strip, y_lo);
          if (sweep(row_of(y) + x, min(s * strip + strip, y_hi) - y, w, 1,
                    above))
            changed[s] = 1;
        }
      }
      if (cx1 < w) cluster.sync();  // the next step reuses summ
    }
    __syncthreads();
    for (int s = s0 + tid; s < s1; s += kThreads)
      if (changed[s]) {
        mark_dirty(f0, s, n_rs, cur);
        changed[s] = 0;
      }
    cluster.sync();  // the plane and this round's flags complete

    // (3) roll: the plane stops after a round that changed nothing
    ++r;
    if (tid == 0) go_on = f0->any[cur];
    __syncthreads();
    if (!go_on) break;
  }
  // the band's rows that end in the scratch buffer go to the labels
  for (int y = y_lo + warp; y < y_hi; y += kWarps)
    if (buf_l[y / strip])
      copy_row(tmp + (size_t)y * w, lab + (size_t)y * w, w, lane);
  if (rank == 0 && tid == 0) rounds[blockIdx.y] = r;
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// The launch of a batch of planes of (h, w): cluster size, shared memory,
// row warps.  Returns false where the kernel does not take the shape.
bool launch_config(int h, int w, int strip, cudaLaunchConfig_t* cfg,
                   cudaLaunchAttribute* attr, int* row_warps) {
  if (h <= 0 || w <= 0 || strip <= 0 || (long long)h * w >= kBig ||
      (h + strip - 1) / strip > kMaxStrips ||
      (w + kGroup - 1) / kGroup > kMaxGroups)
    return false;
  const int bands = (h + kMinBand - 1) / kMinBand;
  const int n_cta = bands < kMaxCluster ? bands : kMaxCluster;
  // per row warp two lines of 32 * seg ints; as many row warps as leave
  // room for two CTAs on an SM, at least one
  const size_t line = (size_t)2 * 32 * lane_segment(w) * sizeof(int);
  const size_t static_smem = sizeof(Flags) + sizeof(int) *
      (4 * kMaxStrips + 2 * kMaxGroups + 2) + sizeof(int2) * kSumCols;
  *row_warps = kWarps;
  while (*row_warps > 1 && static_smem + *row_warps * line > kMaxSmem / 2)
    *row_warps >>= 1;
  const size_t smem = *row_warps * line;
  if (static_smem + smem > kMaxSmem) return false;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(n_cta, 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_cta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return true;
}

}  // namespace

// fg: (n, h, w) uint8 (0/1) -> labels: (n, h, w) int32 after at most
// ``iters`` rounds of strips of ``strip`` rows (the reference's padding:
// 64 where h > 64, else h rounded up to 8), through scratch of the same
// shape; rounds: (n,) int32, the rounds each plane ran.
extern "C" int arslam_ccl(const uint8_t* fg, int* labels, int* scratch,
                          int* rounds, int n, int h, int w, int strip,
                          int iters, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int row_warps;
  if (n <= 0 || n > 65535 || iters < 0 ||
      !launch_config(h, w, strip, &cfg, attr, &row_warps))
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      ccl_fused, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  cfg.gridDim.y = n;
  cfg.stream = (cudaStream_t)stream;
  rc = cudaLaunchKernelEx(&cfg, ccl_fused, fg, labels, scratch, rounds, h, w,
                          strip, iters, row_warps);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// How many planes of (h, w) the card holds at once (its most active
// clusters for this launch), or a negative CUDA error.
extern "C" int arslam_ccl_resident_planes(int h, int w, int strip) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int row_warps, clusters = 0;
  if (!launch_config(h, w, strip, &cfg, attr, &row_warps))
    return -(int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      ccl_fused, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveClusters(&clusters, ccl_fused, &cfg);
  return rc == cudaSuccess ? clusters : -(int)rc;
}
