"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--tag-mm 50]

(``--one-shot-map MODE SRC OUT`` runs one process of phase 19,
``--mesh-map MODE SPEC SRC OUT`` one of phase 17.)

Phases (each prints one JSON line; any failure exits non-zero):

1. device  — requires CUDA; prints the card's name and power limit;
2. build   — compiles the CUDA kernels from ar_slam_tpu_torch/csrc (one
   nvcc per source, in parallel);
3. kernels — each kernel against its plain PyTorch version on rendered
   frames at the shapes of both main paths below: K1's threshold use
   (uint8 frames, windows 3/13/23, one launch) bool for bool, K1's field
   use (the five refine maps at window 11) bit for bit and within 1e-5 of
   a float64 sum, K2 and K3 (connected components) exactly under their
   24-round cap, K2 also with its per-plane rounds on a serpentine the cap
   cuts short, 45 % noise and (8, 896, 1024) planes just under the fused
   limit, K4 (extreme points) exactly where its coordinate sums are below
   2^24 and within 2 px elsewhere, K3 also on a serpentine cut short by
   its cap; whether the cap binds (K2 with a cap no plane reaches gives
   the fixpoint); the rounds each plane ran and K3's row- and
   column-stage device ms per round (torch.profiler); median CUDA-event
   times of the kernel, its plain version and, for K1, the library call
   F.avg_pool2d;
4. room-16 — 16 rendered 1020x768 frames of a 24-tag room through the
   engine (add_decoded in batches of 8 -> solve -> save_map); K1 (both
   uses), K2 and K4 must launch (K3 not, and no K2 rounds read), every
   rendered tag of side >= 40 px must be found with its true id, no
   foreign id may appear, the map's rmse must be < 1 px, and map.yaml must
   reload through the fast parser with the same tags;
5. phone_12mp — 12 rendered 4032x3024 phone photos of the room (50 mm
   tags, 114-182 px): frames
   0-7 mapped (one batch of 8), the map saved, then a fresh engine loads it
   and localizes frames 8-11, taken between the map's viewpoints
   (engine.localize_decoded); K1 (both uses), K3 and K4 must
   launch and K2 not, every rendered tag of side >= 80 px must be found
   with its true id and no foreign id, map and localize rmse < 1 px, every
   query localized, each query camera within 2 cm of the rendered truth
   after aligning the map's cameras to it (utils/ate.py), and the card's
   float32 localization within 1e-3 (pose) and 0.01 px (rmse) of a float64
   CPU localization of the same detections against the same map;
6. serve_12mp — the same 12 frames as .npy files (np.load stands in for
   the image decoder: the card has no PIL) streamed through
   StreamPipeline in batches of 8 + 4: the ingest thread decodes, the
   detect thread runs the detector, the merge stage joins, and this
   thread runs solve_incremental twice (the second call replays the 8
   solved captures and attaches 4), recording an event log; K1 (both
   uses), K3 and K4 must launch, only from the detect thread, and K2 not;
   12 waves, 0 unsolved, every merge published, the tags as in
   phone_12mp, rmse < 1 px, every camera within 2 cm of the truth after
   alignment; a second engine's add_images + solve_incremental over the
   same batches (serve --sequential) must give the same captures and
   stats, rmse within 1e-3 px and focal within 1e-4; the replay command
   must rebuild the same blocks from the event log at rmse < 1 px.
   Printed: both runs' wall seconds, each stage's seconds, the
   detect/solve and ingest/detect overlaps, each solve_incremental call;
7. solver  — the 500-tag / 200-capture synthetic in float32: final cost
   within 1e-3 relative of the float64 optimum 3771.57, and LM
   iterations/s from two iteration budgets;
8. solver_cg_10k — implicit-Schur CG (``--iterative-schur``) at the
   large-map scale: make_synthetic_map(10000, 4000) (9 860 tags, 4 000
   captures, 262 839 blocks) in float32, row-split slot packing (8 slots a
   row), 12 LM iterations; the final cost must be finite and below the
   initial one, and one CG solve must raise nothing under
   torch.cuda.set_sync_debug_mode("error") (no host read);
9. solver_cg_vs_dense_2000 — 2 000 tags / 800 captures in float32, CG and
   dense each to convergence: both rmse < 1 px, costs within 1e-2;
10. solver_flat_500 — the 500-tag problem through lm_solve without
   observation bounds (the flat hooks, their sums in a fixed order),
   replaying CUDA graphs: cost within 1e-3 of 3771.57, one capture and
   1 + 2 x iterations replays a call, and the same LM eager and graphed
   bit for bit (host ms per iteration; launches and device ms profiled
   last, ``solver_flat_500_profile``);
11. map_cg_room16 — room-16's detections (from phase 4) mapped again with
   linear_solver="cg": rmse < 1 px, every tag in the map;
12. progress — room-16's first 4 captures solved with
   minimizer_progress_to_stdout, in float64: >= 2 iteration lines and a
   terminating line, rmse within 1e-3 px of the ordinary solve; each
   one-iteration LM call a load and replays of the LM program (1 + 2 x
   iterations), its cost and printed line bit for bit the eager
   stepping's (``graphs=False``);
13. mesh_detect — room-16's 16 frames and phone_12mp's 8 frames through
   parallel.detect.detect_batch_sharded over three shards of the card
   (neither batch divides by 3: padding); every output bit for bit the
   unsharded batch's; K1 (both uses), K2 or K3, and K4 must launch, each
   shard's launches printed;
14. mesh_solver_500 — the 500-tag problem through the tag-sharded
   lm_solve_dist over 1, 2 and 4 shards of the card: final cost within
   1e-3 of 3771.57, exactly 1 + 2 x iterations reductions, LM
   iterations/s beside the single-device rate; the LM replays CUDA
   graphs (parallel/dist_lm.py; its shards on one card or spread over
   several): one capture, then a call replays ``setup`` and per iteration
   ``step`` and ``accept`` or ``reject``;
15. mesh_cg_10k — the 10k map of phase 8 (not generated again), CG over
   two shards for 12 LM iterations: cost finite and below the initial
   one, rmse within 1e-2 px of phase 8's, the replays as in phase 14,
   one sharded CG solve with no synchronising call, peak memory and LM
   iterations/s;
16. mesh_map_room16 — room-16's detections mapped again through
   solve(store, mesh=block_mesh(devices=_shard_devices(2))): rmse within
   1e-3 px of the dense map's, every tag, the mesh's seeds and LM
   replayed (two captures);
17. multihost_1 — ``arslam-torch map`` of phone_12mp's saved map with
   ``--multihost 127.0.0.1:<port>,1,0`` in a subprocess (one NCCL
   process; ``chip_smoke.py --mesh-map``), eager and graphed: rmse equal
   to the in-process solve's within 1e-3 px, the two maps the same text,
   the graphed process replaying its graphs (and two and four NCCL
   processes where the machine has as many cards, graphed whatever cards
   each owns: their NCCL all_reduce inside the graphs);
18. solve_graphs — the single-device LM and localize through their CUDA
   graphs (solve/graphs.py) against the eager loops (``graphs=False``):
   synthetic-500 dense (budgets 8 and 32), room-16's LM over its 16
   captures (poses moved by N(0, 0.005); budgets 4 and 16), room-16's
   whole map solve, the 10k CG map of phase 8 (budgets 3 and 12) and
   phone_12mp's localize of its 4 queries (budgets 4 and 16, and the
   default config); every result bit for bit the eager one's, host ms per
   LM iteration between the budgets, capture ms, graph-pool and peak
   memory; then whole calls, eager and graphed, each with its host ms,
   launches, graph launches and device ms: room-16's last flush (its
   seeds, warmup LM and joint LM, from the state ``solve`` reaches
   before it), that flush's seeds alone, and a phone_12mp localize call
   (the seeding ``init`` and the iterations).  Phases 4-6 also require
   the solve and localize to replay graphs, every capture of them to
   make no ``torch.cuda.synchronize`` and no ``empty_cache`` call (the
   ``capture_syncs`` line), and each rmse to stay within 1e-4 px of the
   one the torch.func Jacobians gave (``JACFWD_RMSE_PX``);
19. one_shot_map — ``arslam-torch map`` of room-16's saved map in two
   fresh processes, eager then graphed (the eager loop through
   ``solve(graphs=False)``, which no flag of the command reaches): each
   process's wall, import, CUDA start, command and solve seconds, whether
   ``torch._dynamo`` or sympy was imported (neither may be), each
   program's first warm-up round by stage and the captures' recording
   ms; the two maps written must be the same text;
20. serve_growth — solve_incremental, one call per batch of 8 captures
   as serve runs it, over make_synthetic_map(200, 64) growing through its
   padding buckets: after each call the captures made, the programs held
   (two: the seeds' and the LM's), the graph pools' and the reserved
   memory; rmse < 1 px and no capture unsolved at the end;
21. mesh_graphs (run after solve_graphs) — the tag-sharded LM through its
   CUDA graphs (one graph a stage, each shard's work on a branch stream
   of its own) against its eager stages on shards of one card:
   synthetic-500 dense over 1, 2 and 4 shards (budgets 8 and 32), the
   10k CG map over 2 (budgets 3 and 12): results bit for bit, host ms per
   LM iteration and LM iterations/s, one capture and 1 + 2 x iterations
   replays a call, capture ms, pool and peak memory (launches and device
   ms per iteration profiled last, ``mesh_graphs_profile``, per card on
   several); and room-16's map solve over 2 shards, eager once and
   graphed twice (the first captures), beside the single-device graphed
   solve: seconds, the mesh LM's iterations and the ms of its LM calls
   per iteration, the same map bit for bit.  On several cards the same
   cells also spread over them (synthetic-500 over 2 and 4 shards, 10k CG
   over 2 and, with 4 cards, 4, room-16's map over 2), with each card's
   peak and pool;
22. detect_graphs (run after solve_graphs) — the detector through its
   CUDA graphs (detect/detect.py, programs.py) against its eager stage
   (``graphs=False``): room-16's two batches of (8, 768, 1020), phone_12mp's
   map batch of (8, 3024, 4032) and localize batch of 4, and mesh_detect's
   two batches over three shards of the card; per cell the outputs bit
   for bit, one capture per (card, shape) with a replay a shard's call
   after it, host ms per call (median of 3 after a first call), capture
   ms, the pools' and the peak GB; launches, graph launches, device ms
   and the idle share per call profiled last (``detect_graphs_profile``).
   Phases 4-6 and 13 detect through replays too: each detection call of
   theirs must be one replay of the detector's graph.

A mesh of k shards puts shard i on card i mod the card count: on one
card all shards share it (graphed, each on a branch stream of its own;
their times are what they are, not a speedup); on a machine with several
cards the same phases spread over them, one graph a stage spanning the
cards, mesh_cg_10k also runs 4 shards and multihost_1 also 2 (and 4)
NCCL processes.

Last, where the time goes in one CG LM iteration at 10k (the CG solve,
the step quality, the relinearization): wall ms on the host clock (taken
in phase 8, before any profiler attaches), device ms and items from
torch.profiler, and both per CG step; then solve_graphs' launches (the
runtime calls that enqueue work, graph launches among them), device items
and device ms per LM iteration, eager and graphed, from torch.profiler
runs at budgets 2 and 4, and mesh_graphs' likewise.
With --profile, one detection batch of each cell and phone_12mp's
localization then run under torch.profiler (device time, idle share, the
host-to-device bytes and ms, the largest device items).  Then the kernel
table as one JSON line, and last {"ok": true, "device": {...}}.  Uses no
jax, PIL, cv2 or yaml.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
F64_OPTIMUM_500 = 3771.57  # BASELINE.md, CPU float64 solve of the same map
CG_VS_DENSE_REL = 1e-2  # f32 CG and dense stop at points of a shallow valley
PROGRESS_RMSE_TOL_PX = 1e-3  # host-stepped vs one-call LM (tests/test_lm.py)
ROW_SLOTS = 8  # the CG path's row-split packing (solve/batch.py)
DEVICE = "cuda"
MESH_CARD = "cuda:0"  # mesh_graphs' shards share this card
HBM_BYTES_PER_S = 3.35e12  # H100 SXM 80 GB, NVIDIA data sheet (700 W)
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, same source
PHONE_SIDE_PX = 80.0  # tags below this side need not be found at 12 MP
# phone_12mp prints 50 mm tags (sides 114-182 px in the frames); with the
# room-16 size of 63.5 mm (--tag-mm 63.5, sides 145-231 px) one frame
# decodes a foreign id, as the JAX detector does too (PERF.md, Findings)
PHONE_TAG_M = 0.05
QUERY_POSITION_M = 0.02  # query camera position bound after alignment
# K4 slots whose coordinate sums reach 2^24: the float32 centroids of the
# kernel (integer sums) and the plain version (float sums) may differ in the
# last bits, which can flip an argmax between two tied neighbouring extreme
# pixels, so their corners are held within 2 px
K4_INEXACT_TOL_PX = 2.0
F32_POSE_TOL, F32_RMSE_TOL_PX = 1e-3, 0.01  # card float32 vs CPU float64
# serve_12mp, pipelined vs sequential: the same detections and solves in
# another thread interleaving; only reduction order on the card may differ
SERVE_RMSE_TOL_PX, SERVE_FOCAL_TOL = 1e-3, 1e-4
# phone_12mp camera arc: the 8 map frames evenly along it, the 4 queries
# halfway between map frames 0-1, 2-3, 4-5 and 6-7 (photos taken inside
# the mapped stretch of the room)
PHONE_ARC = [i / 7 for i in range(8)] + [(i + 0.5) / 7 for i in (0, 2, 4, 6)]


# each cell's rmse with the Jacobians of torch.func.jacfwd, the plain
# version the jets of core/jet.py are held to (tests/test_torch_jet.py):
# the jets move the last bits of every Jacobian, not the optimum
JACFWD_RMSE_PX = {"room-16": 0.5854781062953117,
                  "phone_12mp map": 0.16911114668753466,
                  "phone_12mp localize": 0.1963597989953149,
                  "serve_12mp": 0.1735787689156555}
JET_RMSE_TOL_PX = 1e-4
MESH_RMSE_TOL_PX = 1e-3  # mesh_map_room16, multihost_1 vs the dense map
MESH_CG_RMSE_TOL_PX = 1e-2  # mesh_cg_10k vs phase 8 (CG follows rounding)
MULTIHOST_TIMEOUT_S = 180
ONE_SHOT_TIMEOUT_S = 180


# the launch counter (read_counts key) behind each kernel row
COUNTERS = {"threshold (K1)": "box_threshold", "box_sum (K1)": "box",
            "connected_components (K2)": "ccl",
            "connected_components_strip (K3)": "ccl_strip",
            "extreme_quads (K4)": "extract"}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def timed(phase: str, fn, *args):
    """fn(*args), then a line with its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit("seconds", of=phase, seconds=time.perf_counter() - t0)
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync_cards() -> None:
    """Wait for every card (torch.cuda.synchronize waits for the current
    one only)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median milliseconds of fn() over reps, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    """Least milliseconds the card could take: the larger of the bytes over
    the memory rate and the float32 operations over their peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(line, flush=True)
    n = torch.cuda.device_count()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=line,
         torch=torch.__version__, cuda=torch.version.cuda, cards=n,
         peer_access={f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
                      for i in range(n) for j in range(n) if i != j})
    return line


def phase_build():
    from ar_slam_tpu_torch import cuda

    t0 = time.perf_counter()
    path = cuda.build()
    cuda.library()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=cuda.build_seconds, library=os.path.relpath(path, REPO))


WINDOWS, THRESH_C, DECIMATE = (3, 13, 23), 7.0, 2  # the main path's
# threshold (config.DetectConfig, DetectParams.ccl_decimate)
REFINE_WIN = 2 * 5 + 1  # the corner-refine box window (DetectParams)


def _serpentine(h, w, seed=1):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), bool)
    for i, y in enumerate(range(4, h - 8, 6)):
        img[y, 4:w - 4] = True
        img[y:y + 7, (w - 6) if i % 2 == 0 else 4] = True
    noise = rng.random((h, w)) < 0.45
    return np.stack([img, noise])


def _library_box_ms(imgs, win) -> float:
    """The library's box sum: F.avg_pool2d on a replicate-padded plane,
    times win^2."""
    import torch.nn.functional as F

    r = win // 2
    return cuda_ms(lambda: F.avg_pool2d(F.pad(
        imgs[:, None], (r, r, r, r), mode="replicate"), win,
        stride=1)[:, 0] * float(win * win))


def _k1_threshold_row(frames, label):
    """K1's threshold use on one batch of uint8 frames (all windows, one
    launch): bool for bool the plain version.  Returns the table row."""
    import torch

    from ar_slam_tpu_torch.detect import box

    n, h, w = frames.shape
    args = (frames, WINDOWS, THRESH_C, DECIMATE)
    got = box.threshold_batch(*args)
    plain = box.threshold_plain(*args)
    torch.cuda.synchronize()
    differ = int((got != plain).sum())
    emit("kernel_check", kernel="threshold", cell=label, shape=[n, h, w],
         windows=list(WINDOWS), out_shape=list(got.shape),
         differing=differ, dark_share=float(got.float().mean()))
    if differ:
        fail(f"K1 threshold {label}: {differ} planes' pixels differ from "
             f"the plain version")
    # the frames read once (1 B/px), the planes written once (1 B/px);
    # a sliding box sum is 4 adds a pixel and window, then a divide, a
    # subtract and a compare
    bound_ms, bound_by = bound(frames.numel() + got.numel(),
                               7 * len(WINDOWS) * frames.numel())
    imgs = frames.to(torch.float32)
    lib = sum(_library_box_ms(imgs, win) for win in WINDOWS)
    del imgs, plain
    return {
        "name": "threshold (K1)", "route": "cuda",
        "source": "ar_slam_tpu_torch/csrc/box.cu",
        "replaces": "ar_slam_tpu/detect/pallas_box.py:35",
        "max_abs_err": float(differ), "tolerance": "exact (bool)",
        "ms": cuda_ms(lambda: box.threshold_batch(*args)),
        "plain_ms": cuda_ms(lambda: box.threshold_plain(*args), reps=3,
                            warm=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
        "library_call": "F.avg_pool2d(F.pad(x, replicate)) * win^2, one "
                        "call per window, summed (box sums only)",
        "cell": label, "shape": [n, h, w], "windows": list(WINDOWS)}


def _k1_field_row(imgs, label):
    """K1's field use: the five corner-refine field maps of one batch at
    window 11, bit for bit the plain version.  Returns the table row."""
    import torch

    from ar_slam_tpu_torch.detect import box
    from ar_slam_tpu_torch.detect.detect import _gradient

    dev = imgs.device
    n, h, w = imgs.shape
    gy, gx = _gradient(imgs, 1), _gradient(imgs, 2)
    x = torch.arange(w, device=dev, dtype=torch.float32)
    y = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    fields = torch.stack([gx * gx, gx * gy, gy * gy, gx * gx * x + gx * gy * y,
                          gx * gy * x + gy * gy * y], 1).reshape(n * 5, h, w)
    del gx, gy
    win = REFINE_WIN
    got = box.box_sum_batch(fields, win)
    plain = box.box_sum_plain(fields, win)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    # float32 sums of win^2 terms against a float64 sum: ~win^2 * 2^-24
    ref = box.box_sum_plain(fields.double(), win)
    f64_err = float((got.double() - ref).abs().max())
    tol = 1e-5 * float(ref.abs().max())
    del ref, plain
    emit("kernel_check", kernel="box_sum", cell=label, win=win,
         shape=list(fields.shape), max_abs_err=err, f64_max_abs_err=f64_err,
         f64_tolerance=tol)
    if not (err == 0.0 and f64_err <= tol):
        fail(f"K1 fields {label}: {err} from the plain version, {f64_err} "
             f"from float64 (bound {tol})")
    # one read of the planes and one write of the sums; 2 * (win - 1) adds
    # per pixel for a separable window sum
    bound_ms, bound_by = bound(2 * 4 * fields.numel(),
                               2 * (win - 1) * fields.numel())
    row = {
        "name": "box_sum (K1)", "route": "cuda",
        "source": "ar_slam_tpu_torch/csrc/box.cu",
        "replaces": "ar_slam_tpu/detect/pallas_box.py:35",
        "max_abs_err": err, "tolerance": "exact (the plain version's sums)",
        "ms": cuda_ms(lambda: box.box_sum_batch(fields, win)),
        "plain_ms": cuda_ms(lambda: box.box_sum_plain(fields, win), reps=3,
                            warm=1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": _library_box_ms(fields, win),
        "library_call": "F.avg_pool2d(F.pad(x, replicate)) * win^2",
        "cell": label, "shape": list(fields.shape), "win": win}
    del fields, got
    return row


def _k4_row(labels, label, jobs):
    """K4 on the top-64 roots of one batch of label planes: exact where
    the plain version's float32 coordinate sums are exact (< 2^24); the
    other slots' largest corner difference is reported.  Queues the
    profile of K4's own kernels on ``jobs``."""
    import torch

    from ar_slam_tpu_torch.detect import extract
    from ar_slam_tpu_torch.detect.detect import top_k_subsampled

    dev = labels.device
    roots, _ = top_k_subsampled(labels, 64, 2, 0.25)
    q = extract.extreme_quads(labels, roots)
    qp = extract.extreme_quads_plain(labels, roots)
    torch.cuda.synchronize()
    hd, wd = labels.shape[1:]
    lin = torch.arange(hd * wd, device=dev)
    exact = torch.zeros(roots.shape, dtype=torch.bool, device=dev)
    for i in range(labels.shape[0]):
        member = labels[i].reshape(1, -1) == roots[i][:, None]
        sx = torch.where(member, lin % wd, 0).sum(1)
        sy = torch.where(member, lin // wd, 0).sum(1)
        exact[i] = (sx < 2**24) & (sy < 2**24)
        del member, sx, sy
    if not torch.equal(q[exact], qp[exact]):
        fail(f"K4 {label}: quads differ from the plain version")
    inexact = (q[~exact] - qp[~exact]).abs()
    inexact_err = float(inexact.max()) if inexact.numel() else 0.0
    emit("kernel_check", kernel="extract", cell=label,
         shape=list(roots.shape), exact_slots=int(exact.sum()),
         slots=int(exact.numel()), max_abs_err_inexact_slots=inexact_err,
         inexact_slots_differing=int((inexact.amax(dim=(1, 2)) > 0).sum())
         if inexact.numel() else 0, inexact_tolerance_px=K4_INEXACT_TOL_PX)
    if not inexact_err <= K4_INEXACT_TOL_PX:
        fail(f"K4 {label}: corners of slots beyond the exact range differ by "
             f"{inexact_err} px (bound {K4_INEXACT_TOL_PX})")
    # the label planes read once, the quads written once
    bound_ms, bound_by = bound(4 * labels.numel() + q.numel() * 4)
    row = {
        "name": "extreme_quads (K4)", "route": "cuda",
        "source": "ar_slam_tpu_torch/csrc/extract.cu",
        "replaces": "ar_slam_tpu/detect/pallas_extract.py:41",
        "max_abs_err": float((q[exact] - qp[exact]).abs().max()),
        "ms": cuda_ms(lambda: extract.extreme_quads(labels, roots)),
        "plain_ms": cuda_ms(lambda: extract.extreme_quads_plain(labels,
                                                                roots),
                            reps=3, warm=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "cell": label, "shape": list(roots.shape) + list(labels.shape[1:])}
    # device ms of each of K4's kernels in one call (quad_sweep: 3 launches)
    jobs.append((row, "kernel_ms", lambda: extract.extreme_quads(
        labels, roots), ("quad_stats", "quad_plan", "quad_sweep",
                         "quad_finish"), 1))
    return row


def _k2_check(planes, iters, what) -> list:
    """K2 on a batch against the plain transcription of the reference's
    schedule: labels and per-plane rounds exactly.  Returns the rounds."""
    import torch

    from ar_slam_tpu_torch.detect import ccl

    got = ccl.connected_components_batch(planes.contiguous(), iters)
    rounds = ccl.fused_plane_rounds()
    plain = [ccl.fused_plane_plain(p, iters) for p in planes]
    torch.cuda.synchronize()
    if not (torch.equal(got, torch.stack([lab for lab, _ in plain]))
            and rounds == [r for _, r in plain]):
        fail(f"K2 differs from the plain version on {what} (cap {iters})")
    return rounds


def _near_limit_planes(dev):
    """(8, 896, 1024): planes just under FUSED_CCL_PIXEL_LIMIT, blobs of
    16x16 cells plus 5 % noise."""
    import torch

    rng = np.random.default_rng(5)
    base = rng.uniform(60, 220, size=(8, 896 // 16, 1024 // 16))
    b = np.kron(base, np.ones((16, 16))) < 120
    return torch.from_numpy(b | (rng.random(b.shape) < 0.05)).to(dev)


def phase_kernels(frames16, frames12):
    """Each kernel against its plain version at the shapes of room-16
    (K1, K2, K4) and phone_12mp (K1, K3, K4).  Returns the kernel rows and
    the profiles to take later, (row, key, fn, kernel names, divisor)."""
    import torch

    from ar_slam_tpu_torch.detect import box, ccl

    dev = torch.device(DEVICE)
    rows, jobs = [], []

    # room-16: 8 frames of 1020x768
    frames = torch.from_numpy(frames16[:8]).to(dev).contiguous()
    rows.append(_k1_threshold_row(frames, "room-16"))
    rows.append(_k1_field_row(frames.to(torch.float32), "room-16"))
    planes = box.threshold_plain(frames, WINDOWS, THRESH_C, DECIMATE)
    iters = 24
    rounds = _k2_check(planes, iters, "room-16's planes")
    got = ccl.connected_components_batch(planes, iters)
    extra = torch.from_numpy(_serpentine(*planes.shape[1:])).to(dev)
    rounds_x = _k2_check(extra, iters, "a serpentine and 45 % noise")
    rounds_n = _k2_check(_near_limit_planes(dev), iters,
                         "(8, 896, 1024) planes")
    if rounds_x[0] != iters:
        fail(f"the serpentine did not reach K2's cap ({rounds_x[0]} rounds)")
    # does the 24-round cap bind on these planes?  K2 with a cap no plane
    # reaches gives the fixpoint
    fixpoint = ccl.connected_components_batch(planes, planes[0].numel())
    fix_rounds = ccl.fused_plane_rounds()
    emit("kernel_check", kernel="ccl", cell="room-16",
         shape=list(planes.shape), exact=True, iters=iters,
         plane_rounds=rounds, serpentine_noise_rounds=rounds_x,
         near_limit_rounds=rounds_n,
         components=int((got == torch.arange(
             got[0].numel(), device=dev).reshape(got.shape[1:])).sum()))
    emit("kernel_check", kernel="ccl_cap", cell="room-16", iters=iters,
         plane_rounds=rounds, fixpoint_rounds=fix_rounds,
         equals_fixpoint=bool(torch.equal(got, fixpoint)))
    del fixpoint, extra
    # the binary planes read once (1 B/px), the labels written once
    bound_ms, bound_by = bound(5 * planes.numel())
    rows.append({
        "name": "connected_components (K2)", "route": "cuda",
        "source": "ar_slam_tpu_torch/csrc/ccl.cu",
        "replaces": "ar_slam_tpu/detect/pallas_ccl.py:197",
        "max_abs_err": 0.0, "iters": iters,
        "plane_rounds_min_median_max": [
            min(rounds), float(np.median(rounds)), max(rounds)],
        "ms": cuda_ms(lambda: ccl.connected_components_batch(planes, iters)),
        # the plane of most rounds alone: as long as the batch when the
        # time is each round's latency chain, not throughput
        "slowest_plane_alone_ms": cuda_ms(
            lambda p=planes[int(np.argmax(rounds))][None].contiguous():
            ccl.connected_components_batch(p, iters)),
        "resident_planes": ccl.fused_resident_planes(*planes.shape[1:]),
        "plain_ms": cuda_ms(lambda: ccl.connected_components_fused_plain(
            planes, iters), reps=3, warm=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "cell": "room-16", "shape": list(planes.shape)})
    rows.append(_k4_row(got, "room-16", jobs))
    del frames, planes, got

    # phone_12mp: 8 frames of 4032x3024
    frames = torch.from_numpy(frames12[:8]).to(dev).contiguous()
    rows.append(_k1_threshold_row(frames, "phone_12mp"))
    rows.append(_k1_field_row(frames.to(torch.float32), "phone_12mp"))
    planes = box.threshold_plain(frames, WINDOWS, THRESH_C, DECIMATE)
    del frames
    got = ccl.connected_components_strip_batch(planes, iters)
    plane_rounds, converged = ccl.strip_plane_rounds()
    rounds = max(plane_rounds)
    plain = ccl.connected_components_plain(planes, iters)
    extra = torch.from_numpy(_serpentine(*planes.shape[1:])).to(dev)
    got_x = ccl.connected_components_strip_batch(extra.contiguous(), iters)
    rounds_x = ccl.strip_rounds()
    plain_x = ccl.connected_components_plain(extra, iters)
    # the fixpoint: K2 with a cap no plane reaches
    fixpoint = ccl.connected_components_batch(planes, planes[0].numel())
    torch.cuda.synchronize()
    snake = extra[0]
    snake_labels = int(torch.unique(got_x[0][snake]).numel())
    if not (torch.equal(got, plain) and torch.equal(got_x, plain_x)):
        fail("K3 labels differ from the plain version")
    if all(converged) and not torch.equal(got, fixpoint):
        fail("K3 reached every fixpoint but differs from it")
    if not (rounds_x == iters and snake_labels > 1):
        fail(f"the serpentine did not reach the round cap ({rounds_x}, "
             f"{snake_labels} labels)")
    emit("kernel_check", kernel="ccl_strip", cell="phone_12mp",
         shape=list(planes.shape), exact=True, iters=iters, rounds=rounds,
         plane_rounds=plane_rounds, converged_planes=sum(converged),
         equals_fixpoint=bool(torch.equal(got, fixpoint)),
         serpentine_rounds=rounds_x, serpentine_labels=snake_labels)
    del fixpoint, plain, extra, got_x, plain_x
    # the binary planes read once (1 B/px), the labels written once; this
    # design's own traffic (two stages a round, each reading and writing
    # the int32 plane, for the rounds each plane ran) beside it
    plane_px = planes[0].numel()
    bound_ms, bound_by = bound(5 * planes.numel())
    rows.append({
        "name": "connected_components_strip (K3)", "route": "cuda",
        "source": "ar_slam_tpu_torch/csrc/ccl_strip.cu",
        "replaces": "ar_slam_tpu/detect/pallas_ccl.py:73",
        "max_abs_err": 0.0, "iters": iters, "rounds": rounds,
        "plane_rounds_min_median_max": [
            min(plane_rounds), float(np.median(plane_rounds)), rounds],
        "ms": cuda_ms(lambda: ccl.connected_components_strip_batch(
            planes, iters)),
        "plain_ms": cuda_ms(lambda: ccl.connected_components_plain(
            planes, iters), reps=3, warm=1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "jacobi_traffic_ms": bound(
            sum(plane_rounds) * 2 * 2 * 4 * plane_px)[0],
        "library_ms": None, "cell": "phone_12mp",
        "shape": list(planes.shape)})
    # device ms a round of each stage: row (pool + row run-min), column
    jobs.append((rows[-1], "stage_ms_per_round",
                 lambda p=planes: ccl.connected_components_strip_batch(
                     p, iters), ("strip_row", "strip_col"), iters))
    rows.append(_k4_row(got, "phone_12mp", jobs))
    del planes, got
    torch.cuda.empty_cache()
    return rows, jobs


def phase_kernel_profiles(jobs) -> None:
    """The device ms of each kernel's own CUDA kernels, by torch.profiler.
    Run last: after these profiles, a later profile in the same process
    (--profile) showed no host-to-device copies."""
    for row, key, fn, names, divisor in jobs:
        row[key] = {name: ms / divisor
                    for name, ms in _device_ms(fn, names).items()}


def reset_counts() -> None:
    from ar_slam_tpu_torch.detect import box, ccl, extract

    box.launches = box.threshold_launches = ccl.launches = 0
    ccl.strip_launches = extract.launches = 0
    ccl.strip_kernel_launches = ccl.strip_flag_reads = 0
    ccl.fused_round_reads = 0


def read_counts() -> dict:
    from ar_slam_tpu_torch.detect import box, ccl, extract

    return {"box": box.launches, "box_threshold": box.threshold_launches,
            "ccl": ccl.launches, "ccl_round_reads": ccl.fused_round_reads,
            "ccl_strip": ccl.strip_launches,
            "ccl_strip_kernels": ccl.strip_kernel_launches,
            "ccl_strip_flag_reads": ccl.strip_flag_reads,
            "extract": extract.launches}


def check_launches(cell: str, launches: dict, used, unused) -> None:
    if any(launches[k] <= 0 for k in used) or any(launches[k] for k in unused):
        fail(f"{cell}: kernels {list(used)} must launch and {list(unused)} "
             f"must not: {launches}")


def check_graphs(cell: str, stats: dict) -> None:
    """The single-device solve and localize replay CUDA graphs."""
    if stats["replays"] <= 0:
        fail(f"{cell}: no CUDA graph was replayed: {stats}")


def detect_replays() -> int:
    """Replays of the detector's programs since the cache's last clear."""
    from ar_slam_tpu_torch import programs

    return programs.CACHE.kinds.get("detect", {}).get("replays", 0)


def check_detect_replays(cell: str, replays: int, calls: int) -> None:
    """Every detect_batch call of a main path replayed the detector's CUDA
    graph (detect/detect.py), one replay a call."""
    if replays != calls:
        fail(f"{cell}: {calls} detection calls made {replays} replays of "
             "the detector's graph")


def check_rmse(cell: str, rmse: float) -> None:
    """rmse within JET_RMSE_TOL_PX of the cell's JACFWD_RMSE_PX."""
    if not abs(rmse - JACFWD_RMSE_PX[cell]) <= JET_RMSE_TOL_PX:
        fail(f"{cell} rmse {rmse} px is not within {JET_RMSE_TOL_PX} of "
             f"{JACFWD_RMSE_PX[cell]}")


class CaptureSyncs:
    """Counts the calls of ``torch.cuda.synchronize`` and
    ``torch.cuda.empty_cache`` that a capturing thread makes while a
    program of solve/graphs.py captures; ``close`` restores both."""

    NAMES = ("synchronize", "empty_cache")

    def __init__(self):
        import threading

        import torch

        from ar_slam_tpu_torch.solve import graphs

        self.counts = dict.fromkeys(self.NAMES, 0)
        self.captures = 0
        self._saved = {n: getattr(torch.cuda, n) for n in self.NAMES}
        self._capture = graphs.Program._capture
        capturing = set()

        def counted(name):
            real = self._saved[name]

            def call(*a, **k):
                if threading.get_ident() in capturing:
                    self.counts[name] += 1
                return real(*a, **k)
            return call

        def watched(prog):
            capturing.add(threading.get_ident())
            try:
                self._capture(prog)
            finally:
                capturing.discard(threading.get_ident())
            self.captures += 1

        for n in self.NAMES:
            setattr(torch.cuda, n, counted(n))
        graphs.Program._capture = watched

    def close(self) -> None:
        import torch

        from ar_slam_tpu_torch.solve import graphs

        for n, f in self._saved.items():
            setattr(torch.cuda, n, f)
        graphs.Program._capture = self._capture


def check_tags(cell: str, found: dict, truth_frames, uids, min_side: float):
    """Every rendered tag of side >= min_side found with its true id in
    its frame, no id that is not rendered there.  Returns the count of
    required sightings."""
    missing, foreign, n_req = [], [], 0
    for uid, seen in zip(uids, truth_frames):
        got = found.get(uid, set())
        present = {f"aruco_{n}_{m}" for n, m, _, _ in seen}
        for n, m, _, side in seen:
            if side >= min_side:
                n_req += 1
                if f"aruco_{n}_{m}" not in got:
                    missing.append((uid, f"aruco_{n}_{m}"))
        foreign += [(uid, t) for t in sorted(got - present)]
    if missing or foreign:
        fail(f"{cell} detection: missing {missing}, foreign {foreign}")
    return n_req


def _ids_in(store, first: int = 0) -> dict:
    """The tag ids each capture from ``first`` on added to the graph."""
    return {c.uid: {store.arucos[store.blocks[b].tag_idx].id
                    for b in c.blocks} for c in store.captures[first:]}


def phase_main_path(frames, truth):
    """room-16: map 16 frames of 1020x768 in batches of 8."""
    import torch

    from ar_slam_tpu_torch.graph import yamlio
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
    from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture
    from ar_slam_tpu_torch.solve import graphs

    caps = [IngestedCapture(f"frame{k:02d}", f"frame{k:02d}.png", frames[k])
            for k in range(len(frames))]
    batches = [caps[i:i + 8] for i in range(0, len(caps), 8)]
    ArSlamEngine(device=DEVICE).detect_decoded(batches[0])  # warm-up

    reset_counts()
    engine = ArSlamEngine(device=DEVICE)
    torch.cuda.synchronize()
    replays = detect_replays()
    t0 = time.perf_counter()
    for b in batches:
        engine.add_decoded(b)
    t_detect = time.perf_counter() - t0
    detect_graphs = graphs.CACHE.stats()
    check_detect_replays("room-16 detect", detect_replays() - replays,
                         len(batches))
    graphs.CACHE.clear()
    t0 = time.perf_counter()
    summary = engine.solve()
    t_solve = time.perf_counter() - t0
    solve_graphs = graphs.CACHE.stats()
    os.makedirs(OUT_DIR, exist_ok=True)
    map_path = os.path.join(OUT_DIR, "map.yaml")
    engine.save_map(map_path)
    launches = read_counts()

    check_launches("room-16", launches,
                   ("box", "box_threshold", "ccl", "extract"),
                   ("ccl_strip", "ccl_round_reads"))
    n_req = check_tags("room-16", _ids_in(engine.store), truth["frames"],
                       [c.uid for c in caps], 40.0)
    rmse = summary.get("rmse", float("nan"))
    if not (np.isfinite(rmse) and rmse < 1.0):
        fail(f"map rmse {rmse} px is not < 1")
    check_rmse("room-16", rmse)
    with open(map_path) as f:
        parsed = yamlio._fast_parse(f.read())
    if sorted(parsed["tag_ids"]) != sorted(t.id for t in engine.store.arucos):
        fail("map.yaml tags differ after reload")
    emit("main_path", cell="room-16", frames=len(frames), launches=launches,
         tags_required=n_req, tags_in_map=len(parsed["tag_ids"]),
         blocks=len(engine.store.blocks), waves=summary.get("waves"),
         rmse_px=rmse, focal=float(engine.store.camera.params[0]),
         detect_seconds=t_detect,
         detect_frames_per_s=len(frames) / t_detect, solve_seconds=t_solve,
         detect_graphs=detect_graphs, solve_graphs=solve_graphs)
    check_graphs("room-16 solve", solve_graphs)
    return launches, engine.store, rmse


def phase_phone_12mp(frames, truth, tag_m: float):
    """phone_12mp: map frames 0-7 (4032x3024), save, then a fresh engine
    loads the map and localizes frames 8-11."""
    import torch

    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.detect import ccl
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
    from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.localize import localize_many
    from ar_slam_tpu_torch.utils.ate import camera_positions, umeyama_alignment

    caps = [IngestedCapture(f"phone{k:02d}", f"phone{k:02d}.png", frames[k])
            for k in range(len(frames))]
    config = ArSlamConfig(aruco_size=tag_m)
    ArSlamEngine(config, device=DEVICE).detect_decoded(caps[8:])  # warm-up
    reset_counts()
    engine = ArSlamEngine(config, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    replays = detect_replays()
    t0 = time.perf_counter()
    engine.add_decoded(caps[:8])
    t_detect = time.perf_counter() - t0
    detect_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    detect_graphs = graphs.CACHE.stats()
    check_detect_replays("phone_12mp map detect", detect_replays() - replays,
                         1)
    graphs.CACHE.clear()
    t0 = time.perf_counter()
    summary = engine.solve()
    t_solve = time.perf_counter() - t0
    solve_graphs = graphs.CACHE.stats()
    os.makedirs(OUT_DIR, exist_ok=True)
    map_path = os.path.join(OUT_DIR, "phone_map.yaml")
    engine.save_map(map_path)

    loc = ArSlamEngine(config, device=DEVICE)
    loc.load_map(map_path)
    first = loc.store.next_capture_index
    graphs.CACHE.clear()
    t0 = time.perf_counter()
    result = loc.localize_decoded(caps[8:])
    t_loc_total = time.perf_counter() - t0
    localize_graphs = graphs.CACHE.stats()
    check_detect_replays("phone_12mp localize detect", detect_replays(), 1)
    t_loc = loc.metrics.timings["localize"][-1]
    launches = read_counts()

    found = {**_ids_in(engine.store), **_ids_in(loc.store, first)}
    queries = loc.store.captures[first:]
    loc_rmse = result.get("rmse", float("nan"))

    # align the map's cameras to the rendered ones, then place the queries
    true_pos = -truth["cap_poses"][:, 0:3]
    map_pos = camera_positions(engine.store)
    map_idx = [int(c.uid[5:]) for c in engine.store.captures]
    s, rot, t = umeyama_alignment(map_pos, true_pos[map_idx])
    q_pos = np.stack([-c.inv_pose[0:3] for c in queries])
    q_err = np.linalg.norm((s * (rot @ q_pos.T)).T + t - true_pos[
        [int(c.uid[5:]) for c in queries]], axis=1)
    map_err = np.linalg.norm((s * (rot @ map_pos.T)).T + t
                             - true_pos[map_idx], axis=1)

    # the same detections against the same map, float64 on the CPU
    cpu = ArSlamEngine(config, device="cpu", dtype=torch.float64)
    cpu.load_map(map_path)
    for cap in queries:
        cpu.store.add_detections(
            cap.uid, [(loc.store.arucos[loc.store.blocks[b].tag_idx].id,
                       loc.store.blocks[b].corners) for b in cap.blocks],
            loc.store.camera.size, cap.img_fn)
    ref = localize_many(cpu.store, first, cpu.config, dtype=torch.float64,
                        device="cpu")
    d_pose = max(float(np.abs(a.inv_pose - b.inv_pose).max())
                 for a, b in zip(queries, cpu.store.captures[first:]))
    d_rmse = abs(loc_rmse - ref["rmse"])
    sides = [side for fr in truth["frames"] for _, _, _, side in fr]
    emit("main_path", cell="phone_12mp", frames=len(frames),
         size=list(frames.shape[1:]), launches=launches,
         ccl_strip_rounds=ccl.strip_rounds(),
         tag_side_px=[min(sides), max(sides)],
         tags_in_map=len(engine.store.arucos),
         blocks=len(engine.store.blocks), waves=summary.get("waves"),
         map_rmse_px=summary.get("rmse"),
         focal=float(engine.store.camera.params[0]),
         localize_status=result.get("status"), localize_rmse_px=loc_rmse,
         localize_iterations=result.get("iterations"),
         query_position_err_m=q_err.tolist(),
         map_position_err_m=float(map_err.max()),
         f64_localize_rmse_px=ref.get("rmse"), f32_f64_pose_diff=d_pose,
         f32_f64_rmse_diff_px=d_rmse,
         detect_seconds=t_detect, detect_frames_per_s=8 / t_detect,
         detect_peak_memory_gb=detect_peak_gb, detect_graphs=detect_graphs,
         solve_seconds=t_solve, localize_seconds=t_loc,
         localize_with_detection_seconds=t_loc_total,
         solve_graphs=solve_graphs, localize_graphs=localize_graphs)
    check_graphs("phone_12mp solve", solve_graphs)
    check_graphs("phone_12mp localize", localize_graphs)

    check_launches("phone_12mp", launches,
                   ("box", "box_threshold", "ccl_strip", "extract"),
                   ("ccl", "ccl_strip_flag_reads"))
    n_req = check_tags("phone_12mp", found, truth["frames"],
                       [c.uid for c in caps], PHONE_SIDE_PX)
    emit("phone_12mp_tags", tags_required=n_req, min_side_px=PHONE_SIDE_PX)
    rmse = summary.get("rmse", float("nan"))
    if not (np.isfinite(rmse) and rmse < 1.0):
        fail(f"phone_12mp map rmse {rmse} px is not < 1")
    check_rmse("phone_12mp map", rmse)
    statuses = result.get("status", {})
    if sorted(statuses) != [c.uid for c in caps[8:]] or set(
            statuses.values()) != {"localized"}:
        fail(f"phone_12mp: not every query localized: {statuses}")
    if not (np.isfinite(loc_rmse) and loc_rmse < 1.0):
        fail(f"phone_12mp localize rmse {loc_rmse} px is not < 1")
    check_rmse("phone_12mp localize", loc_rmse)
    if not q_err.max() <= QUERY_POSITION_M:
        fail(f"phone_12mp query positions off by {q_err.tolist()} m "
             f"(bound {QUERY_POSITION_M})")
    if not (d_pose <= F32_POSE_TOL and d_rmse <= F32_RMSE_TOL_PX):
        fail(f"phone_12mp float32 localization differs from float64: pose "
             f"{d_pose} (bound {F32_POSE_TOL}), rmse {d_rmse} px (bound "
             f"{F32_RMSE_TOL_PX})")
    return launches, (loc.store, first, config)


def _align_errors(store, truth) -> np.ndarray:
    """Each camera's distance (m) from the rendered truth after aligning
    the map's cameras to it (utils/ate.py); uids end in the frame index."""
    from ar_slam_tpu_torch.utils.ate import camera_positions, umeyama_alignment

    true_pos = -truth["cap_poses"][:, 0:3][
        [int(c.uid[5:]) for c in store.captures]]
    pos = camera_positions(store)
    s, rot, t = umeyama_alignment(pos, true_pos)
    return np.linalg.norm((s * (rot @ pos.T)).T + t - true_pos, axis=1)


def phase_serve_12mp(frames, truth, tag_m: float) -> None:
    """serve_12mp: the 12 phone_12mp frames streamed as files through
    StreamPipeline (ingest thread, detect thread, merge join, incremental
    solve on this thread; batches of 8 + 4), against a second engine doing
    add_images + solve_incremental over the same batches (serve
    --sequential); then the event log replayed by the replay command."""
    import contextlib
    import io
    import shutil
    import threading

    import torch

    from ar_slam_tpu_torch import cli
    from ar_slam_tpu_torch.config import ArSlamConfig, PipelineConfig
    from ar_slam_tpu_torch.graph.store import MapStore
    from ar_slam_tpu_torch.graph.yamlio import load_yaml
    from ar_slam_tpu_torch.pipeline import ingest
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
    from ar_slam_tpu_torch.pipeline.stream import StreamPipeline
    from ar_slam_tpu_torch.solve import graphs

    serve_dir = os.path.join(OUT_DIR, "serve")
    shutil.rmtree(serve_dir, ignore_errors=True)
    os.makedirs(serve_dir)
    paths = []
    for k, frame in enumerate(frames):
        paths.append(os.path.join(serve_dir, f"phone{k:02d}.npy"))
        np.save(paths[-1], frame)
    uids = [f"phone{k:02d}" for k in range(len(frames))]
    log = os.path.join(serve_dir, "events.jsonl")

    # the card has no PIL and these frames are rendered, not photographed:
    # the ingest stage decodes .npy files for this phase only
    load_image = ingest.load_image
    ingest.load_image = np.load
    try:
        engine = ArSlamEngine(ArSlamConfig(aruco_size=tag_m,
                                           pipeline=PipelineConfig(
                                               event_log_path=log)),
                              device=DEVICE)
        # where detection ran, and what it launched there
        detect_calls = []
        detect = engine.detect_decoded

        def traced_detect(caps):
            before = read_counts()
            out = detect(caps)
            after = read_counts()
            detect_calls.append((threading.current_thread().name,
                                 {k: after[k] - before[k] for k in after}))
            return out

        engine.detect_decoded = traced_detect
        waves = []
        reset_counts()
        graphs.CACHE.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = StreamPipeline(engine, on_solve=lambda summary, batch:
                              waves.append((summary, list(batch))))
        try:
            pipe.submit(paths)
            pipe.drain()
        finally:
            pipe.close()
        torch.cuda.synchronize()
        t_piped = time.perf_counter() - t0
        launches = read_counts()
        solve_graphs = graphs.CACHE.stats()
        engine.close()

        seq = ArSlamEngine(ArSlamConfig(aruco_size=tag_m), device=DEVICE)
        seq_out = []
        t0 = time.perf_counter()
        for batch in (paths[:8], paths[8:]):
            seq.add_images(batch)
            seq_out.append(seq.solve_incremental())
        t_seq = time.perf_counter() - t0
    finally:
        ingest.load_image = load_image

    summaries = [s for s, _ in waves]
    if [b for _, b in waves] != [uids[:8], uids[8:]] or len(seq_out) != 2:
        fail(f"serve_12mp: solved batches {[b for _, b in waves]}")
    stage_s = {k: sum(b - a for a, b in v)
               for k, v in pipe.timeline.intervals.items()}
    rmse = summaries[-1].get("rmse", float("nan"))
    focal = float(engine.store.camera.params[0])
    seq_focal = float(seq.store.camera.params[0])
    d_rmse = abs(rmse - seq_out[-1].get("rmse", float("nan")))
    d_focal = abs(focal - seq_focal) / seq_focal
    d_pose = max(float(np.abs(a.inv_pose - b.inv_pose).max())
                 for a, b in zip(engine.store.captures, seq.store.captures))
    cam_err = _align_errors(engine.store, truth)

    out = os.path.join(serve_dir, "replayed.yaml")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["replay", log, "-o", out, "--device", DEVICE])
    t_replay = time.perf_counter() - t0
    replayed = MapStore()
    load_yaml(replayed, out)
    replay_rmse = float(printed.getvalue().split("replayed -> rmse ")[1]
                        .split(" px")[0])

    def blocks(store):
        return sorted((store.captures[b.cap_idx].uid,
                       store.arucos[b.tag_idx].id) for b in store.blocks)

    stats = {k: v for k, v in engine.store.stats().items() if k != "focal"}
    seq_stats = {k: v for k, v in seq.store.stats().items() if k != "focal"}
    emit("main_path", cell="serve_12mp", frames=len(frames),
         size=list(frames.shape[1:]),
         decode="np.load of .npy frames in place of pipeline.ingest."
                "load_image (the card has no PIL; the frames are rendered)",
         launches=launches,
         detect_calls=[{"thread": n, "launches": c} for n, c in detect_calls],
         stats=engine.store.stats(), map_rmse_px=rmse, focal=focal,
         camera_position_err_m=float(cam_err.max()),
         pipelined_seconds=t_piped, sequential_seconds=t_seq,
         stage_seconds=stage_s,
         detect_solve_overlap_s=pipe.timeline.overlap_s("detect", "solve"),
         ingest_detect_overlap_s=pipe.timeline.overlap_s("ingest", "detect"),
         solve_incremental=[
             {"seconds": t, "waves": s.get("waves")} for t, s in zip(
                 engine.metrics.timings["solve_incremental"], summaries)],
         sequential_solve_incremental=[
             {"seconds": t, "waves": s.get("waves")} for t, s in zip(
                 seq.metrics.timings["solve_incremental"], seq_out)],
         sequential_rmse_px=seq_out[-1].get("rmse"),
         pipelined_vs_sequential={"rmse_px": d_rmse, "focal_rel": d_focal,
                                  "capture_pose": d_pose},
         replay_rmse_px=replay_rmse, replay_blocks=len(replayed.blocks),
         replay_seconds=t_replay, solve_graphs=solve_graphs)
    check_graphs("serve_12mp solve_incremental", solve_graphs)
    check_detect_replays("serve_12mp detect thread",
                         solve_graphs["kinds"].get("detect", {}).get(
                             "replays", 0), len(detect_calls))

    if sum(s.get("waves", 0) for s in summaries) != len(frames) or (
            summaries[-1].get("unsolved") != 0):
        fail(f"serve_12mp: waves and unsolved {summaries}")
    if pipe.merge.inner.published != set(uids):
        fail(f"serve_12mp: merge published {sorted(pipe.merge.inner.published)}")
    check_launches("serve_12mp", launches,
                   ("box", "box_threshold", "ccl_strip", "extract"),
                   ("ccl", "ccl_round_reads", "ccl_strip_flag_reads"))
    main_thread = threading.main_thread().name
    if (any(n == main_thread for n, _ in detect_calls)
            or {k: sum(c[k] for _, c in detect_calls) for k in launches}
            != launches):
        fail(f"serve_12mp: kernels launched outside the detect thread: "
             f"{detect_calls}, all launches {launches}")
    n_req = check_tags("serve_12mp", _ids_in(engine.store), truth["frames"],
                       uids, PHONE_SIDE_PX)
    if not (np.isfinite(rmse) and rmse < 1.0):
        fail(f"serve_12mp map rmse {rmse} px is not < 1")
    check_rmse("serve_12mp", rmse)
    if not cam_err.max() <= QUERY_POSITION_M:
        fail(f"serve_12mp cameras off by {cam_err.tolist()} m after "
             f"alignment (bound {QUERY_POSITION_M})")
    if ([c.uid for c in engine.store.captures]
            != [c.uid for c in seq.store.captures] or stats != seq_stats):
        fail(f"serve_12mp: pipelined {engine.store.stats()} differs from "
             f"sequential {seq.store.stats()}")
    if not (d_rmse <= SERVE_RMSE_TOL_PX and d_focal <= SERVE_FOCAL_TOL):
        fail(f"serve_12mp: pipelined vs sequential rmse {d_rmse} px (bound "
             f"{SERVE_RMSE_TOL_PX}), focal {d_focal} (bound "
             f"{SERVE_FOCAL_TOL})")
    if not (rc == 0 and blocks(replayed) == blocks(engine.store)
            and replay_rmse < 1.0):
        fail(f"serve_12mp: replay rc {rc}, {len(replayed.captures)} "
             f"captures, {len(replayed.blocks)} blocks, rmse {replay_rmse}")
    emit("serve_12mp_tags", tags_required=n_req, min_side_px=PHONE_SIDE_PX)


def _synthetic(n_tags: int, n_caps: int):
    """make_synthetic_map(n_tags, n_caps) at its truth, every pose then
    perturbed by N(0, 0.005) (bench.py:28-49), float32 on the card.
    Returns (tensors, numpy BlockArrays, generation seconds)."""
    import torch

    from ar_slam_tpu_torch.convert import arrays_from_numpy
    from ar_slam_tpu_torch.graph.arrays import export_arrays
    from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map

    t0 = time.perf_counter()
    store, truth = make_synthetic_map(n_tags=n_tags, n_caps=n_caps, seed=0,
                                      noise_px=0.3, focal=3000.0)
    for cap in store.captures:
        cap.inv_pose[:] = truth["cap_poses"][int(cap.uid.split("_")[1])]
    for tag in store.arucos:
        tag.pose[:] = truth["tag_poses"][int(tag.id.split("_")[-1])]
    arrs = export_arrays(store, dtype=np.float32)
    rng = np.random.default_rng(1)
    cap0 = (arrs.cap_poses + rng.normal(scale=0.005,
                                        size=arrs.cap_poses.shape))
    tag0 = (arrs.tag_poses + rng.normal(scale=0.005,
                                        size=arrs.tag_poses.shape))
    arrs = arrs._replace(cap_poses=cap0.astype(np.float32),
                         tag_poses=tag0.astype(np.float32))
    t = arrays_from_numpy(arrs, DEVICE, torch.float32)
    return t, arrs, time.perf_counter() - t0


def _slot_bounds(arrs, cg: bool) -> dict:
    """lm_solve's static slot bounds for ``arrs`` (bench.py:80-102): the
    most observations of a tag / capture in multiples of 8, and for CG the
    row-split budgets sum ceil(obs / 8) in multiples of 256."""
    def up(n, m):
        return -(-int(n) // m) * m

    counts = np.bincount(arrs.tag_idx[arrs.block_mask])
    ccounts = np.bincount(arrs.cap_idx[arrs.block_mask])
    kw = dict(obs_per_tag=up(counts.max(), 8),
              obs_per_cap=up(ccounts.max(), 8))
    if cg:
        kw.update(row_slots=ROW_SLOTS,
                  tag_rows=up((-(-counts // ROW_SLOTS)).sum(), 256),
                  cap_rows=up((-(-ccounts // ROW_SLOTS)).sum(), 256))
    return kw


def _lm_run(t, config, budget=None, **kw):
    """One lm_solve on the synthetic tensors: (seconds, info)."""
    import torch

    from ar_slam_tpu_torch.solve.lm import lm_solve

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = lm_solve(
        t["camera"], t["cap_poses"], t["tag_poses"], t["cap_idx"],
        t["tag_idx"], t["corners"], t["block_mask"], True, t["cap_mask"],
        t["tag_mask"], aruco_size=0.0635, config=config, iter_budget=budget,
        **kw)
    float(out[3]["cost"])  # waits for the card
    return time.perf_counter() - t1, out[3]


def _marginal_rate(t, config, lo: int, hi: int, **kw):
    """LM iterations/s between budgets ``lo`` and ``hi`` after a warm-up:
    (rate, seconds at lo, seconds at hi, info at hi)."""
    _lm_run(t, config, 2, **kw)
    t_lo, info_lo = _lm_run(t, config, lo, **kw)
    t_hi, info_hi = _lm_run(t, config, hi, **kw)
    rate = (info_hi["iterations"] - info_lo["iterations"]) / max(
        t_hi - t_lo, 1e-9)
    return rate, t_lo, t_hi, info_hi


def phase_solver() -> float:
    """The 500-tag synthetic through the grouped dense solve; returns its
    LM iterations/s."""
    from ar_slam_tpu_torch.solve.lm import LMConfig

    t, arrs, gen_s = _synthetic(500, 200)
    config = LMConfig(max_iterations=32, function_tolerance=0.0,
                      parameter_tolerance=0.0)
    rate, _, t_hi, info = _marginal_rate(t, config, 8, 32,
                                         **_slot_bounds(arrs, cg=False))
    cost = float(info["cost"])
    rel = abs(cost - F64_OPTIMUM_500) / F64_OPTIMUM_500
    emit("solver", tags=arrs.n_tags, captures=arrs.n_caps,
         blocks=arrs.n_blocks, dtype="float32", final_cost=cost,
         f64_optimum=F64_OPTIMUM_500, rel_err=rel,
         iterations=info["iterations"], lm_iterations_per_s=rate,
         seconds_32=t_hi, problem_gen_s=gen_s)
    if not rel <= 1e-3:
        fail(f"500-tag final cost {cost} is not within 1e-3 of "
             f"{F64_OPTIMUM_500}")
    return rate


def phase_solver_flat_500(grouped_rate: float) -> list:
    """The 500-tag synthetic through lm_solve without observation bounds:
    the flat block hooks and the flat dense Schur solve, replaying CUDA
    graphs (its sums in a fixed order, solve/schur.py ``segment_plan``):
    the rate and cost of the graphed LM (one capture, then replays), and
    a ``_graph_cell`` of the same LM eager and graphed, bit for bit.
    Returns the cell's profile jobs."""
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.lm import LMConfig

    t, arrs, gen_s = _synthetic(500, 200)
    config = LMConfig(max_iterations=32, function_tolerance=0.0,
                      parameter_tolerance=0.0)
    graphs.CACHE.clear()
    rate, _, t_hi, info = _marginal_rate(t, config, 8, 32)
    kinds = graphs.CACHE.stats()["kinds"].get("lm", {})
    cost = float(info["cost"])
    rel = abs(cost - F64_OPTIMUM_500) / F64_OPTIMUM_500
    cell, jobs = _graph_cell("synthetic-500 flat", _lm_runner(t, config, {}),
                             8, 32, phase="solver_flat_500_graphs")
    emit("solver_flat_500", tags=arrs.n_tags, captures=arrs.n_caps,
         blocks=arrs.n_blocks, dtype="float32", final_cost=cost,
         f64_optimum=F64_OPTIMUM_500, rel_err=rel,
         iterations=info["iterations"], lm_iterations_per_s=rate,
         grouped_lm_iterations_per_s=grouped_rate, seconds_32=t_hi,
         graphs=kinds, bit_for_bit=cell["bit_for_bit"],
         problem_gen_s=gen_s)
    if not rel <= 1e-3:
        fail(f"flat 500-tag final cost {cost} is not within 1e-3 of "
             f"{F64_OPTIMUM_500}")
    # three calls (budgets 2, 8, 32), one capture
    want = sum(1 + 2 * it for it in (2, 8, info["iterations"]))
    if not (kinds.get("captures") == 1 and kinds.get("replays") == want):
        fail(f"solver_flat_500: the flat LM replayed {kinds}, want one "
             f"capture and {want} replays")
    g = cell["graphed"]
    want = sum(1 + 2 * it for it in g["iterations"])
    if not (g["captures"] == 1 and g["replays_first_calls"] == want):
        fail(f"solver_flat_500: {g['captures']} captures, "
             f"{g['replays_first_calls']} replays (want {want})")
    return jobs


def _wall_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of fn() to a synchronized card, after one
    warm-up call, with no profiler attached."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        sync_cards()
        t0 = time.perf_counter()
        fn()
        sync_cards()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_solver_cg_10k():
    """CG at 10 000 tags / 4 000 captures (tools/big_map_bench.py's
    problem): LM iterations/s from budgets 3 and 12, one CG solve under
    set_sync_debug_mode("error"), and the host ms of one LM iteration's
    parts.  Returns (the parts, their ms, the CG steps) for their profile,
    taken last (phase_cg_profile), and (the map's numpy arrays, its rmse
    after 12 iterations) for mesh_cg_10k."""
    import torch

    from ar_slam_tpu_torch.solve.batch import rmse_from_cost
    from ar_slam_tpu_torch.solve.lm import LMConfig, make_grouped_hooks
    from ar_slam_tpu_torch.solve.schur import schur_solve_grouped_cg

    t, arrs, gen_s = _synthetic(10000, 4000)
    kw = _slot_bounds(arrs, cg=True)
    config = LMConfig(max_iterations=12, function_tolerance=0.0,
                      parameter_tolerance=0.0, linear_solver="cg")
    torch.cuda.reset_peak_memory_stats()
    rate, t_lo, t_hi, info = _marginal_rate(t, config, 3, 12, **kw)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cost0, cost = float(info["initial_cost"]), float(info["cost"])

    # one CG solve with no host read: every input is on the card first
    lin, quality, ctx = make_grouped_hooks(
        t["cap_idx"], t["tag_idx"], t["corners"], t["block_mask"], 0.0635,
        t["cap_poses"].shape[0], t["tag_poses"].shape[0], kw["obs_per_tag"],
        kw["obs_per_cap"], row_slots=ROW_SLOTS, n_rows=kw["tag_rows"],
        n_cap_rows=kw["cap_rows"])
    eqs, _ = lin(t["camera"], t["cap_poses"], t["tag_poses"])
    lam = torch.full((), config.initial_lambda, device=DEVICE)

    def cg(iters):
        return schur_solve_grouped_cg(
            eqs, ctx[0], ctx[1], ctx[2], lam, True, t["cap_mask"],
            t["tag_mask"], cg_tol=config.cg_tolerance, cg_iters=iters,
            x0=torch.zeros(3 + 6 * t["cap_poses"].shape[0], device=DEVICE),
            rows=ctx[3], cap_rows=ctx[4])

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sol = cg(config.cg_max_iterations)
    except RuntimeError as e:
        traceback.print_exc()
        fail(f"solver_cg_10k: the CG solve synchronised the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sol_finite = all(bool(torch.isfinite(x).all()) for x in sol)
    # one LM iteration's parts on the host clock, before any profiler has
    # attached to this process (profiling leaves the host slower after it)
    d_cam, d_cap, d_tag, _ = sol
    new = (t["camera"] + d_cam, t["cap_poses"] + d_cap,
           t["tag_poses"] + d_tag)
    parts = {"cg_solve": lambda: cg(config.cg_max_iterations),
             "cg_solve_1_step": lambda: cg(1),
             "step_quality": lambda: quality(eqs, *new, d_cam, d_cap, d_tag),
             "relinearize": lambda: lin(*new)}
    wall = {name: _wall_ms(fn) for name, fn in parts.items()}
    emit("solver_cg_10k", tags=arrs.n_tags, captures=arrs.n_caps,
         blocks=arrs.n_blocks, padded=[arrs.tag_poses.shape[0],
                                       arrs.cap_poses.shape[0]],
         dtype="float32", slot_bounds=kw,
         slots=kw["tag_rows"] * ROW_SLOTS,
         cg=[config.cg_tolerance, config.cg_max_iterations],
         initial_cost=cost0, final_cost=cost,
         final_rmse_px=rmse_from_cost(cost, arrs.n_blocks),
         iterations=info["iterations"], lm_iterations_per_s=rate,
         seconds_3=t_lo, seconds_12=t_hi, peak_memory_gb=peak_gb,
         sync_debug_cg_solve="no synchronising call",
         sync_debug_solution_finite=sol_finite, part_wall_ms=wall,
         problem_gen_s=gen_s)
    if not (np.isfinite(cost) and cost < cost0 and sol_finite):
        fail(f"solver_cg_10k: final cost {cost} from {cost0}, CG solution "
             f"finite: {sol_finite}")
    return ((parts, wall, config.cg_max_iterations),
            (arrs, rmse_from_cost(cost, arrs.n_blocks)))


def phase_cg_profile(fns, wall, steps) -> None:
    """Where one CG LM iteration at 10k goes (run last, like the kernel
    profiles): the CG solve, the step quality and the relinearization of an
    accepted step.  Wall ms on the host clock from phase_solver_cg_10k,
    device ms and items from one profiled run each; per CG step from solves
    of 1 and ``steps`` steps."""
    parts = {}
    for name, fn in fns.items():
        prof = _profiled(f"cg_10k {name}", fn)
        parts[name] = {"wall_ms": wall[name], "device_ms": prof["device_ms"],
                       "device_items": prof["device_items"],
                       "profiled_wall_ms": prof["wall_ms"]}
    one = parts.pop("cg_solve_1_step")
    wall_ms = sum(p["wall_ms"] for p in parts.values())
    device = sum(p["device_ms"] for p in parts.values())
    emit("cg_10k_iteration", parts=parts, wall_ms=wall_ms, device_ms=device,
         device_idle_share=1.0 - device / wall_ms,
         cg_step_wall_ms=(parts["cg_solve"]["wall_ms"] - one["wall_ms"])
         / (steps - 1),
         cg_step_device_ms=(parts["cg_solve"]["device_ms"]
                            - one["device_ms"]) / (steps - 1),
         cg_step_device_items=(parts["cg_solve"]["device_items"]
                               - one["device_items"]) / (steps - 1),
         cg_setup_wall_ms=one["wall_ms"], cg_setup_device_ms=one["device_ms"])


# the runtime calls that enqueue work on the card, as torch.profiler names
# them (a graph replay is one cudaGraphLaunch)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
               "cudaGraphLaunch")


def _launch_profile(fn) -> tuple:
    """One run of fn under torch.profiler: (fn's result, {the runtime
    calls that enqueue work (launches; graph launches apart), the device
    items (kernels, copies) and their device ms})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync_cards()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync_cards()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = dict(launches=0, graph_launches=0, device_items=0, device_ms=0.0)
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA:
            out["device_items"] += a.count
            out["device_ms"] += a.self_device_time_total / 1e3
        elif a.key in LAUNCH_APIS:
            out["launches"] += a.count
            if a.key == "cudaGraphLaunch":
                out["graph_launches"] += a.count
    per_card = {}
    if torch.cuda.device_count() > 1:
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                card = f"cuda:{e.device_index}"
                per_card[card] = (per_card.get(card, 0.0)
                                  + e.self_device_time_total / 1e3)
    out.update(wall_ms=wall_ms,
               device_idle_share=1.0 - out["device_ms"] / wall_ms,
               **({"device_ms_per_card": per_card} if per_card else {}))
    return result, out


def _same(a, b) -> bool:
    """Bit for bit: tensors, arrays, numbers, and lists and dicts of them."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


PROFILE_BUDGETS = (2, 4)  # a profiled eager 10k CG iteration is ~2 900
# device items; the profiler's cost grows with them


def _graph_cell(name, run, lo: int, hi: int, reps: int = 3,
                phase: str = "solve_graphs", cards=None) -> tuple:
    """One cell of ``phase``: ``run(budget, graphed)`` returns a function
    whose call solves and returns (loop iterations, its results).  For the
    eager loop and the graphs: the first calls at budgets lo and hi (the
    graphs' capture), their results bit for bit, peak memory (of each of
    ``cards`` where given: a mesh spread over them, with its pools), and
    host ms per LM iteration between the budgets and the LM iterations/s
    it gives.  Returns (the cell's line, the profile jobs, at
    PROFILE_BUDGETS)."""
    import torch

    from ar_slam_tpu_torch.solve import graphs

    cell, results, jobs = {"cell": name, "budgets": [lo, hi]}, {}, []
    if cards:
        cell["cards"] = cards
    for graphed in (False, True):
        mode = "graphed" if graphed else "eager"
        graphs.CACHE.clear()
        sync_cards()
        for c in cards or [None]:
            torch.cuda.reset_peak_memory_stats(c)
        t0 = time.perf_counter()
        first = {b: run(b, graphed)() for b in (lo, hi)}
        sync_cards()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        stats = graphs.CACHE.stats()
        iters = {b: first[b][0] for b in (lo, hi)}
        wall = {b: _wall_ms(run(b, graphed), reps) for b in (lo, hi)}
        d_it = max(iters[hi] - iters[lo], 1)
        per_it = (wall[hi] - wall[lo]) / d_it
        cell[mode] = dict(
            iterations=[iters[lo], iters[hi]],
            wall_ms=[wall[lo], wall[hi]],
            host_ms_per_iteration=per_it,
            lm_iterations_per_s=1e3 / per_it if per_it > 0 else None,
            first_calls_s=first_s, peak_memory_gb=peak, **(
                dict(captures=stats["captures"],
                     capture_ms=stats["capture_ms"],
                     capture_split_ms=stats["capture_split_ms"],
                     pool_gb=stats["pool_bytes"] / 1e9,
                     replays_first_calls=stats["replays"])
                if graphed else {}))
        if cards:
            cell[mode]["peak_memory_gb_per_card"] = {
                c: torch.cuda.max_memory_allocated(c) / 1e9 for c in cards}
            if graphed:
                cell[mode]["pool_gb_per_card"] = {
                    c: n / 1e9 for h in stats["held"]
                    for c, n in h["pool_bytes_per_card"].items()}
        results[mode] = first[hi][1]
        jobs.append((name, mode, graphed,
                     [run(b, graphed) for b in PROFILE_BUDGETS]))
    cell["bit_for_bit"] = _same(results["eager"], results["graphed"])
    cell["speedup_per_iteration"] = (cell["eager"]["host_ms_per_iteration"]
                                     / cell["graphed"]["host_ms_per_iteration"])
    emit(phase, **cell)
    if not cell["bit_for_bit"]:
        fail(f"{phase} {name}: graphed results differ from the eager "
             "loop's")
    return cell, jobs


def _lm_tensors(arrs):
    import torch

    from ar_slam_tpu_torch.convert import arrays_from_numpy

    return arrays_from_numpy(arrs, DEVICE, torch.float32)


def _lm_runner(t, config, kw):
    """run(budget, graphed) for _graph_cell over lm_solve on tensors t."""
    from ar_slam_tpu_torch.solve.lm import lm_solve

    def run(budget, graphed):
        def fn():
            out = lm_solve(
                t["camera"], t["cap_poses"], t["tag_poses"], t["cap_idx"],
                t["tag_idx"], t["corners"], t["block_mask"], True,
                t["cap_mask"], t["tag_mask"], aruco_size=0.0635,
                config=config, iter_budget=budget, graphs=graphed, **kw)
            return out[3]["iterations"], list(out)
        return fn
    return run


def _perturbed(arrs, seed: int = 1):
    """``arrs`` with every pose moved by N(0, 0.005), as _synthetic does."""
    rng = np.random.default_rng(seed)
    return arrs._replace(
        cap_poses=(arrs.cap_poses + rng.normal(
            scale=0.005, size=arrs.cap_poses.shape)).astype(np.float32),
        tag_poses=(arrs.tag_poses + rng.normal(
            scale=0.005, size=arrs.tag_poses.shape)).astype(np.float32))


def _room16_flush(store16):
    """make(graphed, seeds_only): a function that runs room-16's last
    flush as ``solve`` reaches it (its seeds, the warmup LM and the joint
    LM), or its seeds alone, from the state before it, eagerly or through
    the graphs, and returns (LM iterations, its results)."""
    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.device import resolve_dtype
    from ar_slam_tpu_torch.solve import batch

    config = ArSlamConfig()
    store = _store_from(store16, store16.captures)
    batch._maybe_calibrate_focal(store, config)
    root = store.capture_with_most_blocks()
    order = store.connected_component(root)
    runner = batch._WaveRunner(
        store, config.solver, config.aruco_size,
        resolve_dtype(config.solver.dtype), DEVICE, camera_cfg=config.camera)

    def wave(cap):
        return cap, None if cap == root else store.captures[cap].init_block

    for cap in order[:-1]:
        runner.run_wave(*wave(cap))
    state = ("camera", "cap_poses", "tag_poses")
    host = ("active_blocks", "tag_initialized", "active_tags")
    snap = ([getattr(runner, k).clone() for k in state],
            [getattr(runner, k).copy() for k in host],
            set(runner.active_caps))
    seeds_args = {}
    apply = batch.apply_wave_seeds_multi

    def flush(graphed):
        for k, v in zip(state, snap[0]):
            setattr(runner, k, v.clone())
        for k, v in zip(host, snap[1]):
            setattr(runner, k, v.copy())
        runner.active_caps = set(snap[2])
        runner.graphs = graphed
        info = runner.run_wave(*wave(order[-1]))
        return info["iterations"], [*(getattr(runner, k) for k in state),
                                    info]

    def recorded(*a, **k):
        seeds_args.update(a=a, k=k)
        return apply(*a, **k)

    batch.apply_wave_seeds_multi = recorded
    try:
        flush(False)
    finally:
        batch.apply_wave_seeds_multi = apply

    def make(graphed: bool, seeds_only: bool):
        if not seeds_only:
            return lambda: flush(graphed)
        kw = {**seeds_args["k"], "graphs": graphed}
        return lambda: (1, list(apply(*seeds_args["a"], **kw)))

    return make


def _call_cell(name: str, make, reps: int = 5) -> list:
    """One call's host ms (median of ``reps``, after a first call, so
    that no capture is timed), eager and graphed, and whether the two
    agree bit for bit: ``make(graphed)`` returns the call.  Returns the
    profile jobs (the profiler runs last, ``phase_solve_graphs_profile``:
    a profile session here hid kernels from the later ones)."""
    from ar_slam_tpu_torch.solve import graphs

    cell, results, jobs = {"cell": name}, {}, []
    for graphed in (False, True):
        graphs.CACHE.clear()
        fn = make(graphed)
        results[graphed] = fn()
        cell["graphed" if graphed else "eager"] = dict(
            host_ms=_wall_ms(fn, reps), iterations=results[graphed][0])
        jobs.append((name, "graphed" if graphed else "eager", graphed,
                     [fn]))
    cell["bit_for_bit"] = _same(results[False], results[True])
    emit("solve_graphs", **cell)
    if not cell["bit_for_bit"]:
        fail(f"solve_graphs {name}: graphed results differ from the eager")
    graphs.CACHE.clear()
    return jobs


def phase_solve_graphs(store16, phone, arrs10k):
    """The solve through CUDA graphs against the eager loop, on the card:
    per LM iteration host ms (here) and launches and device ms (profiled
    last, ``phase_solve_graphs_profile``), bit-for-bit results, capture ms
    and pool memory, for synthetic-500 (dense), room-16 (its map's LM at
    16 captures, and its whole map solve), synthetic-10k CG and
    phone_12mp's localize (its 4 queries).  Returns the profile jobs."""
    import dataclasses

    import torch

    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.graph.arrays import export_arrays
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.batch import solve
    from ar_slam_tpu_torch.solve.lm import LMConfig
    from ar_slam_tpu_torch.solve.localize import localize_many

    jobs = []
    zero_tol = dict(function_tolerance=0.0, parameter_tolerance=0.0)
    t500, arrs500, _ = _synthetic(500, 200)
    _, j = _graph_cell("synthetic-500", _lm_runner(
        t500, LMConfig(max_iterations=32, **zero_tol),
        _slot_bounds(arrs500, cg=False)), 8, 32)
    jobs += j
    del t500

    arrs16 = _perturbed(export_arrays(store16, dtype=np.float32))
    _, j = _graph_cell("room-16 LM (16 captures)", _lm_runner(
        _lm_tensors(arrs16), LMConfig(max_iterations=16, **zero_tol),
        _slot_bounds(arrs16, cg=False)), 4, 16)
    jobs += j

    # the whole room-16 map: solve's waves, warmups and polish
    out = {}
    for graphed in (False, True):
        graphs.CACHE.clear()
        store = _store_from(store16, store16.captures)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = solve(store, ArSlamConfig(), device=DEVICE, graphs=graphed)
        out[graphed] = dict(
            seconds=time.perf_counter() - t0, summary=summary,
            graphs=graphs.CACHE.stats(),
            poses=[c.inv_pose.copy() for c in store.captures]
            + [a.pose.copy() for a in store.arucos]
            + [store.camera.params.copy()])
    same = _same(out[False]["poses"], out[True]["poses"]) and (
        out[False]["summary"] == out[True]["summary"])
    emit("solve_graphs", cell="room-16 map (solve)", bit_for_bit=same,
         eager_seconds=out[False]["seconds"],
         graphed_seconds=out[True]["seconds"],
         rmse_px=out[True]["summary"]["rmse"],
         waves=out[True]["summary"]["waves"], graphs=out[True]["graphs"])
    if not same:
        fail("solve_graphs room-16 map: graphed map differs from the eager")

    make = _room16_flush(store16)
    jobs += _call_cell("room-16 flush (seeds, warmup LM, joint LM)",
                       lambda g: make(g, False))
    jobs += _call_cell("room-16 flush seeds", lambda g: make(g, True))

    t10k = _lm_tensors(arrs10k)
    _, j = _graph_cell("synthetic-10k CG", _lm_runner(
        t10k, LMConfig(max_iterations=12, linear_solver="cg", **zero_tol),
        _slot_bounds(arrs10k, cg=True)), 3, 12)
    jobs += j
    del t10k

    store, first, config = phone

    def loc_run(budget, graphed):
        cfg = config if budget is None else dataclasses.replace(
            config, solver=dataclasses.replace(
                config.solver, max_iterations=budget,
                final_polish_iterations=0, **zero_tol))

        def fn():
            res = localize_many(store, first, cfg, device=DEVICE,
                                graphs=graphed)
            return max(res["iterations"].values()), [
                res, [c.inv_pose.copy() for c in store.captures[first:]]]
        return fn

    _, j = _graph_cell("phone_12mp localize (4 queries)", loc_run, 4, 16)
    jobs += j
    jobs += _call_cell("phone_12mp localize call (init + iterations)",
                       lambda g: loc_run(None, g))
    # the default localize, as the engine runs it
    out = {}
    for graphed in (False, True):
        fn = loc_run(None, graphed)
        fn()
        out[graphed] = (_wall_ms(fn, 3), fn())
    same = _same(out[False][1], out[True][1])
    emit("solve_graphs", cell="phone_12mp localize (default config)",
         bit_for_bit=same, eager_ms=out[False][0], graphed_ms=out[True][0],
         iterations=out[True][1][0], rmse_px=out[True][1][1][0]["rmse"])
    if not same:
        fail("solve_graphs phone_12mp localize: graphed differs from eager")
    graphs.CACHE.clear()
    return jobs


def phase_detect_graphs(frames16, frames12) -> list:
    """Detection through its CUDA graphs (detect/detect.py) against the
    eager stage (``graphs=False``), on the card, per cell: room-16's two
    batches of 8, phone_12mp's map batch of 8 and localize batch of 4,
    and mesh_detect's two batches over three shards of one card.  Each
    mode from an empty cache: the first call (the graphs' capture), then
    host ms per call (median of 3 after a first call), the outputs bit
    for bit, one capture per (card, shape) and a replay a shape's call
    after it, capture ms, the pools' and the peak GB.  Returns the profile
    jobs (launches, device ms and idle share, profiled last)."""
    import torch

    from ar_slam_tpu_torch import programs
    from ar_slam_tpu_torch.detect.detect import detect_batch
    from ar_slam_tpu_torch.parallel import detect as pdet
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine

    mesh = pdet.image_mesh(devices=[MESH_CARD] * 3)
    params = ArSlamEngine(device=DEVICE).detect_params()  # the main path's

    def batches(frames, n):
        return lambda g: [detect_batch(frames[i:i + n], params=params,
                                       device=DEVICE, graphs=g)
                          for i in range(0, len(frames), n)]

    def sharded(frames):
        return lambda g: pdet.detect_batch_sharded(
            frames, mesh=mesh, params=params, graphs=g)

    cells = [("room-16, 2 batches of (8, 768, 1020)", batches(frames16, 8),
              2),
             ("phone_12mp map, (8, 3024, 4032)", batches(frames12[:8], 8),
              1),
             ("phone_12mp localize, (4, 3024, 4032)",
              batches(frames12[8:], 4), 1),
             ("mesh_detect room-16, 16 frames over 3 shards of the card",
              sharded(frames16), 3),
             ("mesh_detect phone_12mp, 8 frames over 3 shards of the card",
              sharded(frames12[:8]), 3)]
    jobs = []
    for name, call, replays_per_call in cells:
        cell, results = {"cell": name}, {}
        for graphed in (False, True):
            mode = "graphed" if graphed else "eager"
            programs.CACHE.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            results[mode] = call(graphed)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            first = programs.CACHE.stats()
            host_ms = _wall_ms(lambda: call(graphed), 3)
            last = call(graphed)
            stats = programs.CACHE.stats()
            cell[mode] = dict(
                first_call_ms=first_ms, host_ms_per_call=host_ms,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                reserved_gb=torch.cuda.memory_reserved() / 1e9)
            if graphed:
                cell[mode].update(
                    captures=stats["captures"],
                    replays_first_call=first["replays"],
                    replays=stats["replays"], capture_ms=first["capture_ms"],
                    capture_split_ms=first["capture_split_ms"],
                    pool_gb=stats["pool_bytes"] / 1e9,
                    programs=[{"program": h["program"],
                               "pool_gb": (h["pool_bytes"] or 0) / 1e9}
                              for h in stats["held"]])
                # six calls: the first, _wall_ms' four and the last
                ok = (stats["captures"] == 1
                      and first["replays"] == replays_per_call
                      and stats["replays"] == 6 * replays_per_call
                      and _same(last, results[mode]))
                if not ok:
                    fail(f"detect_graphs {name}: not one capture and a "
                         f"replay a shard's call: {cell[mode]}")
            jobs.append((name, mode, lambda c=call, g=graphed: c(g)))
        cell["bit_for_bit"] = _same(results["eager"], results["graphed"])
        cell["detections"] = int(sum(
            int(d[n]["valid"].sum()) for d in (
                results["eager"] if isinstance(results["eager"], list)
                else [results["eager"]]) for n in d))
        cell["host_speedup"] = (cell["eager"]["host_ms_per_call"]
                                / cell["graphed"]["host_ms_per_call"])
        emit("detect_graphs", **cell)
        if not cell["bit_for_bit"]:
            fail(f"detect_graphs {name}: graphed outputs differ from the "
                 "eager stage's")
    programs.CACHE.clear()
    return jobs


def phase_detect_graphs_profile(jobs) -> None:
    """Per detect_graphs cell and mode, one call under torch.profiler
    (after an unprofiled one, so that no capture is profiled): the
    runtime launches, graph launches, device items, device ms, wall ms
    and the device's idle share."""
    for name, mode, fn in jobs:
        fn()
        _, prof = _launch_profile(fn)
        emit("detect_graphs_profile", cell=name, mode=mode, per_call=prof)


def _mesh_runner(arrs, devices, config):
    """run(budget, graphed) for _graph_cell over lm_solve_sharded on a
    mesh of ``devices`` (shards of one card, ``[cuda:0] * k``, or spread
    over cards), the problem prepared and placed once."""
    import torch

    from ar_slam_tpu_torch.parallel import TagShardedProblem, block_mesh
    from ar_slam_tpu_torch.parallel.dist_lm import lm_solve_sharded

    mesh = block_mesh(devices=devices)
    prob = TagShardedProblem(mesh, arrs.cap_idx, arrs.tag_idx, arrs.corners,
                             arrs.block_mask, arrs.tag_poses.shape[0],
                             dtype=torch.float32)
    cam, caps, cam_a, cap_a = prob.put_rep(arrs.camera, arrs.cap_poses,
                                           np.asarray(True), arrs.cap_mask)
    placed = (cam, caps, prob.put_tags(arrs.tag_poses),
              prob.block_mask(arrs.block_mask), cam_a, cap_a,
              prob.put_tag_mask(arrs.tag_mask))

    def run(budget, graphed):
        def fn():
            out = lm_solve_sharded(prob, 0.0635, config, *placed,
                                   iter_budget=budget, graphs=graphed)
            return out[3]["iterations"], [out[0], out[1], list(out[2]),
                                          out[3]]
        return fn
    return run


def _mesh_cell(name, arrs, devices, config, lo, hi) -> list:
    """One mesh_graphs cell (_graph_cell over ``_mesh_runner``): its first
    graphed calls must replay ``setup`` and per LM iteration one ``step``
    and one ``accept`` or ``reject``; spread over several cards it prints
    each card's peak and pool.  Returns its profile jobs."""
    cards = sorted(set(devices))
    cell, jobs = _graph_cell(name, _mesh_runner(arrs, devices, config), lo,
                             hi, phase="mesh_graphs",
                             cards=cards if len(cards) > 1 else None)
    g = cell["graphed"]
    want = sum(1 + 2 * it for it in g["iterations"])
    if not (g["captures"] == 1 and g["replays_first_calls"] == want):
        fail(f"mesh_graphs {name}: {g['captures']} captures, "
             f"{g['replays_first_calls']} replays for {g['iterations']} LM "
             f"iterations (want {want})")
    return jobs


def phase_mesh_graphs(arrs10k, store16) -> list:
    """Phase 21: the mesh's LM through its CUDA graphs (one graph a
    stage, each shard's work on a branch stream of its own) against its
    eager stages, on shards of one card: synthetic-500 dense on 1, 2 and
    4 shards (budgets 8, 32), the 10k CG map on 2 (budgets 3, 12); and
    room-16's whole map solve on 2 shards, eager once and graphed twice
    (the first call captures), beside the single-device graphed solve of
    the same map: the solve's seconds, and the host wall of its
    ``DistWaveSolver.lm`` calls (the captures of the first graphed call
    included; they end at its last flag read) over their LM iterations.
    On a machine of several cards the same cells spread shard i on card
    i mod the card count (``_shard_devices``): synthetic-500 over 2 and 4
    shards, the 10k CG map over 2 (and 4 where there are 4 cards),
    room-16's map over 2, each card's peak and pool printed.  Returns the
    profile jobs."""
    import torch

    from ar_slam_tpu_torch.parallel import dist_lm
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.lm import LMConfig

    jobs = []
    zero_tol = dict(function_tolerance=0.0, parameter_tolerance=0.0)
    dense = LMConfig(max_iterations=32, **zero_tol)
    cg = LMConfig(max_iterations=12, linear_solver="cg", **zero_tol)
    _, arrs500, _ = _synthetic(500, 200)
    for k in (1, 2, 4):
        jobs += _mesh_cell(f"synthetic-500 dense, {k} shards", arrs500,
                           [MESH_CARD] * k, dense, 8, 32)
    jobs += _mesh_cell("synthetic-10k CG, 2 shards", arrs10k,
                       [MESH_CARD] * 2, cg, 3, 12)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        # the same cells with shard i on card i mod the card count
        for k in (2, 4):
            jobs += _mesh_cell(f"synthetic-500 dense, {k} shards spread",
                               arrs500, _shard_devices(k), dense, 8, 32)
        for k in (2, 4) if n_cards >= 4 else (2,):
            jobs += _mesh_cell(f"synthetic-10k CG, {k} shards spread",
                               arrs10k, _shard_devices(k), cg, 3, 12)

    iters, lm_sec, lm = [], [], dist_lm.DistWaveSolver.lm

    def counted(self, *a, **kw):
        t0 = time.perf_counter()
        res = lm(self, *a, **kw)
        lm_sec.append(time.perf_counter() - t0)
        iters.append(res[3]["iterations"])
        return res

    dist_lm.DistWaveSolver.lm = counted
    try:
        layouts = [("2 shards", [MESH_CARD] * 2)]
        if n_cards > 1:
            layouts.append(("2 shards spread", _shard_devices(2)))
        for label, devices in layouts:
            _mesh_map_cell(store16, label, devices, iters, lm_sec)
    finally:
        dist_lm.DistWaveSolver.lm = lm
        graphs.CACHE.clear()
    return jobs


def _mesh_map_cell(store16, label, devices, iters, lm_sec) -> None:
    """room-16's map solve over a mesh of ``devices``, eager once and
    graphed twice, beside the single-device graphed solve: the same map
    bit for bit, two captures (seeds, LM); per call the seconds, the peak
    memory of each card and the mesh LM's ms per iteration."""
    import torch

    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.parallel import block_mesh
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.batch import solve

    cards = sorted(set(devices))
    out = {}
    for mode in ("eager", "graphed", "single-device graphed"):
        graphs.CACHE.clear()
        calls = []
        for _ in range(1 if mode == "eager" else 2):
            store = _store_from(store16, store16.captures)
            mesh = (None if mode.startswith("single")
                    else block_mesh(devices=devices))
            iters.clear()
            lm_sec.clear()
            sync_cards()
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
            t0 = time.perf_counter()
            summary = solve(store, ArSlamConfig(), device=DEVICE,
                            mesh=mesh, graphs=mode != "eager")
            sync_cards()
            sec = time.perf_counter() - t0
            calls.append(dict(seconds=sec, peak_memory_gb_per_card={
                c: torch.cuda.max_memory_allocated(c) / 1e9 for c in cards}))
            if mesh is not None:
                calls[-1].update(
                    mesh_lm_calls=len(iters),
                    mesh_lm_iterations=sum(iters),
                    lm_ms_per_mesh_lm_iteration=(
                        sum(lm_sec) * 1e3 / sum(iters)))
        stats = graphs.CACHE.stats()
        out[mode] = dict(
            calls=calls, rmse_px=summary["rmse"], waves=summary["waves"],
            graphs={k: stats[k] for k in (
                "captures", "replays", "capture_ms", "capture_split_ms")},
            pool_gb=stats["pool_bytes"] / 1e9,
            pool_gb_per_card=[{c: n / 1e9 for c, n in
                               h["pool_bytes_per_card"].items()}
                              for h in stats["held"]],
            poses=[c.inv_pose.copy() for c in store.captures]
            + [a.pose.copy() for a in store.arucos]
            + [store.camera.params.copy()])
    same = _same(out["eager"]["poses"], out["graphed"]["poses"]) and (
        out["eager"]["rmse_px"] == out["graphed"]["rmse_px"])
    for v in out.values():
        del v["poses"]
    emit("mesh_graphs", cell=f"room-16 map (solve), {label}", cards=cards,
         bit_for_bit=same, **out)
    if not same:
        fail(f"mesh_graphs room-16 map, {label}: the graphed map differs "
             "from the eager")
    if out["graphed"]["graphs"]["captures"] != 2:
        fail(f"mesh_graphs room-16 map, {label}: {out['graphed']['graphs']}")


def phase_solve_graphs_profile(jobs,
                               phase: str = "solve_graphs_profile") -> None:
    """Launches, device items and device ms per LM iteration of each
    solve_graphs cell, eager and graphed: one profiled run at each of
    PROFILE_BUDGETS (a graphed one after an unprofiled one, so that no
    capture is profiled), the difference over the iterations between
    them; and of each whole call (a job of one function), per call."""
    for name, mode, graphed, fns in jobs:
        if len(fns) == 1:
            fns[0]()
            (iters, _), prof = _launch_profile(fns[0])
            emit(phase, cell=name, mode=mode, iterations=iters,
                 per_call=prof)
            continue
        runs = []
        for fn in fns:
            if graphed:
                fn()
            (iters, _), prof = _launch_profile(fn)
            runs.append((iters, prof))
        (it_lo, lo), (it_hi, hi) = runs
        d_it = max(it_hi - it_lo, 1)

        def per_it(a, b):  # per card on several cards
            if isinstance(a, dict):
                return {c: (a[c] - b.get(c, 0.0)) / d_it for c in a}
            return (a - b) / d_it

        emit(phase, cell=name, mode=mode, iterations=[it_lo, it_hi],
             per_iteration={k: per_it(hi[k], lo[k]) for k in hi},
             at_budgets=[lo, hi])


def phase_solver_cg_vs_dense_2000() -> None:
    """2 000 tags / 800 captures (README's 4x scale), CG and dense each
    run to convergence in float32."""
    from ar_slam_tpu_torch.solve.batch import rmse_from_cost
    from ar_slam_tpu_torch.solve.lm import TERMINATION_REASONS, LMConfig

    t, arrs, gen_s = _synthetic(2000, 800)
    out = {}
    for solver in ("cg", "dense"):
        config = LMConfig(max_iterations=50, linear_solver=solver)
        kw = _slot_bounds(arrs, cg=solver == "cg")
        _lm_run(t, config, 2, **kw)  # warm-up
        seconds, info = _lm_run(t, config, **kw)
        cost = float(info["cost"])
        out[solver] = {"cost": cost,
                       "rmse_px": rmse_from_cost(cost, arrs.n_blocks),
                       "iterations": info["iterations"],
                       "termination": TERMINATION_REASONS[
                           int(info["termination"])],
                       "seconds": seconds}
    rel = abs(out["cg"]["cost"] - out["dense"]["cost"]) / out["dense"]["cost"]
    emit("solver_cg_vs_dense_2000", tags=arrs.n_tags, captures=arrs.n_caps,
         blocks=arrs.n_blocks, dtype="float32", cost_rel_diff=rel,
         tolerance=CG_VS_DENSE_REL, problem_gen_s=gen_s, **out)
    if not (all(v["rmse_px"] < 1.0 for v in out.values())
            and rel <= CG_VS_DENSE_REL):
        fail(f"solver_cg_vs_dense_2000: {out}, costs {rel} apart")


def _store_from(src, caps):
    """A fresh MapStore holding the detections of ``caps`` of ``src``."""
    from ar_slam_tpu_torch.graph.store import MapStore

    from ar_slam_tpu_torch.config import CameraConfig

    store = MapStore(initial_focal=CameraConfig().initial_focal)
    for cap in caps:
        store.add_detections(
            cap.uid, [(src.arucos[src.blocks[b].tag_idx].id,
                       src.blocks[b].corners) for b in cap.blocks],
            src.camera.size, cap.img_fn)
    return store


def phase_map_cg_room16(store16, dense_rmse: float, truth) -> None:
    """room-16's detections mapped again, with linear_solver="cg"."""
    import dataclasses

    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.solve.batch import solve

    config = ArSlamConfig()
    config = dataclasses.replace(config, solver=dataclasses.replace(
        config.solver, linear_solver="cg"))
    store = _store_from(store16, store16.captures)
    t0 = time.perf_counter()
    summary = solve(store, config, device=DEVICE)
    seconds = time.perf_counter() - t0
    rmse = summary.get("rmse", float("nan"))
    n_req = check_tags("map_cg_room16", _ids_in(store), truth["frames"],
                       [c.uid for c in store.captures], 40.0)
    tags = sorted(a.id for a in store.arucos)
    emit("map_cg_room16", waves=summary.get("waves"), rmse_px=rmse,
         dense_rmse_px=dense_rmse, tags_in_map=len(tags),
         tags_required=n_req, focal=float(store.camera.params[0]),
         solve_seconds=seconds)
    if not (np.isfinite(rmse) and rmse < 1.0
            and summary.get("waves") == len(store16.captures)
            and tags == sorted(a.id for a in store16.arucos)):
        fail(f"map_cg_room16: rmse {rmse} px, {summary.get('waves')} waves, "
             f"{len(tags)} tags")


def phase_progress(store16) -> None:
    """room-16's first 4 captures solved host-stepped with progress
    printing, against the ordinary solve of the same detections, both in
    float64 as the reference's own check (tests/test_lm.py:658-678, x64):
    the stepped solve skips the register-then-refine warmup, as the
    reference's does, and in float32 the two can stall in different basins
    (PERF.md).  The stepping runs graphed (each call a load and replays)
    and eagerly (``graphs=False``): the same costs and lines."""
    import contextlib
    import dataclasses
    import io

    import torch

    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.solve.batch import solve

    from ar_slam_tpu_torch.solve import batch, graphs

    config = ArSlamConfig()
    caps = store16.captures[:4]
    plain = solve(_store_from(store16, caps), config, dtype=torch.float64,
                  device=DEVICE)
    stepping = dataclasses.replace(config, solver=dataclasses.replace(
        config.solver, minimizer_progress_to_stdout=True))
    runs, lm_solve = {}, batch.lm_solve
    for graphed in (True, False):
        costs = []

        def recorded(*a, **kw):
            out = lm_solve(*a, **kw)
            costs.append((float(out[3]["cost"]), out[3]["iterations"]))
            return out

        graphs.CACHE.clear()
        printed = io.StringIO()
        batch.lm_solve = recorded
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(printed):
                summary = solve(_store_from(store16, caps), stepping,
                                dtype=torch.float64, device=DEVICE,
                                graphs=graphed)
        finally:
            batch.lm_solve = lm_solve
        lines = printed.getvalue().splitlines()
        runs[graphed] = dict(
            summary=summary, seconds=time.perf_counter() - t0, costs=costs,
            graphs=graphs.CACHE.stats()["kinds"].get("lm", {}),
            iters=[ln for ln in lines
                   if ln.split() and ln.split()[0].isdigit()],
            terms=[ln for ln in lines if ln.startswith("terminating: ")])
    graphs.CACHE.clear()
    stepped, iters, terms = (runs[True]["summary"], runs[True]["iters"],
                             runs[True]["terms"])
    # the lines but their times; each call's cost bit for bit
    same = (runs[True]["costs"] == runs[False]["costs"]
            and [ln.split()[:5] for ln in iters]
            == [ln.split()[:5] for ln in runs[False]["iters"]]
            and terms == runs[False]["terms"])
    replays = runs[True]["graphs"].get("replays", 0)
    d_rmse = abs(stepped["rmse"] - plain["rmse"])
    emit("progress", captures=len(caps), dtype="float64",
         iteration_lines=len(iters),
         terminating=terms, rmse_px=stepped["rmse"],
         plain_rmse_px=plain["rmse"], rmse_diff_px=d_rmse,
         tolerance_px=PROGRESS_RMSE_TOL_PX, seconds=runs[True]["seconds"],
         eager_seconds=runs[False]["seconds"], lm_calls=len(
             runs[True]["costs"]), lm_graphs=runs[True]["graphs"],
         equal_to_eager_stepping=same,
         last_line=iters[-1] if iters else None)
    if not (len(iters) >= 2 and terms and d_rmse <= PROGRESS_RMSE_TOL_PX):
        fail(f"progress: {len(iters)} iteration lines, {terms}, rmse "
             f"{stepped['rmse']} vs {plain['rmse']}")
    # every LM call of the stepped solve a load and replays: setup, then
    # a step and an accept or reject an iteration
    want = sum(1 + 2 * it for _, it in runs[True]["costs"])
    if not (same and replays == want
            and runs[True]["graphs"].get("captures", 0) >= 1):
        fail(f"progress: graphed stepping equal to the eager: {same}, LM "
             f"graphs {runs[True]['graphs']} for {len(iters)} lines")


def _shard_devices(k: int) -> list:
    """Shard i of k on card i mod the card count."""
    import torch

    return [f"cuda:{i % torch.cuda.device_count()}" for i in range(k)]


def phase_mesh_detect(frames16, frames12):
    """Both cells' detection batches split over three shards of the card:
    bit for bit the unsharded batch, and each shard's kernel launches.
    Returns each cell's launch counts of the sharded run."""
    import torch

    from ar_slam_tpu_torch.detect.detect import detect_batch
    from ar_slam_tpu_torch.parallel import detect as pdet

    mesh = pdet.image_mesh(devices=_shard_devices(3))
    plain = pdet.detect_batch
    out = {}
    for cell, frames, k_ccl, k_unused in (
            ("room-16", frames16, "ccl", "ccl_strip"),
            ("phone_12mp", frames12[:8], "ccl_strip", "ccl")):
        per_shard = []

        def counted(*a, **kw):
            before = read_counts()
            res = plain(*a, **kw)
            after = read_counts()
            per_shard.append({k: after[k] - before[k] for k in after})
            return res

        pdet.detect_batch = counted
        try:
            torch.cuda.synchronize()
            reset_counts()
            replays = detect_replays()
            t0 = time.perf_counter()
            got = pdet.detect_batch_sharded(frames, mesh=mesh)
            torch.cuda.synchronize()
            t_sharded = time.perf_counter() - t0
            launches = read_counts()
            replays = detect_replays() - replays
        finally:
            pdet.detect_batch = plain
        check_launches(f"mesh_detect {cell}", launches,
                       ("box", "box_threshold", k_ccl, "extract"),
                       (k_unused,))
        check_detect_replays(f"mesh_detect {cell}", replays, 3)
        t0 = time.perf_counter()
        ref = detect_batch(frames, device=DEVICE)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        same = all(torch.equal(got[n][k], ref[n][k])
                   for n in ref for k in ref[n])
        n_found = int(sum(int(ref[n]["valid"].sum()) for n in ref))
        per = -(-len(frames) // 3)
        emit("mesh_detect", cell=cell, frames=len(frames), shards=3,
             devices=[str(d) for d in mesh.devices],
             frames_per_shard=[min(per, len(frames) - i * per)
                               for i in range(3)],
             padding_frames=3 * per - len(frames), equal_to_unsharded=same, detections=n_found, launches=launches,
             launches_per_shard=per_shard, detect_replays=replays,
             sharded_seconds=t_sharded,
             unsharded_seconds=t_plain)
        if not same:
            fail(f"mesh_detect {cell}: sharded outputs differ from the "
                 "unsharded batch")
        out[cell] = launches
    return out


def _dist_run(mesh, arrs, config):
    """One lm_solve_dist of the synthetic arrays: (seconds, info)."""
    import torch

    from ar_slam_tpu_torch.parallel import lm_solve_dist

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lm_solve_dist(
        mesh, arrs.camera, arrs.cap_poses, arrs.tag_poses, arrs.cap_idx,
        arrs.tag_idx, arrs.corners, arrs.block_mask, True, arrs.cap_mask,
        arrs.tag_mask, aruco_size=0.0635, config=config)
    float(out[3]["cost"])  # waits for the card
    return time.perf_counter() - t0, out[3]


def _dist_rate(shards, arrs, config, lo, hi):
    """LM iterations/s of lm_solve_dist over ``shards`` shards of the card
    between budgets ``lo`` and ``hi`` (the host prep of each call cancels),
    after a first call that captures the graphs: (rate, seconds at hi,
    info at hi, reductions at hi, the mesh, {graphed, captures made, capture
    ms, replays at hi, the programs held and their pools' GB after})."""
    from ar_slam_tpu_torch.parallel import block_mesh
    from ar_slam_tpu_torch.parallel.dist_lm import graphed_mesh
    from ar_slam_tpu_torch.solve import graphs

    mesh = block_mesh(devices=_shard_devices(shards))
    captures, capture_ms = graphs.CACHE.captures, len(graphs.CACHE.capture_ms)
    _dist_run(mesh, arrs, config._replace(max_iterations=2))
    t_lo, info_lo = _dist_run(mesh, arrs, config._replace(max_iterations=lo))
    before, replays = mesh.reductions, graphs.CACHE.replays
    t_hi, info_hi = _dist_run(mesh, arrs, config._replace(max_iterations=hi))
    rate = (info_hi["iterations"] - info_lo["iterations"]) / max(
        t_hi - t_lo, 1e-9)
    stats = graphs.CACHE.stats()
    g = dict(graphed=graphed_mesh(mesh),
             captures=stats["captures"] - captures,
             capture_ms=sum(sum(sum(r.values()) for r in c["warmup"])
                            + c["record"]
                            for c in graphs.CACHE.capture_ms[capture_ms:]),
             replays=stats["replays"] - replays, programs=stats["programs"],
             pool_gb=stats["pool_bytes"] / 1e9)
    return rate, t_hi, info_hi, mesh.reductions - before, mesh, g


def _check_replays(cell: str, g: dict, iterations: int) -> None:
    """A graphed LM call: one capture before, then ``setup`` and per
    iteration one ``step`` and one ``accept`` or ``reject`` replay."""
    if g["graphed"] and not (g["captures"] >= 1
                             and g["replays"] == 1 + 2 * iterations):
        fail(f"{cell}: {iterations} LM iterations replayed {g}")


def phase_mesh_solver_500(grouped_rate: float) -> None:
    """The 500-tag problem through the tag-sharded LM over 1, 2 and 4
    shards of the card, float32."""
    from ar_slam_tpu_torch.solve.lm import LMConfig

    _, arrs, gen_s = _synthetic(500, 200)
    from ar_slam_tpu_torch.solve import graphs

    config = LMConfig(max_iterations=32, function_tolerance=0.0,
                      parameter_tolerance=0.0)
    runs = {}
    # one program a kind: each shard count's capture replaces the last one
    # in the kind's pool, which its graphs reuse
    graphs.CACHE.clear()
    for shards in (1, 2, 4):
        rate, t_hi, info, reductions, _, g = _dist_rate(shards, arrs, config,
                                                        8, 32)
        cost = float(info["cost"])
        runs[shards] = dict(
            final_cost=cost, iterations=info["iterations"],
            rel_err=abs(cost - F64_OPTIMUM_500) / F64_OPTIMUM_500,
            reductions=reductions,
            reductions_per_iteration=(reductions - 1) / info["iterations"],
            lm_iterations_per_s=rate, seconds_32=t_hi,
            devices=_shard_devices(shards), graphs=g)
        _check_replays(f"mesh_solver_500 at {shards} shards", g,
                       info["iterations"])
    graphs.CACHE.clear()
    emit("mesh_solver_500", tags=arrs.n_tags, captures=arrs.n_caps,
         blocks=arrs.n_blocks, dtype="float32", f64_optimum=F64_OPTIMUM_500,
         single_device_lm_iterations_per_s=grouped_rate, shards=runs,
         problem_gen_s=gen_s)
    for shards, r in runs.items():
        if not (r["rel_err"] <= 1e-3
                and r["reductions"] == 1 + 2 * r["iterations"]):
            fail(f"mesh_solver_500 at {shards} shards: {r}")


def phase_mesh_cg_10k(arrs, single_rmse: float) -> None:
    """The 10k map of phase 8 through the tag-sharded CG over two shards
    (and four on a machine of four cards or more): 12 LM iterations, their
    rate and the peak memory of each card, and one sharded CG solve under
    set_sync_debug_mode("error")."""
    import torch

    for shards in (2, 4) if torch.cuda.device_count() >= 4 else (2,):
        _mesh_cg_10k(arrs, single_rmse, shards)


def _mesh_cg_10k(arrs, single_rmse: float, shards: int) -> None:
    import torch

    from ar_slam_tpu_torch.parallel import (TagShardedProblem,
                                            make_tag_sharded_hooks)
    from ar_slam_tpu_torch.solve.batch import rmse_from_cost
    from ar_slam_tpu_torch.solve.lm import LMConfig

    config = LMConfig(max_iterations=12, function_tolerance=0.0,
                      parameter_tolerance=0.0, linear_solver="cg")
    from ar_slam_tpu_torch.solve import graphs

    cards = sorted(set(_shard_devices(shards)))
    graphs.CACHE.clear()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    rate, t_hi, info, reductions, mesh, g = _dist_rate(shards, arrs, config,
                                                       3, 12)
    graphs.CACHE.clear()
    peak_gb = {d: torch.cuda.max_memory_allocated(d) / 1e9 for d in cards}
    _check_replays(f"mesh_cg_10k at {shards} shards", g, info["iterations"])
    cost0, cost = float(info["initial_cost"]), float(info["cost"])
    rmse = rmse_from_cost(cost, arrs.n_blocks)

    # one sharded CG solve with no host read: its inputs placed first
    t0 = time.perf_counter()
    prob = TagShardedProblem(mesh, arrs.cap_idx, arrs.tag_idx, arrs.corners,
                             arrs.block_mask, arrs.tag_poses.shape[0],
                             dtype=torch.float32)
    prep_s = time.perf_counter() - t0
    make_group, make_lin, _, make_solve = make_tag_sharded_hooks(
        mesh, prob.t_per, arrs.cap_poses.shape[0], 0.0635,
        obs_per_tag=prob.obs_per_tag, obs_per_cap=prob.obs_per_cap,
        linear_solver="cg", cg_tol=config.cg_tolerance,
        cg_iters=config.cg_max_iterations, row_slots=prob.row_slots,
        shard_rows=prob.shard_rows, shard_cap_rows=prob.shard_cap_rows)
    grouped = make_group(prob.cap_idx, prob.tag_idx, prob.corners,
                         prob.block_mask(arrs.block_mask))
    tag_act = prob.put_tag_mask(arrs.tag_mask)
    cam, caps, cap_act = prob.put_rep(arrs.camera, arrs.cap_poses,
                                      arrs.cap_mask)
    eqs, _ = make_lin(grouped, tag_act)(cam, caps, prob.put_tags(
        arrs.tag_poses))
    solve_fn = make_solve(True, cap_act, tag_act, grouped)
    lam = torch.full((), config.initial_lambda, device=mesh.home)
    x0 = torch.zeros(3 + 6 * arrs.cap_poses.shape[0], device=mesh.home)
    for d in cards:
        torch.cuda.synchronize(d)
    torch.cuda.set_sync_debug_mode("error")
    try:
        sol = solve_fn(eqs, lam, x0)
    except RuntimeError as e:
        traceback.print_exc()
        fail(f"mesh_cg_10k: the sharded CG solve synchronised the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sol_finite = all(bool(torch.isfinite(x).all())
                     for x in (sol[0], sol[1], *sol[2], sol[3]))
    emit("mesh_cg_10k", tags=arrs.n_tags, captures=arrs.n_caps,
         blocks=arrs.n_blocks, shards=shards,
         devices=[str(d) for d in mesh.devices], dtype="float32",
         shard_rows=prob.shard_rows, shard_cap_rows=prob.shard_cap_rows,
         initial_cost=cost0, final_cost=cost, final_rmse_px=rmse,
         single_device_rmse_px=single_rmse,
         rmse_diff_px=abs(rmse - single_rmse),
         tolerance_px=MESH_CG_RMSE_TOL_PX, iterations=info["iterations"],
         reductions_12=reductions, lm_iterations_per_s=rate,
         seconds_12=t_hi, peak_memory_gb=peak_gb, graphs=g,
         host_prep_s=prep_s,
         sync_debug_cg_solve="no synchronising call",
         sync_debug_solution_finite=sol_finite)
    if not (np.isfinite(cost) and cost < cost0 and sol_finite
            and abs(rmse - single_rmse) <= MESH_CG_RMSE_TOL_PX):
        fail(f"mesh_cg_10k at {shards} shards: cost {cost0} -> {cost}, rmse "
             f"{rmse} against {single_rmse}, CG solution finite: "
             f"{sol_finite}")


def phase_mesh_map_room16(store16, dense_rmse: float, truth) -> None:
    """room-16's detections mapped again with the tags sharded over two
    shards of the card."""
    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.parallel import block_mesh
    from ar_slam_tpu_torch.solve.batch import solve

    from ar_slam_tpu_torch.parallel.dist_lm import graphed_mesh
    from ar_slam_tpu_torch.solve import graphs

    store = _store_from(store16, store16.captures)
    mesh = block_mesh(devices=_shard_devices(2))
    graphs.CACHE.clear()
    t0 = time.perf_counter()
    summary = solve(store, ArSlamConfig(), mesh=mesh)
    seconds = time.perf_counter() - t0
    stats = graphs.CACHE.stats()
    graphs.CACHE.clear()
    if graphed_mesh(mesh) and not (stats["captures"] == 2
                                   and stats["replays"] > 0):
        fail(f"mesh_map_room16: the mesh's seeds and LM replayed no graphs: "
             f"{stats}")
    rmse = summary.get("rmse", float("nan"))
    n_req = check_tags("mesh_map_room16", _ids_in(store), truth["frames"],
                       [c.uid for c in store.captures], 40.0)
    tags = sorted(a.id for a in store.arucos)
    emit("mesh_map_room16", shards=2,
         devices=[str(d) for d in mesh.devices], waves=summary.get("waves"),
         rmse_px=rmse, dense_rmse_px=dense_rmse,
         rmse_diff_px=abs(rmse - dense_rmse), tolerance_px=MESH_RMSE_TOL_PX,
         tags_in_map=len(tags), tags_required=n_req,
         reductions=mesh.reductions, focal=float(store.camera.params[0]),
         solve_seconds=seconds, graphed=graphed_mesh(mesh),
         graphs={k: stats[k] for k in ("captures", "replays", "capture_ms",
                                       "pool_bytes")})
    if not (abs(rmse - dense_rmse) <= MESH_RMSE_TOL_PX
            and summary.get("waves") == len(store16.captures)
            and tags == sorted(a.id for a in store16.arucos)):
        fail(f"mesh_map_room16: rmse {rmse} px against {dense_rmse}, "
             f"{summary.get('waves')} waves, {len(tags)} tags")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


MESH_MAP_MARK = "mesh_map_process: "


def mesh_map(mode: str, spec: str, src: str, out: str) -> int:
    """One process of multihost_1: ``arslam-torch map SRC -o OUT
    --multihost SPEC`` with the solve's graphs (``mode`` "graphs") or its
    eager stages ("eager"); prints on stderr (every process: the others
    mute stdout), after MESH_MAP_MARK, the solve's seconds and the graph
    cache's counts."""
    import torch

    from ar_slam_tpu_torch import cli
    from ar_slam_tpu_torch.solve import batch, graphs

    solve, seen = batch.solve, {}

    def timed_solve(*a, **kw):
        t0 = time.perf_counter()
        res = solve(*a, graphs=mode == "graphs", **kw)
        torch.cuda.synchronize()
        seen.update(solve_s=time.perf_counter() - t0,
                    graphs=graphs.CACHE.stats())
        return res

    batch.solve = timed_solve
    rc = cli.main(["map", src, "-o", out, "--multihost", spec])
    print(MESH_MAP_MARK + json.dumps(dict(mode=mode, rc=rc, **seen)),
          file=sys.stderr, flush=True)
    return rc


def phase_multihost_1() -> None:
    """``arslam-torch map`` of phone_12mp's saved map (8 captures:
    room-16's takes 3x as long to solve) with --multihost, one NCCL
    process (two and four where there are as many cards, the cards shared
    out among them),
    eager and graphed, against the in-process solve of the same map with
    the command's default config; each mode's maps the same text.  A
    graphed process replays graphs whether its shards sit on one card or
    several (one graph a stage spanning them); with several processes its
    packed reductions' NCCL all_reduce is inside the graphs."""
    import torch

    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.graph.store import MapStore
    from ar_slam_tpu_torch.graph.yamlio import load_yaml
    from ar_slam_tpu_torch.solve.batch import solve

    src = os.path.join(OUT_DIR, "phone_map.yaml")
    store = MapStore()
    load_yaml(store, src)
    ref = solve(store, ArSlamConfig(), device=DEVICE)["rmse"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    runs = {}
    count = torch.cuda.device_count()
    for world in [w for w in (1, 2, 4) if w <= count]:
        maps = set()
        for mode in ("eager", "graphs"):
            port = _free_port()
            out = os.path.join(OUT_DIR, f"multihost_{world}_{mode}.yaml")
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-map",
                 mode, f"127.0.0.1:{port},{world},{rank}", src, out],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True) for rank in range(world)]
            try:
                res = [p.communicate(timeout=MULTIHOST_TIMEOUT_S)
                       for p in procs]
            except subprocess.TimeoutExpired:
                fail(f"multihost_{world} {mode}: no answer in "
                     f"{MULTIHOST_TIMEOUT_S} s")
            finally:
                for p in procs:
                    p.kill()
            seconds = time.perf_counter() - t0
            for p, (o, e) in zip(procs, res):
                if p.returncode != 0:
                    fail(f"multihost_{world} {mode}: exit {p.returncode}\n"
                         f"{o}\n{e}")
            rmse = float(res[0][0].split("rmse ")[1].split(" px")[0])
            costs = sorted({ln.split("cost=")[1].split()[0] for _, e in res
                            for ln in e.splitlines()
                            if "solve done: cost=" in ln})
            ranks = [json.loads(ln[len(MESH_MAP_MARK):]) for _, e in res
                     for ln in e.splitlines() if ln.startswith(MESH_MAP_MARK)]
            replayed = [r["graphs"]["captures"] >= 2
                        and r["graphs"]["replays"] > 0 for r in ranks]
            runs[f"{world}_{mode}"] = dict(
                rmse_px=rmse, costs=costs, seconds=seconds, backend="nccl",
                graphed=mode == "graphs",
                cards_per_process=max(count // world, 1),
                solve_s=[r["solve_s"] for r in ranks],
                graphs=[{k: r["graphs"][k] for k in (
                    "captures", "replays", "capture_ms", "pool_bytes")}
                    for r in ranks])
            with open(out) as f:
                maps.add(f.read())
            if not (abs(rmse - ref) <= MESH_RMSE_TOL_PX and len(costs) == 1
                    and len(ranks) == world
                    and all(x == (mode == "graphs") for x in replayed)):
                fail(f"multihost_{world} {mode}: rmse {rmse} against {ref}, "
                     f"costs {costs}, graphs replayed {replayed}")
        runs[f"{world}_same_maps"] = len(maps) == 1
        if len(maps) != 1:
            fail(f"multihost_{world}: the eager and graphed processes wrote "
                 "different maps")
    emit("multihost", in_process_rmse_px=ref, tolerance_px=MESH_RMSE_TOL_PX,
         cards=torch.cuda.device_count(), processes=runs)


def one_shot_map(mode: str, src: str, out: str) -> int:
    """One process of phase 19: ``arslam-torch map SRC -o OUT`` with the
    solve's graphs (``mode`` "graphs") or its eager loop ("eager"); prints
    the seconds of its parts and the graph cache's counts."""
    import contextlib
    import io

    t0 = time.perf_counter()
    import torch

    from ar_slam_tpu_torch import cli
    from ar_slam_tpu_torch.solve import batch, graphs

    import_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.zeros(1, device=DEVICE)
    cuda_s = time.perf_counter() - t0
    solve, solve_s = batch.solve, []

    def timed_solve(*a, **kw):
        t1 = time.perf_counter()
        res = solve(*a, graphs=mode == "graphs", **kw)
        solve_s.append(time.perf_counter() - t1)
        return res

    batch.solve = timed_solve
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["map", src, "-o", out])
    torch.cuda.synchronize()
    stats = graphs.CACHE.stats()
    first = {}  # each program's first capture: its first warm-up round
    for c in stats["capture_split_ms"]:
        first.setdefault(c["program"], c["warmup"][0])
    emit("one_shot_map_process", mode=mode, rc=rc, import_s=import_s,
         cuda_start_s=cuda_s, command_s=time.perf_counter() - t0,
         solve_s=solve_s, printed=printed.getvalue().splitlines()[-1],
         imported={m: m in sys.modules for m in ("torch._dynamo", "sympy")},
         first_warmup_round_ms=first,
         graphs=stats)
    return rc


def phase_one_shot_map() -> None:
    """Phase 19: room-16's map.yaml (phase 4) re-solved by ``arslam-torch
    map`` in fresh processes, eager and graphed."""
    src = os.path.join(OUT_DIR, "map.yaml")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    runs, maps = [], set()
    for k, mode in enumerate(("eager", "graphs")):
        out = os.path.join(OUT_DIR, f"one_shot_{k}.yaml")
        t0 = time.perf_counter()
        try:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one-shot-map",
                 mode, src, out], cwd=REPO, env=env, capture_output=True,
                text=True, timeout=ONE_SHOT_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"one_shot_map {mode}: no answer in {ONE_SHOT_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        if p.returncode != 0:
            fail(f"one_shot_map {mode}: exit {p.returncode}\n{p.stdout}\n"
                 f"{p.stderr}")
        runs.append(dict(json.loads(p.stdout.strip().splitlines()[-1]),
                         process_s=wall))
        with open(out) as f:
            maps.add(f.read())
    emit("one_shot_map", cell="room-16 map.yaml", runs=runs,
         same_maps=len(maps) == 1)
    if len(maps) != 1:
        fail("one_shot_map: the eager and graphed processes wrote different "
             "maps")
    if any(any(r["imported"].values()) for r in runs):
        fail("one_shot_map: a solve imported "
             f"{[r['imported'] for r in runs]}")


def phase_serve_growth() -> None:
    """Phase 20: solve_incremental over a synthetic map growing 8 captures
    a call through its padding buckets."""
    import torch

    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.graph.store import MapStore
    from ar_slam_tpu_torch.solve import graphs
    from ar_slam_tpu_torch.solve.batch import solve_incremental
    from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map

    src, _ = make_synthetic_map(n_tags=200, n_caps=64, seed=0, noise_px=0.3,
                                focal=3000.0)
    store = MapStore(initial_focal=3000.0)
    graphs.CACHE.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    calls, out = [], {}
    for k in range(0, len(src.captures), 8):
        for cap in src.captures[k:k + 8]:
            store.add_detections(cap.uid, [
                (src.arucos[src.blocks[b].tag_idx].id, src.blocks[b].corners)
                for b in cap.blocks], src.camera.size)
        t0 = time.perf_counter()
        out = solve_incremental(store, ArSlamConfig(), device=DEVICE)
        torch.cuda.synchronize()
        stats = graphs.CACHE.stats()
        calls.append(dict(
            captures_in_map=len(store.captures), tags=len(store.arucos),
            blocks=len(store.blocks), seconds=time.perf_counter() - t0,
            waves=out.get("waves"), rmse_px=out.get("rmse"),
            captures_made=stats["captures"], programs=stats["programs"],
            pool_gb=stats["pool_bytes"] / 1e9,
            reserved_gb=(torch.cuda.memory_reserved() - reserved0) / 1e9))
    emit("serve_growth", calls=calls,
         capture_split_ms=graphs.CACHE.stats()["capture_split_ms"])
    rmse = out.get("rmse", float("nan"))
    if not (all(c["programs"] == 2 for c in calls) and np.isfinite(rmse)
            and rmse < 1.0 and out.get("unsolved") == 0):
        fail(f"serve_growth: {calls}")
    graphs.CACHE.clear()


def _device_ms(fn, names) -> dict:
    """Device ms, by torch.profiler, of the kernels whose names hold each
    of ``names`` over one run of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA:
            for name in names:
                if name in a.key:
                    out[name] += a.self_device_time_total / 1e3
    if not all(out.values()):
        fail(f"the profile shows no device time for {names}: {out}")
    return out


def _profiled(label: str, fn) -> dict:
    """One run of fn under torch.profiler: wall ms (host clock, synchronized),
    device ms (summed over kernels and copies), the idle share, and the
    largest device items; printed and returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): the host ops that launched
    # them carry the same device time again
    avgs = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA
            and a.self_device_time_total > 0]
    device_ms = sum(a.self_device_time_total for a in avgs) / 1e3
    top = sorted(avgs, key=lambda a: -a.self_device_time_total)[:10]
    # host-to-device copies, from the trace's memcpy records
    os.makedirs(OUT_DIR, exist_ok=True)
    trace = os.path.join(OUT_DIR, "profile_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(trace)
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    out = dict(
        wall_ms=wall_ms, device_ms=device_ms,
        device_idle_share=1.0 - device_ms / wall_ms if device_ms else None,
        h2d_bytes=sum(e.get("args", {}).get("bytes", 0) for e in h2d),
        h2d_ms=sum(e.get("dur", 0.0) for e in h2d) / 1e3,
        h2d_copies=len(h2d),
        device_items=sum(a.count for a in avgs),
        top=[{"name": a.key[:80], "ms": a.self_device_time_total / 1e3,
              "count": a.count} for a in top])
    emit("profile", run=label, **out)
    return out


def phase_profile(frames16, frames12, tag_m: float) -> None:
    """--profile: where the device time goes in one detection batch of each
    cell and in phone_12mp's localization (run after the checked phases,
    so every shape is warm)."""
    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
    from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture

    def caps(frames, ks, prefix):
        return [IngestedCapture(f"{prefix}{k:02d}", "", frames[k]) for k in ks]

    # each detection program is captured before its profile, so that no
    # capture is profiled
    room = ArSlamEngine(device=DEVICE)
    room.detect_decoded(caps(frames16, range(8), "frame"))
    _profiled("room-16 detect 8 frames",
              lambda: room.detect_decoded(caps(frames16, range(8), "frame")))
    config = ArSlamConfig(aruco_size=tag_m)
    phone = ArSlamEngine(config, device=DEVICE)
    phone.detect_decoded(caps(frames12, range(8), "phone"))
    _profiled("phone_12mp detect 8 frames",
              lambda: phone.detect_decoded(caps(frames12, range(8), "phone")))
    loc = ArSlamEngine(config, device=DEVICE)
    loc.load_map(os.path.join(OUT_DIR, "phone_map.yaml"))
    loc.detect_decoded(caps(frames12, range(8, 12), "phone"))
    _profiled("phone_12mp localize 4 frames (detect + pose-only LM)",
              lambda: loc.localize_decoded(caps(frames12, range(8, 12),
                                                "phone")))


def main() -> int:
    import argparse

    p = argparse.ArgumentParser(description="smoke run of the port on a GPU")
    p.add_argument("--profile", action="store_true",
                   help="profile a detection batch of each cell and the "
                        "phone_12mp localization")
    p.add_argument("--tag-mm", type=float, default=PHONE_TAG_M * 1e3,
                   help="printed tag side of the phone_12mp scene in mm")
    p.add_argument("--one-shot-map", nargs=3, metavar=("MODE", "SRC", "OUT"),
                   help="run one process of phase 19 (MODE graphs or eager)")
    p.add_argument("--mesh-map", nargs=4,
                   metavar=("MODE", "SPEC", "SRC", "OUT"),
                   help="run one --multihost SPEC process of phase 17 "
                        "(MODE graphs or eager)")
    args = p.parse_args()
    if args.one_shot_map:
        return one_shot_map(*args.one_shot_map)
    if args.mesh_map:
        return mesh_map(*args.mesh_map)

    import torch

    from ar_slam_tpu_torch.utils.render import PHONE_12MP, room_scene

    tag_m = args.tag_mm / 1e3
    phase_device()
    phase_build()
    t0 = time.perf_counter()
    frames16, truth16 = room_scene(n_frames=16)
    frames12, truth12 = room_scene(n_frames=12, arc=PHONE_ARC,
                                   aruco_size=tag_m, **PHONE_12MP)
    emit("render", seconds=time.perf_counter() - t0)
    rows, jobs = phase_kernels(frames16, frames12)
    syncs = CaptureSyncs()
    room16, store16, rmse16 = phase_main_path(frames16, truth16)
    launches = {"room-16": room16}
    launches["phone_12mp"], phone = phase_phone_12mp(frames12, truth12,
                                                     tag_m)
    phase_serve_12mp(frames12, truth12, tag_m)
    syncs.close()
    emit("capture_syncs", cells=["room-16", "phone_12mp", "serve_12mp"],
         captures=syncs.captures, calls=syncs.counts)
    if syncs.captures <= 0 or any(syncs.counts.values()):
        fail(f"the main paths' captures: {syncs.captures}, calls during "
             f"them {syncs.counts}")
    grouped_rate = timed("solver", phase_solver)
    cg_10k, (arrs10k, rmse10k) = timed("solver_cg_10k", phase_solver_cg_10k)
    timed("solver_cg_vs_dense_2000", phase_solver_cg_vs_dense_2000)
    flat_jobs = timed("solver_flat_500", phase_solver_flat_500, grouped_rate)
    timed("map_cg_room16", phase_map_cg_room16, store16, rmse16, truth16)
    timed("progress", phase_progress, store16)
    mesh_launches = timed("mesh_detect", phase_mesh_detect, frames16,
                          frames12)
    timed("mesh_solver_500", phase_mesh_solver_500, grouped_rate)
    timed("mesh_cg_10k", phase_mesh_cg_10k, arrs10k, rmse10k)
    timed("mesh_map_room16", phase_mesh_map_room16, store16, rmse16, truth16)
    timed("multihost_1", phase_multihost_1)
    graph_jobs = timed("solve_graphs", phase_solve_graphs, store16, phone,
                       arrs10k)
    detect_jobs = timed("detect_graphs", phase_detect_graphs, frames16,
                        frames12)
    mesh_jobs = timed("mesh_graphs", phase_mesh_graphs, arrs10k, store16)
    del arrs10k, phone
    timed("one_shot_map", phase_one_shot_map)
    timed("serve_growth", phase_serve_growth)
    if args.profile:
        phase_profile(frames16, frames12, tag_m)
    phase_kernel_profiles(jobs)
    timed("cg_10k_profile", phase_cg_profile, *cg_10k)
    del cg_10k
    timed("solve_graphs_profile", phase_solve_graphs_profile, graph_jobs)
    timed("mesh_graphs_profile", phase_solve_graphs_profile, mesh_jobs,
          "mesh_graphs_profile")
    timed("solver_flat_500_profile", phase_solve_graphs_profile, flat_jobs,
          "solver_flat_500_profile")
    timed("detect_graphs_profile", phase_detect_graphs_profile, detect_jobs)
    for row in rows:
        row["launches"] = launches[row["cell"]][COUNTERS[row["name"]]]
        row["mesh_detect_launches"] = mesh_launches[row["cell"]][
            COUNTERS[row["name"]]]
    # K3's wrapper enqueues 1 + 2 x iters kernels a call and reads no flag
    for row in rows:
        if COUNTERS[row["name"]] == "ccl_strip":
            counts = launches[row["cell"]]
            calls = max(counts["ccl_strip"], 1)
            row["kernel_launches"] = counts["ccl_strip_kernels"]
            row["kernel_launches_per_call"] = counts["ccl_strip_kernels"] / calls
            row["host_flag_reads_per_call"] = (counts["ccl_strip_flag_reads"]
                                               / calls)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
