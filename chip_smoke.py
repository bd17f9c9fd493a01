"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--tag-mm 50]

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
   observation bounds (the flat hooks): cost within 1e-3 of 3771.57;
11. map_cg_room16 — room-16's detections (from phase 4) mapped again with
   linear_solver="cg": rmse < 1 px, every tag in the map;
12. progress — room-16's first 4 captures solved with
   minimizer_progress_to_stdout, in float64: >= 2 iteration lines and a
   terminating line, rmse within 1e-3 px of the ordinary solve.

Last, where the time goes in one CG LM iteration at 10k (the CG solve,
the step quality, the relinearization): wall ms on the host clock (taken
in phase 8, before any profiler attaches), device ms and items from
torch.profiler, and both per CG step.  With --profile, one detection batch of each cell and phone_12mp's
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
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=line,
         torch=torch.__version__, cuda=torch.version.cuda)
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

    caps = [IngestedCapture(f"frame{k:02d}", f"frame{k:02d}.png", frames[k])
            for k in range(len(frames))]
    batches = [caps[i:i + 8] for i in range(0, len(caps), 8)]
    ArSlamEngine(device=DEVICE).detect_decoded(batches[0])  # warm-up

    reset_counts()
    engine = ArSlamEngine(device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        engine.add_decoded(b)
    t_detect = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary = engine.solve()
    t_solve = time.perf_counter() - t0
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
    with open(map_path) as f:
        parsed = yamlio._fast_parse(f.read())
    if sorted(parsed["tag_ids"]) != sorted(t.id for t in engine.store.arucos):
        fail("map.yaml tags differ after reload")
    emit("main_path", cell="room-16", frames=len(frames), launches=launches,
         tags_required=n_req, tags_in_map=len(parsed["tag_ids"]),
         blocks=len(engine.store.blocks), waves=summary.get("waves"),
         rmse_px=rmse, focal=float(engine.store.camera.params[0]),
         detect_seconds=t_detect,
         detect_frames_per_s=len(frames) / t_detect, solve_seconds=t_solve)
    return launches, engine.store, rmse


def phase_phone_12mp(frames, truth, tag_m: float):
    """phone_12mp: map frames 0-7 (4032x3024), save, then a fresh engine
    loads the map and localizes frames 8-11."""
    import torch

    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.detect import ccl
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
    from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture
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
    t0 = time.perf_counter()
    engine.add_decoded(caps[:8])
    t_detect = time.perf_counter() - t0
    detect_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    summary = engine.solve()
    t_solve = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    map_path = os.path.join(OUT_DIR, "phone_map.yaml")
    engine.save_map(map_path)

    loc = ArSlamEngine(config, device=DEVICE)
    loc.load_map(map_path)
    first = loc.store.next_capture_index
    t0 = time.perf_counter()
    result = loc.localize_decoded(caps[8:])
    t_loc_total = time.perf_counter() - t0
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
         detect_peak_memory_gb=detect_peak_gb,
         solve_seconds=t_solve, localize_seconds=t_loc,
         localize_with_detection_seconds=t_loc_total)

    check_launches("phone_12mp", launches,
                   ("box", "box_threshold", "ccl_strip", "extract"),
                   ("ccl", "ccl_strip_flag_reads"))
    n_req = check_tags("phone_12mp", found, truth["frames"],
                       [c.uid for c in caps], PHONE_SIDE_PX)
    emit("phone_12mp_tags", tags_required=n_req, min_side_px=PHONE_SIDE_PX)
    rmse = summary.get("rmse", float("nan"))
    if not (np.isfinite(rmse) and rmse < 1.0):
        fail(f"phone_12mp map rmse {rmse} px is not < 1")
    statuses = result.get("status", {})
    if sorted(statuses) != [c.uid for c in caps[8:]] or set(
            statuses.values()) != {"localized"}:
        fail(f"phone_12mp: not every query localized: {statuses}")
    if not (np.isfinite(loc_rmse) and loc_rmse < 1.0):
        fail(f"phone_12mp localize rmse {loc_rmse} px is not < 1")
    if not q_err.max() <= QUERY_POSITION_M:
        fail(f"phone_12mp query positions off by {q_err.tolist()} m "
             f"(bound {QUERY_POSITION_M})")
    if not (d_pose <= F32_POSE_TOL and d_rmse <= F32_RMSE_TOL_PX):
        fail(f"phone_12mp float32 localization differs from float64: pose "
             f"{d_pose} (bound {F32_POSE_TOL}), rmse {d_rmse} px (bound "
             f"{F32_RMSE_TOL_PX})")
    return launches


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
         replay_seconds=t_replay)

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


def phase_solver_flat_500(grouped_rate: float) -> None:
    """The 500-tag synthetic through lm_solve without observation bounds:
    the flat block hooks and the flat dense Schur solve."""
    from ar_slam_tpu_torch.solve.lm import LMConfig

    t, arrs, gen_s = _synthetic(500, 200)
    config = LMConfig(max_iterations=32, function_tolerance=0.0,
                      parameter_tolerance=0.0)
    rate, _, t_hi, info = _marginal_rate(t, config, 8, 32)
    cost = float(info["cost"])
    rel = abs(cost - F64_OPTIMUM_500) / F64_OPTIMUM_500
    emit("solver_flat_500", tags=arrs.n_tags, captures=arrs.n_caps,
         blocks=arrs.n_blocks, dtype="float32", final_cost=cost,
         f64_optimum=F64_OPTIMUM_500, rel_err=rel,
         iterations=info["iterations"], lm_iterations_per_s=rate,
         grouped_lm_iterations_per_s=grouped_rate, seconds_32=t_hi,
         problem_gen_s=gen_s)
    if not rel <= 1e-3:
        fail(f"flat 500-tag final cost {cost} is not within 1e-3 of "
             f"{F64_OPTIMUM_500}")


def _wall_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of fn() to a synchronized card, after one
    warm-up call, with no profiler attached."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_solver_cg_10k():
    """CG at 10 000 tags / 4 000 captures (tools/big_map_bench.py's
    problem): LM iterations/s from budgets 3 and 12, one CG solve under
    set_sync_debug_mode("error"), and the host ms of one LM iteration's
    parts.  Returns (the parts, their ms, the CG steps) for their profile,
    taken last (phase_cg_profile)."""
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
    return parts, wall, config.cg_max_iterations


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
    (PERF.md)."""
    import contextlib
    import dataclasses
    import io

    import torch

    from ar_slam_tpu_torch.config import ArSlamConfig
    from ar_slam_tpu_torch.solve.batch import solve

    config = ArSlamConfig()
    caps = store16.captures[:4]
    plain = solve(_store_from(store16, caps), config, dtype=torch.float64,
                  device=DEVICE)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        stepped = solve(_store_from(store16, caps), dataclasses.replace(
            config, solver=dataclasses.replace(
                config.solver, minimizer_progress_to_stdout=True)),
            dtype=torch.float64, device=DEVICE)
    seconds = time.perf_counter() - t0
    lines = printed.getvalue().splitlines()
    iters = [ln for ln in lines if ln.split() and ln.split()[0].isdigit()]
    terms = [ln for ln in lines if ln.startswith("terminating: ")]
    d_rmse = abs(stepped["rmse"] - plain["rmse"])
    emit("progress", captures=len(caps), dtype="float64",
         iteration_lines=len(iters),
         terminating=terms, rmse_px=stepped["rmse"],
         plain_rmse_px=plain["rmse"], rmse_diff_px=d_rmse,
         tolerance_px=PROGRESS_RMSE_TOL_PX, seconds=seconds,
         last_line=iters[-1] if iters else None)
    if not (len(iters) >= 2 and terms and d_rmse <= PROGRESS_RMSE_TOL_PX):
        fail(f"progress: {len(iters)} iteration lines, {terms}, rmse "
             f"{stepped['rmse']} vs {plain['rmse']}")


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

    room = ArSlamEngine(device=DEVICE)
    _profiled("room-16 detect 8 frames",
              lambda: room.detect_decoded(caps(frames16, range(8), "frame")))
    config = ArSlamConfig(aruco_size=tag_m)
    phone = ArSlamEngine(config, device=DEVICE)
    _profiled("phone_12mp detect 8 frames",
              lambda: phone.detect_decoded(caps(frames12, range(8), "phone")))
    loc = ArSlamEngine(config, device=DEVICE)
    loc.load_map(os.path.join(OUT_DIR, "phone_map.yaml"))
    _profiled("phone_12mp localize 4 frames (detect + pose-only LM)",
              lambda: loc.localize_decoded(caps(frames12, range(8, 12),
                                                "phone")))


def main() -> int:
    import argparse

    import torch

    from ar_slam_tpu_torch.utils.render import PHONE_12MP, room_scene

    p = argparse.ArgumentParser(description="smoke run of the port on a GPU")
    p.add_argument("--profile", action="store_true",
                   help="profile a detection batch of each cell and the "
                        "phone_12mp localization")
    p.add_argument("--tag-mm", type=float, default=PHONE_TAG_M * 1e3,
                   help="printed tag side of the phone_12mp scene in mm")
    args = p.parse_args()
    tag_m = args.tag_mm / 1e3
    phase_device()
    phase_build()
    t0 = time.perf_counter()
    frames16, truth16 = room_scene(n_frames=16)
    frames12, truth12 = room_scene(n_frames=12, arc=PHONE_ARC,
                                   aruco_size=tag_m, **PHONE_12MP)
    emit("render", seconds=time.perf_counter() - t0)
    rows, jobs = phase_kernels(frames16, frames12)
    room16, store16, rmse16 = phase_main_path(frames16, truth16)
    launches = {"room-16": room16,
                "phone_12mp": phase_phone_12mp(frames12, truth12, tag_m)}
    phase_serve_12mp(frames12, truth12, tag_m)
    grouped_rate = timed("solver", phase_solver)
    cg_10k = timed("solver_cg_10k", phase_solver_cg_10k)
    timed("solver_cg_vs_dense_2000", phase_solver_cg_vs_dense_2000)
    timed("solver_flat_500", phase_solver_flat_500, grouped_rate)
    timed("map_cg_room16", phase_map_cg_room16, store16, rmse16, truth16)
    timed("progress", phase_progress, store16)
    if args.profile:
        phase_profile(frames16, frames12, tag_m)
    phase_kernel_profiles(jobs)
    timed("cg_10k_profile", phase_cg_profile, *cg_10k)
    del cg_10k
    for row in rows:
        row["launches"] = launches[row["cell"]][COUNTERS[row["name"]]]
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
