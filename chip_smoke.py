"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. device  — requires CUDA; prints the card's name and power limit;
2. build   — compiles the CUDA kernels from ar_slam_tpu_torch/csrc;
3. kernels — each kernel against its plain PyTorch version at the main
   path's shapes on rendered frames (box filter within a stated tolerance
   of a float64 reference; connected components and extreme points
   exactly), with median CUDA-event times of both;
4. main path — 16 rendered 1020x768 frames of a 24-tag room through the
   engine (detect_decoded in batches of 8 -> add_detections -> solve ->
   save_map); every kernel must have launched, every rendered tag of side
   >= 40 px must be found with its true id, no foreign id may appear, the
   map's rmse must be < 1 px, and map.yaml must reload through the fast
   parser with the same tags;
5. solver  — the 500-tag / 200-capture synthetic in float32: final cost
   within 1e-3 relative of the float64 optimum 3771.57, and LM
   iterations/s from two iteration budgets.

Then the kernel table as one JSON line, and last
{"ok": true, "device": {...}}.  Uses no jax, PIL, cv2 or yaml.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
F64_OPTIMUM_500 = 3771.57  # BASELINE.md, CPU float64 solve of the same map
DEVICE = "cuda"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def _planes(imgs, windows=(3, 13, 23)):
    """The main path's decimated binary planes of a batch of frames."""
    import torch

    from ar_slam_tpu_torch.detect import box

    b = torch.cat([imgs < box.box_sum_plain(imgs, w) / float(w * w) - 7.0
                   for w in windows])
    n, h, w = b.shape
    return (b.reshape(n, h // 2, 2, w // 2, 2).to(torch.int32).sum((2, 4))
            >= 2).contiguous()


def _serpentine(h, w, seed=1):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), bool)
    for i, y in enumerate(range(4, h - 8, 6)):
        img[y, 4:w - 4] = True
        img[y:y + 7, (w - 6) if i % 2 == 0 else 4] = True
    noise = rng.random((h, w)) < 0.45
    return np.stack([img, noise])


def phase_kernels(frames):
    import torch

    from ar_slam_tpu_torch.detect import box, ccl, extract
    from ar_slam_tpu_torch.detect.detect import _gradient, top_k_subsampled

    dev = torch.device(DEVICE)
    imgs = torch.from_numpy(frames[:8]).to(dev, torch.float32).contiguous()
    n, h, w = imgs.shape
    rows = []

    # K1: thresholds at 3/13/23, refine fields at 11
    gy, gx = _gradient(imgs, 1), _gradient(imgs, 2)
    x = torch.arange(w, device=dev, dtype=torch.float32)
    y = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    fields = torch.stack([gx * gx, gx * gy, gy * gy, gx * gx * x + gx * gy * y,
                          gx * gy * x + gy * gy * y], 1).reshape(n * 5, h, w)
    k1_err = 0.0
    for win, inp in ((3, imgs), (13, imgs), (23, imgs),
                     (11, fields.contiguous())):
        got = box.box_sum_batch(inp, win)
        ref = box.box_sum_plain(inp.double(), win)
        plain = box.box_sum_plain(inp, win)
        torch.cuda.synchronize()
        # float32 sums of win^2 taps: error <= ~win^2 * 2^-24 * max|ref|;
        # stated bound 1e-5 * max|ref| (both kernel and plain version)
        tol = 1e-5 * ref.abs().max().item()
        err = (got.double() - ref).abs().max().item()
        perr = (plain.double() - ref).abs().max().item()
        if not (err <= tol and perr <= tol):
            fail(f"K1 win {win}: error {err} (plain {perr}) > {tol}")
        if win == 23:
            k1_err = err
        emit("kernel_check", kernel="box", win=win, shape=list(inp.shape),
             max_abs_err=err, plain_max_abs_err=perr, tolerance=tol)
    rows.append({
        "name": "box_sum (K1)", "route": "cuda",
        "source": "ar_slam_tpu_torch/csrc/box.cu",
        "replaces": "ar_slam_tpu/detect/pallas_box.py:35",
        "max_abs_err": k1_err, "tolerance": "1e-5 * max|f64 sum|",
        "ms": cuda_ms(lambda: box.box_sum_batch(imgs, 23)),
        "plain_ms": cuda_ms(lambda: box.box_sum_plain(imgs, 23)),
        "shape": [n, h, w], "win": 23})

    # K2: the 24 stacked decimated planes + a serpentine/noise pair
    planes = _planes(imgs)
    got = ccl.connected_components_batch(planes)
    plain = ccl.connected_components_plain(planes)
    extra = torch.from_numpy(_serpentine(*planes.shape[1:])).to(dev)
    got_x = ccl.connected_components_batch(extra.contiguous())
    plain_x = ccl.connected_components_plain(extra)
    torch.cuda.synchronize()
    if not (torch.equal(got, plain) and torch.equal(got_x, plain_x)):
        fail("K2 labels differ from the plain version")
    emit("kernel_check", kernel="ccl", shape=list(planes.shape),
         exact=True, components=int((got == torch.arange(
             got[0].numel(), device=dev).reshape(got.shape[1:])).sum()))
    rows.append({
        "name": "connected_components (K2)", "route": "cuda",
        "source": "ar_slam_tpu_torch/csrc/ccl.cu",
        "replaces": "ar_slam_tpu/detect/pallas_ccl.py:197",
        "max_abs_err": float(max((got - plain).abs().max(),
                                 (got_x - plain_x).abs().max())),
        "ms": cuda_ms(lambda: ccl.connected_components_batch(planes)),
        "plain_ms": cuda_ms(lambda: ccl.connected_components_plain(planes),
                            reps=3, warm=1),
        "shape": list(planes.shape)})

    # K4: top-64 roots of those labels
    roots, _ = top_k_subsampled(got, 64, 2, 0.25)
    q = extract.extreme_quads(got, roots)
    qp = extract.extreme_quads_plain(got, roots)
    torch.cuda.synchronize()
    hd, wd = got.shape[1:]
    lin = torch.arange(hd * wd, device=dev)
    exact = torch.zeros(roots.shape, dtype=torch.bool, device=dev)
    for i in range(got.shape[0]):
        member = got[i].reshape(1, -1) == roots[i][:, None]
        sx = torch.where(member, lin % wd, 0).sum(1)
        sy = torch.where(member, lin // wd, 0).sum(1)
        exact[i] = (sx < 2**24) & (sy < 2**24)
    if not torch.equal(q[exact], qp[exact]):
        fail("K4 quads differ from the plain version")
    emit("kernel_check", kernel="extract", shape=list(roots.shape),
         exact_slots=int(exact.sum()), slots=int(exact.numel()),
         max_abs_err_all=float((q - qp).abs().max()))
    rows.append({
        "name": "extreme_quads (K4)", "route": "cuda",
        "source": "ar_slam_tpu_torch/csrc/extract.cu",
        "replaces": "ar_slam_tpu/detect/pallas_extract.py:41",
        "max_abs_err": float((q[exact] - qp[exact]).abs().max()),
        "ms": cuda_ms(lambda: extract.extreme_quads(got, roots)),
        "plain_ms": cuda_ms(lambda: extract.extreme_quads_plain(got, roots),
                            reps=3, warm=1),
        "shape": list(roots.shape)})
    return rows


def phase_main_path(frames, truth):
    import torch

    from ar_slam_tpu_torch.detect import box, ccl, extract
    from ar_slam_tpu_torch.graph import yamlio
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
    from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture

    caps = [IngestedCapture(f"frame{k:02d}", f"frame{k:02d}.png", frames[k])
            for k in range(len(frames))]
    batches = [caps[i:i + 8] for i in range(0, len(caps), 8)]
    ArSlamEngine(device=DEVICE).detect_decoded(batches[0])  # warm-up

    for mod in (box, ccl, extract):
        mod.launches = 0
    engine = ArSlamEngine(device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    detected = [d for b in batches for d in engine.detect_decoded(b)]
    t_detect = time.perf_counter() - t0
    for uid, by_dict, size, path in detected:
        engine.store.add_detections(
            uid, [d for dets in by_dict.values() for d in dets], size, path)
    t0 = time.perf_counter()
    summary = engine.solve()
    t_solve = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    map_path = os.path.join(OUT_DIR, "map.yaml")
    engine.save_map(map_path)
    launches = {"box": box.launches, "ccl": ccl.launches,
                "extract": extract.launches}

    if min(launches.values()) <= 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    missing, foreign, n_req = [], [], 0
    for (uid, by_dict, _, _), seen in zip(detected, truth["frames"]):
        got = {tid for dets in by_dict.values() for tid, _ in dets}
        present = {f"aruco_{n}_{m}" for n, m, _, _ in seen}
        for n, m, _, side in seen:
            if side >= 40.0:
                n_req += 1
                if f"aruco_{n}_{m}" not in got:
                    missing.append((uid, f"aruco_{n}_{m}"))
        foreign += [(uid, t) for t in sorted(got - present)]
    if missing or foreign:
        fail(f"detection: missing {missing}, foreign {foreign}")
    rmse = summary.get("rmse", float("nan"))
    if not (np.isfinite(rmse) and rmse < 1.0):
        fail(f"map rmse {rmse} px is not < 1")
    with open(map_path) as f:
        parsed = yamlio._fast_parse(f.read())
    if sorted(parsed["tag_ids"]) != sorted(t.id for t in engine.store.arucos):
        fail("map.yaml tags differ after reload")
    emit("main_path", frames=len(frames), launches=launches,
         tags_required=n_req, tags_in_map=len(parsed["tag_ids"]),
         blocks=len(engine.store.blocks), waves=summary.get("waves"),
         rmse_px=rmse, focal=float(engine.store.camera.params[0]),
         detect_seconds=t_detect,
         detect_frames_per_s=len(frames) / t_detect, solve_seconds=t_solve)
    return launches


def phase_solver():
    import torch

    from ar_slam_tpu_torch.convert import arrays_from_numpy
    from ar_slam_tpu_torch.graph.arrays import export_arrays
    from ar_slam_tpu_torch.solve.lm import LMConfig, lm_solve
    from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map

    t0 = time.perf_counter()
    store, truth = make_synthetic_map(n_tags=500, n_caps=200, seed=0,
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
    gen_s = time.perf_counter() - t0
    counts = np.bincount(arrs.tag_idx[arrs.block_mask])
    ccounts = np.bincount(arrs.cap_idx[arrs.block_mask])
    config = LMConfig(max_iterations=32, function_tolerance=0.0,
                      parameter_tolerance=0.0)

    def run(n):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = lm_solve(
            t["camera"], t["cap_poses"], t["tag_poses"], t["cap_idx"],
            t["tag_idx"], t["corners"], t["block_mask"], True,
            t["cap_mask"], t["tag_mask"], aruco_size=0.0635, config=config,
            iter_budget=n, obs_per_tag=-(-int(counts.max()) // 8) * 8,
            obs_per_cap=-(-int(ccounts.max()) // 8) * 8)
        cost = float(out[3]["cost"])
        return time.perf_counter() - t1, out[3]["iterations"], cost

    run(2)  # warm-up
    t_lo, it_lo, _ = run(8)
    t_hi, it_hi, cost = run(32)
    rel = abs(cost - F64_OPTIMUM_500) / F64_OPTIMUM_500
    rate = (it_hi - it_lo) / max(t_hi - t_lo, 1e-9)
    emit("solver", tags=arrs.n_tags, captures=arrs.n_caps,
         blocks=arrs.n_blocks, dtype="float32", final_cost=cost,
         f64_optimum=F64_OPTIMUM_500, rel_err=rel, iterations=it_hi,
         lm_iterations_per_s=rate, seconds_32=t_hi, problem_gen_s=gen_s)
    if not rel <= 1e-3:
        fail(f"500-tag final cost {cost} is not within 1e-3 of "
             f"{F64_OPTIMUM_500}")


def main() -> int:
    import torch

    from ar_slam_tpu_torch.utils.render import room_scene

    phase_device()
    phase_build()
    frames, truth = room_scene(n_frames=16)
    rows = phase_kernels(frames)
    launches = phase_main_path(frames, truth)
    phase_solver()
    for row, key in zip(rows, ("box", "ccl", "extract")):
        row["launches"] = launches[key]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
