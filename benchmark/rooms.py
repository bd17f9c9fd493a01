"""What the room cells share: the configuration's scene and what the
comparison needs of it, the engine's configuration, the faults planted in
detection for the benchmark's own tests, and the comparison of the
program's detections with the render and the plain detector.

Nothing here imports the program at module level, so that the plain
detector's worker processes load NumPy and SciPy alone.
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from benchmark.reference import aruco as A
from benchmark.reference import detections as D
from benchmark.scenes import room as R


def scene_of(cfg: dict) -> R.Room:
    """The configuration's room: its layout and the photos' pixel noise
    from the configuration's seeds."""
    return R.room(cfg["layout_seed"], cfg["photos"], cfg["width"],
                  cfg["height"], cfg["focal"], cfg["aruco_size"],
                  cfg["image_noise"], noise_seed=cfg["noise_seed"])


class Truth:
    """What the comparison needs of the scene: each photo's sightings and
    the tags' and photos' poses."""

    def __init__(self, scene: R.Room, photos: list):
        self.scene = scene
        self.center = np.array([scene.width / 2.0, scene.height / 2.0])
        self.sightings = {k: R.sightings(scene, k) for k in photos}
        self.tag_pose = {D.tag_id(n, m): p for n, m, p in scene.tags}


def engine_config(cfg: dict):
    """The engine's configuration from the cell's: tag size, detection and
    solver settings."""
    from ar_slam_tpu_torch.config import (ArSlamConfig, DetectConfig,
                                          SolverConfig)

    d, s = cfg["detect"], cfg["solver"]
    return ArSlamConfig(
        aruco_size=cfg["aruco_size"],
        detect=DetectConfig(dictionaries=tuple(d["dictionaries"]),
                            adaptive_thresh_win_sizes=tuple(d["windows"]),
                            max_candidates=d["candidates"]),
        solver=SolverConfig(linear_solver=s["linear_solver"],
                            max_iterations=s["max_iterations"],
                            dtype=s["dtype"]))


DETECTION_FAULTS = ("ids", "corners")


def altered_detections(run, fault: str):
    """``ArSlamEngine._run_detector`` broken where its answer is produced,
    for the benchmark's own tests: "ids" renames each photo's first
    detection to an id no room renders, "corners" moves every detection's
    corners by one pixel."""
    def altered(*a, **k):
        out = run(*a, **k)
        for im in out:
            for name, dets in im.items():
                if fault == "corners":
                    dets[:] = [(t, c + 1.0) for t, c in dets]
                elif dets:
                    dets[0] = (name + "_999", dets[0][1])
                    break
        return out
    return altered


def _plain(scene: R.Room, k: int, detect: dict, precision: str) -> list:
    return A.detect(R.render(scene, k), tuple(detect["dictionaries"]),
                    tuple(detect["windows"]),
                    max_candidates=int(detect["candidates"]),
                    precision=precision)


def plain_detections(truth: Truth, photos: list, cfg: dict,
                     precision: str = "f32") -> dict:
    """{photo: [(tag id, corners px)]} of the plain detector, each photo
    rendered again and detected in a worker process of its own."""
    n = len(photos)
    with ProcessPoolExecutor(min(n, os.cpu_count() or 1, 8),
                             mp_context=get_context("spawn")) as pool:
        out = list(pool.map(_plain, [truth.scene] * n, photos,
                            [cfg["detect"]] * n, [precision] * n))
    return dict(zip(photos, out))


# a corner farther than this from the plain detector's is off (the two
# agree to ~3e-4 px where they agree at all)
OFF_PX = 0.01


def detection_numbers(truth: Truth, items, plain: dict,
                      min_side: float) -> dict:
    """The compared numbers of detection over ``items`` [(photo,
    [(tag id, centered corners)])]: required tags missed, foreign ids
    found, the largest corner distance to the render, and the share (%) of
    corners off the plain detector's by more than ``OFF_PX``."""
    missed, foreign, render, corners = 0, set(), [], []
    for k, dets in items:
        c = D.compare(truth.sightings[k], dets, truth.center, min_side,
                      plain[k])
        missed += c["missed"]
        foreign.update((k, t) for t in c["foreign"])
        render += c["render"]
        corners += c["corners"]
    gaps = np.asarray(corners)
    print(f"benchmark: detection: {len(render)} detections of required "
          f"tags; corners to the plain detector's: median "
          f"{np.median(gaps) if len(gaps) else 0} px, max "
          f"{gaps.max() if len(gaps) else 0} px, "
          f"{int(np.isinf(gaps).sum())} with no plain detection of their "
          f"id; to the render: median "
          f"{np.median(render) if render else 0} px; foreign ids "
          f"{sorted(foreign)}", file=sys.stderr)
    return {"missed_tags": float(missed), "foreign_ids": float(len(foreign)),
            "corner_err_px": max(render) if render else float("nan"),
            "corner_off_pct": (100.0 * float((gaps > OFF_PX).mean())
                               if len(gaps) else float("nan"))}
