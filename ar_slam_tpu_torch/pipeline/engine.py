"""The mapping engine (trimmed port of ar_slam_tpu/pipeline/engine.py).

≙ the batch flow of the reference's ar_slam_cli: ingest images, detect
markers on the device, add each capture's detections to the constraint
graph, solve, save map.yaml.  The event log, snapshots, artifact export and
localization of the reference engine are not ported yet.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict

import numpy as np

from ar_slam_tpu_torch.config import ArSlamConfig
from ar_slam_tpu_torch.device import resolve_device, resolve_dtype
from ar_slam_tpu_torch.graph.store import MapStore
from ar_slam_tpu_torch.graph.yamlio import load_yaml, save_yaml
from ar_slam_tpu_torch.pipeline.ingest import ImageIngest

logger = logging.getLogger(__name__)


class Metrics:
    """Accumulating counters + stage timings (utils/metrics.Metrics)."""

    def __init__(self):
        self.counters: dict[str, float] = defaultdict(float)
        self.timings: dict[str, list[float]] = defaultdict(list)

    def count(self, name: str, value: float = 1.0):
        self.counters[name] += value

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        out = dict(self.counters)
        for name, vals in self.timings.items():
            out[f"{name}_s"] = round(sum(vals), 4)
            out[f"{name}_calls"] = len(vals)
        return out


class ArSlamEngine:
    """Batch mapping engine with the batched device detector.

    ``device`` (default: the card when present) runs detection and the
    solve; ``dtype`` (default: config.solver.dtype) is the solver's
    working precision.
    """

    def __init__(self, config: ArSlamConfig | None = None, device=None,
                 dtype=None):
        self.config = config or ArSlamConfig()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype if dtype is not None
                                   else self.config.solver.dtype)
        self.store = MapStore(initial_focal=self.config.camera.initial_focal)
        self.ingest = ImageIngest()
        self.metrics = Metrics()

    def load_map(self, path: str):
        load_yaml(self.store, path)
        logger.info("loaded map %s: %s", path, self.store.stats())

    def detect_images(self, paths: list[str]) -> list[tuple[str, list, tuple,
                                                             str]]:
        """Ingest + detect a batch of images.

        Returns [(uid, [(tag_id, centered_corners(4,2)), ...], (w, h),
        path)]."""
        with self.metrics.timer("ingest"):
            caps = self.ingest.ingest_many(paths)
        return [
            (uid, [d for dets in by_dict.values() for d in dets], size, path)
            for uid, by_dict, size, path in self.detect_decoded(caps)
        ]

    def detect_decoded(self, caps) -> list[tuple[str, dict, tuple, str]]:
        """Detect over already-ingested captures (objects with ``uid``,
        ``path`` and a (H, W) uint8 ``image``), keeping each dictionary's
        detections apart.

        Returns [(uid, {"aruco_<dict>": [(tag_id, corners), ...]}, (w, h),
        path)]."""
        if not caps:
            return []
        images = np.stack([c.image for c in caps])
        h, w = images.shape[1:]
        dict_names = tuple(self.config.detect.dictionaries)
        max_side = self.config.detect.max_side
        scale = 1.0
        det_images = images
        if max_side and max(h, w) > max_side:
            scale = max_side / max(h, w)
            from PIL import Image as _Image

            det_images = np.stack([
                np.asarray(_Image.fromarray(img).resize(
                    (int(round(w * scale)), int(round(h * scale))),
                    _Image.BILINEAR)) for img in images])
            logger.info("detection at %dx%d (scale %.3f) for %dx%d input",
                        det_images.shape[2], det_images.shape[1], scale, w, h)
        with self.metrics.timer("detect"):
            per_image = self._run_detector(det_images, dict_names)
        if scale != 1.0:
            per_image = [
                {dt: [(tid, corners / scale) for tid, corners in dets]
                 for dt, dets in by_dict.items()}
                for by_dict in per_image
            ]
        self.metrics.count("images_detected", len(caps))
        self.metrics.count(
            "detections", sum(len(d) for bd in per_image for d in bd.values()))
        out = []
        for i, cap in enumerate(caps):
            by_dict = per_image[i]
            n_det = sum(len(d) for d in by_dict.values())
            if n_det <= 2:
                logger.warning("not enough AR tags detected in %s (%d)",
                               cap.path, n_det)
            out.append((cap.uid, by_dict, (w, h), cap.path))
        return out

    def _run_detector(self, images, dict_names):
        """One dict per image: {"aruco_<dict>": [(tag_id, centered
        corners), ...]}, from detect.detect_batch on the engine's device."""
        from ar_slam_tpu_torch.detect.detect import DetectParams, detect_batch

        h, w = images.shape[1:]
        center = np.array([w / 2.0, h / 2.0])
        dcfg = self.config.detect
        params = DetectParams(
            win=dcfg.adaptive_thresh_win_sizes[0],
            win_sizes=tuple(dcfg.adaptive_thresh_win_sizes),
            thresh_c=dcfg.adaptive_thresh_constant,
            max_candidates=dcfg.max_candidates,
            min_corner_distance_rate=dcfg.min_corner_distance_rate,
            min_perimeter_rate=dcfg.min_marker_perimeter_rate,
            max_perimeter_rate=dcfg.max_marker_perimeter_rate,
        )
        out = detect_batch(images, params=params, dict_names=dict_names,
                           device=self.device)
        per_image = [{f"aruco_{n}": [] for n in dict_names}
                     for _ in range(len(images))]
        for name in dict_names:
            ids = out[name]["ids"].cpu().numpy()
            corners = out[name]["corners"].cpu().numpy()
            valid = out[name]["valid"].cpu().numpy()
            for i in range(len(per_image)):
                for k in np.nonzero(valid[i])[0]:
                    per_image[i][f"aruco_{name}"].append(
                        (f"aruco_{name}_{int(ids[i][k])}",
                         corners[i][k] - center))
        return per_image

    def add_images(self, paths: list[str]) -> list[int]:
        """Detect + add captures to the graph (unsolved pool)."""
        added = []
        for uid, dets, size, path in self.detect_images(paths):
            idx = self.store.add_detections(uid, dets, size, path)
            if idx is not None:
                added.append(idx)
        return added

    def solve(self) -> dict:
        """Batch BFS solve (≙ ar_slam_cli)."""
        from ar_slam_tpu_torch.solve.batch import solve

        with self.metrics.timer("solve"):
            out = solve(self.store, self.config, dtype=self.dtype,
                        device=self.device)
        self.metrics.count("captures_solved", out.get("waves", 0))
        return out

    def save_map(self, path: str):
        save_yaml(self.store, path)
        logger.info("saved map to %s", path)

    def print_cameras(self):
        p = self.store.camera.params
        print(f"\tf={p[0]}\tl1={p[1]}\tl1={p[2]}")
