"""The mapping engine (port of ar_slam_tpu/pipeline/engine.py).

≙ the ArSlam node (ar_slam.cpp): consume merged detections, run incremental
BA, export transforms/camera-info/markers, save the map on shutdown
(ar_slam.cpp:103-111).  Plus the batch flows of the CLIs (ar_slam_cli.cpp,
ar_loc.cpp) and the event-log recorder (≙ BagRecorder, bag_recorder.cpp —
jsonl instead of a rosbag).  Detection and the solves run on the engine's
device (the card unless the caller names the CPU).
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np

from ar_slam_tpu_torch.config import ArSlamConfig
from ar_slam_tpu_torch.device import resolve_device, resolve_dtype
from ar_slam_tpu_torch.graph.store import MapStore
from ar_slam_tpu_torch.graph.yamlio import load_yaml, save_yaml
from ar_slam_tpu_torch.pipeline.ingest import ImageIngest
from ar_slam_tpu_torch.utils.metrics import TRACE, Metrics, profile_trace

logger = logging.getLogger(__name__)


def _encode_png_b64(image) -> str:
    """Grayscale (H, W) uint8 -> base64 PNG string (hermetic log record)."""
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image, mode="L").save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def decode_png_b64(data: str):
    """Inverse of _encode_png_b64 (used by ``arslam-torch replay``)."""
    import base64
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(data)))
                      .convert("L"))


class EventLog:
    """Append-only jsonl event recorder (≙ BagRecorder's /tmp/ar_slam.bag):
    captures and merged detections, replayable into a new engine."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def record(self, kind: str, **payload):
        rec = {"t": time.time(), "kind": kind, **payload}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    @staticmethod
    def replay(path: str):
        with open(path) as f:
            for line in f:
                if line.strip():
                    yield json.loads(line)


class ArSlamEngine:
    """Incremental mapping engine with the batched device detector.

    ``device`` (default: the card; without one only ``"cpu"`` runs) runs
    detection and the solves; ``dtype`` (default: config.solver.dtype) is
    the solver's working precision.  ``detect_mesh`` (parallel.detect.
    image_mesh) splits each detection batch over its devices;
    ``use_device_detector=False`` detects with the NumPy oracle
    (detect/reference.py) on the host instead, when the caller asks for it
    (``--cpu-detector``).
    """

    def __init__(self, config: ArSlamConfig | None = None, device=None,
                 dtype=None, detect_mesh=None, use_device_detector=True):
        self.config = config or ArSlamConfig()
        self.device = resolve_device(device)
        self.detect_mesh = detect_mesh
        self.use_device_detector = use_device_detector
        self.dtype = resolve_dtype(dtype if dtype is not None
                                   else self.config.solver.dtype)
        self.store = MapStore(initial_focal=self.config.camera.initial_focal)
        self.ingest = ImageIngest()
        self.metrics = Metrics()
        self.event_log = None
        if self.config.pipeline.event_log_path:
            self.event_log = EventLog(self.config.pipeline.event_log_path)

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
        from ar_slam_tpu_torch.detect.detect import batch_shape

        # engine.stack: the list of the photos' own arrays, its shape check
        # and the resize where max_side asks; the detector copies each
        # photo into its program's buffer, so no stacked host copy is made
        with TRACE.span("engine.stack"):
            images = [c.image for c in caps]
            h, w = batch_shape(images)[0][1:]
            dict_names = tuple(self.config.detect.dictionaries)
            max_side = self.config.detect.max_side
            scale = 1.0
            det_images = images
            if max_side and max(h, w) > max_side:
                scale = max_side / max(h, w)
                from PIL import Image as _Image

                size = (int(round(w * scale)), int(round(h * scale)))
                det_images = [np.asarray(_Image.fromarray(img).resize(
                    size, _Image.BILINEAR)) for img in images]
                logger.info("detection at %dx%d (scale %.3f) for %dx%d "
                            "input", *size, scale, w, h)
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
            flat = [d for dets in by_dict.values() for d in dets]
            if len(flat) <= 2:
                logger.warning("not enough AR tags detected in %s (%d)",
                               cap.path, len(flat))
            out.append((cap.uid, by_dict, (w, h), cap.path))
            if self.event_log:
                # ≙ BagRecorder's captures stream (bag_recorder.cpp:73-83):
                # the capture (its pixels too with event_log_embed_images,
                # replayable without the originals), then its detections
                extra = {}
                if self.config.pipeline.event_log_embed_images:
                    extra["image_png"] = _encode_png_b64(cap.image)
                self.event_log.record("capture", uid=cap.uid, path=cap.path,
                                      width=w, height=h, **extra)
                self.event_log.record(
                    "detections", uid=cap.uid, path=cap.path, width=w,
                    height=h, detections=[
                        {"id": tid, "corners": c.reshape(-1).tolist()}
                        for tid, c in flat])
        return out

    def detect_params(self):
        """The device detector's DetectParams, from the config's detect
        section (as the JAX engine builds them)."""
        from ar_slam_tpu_torch.detect.detect import DetectParams

        dcfg = self.config.detect
        return DetectParams(
            win=dcfg.adaptive_thresh_win_sizes[0],
            win_sizes=tuple(dcfg.adaptive_thresh_win_sizes),
            thresh_c=dcfg.adaptive_thresh_constant,
            max_candidates=dcfg.max_candidates,
            min_corner_distance_rate=dcfg.min_corner_distance_rate,
            min_perimeter_rate=dcfg.min_marker_perimeter_rate,
            max_perimeter_rate=dcfg.max_marker_perimeter_rate,
        )

    def _run_detector(self, images, dict_names):
        """One dict per image of ``images`` (a sequence of (H, W) arrays of
        one shape): {"aruco_<dict>": [(tag_id, centered corners), ...]},
        from detect.detect_batch on the engine's device (split over
        ``detect_mesh`` when set), or from the NumPy oracle.  Traced, a
        single-device call on K2's planes also counts their rounds
        (``ccl.trace_fused_rounds``)."""
        from ar_slam_tpu_torch.detect import ccl
        from ar_slam_tpu_torch.detect.detect import (detect_batch,
                                                     uses_fused_ccl)

        h, w = np.shape(images[0])
        center = np.array([w / 2.0, h / 2.0])
        per_image = [{f"aruco_{n}": [] for n in dict_names}
                     for _ in range(len(images))]
        TRACE.count("detect.photos", len(images))
        if not self.use_device_detector:
            from ar_slam_tpu_torch.detect.reference import detect_markers

            for i, img in enumerate(images):
                for d in detect_markers(img, dict_names=dict_names):
                    # d.id = "aruco_<dict>_<n>" -> detector stream key
                    det_type = d.id.rsplit("_", 1)[0]
                    per_image[i].setdefault(det_type, []).append(
                        (d.id, d.corners - center))
            return per_image
        params = self.detect_params()
        # the detector pads the batch to a power-of-two bucket with zero
        # frames (whose detections are dropped): each batch shape is a
        # program of its own (a CUDA graph's capture on the card), and a
        # serve loop sees arbitrary sizes
        n = len(images)
        n_pad = 1 << (n - 1).bit_length()
        if self.detect_mesh is not None:
            from ar_slam_tpu_torch.parallel.detect import detect_batch_sharded

            out = detect_batch_sharded(images, mesh=self.detect_mesh,
                                       params=params, dict_names=dict_names,
                                       pad_to=n_pad)
        else:
            out = detect_batch(images, params=params, dict_names=dict_names,
                               device=self.device, pad_to=n_pad)
        reads = {name: [TRACE.wait("detect.out", out[name][key][:n].cpu)
                        for key in ("ids", "corners", "valid")]
                 for name in dict_names}
        if (TRACE.on and self.detect_mesh is None
                and uses_fused_ccl(h, w, params)):
            # K2's rounds of the real photos' planes, once the outputs are
            # on the host (a mesh's shards are not counted)
            ccl.trace_fused_rounds(n, n_pad)
        with TRACE.span("engine.unpack"):
            for name, read in reads.items():
                ids, corners, valid = (r.numpy() for r in read)
                for i in range(len(per_image)):
                    for k in np.nonzero(valid[i])[0]:
                        per_image[i][f"aruco_{name}"].append(
                            (f"aruco_{name}_{int(ids[i][k])}",
                             corners[i][k] - center))
        return per_image

    def add_images(self, paths: list[str]) -> list[int]:
        """Detect + add captures to the graph (unsolved pool)."""
        with self.metrics.timer("ingest"):
            caps = self.ingest.ingest_many(paths)
        return self.add_decoded(caps)

    def add_decoded(self, caps) -> list[int]:
        """``add_images`` over already-ingested captures (see
        ``detect_decoded``).  Returns the indices of the captures added."""
        with profile_trace(self.config.pipeline.profile_trace_dir):
            added = []
            for uid, by_dict, size, path in self.detect_decoded(caps):
                with TRACE.span("store.add"):
                    idx = self.store.add_detections(
                        uid, [d for dets in by_dict.values() for d in dets],
                        size, path)
                if idx is not None:
                    added.append(idx)
            return added

    def localize(self, paths: list[str]) -> dict:
        """Localize new images against the frozen current map (≙ ar_loc)."""
        with self.metrics.timer("ingest"):
            caps = self.ingest.ingest_many(paths)
        return self.localize_decoded(caps)

    def localize_decoded(self, caps) -> dict:
        """``localize`` over already-ingested captures."""
        from ar_slam_tpu_torch.solve.localize import localize_many

        with profile_trace(self.config.pipeline.profile_trace_dir):
            first = self.store.next_capture_index
            self.add_decoded(caps)
            with self.metrics.timer("localize"):
                out = localize_many(self.store, first, self.config,
                                    dtype=self.dtype, device=self.device)
        self.metrics.count("captures_localized", out.get("localized", 0))
        return out

    def solve(self) -> dict:
        """Batch BFS solve (≙ ar_slam_cli)."""
        from ar_slam_tpu_torch.solve.batch import solve

        return self._solve("solve", solve)

    def solve_incremental(self) -> dict:
        """Incremental solve (≙ ArSlam::detection_callback path)."""
        from ar_slam_tpu_torch.solve.batch import solve_incremental

        return self._solve("solve_incremental", solve_incremental)

    def _solve(self, name: str, fn) -> dict:
        with self.metrics.timer(name), \
                profile_trace(self.config.pipeline.profile_trace_dir):
            out = fn(self.store, self.config, dtype=self.dtype,
                     device=self.device)
        self.metrics.count("waves_solved", out.get("waves", 0))
        self._maybe_snapshot()
        return out

    def _maybe_snapshot(self):
        """Periodic durable checkpoint during long solves (the map.yaml is
        the checkpoint format, SURVEY.md §5.4)."""
        p = self.config.pipeline
        if not p.output_map_fn or p.snapshot_every_s <= 0:
            return
        now = time.time()
        last = getattr(self, "_last_snapshot", 0.0)
        if now - last >= p.snapshot_every_s:
            self._last_snapshot = now
            self.save_map(p.output_map_fn)

    def save_map(self, path: str):
        save_yaml(self.store, path)
        logger.info("saved map to %s", path)

    def print_cameras(self):
        p = self.store.camera.params
        print(f"\tf={p[0]}\tl1={p[1]}\tl1={p[2]}")

    def export_artifacts(self) -> dict:
        from ar_slam_tpu_torch.viz.export import (camera_info, marker_array,
                                                  transforms)

        return {
            "transforms": transforms(self.store),
            "camera_info": camera_info(self.store),
            "markers": marker_array(self.store, self.config.aruco_size),
        }

    def close(self):
        if self.event_log:
            self.event_log.close()
