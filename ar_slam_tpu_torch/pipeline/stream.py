# Copied from ar_slam_tpu/pipeline/stream.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Pipelined (overlapping) streaming mode: ingest → detect → merge → solve.

≙ the reference's multithreaded component container: all five components
share one process and overlap via intra-process handoff
(ar_slam_launch.py:124-142, README.md:104-107 "component_container_mt ...
callbacks can run in parallel").  The TPU-native equivalent is a 3-stage
host pipeline around the batched device kernels:

  ingest thread : decode batch N+2 on a thread pool  (host, GIL-released)
  detect thread : device detection of batch N+1      (TPU/CPU device)
  caller thread : merge + incremental solve of batch N  (device + host)

Stages hand off through depth-2 (double-buffered) queues, so decode and
detection of later batches overlap the solve of earlier ones.  The
MergeDetections join stage is driven exactly like the reference graph:
the detect stage emits one ``add_detections`` per dictionary (the fused
kernel decodes all dictionaries in one pass, but each dictionary's stream
reaches the merge separately, ≙ the two ArucoDetector components) plus an
``add_capture`` (the raw-image stream), and only the merge's ``on_merged``
callback feeds the solver.
"""

from __future__ import annotations

import logging
import queue
import threading
import time

import numpy as np

logger = logging.getLogger(__name__)

_SENTINEL = object()


class StageTimeline:
    """Per-stage activity intervals, for overlap verification/metrics."""

    def __init__(self):
        self.intervals: dict[str, list[tuple[float, float]]] = {}
        self._lock = threading.Lock()

    def record(self, stage: str, t0: float, t1: float):
        with self._lock:
            self.intervals.setdefault(stage, []).append((t0, t1))

    def overlap_s(self, a: str, b: str) -> float:
        """Total wall time during which stage a and stage b ran
        concurrently."""
        total = 0.0
        for a0, a1 in self.intervals.get(a, ()):
            for b0, b1 in self.intervals.get(b, ()):
                total += max(0.0, min(a1, b1) - max(a0, b0))
        return total


class StreamPipeline:
    """Drive an ArSlamEngine through the overlapped stage pipeline.

    Usage:
        pipe = StreamPipeline(engine)
        pipe.submit(paths)          # any number of times; applies
                                    # backpressure when the depth-2 decode
                                    # queue is full
        stats = pipe.drain()        # run solves until all batches done
    The solve stage runs on the CALLER's thread (inside submit/drain) so
    engine.store mutation and map saving stay single-threaded, like the
    reference's mutually-exclusive callback group on the ArSlam node.
    """

    def __init__(self, engine, batch_size: int | None = None,
                 on_solve=None):
        self.engine = engine
        cfg = engine.config.pipeline
        self.batch_size = batch_size or max(int(cfg.batch_size), 1)
        # ingest pacing ≙ ImageLoader's one-image-per-pub_period timer
        # (image_loader.cpp:92-102); 0 = unthrottled
        self.pub_period = max(float(getattr(cfg, "pub_period", 0.0)), 0.0)
        self._release_at = time.time()
        self.on_solve = on_solve or (lambda summary, uids: None)
        self.merge = _make_merge(engine)
        self.timeline = StageTimeline()
        # depth-2 queues = double buffering: each stage can hold one batch
        # in flight while the next is prepared
        self._decode_q: queue.Queue = queue.Queue(maxsize=2)
        self._detect_q: queue.Queue = queue.Queue(maxsize=2)
        self._merged: queue.Queue = queue.Queue()
        self._inflight = 0
        self._lock = threading.Lock()
        self._errors: list[BaseException] = []
        self._ingest_t = threading.Thread(target=self._ingest_loop,
                                          daemon=True)
        self._detect_t = threading.Thread(target=self._detect_loop,
                                          daemon=True)
        self._ingest_t.start()
        self._detect_t.start()
        self._closed = False

    # ---- producer side ---------------------------------------------------

    def submit(self, paths: list[str]):
        """Queue image paths (split into detector-sized batches) and run
        any already-merged batches through the solver while ingest/detect
        of later batches proceed in the background."""
        paths = list(paths)
        for i in range(0, len(paths), self.batch_size):
            chunk = paths[i:i + self.batch_size]
            with self._lock:
                self._inflight += 1
            self._decode_q.put(chunk)
            self._solve_ready(block=False)

    # ---- worker stages ---------------------------------------------------

    def _ingest_loop(self):
        while True:
            chunk = self._decode_q.get()
            if chunk is _SENTINEL:
                self._detect_q.put(_SENTINEL)
                return
            t0 = time.time()
            try:
                caps = self.engine.ingest.ingest_many(chunk)
            except BaseException as e:  # noqa: BLE001
                self._errors.append(e)
                caps = []
            if self.pub_period > 0 and caps:
                # one image per pub_period tick: the batch of k images is
                # released k ticks after the previous one
                now = time.time()
                wait = self._release_at - now
                if wait > 0:
                    time.sleep(wait)
                self._release_at = (max(self._release_at, now)
                                    + len(caps) * self.pub_period)
            self.timeline.record("ingest", t0, time.time())
            self._detect_q.put(caps)

    def _detect_loop(self):
        while True:
            caps = self._detect_q.get()
            if caps is _SENTINEL:
                return
            t0 = time.time()
            try:
                per_image = (self.engine.detect_decoded(caps)
                             if caps else [])
            except BaseException as e:  # noqa: BLE001
                self._errors.append(e)
                per_image = []
            self.timeline.record("detect", t0, time.time())
            # drive the merge stage exactly like the reference graph: the
            # image/capture stream and one detections stream per detector
            batch_uids = []
            for uid, by_dict, size, path in per_image:
                batch_uids.append(uid)
                self.merge.add_capture(uid, True, size, path)
                for det_type in self.merge.expected:
                    self.merge.add_detections(
                        uid, det_type, by_dict.get(det_type, []), size)
            self._merged.put(batch_uids)

    # ---- consumer side (caller thread) -----------------------------------

    def _solve_batch(self, uids) -> dict | None:
        t0 = time.time()
        added = 0
        for uid in uids:
            rec = self.merge.take(uid)
            if rec is None:
                continue  # dropped by the bounded merge queue / zero dets
            idx = self.engine.store.add_detections(
                rec["uid"], rec["detections"], rec["image_size"],
                rec["image_path"])
            if idx is not None:
                added += 1
        out = self.engine.solve_incremental() if added else None
        if out is not None:
            self.on_solve(out, uids)
        self.timeline.record("solve", t0, time.time())
        with self._lock:
            self._inflight -= 1
        return out

    def _solve_ready(self, block: bool):
        """Solve every batch already merged; with ``block`` wait for at
        least one.  Returns the last solve summary (or None)."""
        last = None
        first = True
        while True:
            try:
                if first and block:
                    uids = self._merged.get(timeout=300)
                else:
                    uids = self._merged.get_nowait()
            except queue.Empty:
                if first and block and self._errors:
                    raise self._errors[0]
                break
            first = False
            last = self._solve_batch(uids) or last
        return last

    def poll(self) -> dict | None:
        """Non-blocking: solve whatever has merged so far."""
        return self._solve_ready(block=False)

    def drain(self) -> dict | None:
        """Block until every submitted batch has been merged and solved.
        Returns the last solve summary (or None if nothing solved)."""
        last = None
        while True:
            with self._lock:
                if self._inflight == 0:
                    break
            out = self._solve_ready(block=True)
            if out is not None:
                last = out
        if self._errors:
            raise self._errors[0]
        return last

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._decode_q.put(_SENTINEL)
        self._ingest_t.join(timeout=10)
        self._detect_t.join(timeout=10)


class _TakeableMerge:
    """MergeDetections wrapper that stores merged records for the solve
    stage to ``take`` in its own thread (the on_merged callback fires on
    the detect thread)."""

    def __init__(self, inner):
        self.inner = inner
        self.expected = inner.expected
        self.records: dict[str, dict] = {}
        inner.on_merged = self._on_merged
        self._lock = threading.Lock()

    def _on_merged(self, uid, merged):
        with self._lock:
            self.records[uid] = merged

    def add_capture(self, *a, **kw):
        self.inner.add_capture(*a, **kw)

    def add_detections(self, *a, **kw):
        self.inner.add_detections(*a, **kw)

    def take(self, uid: str) -> dict | None:
        with self._lock:
            return self.records.pop(uid, None)


def _make_merge(engine) -> _TakeableMerge:
    from ar_slam_tpu_torch.pipeline.merge import MergeDetections

    cfg = engine.config
    expected = tuple(
        t for t in cfg.pipeline.expected_detector_types
        if t.removeprefix("aruco_") in cfg.detect.dictionaries
    ) or tuple(f"aruco_{d}" for d in cfg.detect.dictionaries)
    return _TakeableMerge(MergeDetections(
        expected_detector_types=expected,
        include_image=cfg.pipeline.include_image,
        queue_depth=cfg.pipeline.merge_queue_depth,
    ))
