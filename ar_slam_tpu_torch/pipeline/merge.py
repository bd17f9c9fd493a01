# Copied from ar_slam_tpu/pipeline/merge.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Merge/join stage for pipelined (streaming) detection.

≙ the MergeDetections component (merge_detections.cpp): accumulate per
capture-uid the Detections from each expected detector type (+ optionally
the raw image), publish when complete, keep a bounded queue of 3 incomplete
merges dropping the oldest with a warning (:126-138), warn-and-drop late
detections after publish (:108-112), pass-through when the expected set is
empty.

In the fused single-kernel mode both dictionaries decode in one device pass
and this stage is trivially complete per capture; it exists for pipelined
mode (separate detector stages) and for behavior parity.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


@dataclass
class _Pending:
    detections: dict = field(default_factory=dict)  # detector_type -> list
    image: object = None
    image_size: tuple | None = None
    image_path: str = ""


class MergeDetections:
    def __init__(self, expected_detector_types=("aruco_4X4_50",
                                                "aruco_5X5_100"),
                 include_image: bool = True, queue_depth: int = 3,
                 on_merged=None):
        self.expected = tuple(expected_detector_types)
        self.include_image = include_image
        self.queue_depth = queue_depth
        self.on_merged = on_merged or (lambda uid, merged: None)
        self.pending: "OrderedDict[str, _Pending]" = OrderedDict()
        self.published: set[str] = set()

    def _get(self, uid: str) -> _Pending | None:
        if uid in self.published:
            logger.warning("late data for already-published capture %s "
                           "dropped", uid)
            return None
        if uid not in self.pending:
            self.pending[uid] = _Pending()
            while len(self.pending) > self.queue_depth:
                old_uid, _ = self.pending.popitem(last=False)
                logger.warning(
                    "dropping incomplete merge for capture %s (queue > %d)",
                    old_uid, self.queue_depth,
                )
        return self.pending[uid]

    def add_capture(self, uid: str, image, image_size, image_path: str = ""):
        p = self._get(uid)
        if p is None:
            return
        p.image = image
        p.image_size = tuple(image_size)
        p.image_path = image_path
        self._maybe_publish(uid)

    def add_detections(self, uid: str, detector_type: str, detections,
                       image_size=None):
        p = self._get(uid)
        if p is None:
            return
        if detector_type in p.detections:
            logger.warning("duplicate detections from %s for %s",
                           detector_type, uid)
        p.detections[detector_type] = list(detections)
        if image_size is not None and p.image_size is None:
            p.image_size = tuple(image_size)
        self._maybe_publish(uid)

    def _has_all(self, p: _Pending) -> bool:
        if any(t not in p.detections for t in self.expected):
            return False
        if self.include_image and p.image is None:
            return False
        return True

    def _maybe_publish(self, uid: str):
        p = self.pending.get(uid)
        if p is None or not self._has_all(p):
            return
        del self.pending[uid]
        self.published.add(uid)
        merged = {
            "uid": uid,
            "detections": [d for t in self.expected for d in p.detections[t]],
            "detector_types": list(self.expected),
            "image": p.image,
            "image_size": p.image_size,
            "image_path": p.image_path,
        }
        self.on_merged(uid, merged)
