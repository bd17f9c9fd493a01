# Copied from ar_slam_tpu/pipeline/messages.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Wire-schema dataclasses mirroring the reference message IDL
(ar_slam_interfaces): the pipeline's stage contract and the event-log record
shapes.  (The reference also declares a ``MakeMap`` service that no node
implements — ar_slam_interfaces/CMakeLists.txt:21; intentionally absent.)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class CaptureMsg:
    """≙ ar_slam_interfaces/msg/Capture: one camera image entering the
    pipeline."""

    uid: str
    image_path: str = ""
    image: np.ndarray | None = None  # (H, W) grayscale


@dataclass
class DetectionMsg:
    """≙ msg/Detection: one detected tag — 4 corners (centered coords) + the
    string id ``aruco_<dict>_<n>``."""

    id: str
    corners: np.ndarray = field(default_factory=lambda: np.zeros((4, 2)))


@dataclass
class DetectionsMsg:
    """≙ msg/Detections: all detections of one detector pass over one
    capture (merged messages carry the union + the image)."""

    capture_uid: str
    image_width: int = 0
    image_height: int = 0
    image_path: str = ""
    image: np.ndarray | None = None
    detector_types: list[str] = field(default_factory=list)
    detections: list[DetectionMsg] = field(default_factory=list)


@dataclass
class LoadImagesRequest:
    """≙ srv/LoadImages request: filename list for the ingest stage."""

    img_fns: list[str] = field(default_factory=list)


@dataclass
class LoadImagesResponse:
    success: bool = True
    message: str = ""
