"""A full 12 MP phone frame through both detectors (CPU): the port's
strip-scan (K3) branch with its round cap against the JAX package's XLA
path, on the frame where 63.5 mm tags show a foreign id.

The frame is phone06 of chip_smoke's phone_12mp scene printed at 63.5 mm
(frames 0-6 are rendered so that the random stream, and so the pose and
noise of frame 6, are the scene's).  There both detectors decode one
mis-shaped quad of the true 5X5_100_69 as 5X5_100_84: the foreign id is
the shared detector's behaviour at this tag size, not a fault of the port,
which is why chip_smoke prints 50 mm tags.  The full frame matters: the
perimeter and side gates scale with max(h, w) and only a padded decimated
plane above 1 M px takes the K3 branch.
"""

import numpy as np
import torch

from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.pipeline.engine import ArSlamEngine as JEngine
from ar_slam_tpu_torch.config import ArSlamConfig as TConfig
from ar_slam_tpu_torch.detect import ccl
from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine as TEngine
from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture
from ar_slam_tpu_torch.utils.render import PHONE_12MP, room_scene

TAG_M = 0.0635
FOREIGN = "aruco_5X5_100_84"


def _detections(engine, cap):
    [(_, by_dict, _, _)] = engine.detect_decoded([cap])
    return {tid: c for dets in by_dict.values() for tid, c in dets}


def test_phone_frame_ids_match_jax_at_12mp(monkeypatch):
    """The same id set from both packages on the 4032x3024 frame, foreign
    id included, every rendered tag found, and the port through K3 at the
    reference's 24-round cap.  Corners agree within 1 px: the JAX CPU path
    box-filters the refine field maps through float32 prefix differences,
    the port sums windows directly (ROADMAP Queue 3), which moves refined
    corners by fractions of a pixel at this size (0.61 px at most here)."""
    frames, truth = room_scene(n_frames=7, arc=[i / 7 for i in range(7)],
                               aruco_size=TAG_M, **PHONE_12MP)
    cap = IngestedCapture("phone06", "phone06.png", frames[6])
    del frames
    strip_calls = []
    strip = ccl.connected_components_strip_batch
    monkeypatch.setattr(ccl, "connected_components_strip_batch",
                        lambda b, it: strip_calls.append(it) or strip(b, it))
    got = _detections(TEngine(TConfig(aruco_size=TAG_M), device="cpu"), cap)
    ref = _detections(JEngine(JConfig(aruco_size=TAG_M),
                              use_tpu_detector=True), cap)
    assert strip_calls == [24]
    assert set(got) == set(ref)
    assert FOREIGN in got
    assert {f"aruco_{n}_{m}" for n, m, _, _ in truth["frames"][6]} == set(
        got) - {FOREIGN}
    for tid, corners in got.items():
        assert np.abs(corners - ref[tid]).max() <= 1.0, tid
