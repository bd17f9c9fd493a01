# Copied from ar_slam_tpu/pipeline/ingest.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Image ingest: decode, size-gauge, uid generation.

≙ the ImageLoader component (image_loader.cpp): filename-based uids deduped
as ``name:N`` (image_loader.cpp:208-224), 90° auto-rotation of transposed
images (:135-162 via checkAndFixImageSize), uniform-size enforcement.
Decode runs on host (PIL); images batch onto the device as one tensor.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np

logger = logging.getLogger(__name__)


def filename_no_ext(path: str) -> str:
    """≙ filename_no_ext (ar_slam_util.cpp:1165-1183): basename, no ext."""
    base = os.path.basename(path)
    dot = base.rfind(".")
    return base[:dot] if dot > 0 else base


def load_image(path: str) -> np.ndarray:
    """Load an image as grayscale uint8 (H, W): native libjpeg decoder
    when built (≙ cv::imread in the reference ImageLoader), PIL otherwise
    and for non-JPEG formats."""
    from ar_slam_tpu_torch.pipeline.fast_decode import decode_gray

    img = decode_gray(path)
    if img is not None:
        return img
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"))


@dataclass
class IngestedCapture:
    uid: str
    path: str
    image: np.ndarray  # (H, W) uint8 grayscale


class ImageIngest:
    """Stateful ingest stage: uid dedup + size gauge."""

    def __init__(self):
        self.used_names: dict[str, int] = {}
        self.expected_size: tuple[int, int] | None = None  # (w, h)

    def gen_unique_name(self, path: str) -> str:
        """≙ ImageLoader::gen_unique_name: basename, deduped as name:N."""
        base = filename_no_ext(path)
        count = self.used_names.get(base)
        if count is None:
            self.used_names[base] = 0
            return base
        self.used_names[base] = count + 1
        return f"{base}:{count + 1}"

    def ingest(self, path: str, img: np.ndarray | None = None
               ) -> IngestedCapture:
        if img is None:
            img = load_image(path)
        h, w = img.shape
        if self.expected_size is None:
            self.expected_size = (w, h)
        else:
            ew, eh = self.expected_size
            if (w, h) == (eh, ew):
                logger.warning(
                    "image %s rotated relative to others; rotating 90 deg",
                    path,
                )
                img = np.rot90(img, k=-1).copy()  # clockwise like cv::ROTATE_90_CLOCKWISE
                h, w = img.shape
            if (w, h) != self.expected_size:
                raise ValueError(
                    f"Loaded images should all be same size: expected "
                    f"{self.expected_size} got {(w, h)}"
                )
        return IngestedCapture(self.gen_unique_name(path), path, img)

    def ingest_many(self, paths) -> list[IngestedCapture]:
        """Ingest a batch: decodes run on a thread pool (the native libjpeg
        call and PIL both release the GIL), the stateful uid/size-gauge
        steps stay sequential in input order."""
        paths = list(paths)
        if len(paths) <= 1:
            return [self.ingest(p) for p in paths]
        from concurrent.futures import ThreadPoolExecutor

        workers = min(len(paths), os.cpu_count() or 4)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            imgs = list(pool.map(load_image, paths))
        return [self.ingest(p, img) for p, img in zip(paths, imgs)]
