"""Headless debug-image annotation (port of ar_slam_tpu/viz/annotate.py).

≙ displayDebug (ar_slam_util.cpp:468-563) without the GUI: scale the image
to ≤800 px, draw each detected rect magenta (250, 0, 250), each projected
tag cyan, and optionally ALL map tags (undetected ones yellow) — writing a
PNG instead of cv::imshow.  The projections run on float64 CPU tensors;
the tag side is the reference's hard-coded 0.0635 m, whatever the map's
configured size (reference behaviour).
"""

from __future__ import annotations

import numpy as np
import torch

from ar_slam_tpu_torch.core.projection import project_corners
from ar_slam_tpu_torch.graph.store import MapStore

MAGENTA = (250, 0, 250)
CYAN = (0, 250, 250)
YELLOW = (250, 250, 0)
TAG_SIDE_M = 0.0635  # ar_slam_tpu/viz/annotate.py:51-62


def _draw_poly(draw, pts, color, width=2):
    pts = [tuple(p) for p in pts]
    draw.line(pts + [pts[0]], fill=color, width=width)


def _project(store: MapStore, cap, tag_pose) -> np.ndarray:
    """(4, 2) centered pixel coords of a tag in a capture."""
    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64))

    return project_corners(f64(store.camera.params), f64(cap.inv_pose),
                           f64(tag_pose), TAG_SIDE_M).numpy()


def annotate_capture(store: MapStore, cap_idx: int, image: np.ndarray,
                     out_path: str, show_all_tags: bool = False,
                     max_dim: float = 800.0) -> str:
    """Write an annotated debug PNG for one capture; returns the path."""
    from PIL import Image, ImageDraw

    cap = store.captures[cap_idx]
    h, w = image.shape[:2]
    scale = min(max_dim / max(h, w), 1.0)
    img = Image.fromarray(image).convert("RGB")
    if scale < 1.0:
        img = img.resize((int(w * scale), int(h * scale)))
    draw = ImageDraw.Draw(img)
    cx, cy = w * scale / 2.0, h * scale / 2.0

    def to_img(pts):
        return np.asarray(pts) * scale + np.array([cx, cy])

    detected_tags = set()
    for bh in cap.blocks:
        block = store.blocks[bh]
        detected_tags.add(block.tag_idx)
        _draw_poly(draw, to_img(block.corners), MAGENTA)
        proj = _project(store, cap, store.arucos[block.tag_idx].pose)
        _draw_poly(draw, to_img(proj), CYAN)

    if show_all_tags:
        for tag in store.arucos:
            if tag.index in detected_tags:
                continue
            proj = _project(store, cap, tag.pose)
            inside = (np.abs(proj[:, 0]) < w / 2) & (np.abs(proj[:, 1]) < h / 2)
            if inside.all():
                _draw_poly(draw, to_img(proj), YELLOW)

    img.save(out_path)
    return out_path
