# Copied from ar_slam_tpu/detect/gen.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Tag sheet generation (≙ ar_gen, ar_slam/src/ar_gen.cpp).

Renders dictionary markers as printable PNG pages: 8.5x11 in at 100 dpi,
2x3 grid of 2.5 in markers with id labels, files
``aruco<dict>_page<N>.png`` (ar_gen.cpp:53-101).  Pure NumPy/PIL — no GUI
(the reference also imshows each page for 200 ms; headless here).
"""

from __future__ import annotations

import os

import numpy as np

from ar_slam_tpu_torch.detect.dictionaries import get_dictionary


def render_marker(dict_name: str, marker_id: int, pixels: int,
                  border_bits: int = 1) -> np.ndarray:
    """Render one marker as a (pixels, pixels) uint8 image (0=black)."""
    d = get_dictionary(dict_name)
    bits = d.bits[marker_id]
    s = d.marker_size
    n = s + 2 * border_bits
    grid = np.zeros((n, n), dtype=np.uint8)
    grid[border_bits:-border_bits, border_bits:-border_bits] = bits
    cell = pixels // n
    img = np.kron(grid, np.ones((cell, cell), dtype=np.uint8)) * 255
    pad = pixels - img.shape[0]
    if pad > 0:
        img = np.pad(img, ((0, pad), (0, pad)), constant_values=255)
    return img


def generate_pages(
    out_dir: str = ".",
    dict_name: str = "4X4_50",
    dpi: int = 100,
    page_in: tuple[float, float] = (8.5, 11.0),
    marker_in: float = 2.5,
    cols: int = 2,
    rows: int = 3,
) -> list[str]:
    """Write tag sheet pages; returns the file paths."""
    from PIL import Image, ImageDraw

    d = get_dictionary(dict_name)
    page_w, page_h = int(page_in[0] * dpi), int(page_in[1] * dpi)
    marker_px = int(marker_in * dpi)
    per_page = cols * rows
    n_pages = (d.n_markers + per_page - 1) // per_page

    gap_x = (page_w - cols * marker_px) // (cols + 1)
    gap_y = (page_h - rows * marker_px) // (rows + 1)

    paths = []
    for page in range(n_pages):
        canvas = Image.new("L", (page_w, page_h), 255)
        draw = ImageDraw.Draw(canvas)
        for slot in range(per_page):
            marker_id = page * per_page + slot
            if marker_id >= d.n_markers:
                break
            r, c = divmod(slot, cols)
            x = gap_x + c * (marker_px + gap_x)
            y = gap_y + r * (marker_px + gap_y)
            marker = render_marker(dict_name, marker_id, marker_px)
            canvas.paste(Image.fromarray(marker), (x, y))
            draw.text((x, y + marker_px + 4),
                      f"aruco_{dict_name}_{marker_id}", fill=0)
        fn = os.path.join(out_dir,
                          f"aruco{dict_name.lower()}_page{page}.png")
        canvas.save(fn)
        paths.append(fn)
    return paths
