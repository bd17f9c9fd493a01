"""Peaks of the card and the least time of the detection stage's roles.

The least time of a piece of work is the larger of its bytes over the
memory rate and its float32 operations over their peak rate, the bytes
counted as inputs read once and outputs written once, from the shapes.
The detection stage's roles are counted from the stage's own input and
output shapes, whatever kernels implement them, so a later change of the
kernels leaves this yardstick where it is.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet, dense rates, at the 700 W limit
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}


def least_ms(n_bytes: float, n_ops: float = 0.0) -> float:
    """Least milliseconds the card could take for the work."""
    return max(n_bytes / PEAKS["hbm_bytes_per_s"],
               n_ops / PEAKS["f32_ops_per_s"]) * 1e3


def detect_roles(n: int, h: int, w: int, windows: int = 3,
                 candidates: int = 64, decimate: int = 2,
                 field_planes: int = 5, refine_win: int = 11) -> dict:
    """Least ms of each role of detecting ``n`` uint8 frames of h x w:

    - threshold: the frames read (1 B/px), one binary plane a window
      written at 1/``decimate`` resolution (1 B/px); a sliding box sum is 4
      adds a pixel and window, then a divide, a subtract and a compare;
    - fields: the corner-refinement planes (``field_planes`` float32 planes
      a frame) read once and their window sums written once, 2 (win - 1)
      adds a pixel;
    - components: the binary planes read (1 B/px), int32 labels written;
    - extraction: the labels read, ``candidates`` quads (4 x 2 float32) a
      plane written.
    """
    hd, wd = h // decimate, w // decimate
    frame_px = n * h * w
    plane_px = n * windows * hd * wd
    fields = n * field_planes * h * w
    return {
        "threshold": least_ms(frame_px + plane_px, 7 * windows * frame_px),
        "fields": least_ms(2 * 4 * fields, 2 * (refine_win - 1) * fields),
        "components": least_ms(5 * plane_px),
        "extraction": least_ms(4 * plane_px
                               + n * windows * candidates * 8 * 4),
    }


def detect_least_ms(n: int, h: int, w: int, **kw) -> float:
    """Least ms of the whole detection stage on a batch."""
    return sum(detect_roles(n, h, w, **kw).values())
