# Copied from ar_slam_tpu/core/calib.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Focal-length self-calibration from square-tag homographies.

The reference initializes the shared focal length to a fixed 3000.0
(ar_slam_util.hpp:69) and relies on LM to fix it — which strands the solve
in a poor basin when the true focal is far away (the bundled demo images
have focal ≈ 760 px; from 3000 every descent method plateaus at ~10 px
RMSE vs ~0.5 px at the optimum).

This module replaces the magic constant with a classical planar
self-calibration: each detected tag is a square of known size, so the
4-corner DLT homography H = [h1 h2 h3] (tag plane → centered image) must
satisfy, for K = diag(f, f, 1) (principal point at center, square pixels):

    h1ᵀ ω h2 = 0          with  ω = K⁻ᵀ K⁻¹
    h1ᵀ ω h1 = h2ᵀ ω h2

each yielding a closed-form f² estimate; the median over all detections in
all captures is robust to the near-degenerate (fronto-parallel) tags whose
h31, h32 ≈ 0.  Controlled by ``CameraConfig.focal_init_mode`` ("homography"
default, "fixed" for reference parity).
"""

from __future__ import annotations

import numpy as np

_DIRS = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])


def homography_4pt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact DLT homography from 4 correspondences (src (4,2) → dst (4,2))."""
    rows = []
    for (x, y), (u, v) in zip(src, dst):
        rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        rows.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    a = np.asarray(rows)
    _, _, vt = np.linalg.svd(a)
    h = vt[-1].reshape(3, 3)
    if abs(h[2, 2]) > 1e-12:
        h = h / h[2, 2]
    return h


def focal_estimates_from_rect(corners: np.ndarray, aruco_size: float):
    """Yield f² estimates from one detected rect (centered coords)."""
    out = []
    for a, b in focal_constraints_from_rect(corners, aruco_size):
        if abs(a) > 1e-12:
            f2 = b / a
            if f2 > 0:
                out.append(f2)
    return out


def focal_constraints_from_rect(corners: np.ndarray, aruco_size: float):
    """Linear constraints ``a·f² = b`` from one rect's homography.

    The IAC equations multiplied through by f² — h1ᵀωh2 = 0 becomes
    h31·h32·f² = −(h11·h21 + h12·h22), and the equal-norm equation
    (h31² − h32²)·f² = h11² + h12² − h21² − h22².  In this form a
    near-fronto-parallel tag contributes a ≈ 0: it self-downweights in a
    least-squares aggregate instead of producing a noise-ratio estimate.
    (The earlier per-tag ratio + f²>0 censoring biased the aggregate ~70%
    high on a near-frontal 10k-tag synthetic — enough to strand the whole
    bundle adjustment in the planar focal/depth-ambiguity basin.)
    """
    src = _DIRS * (0.5 * aruco_size)
    h = homography_4pt(src, np.asarray(corners, dtype=float))
    # scale-normalize so constraints are comparable across detections
    norm = np.linalg.norm(h)
    if norm < 1e-12:
        return []
    h = h / norm
    h1, h2 = h[:, 0], h[:, 1]
    return [
        (h1[2] * h2[2], -(h1[0] * h2[0] + h1[1] * h2[1])),
        (h1[2] ** 2 - h2[2] ** 2,
         h2[0] ** 2 + h2[1] ** 2 - h1[0] ** 2 - h1[1] ** 2),
    ]


def estimate_focal(rects, aruco_size: float) -> float | None:
    """Focal estimate over an iterable of (4,2) rects: median of f² = b/a
    over the STRONGEST constraints only — the returned value is the
    TOP-DECILE (|a| ≥ 90th percentile) median; the top-QUARTILE median is
    computed only as the consistency gate (the two cuts must agree within
    1.5× in f or the estimate is rejected).  Below 256 constraints the
    percentile cuts are too unstable and the estimator switches to the
    censored all-constraint median (see inline comment).

    Why the shape: the IAC constraints a·f² = b are noise-dominated for
    near-frontal tags (a → 0 faster than its corner-noise floor), and
    every whole-population aggregate fails differently — the per-tag
    ratio median with f²>0 censoring biased ~70 % HIGH on a near-frontal
    10k-tag synthetic (strandng the BA in the focal/depth-ambiguity
    basin), while a·a-weighted least squares is errors-in-variables
    attenuated ~80 % LOW on real photos (the bundled demo: 338 vs ≈760,
    which the TPU's f32 LM could not climb out of).  Restricting to the
    strongest |a| keeps only constraints whose denominator carries signal;
    when even those disagree between the top-10 % and top-25 % cuts
    (>1.5× apart in f), the data has no usable tilt and we return None —
    the caller falls back to the reference's fixed 3000 init
    (ar_slam_util.hpp:69), from which the batch construction converges on
    the near-frontal synthetics (README 10k-tag row).
    """
    ab = []
    for corners in rects:
        ab.extend(focal_constraints_from_rect(corners, aruco_size))
    if not ab:
        return None
    a = np.array([x[0] for x in ab])
    b = np.array([x[1] for x in ab])

    # few constraints (small real datasets like the bundled demo, 28):
    # percentile cuts are unstable at this count — use the censored
    # all-constraint median (the real-photo regime has genuine tilt, so
    # the near-frontal bias mode doesn't apply; demo: 798 vs true ≈760)
    if a.size < 256:
        f2 = b[np.abs(a) > 1e-15] / a[np.abs(a) > 1e-15]
        f2 = f2[f2 > 0]
        if f2.size < 2:
            return None
        med = float(np.median(f2))
        return float(np.sqrt(med)) if med > 0 else None

    def strong_median(q: float) -> float | None:
        thr = np.percentile(np.abs(a), q)
        k = (np.abs(a) >= thr) & (np.abs(a) > 1e-15)
        if k.sum() < 2:
            return None
        f2 = b[k] / a[k]
        f2 = f2[f2 > 0]
        if f2.size < 2:
            return None
        return float(np.median(f2))

    m75 = strong_median(75.0)
    m90 = strong_median(90.0)
    if m75 is None or m90 is None or m75 <= 0 or m90 <= 0:
        return None
    f75, f90 = np.sqrt(m75), np.sqrt(m90)
    if max(f75, f90) > 1.5 * min(f75, f90):
        return None  # noise-dominated: no consistent tilt signal
    return float(f90)
