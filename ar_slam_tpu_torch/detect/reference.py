# Copied from ar_slam_tpu/detect/reference.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Reference (NumPy) Aruco detector — the engine's correctness oracle and
CPU fallback path.

A from-scratch implementation of the same detection capability the reference
gets from cv::aruco::detectMarkers (ar_slam_util.cpp:247-286,
aruco_detector.cpp:93-135):

  grayscale → blockwise adaptive threshold (integral-image mean) →
  connected components → convex-hull quad decimation → homography bit
  sampling → dictionary decode with rotations → corner-order
  canonicalization → geometric filters (minCornerDistanceRate etc.)

The Pallas TPU kernels (pallas_detect.py) implement the same stages with
fixed candidate budgets; this module is their exact-semantics oracle, tested
against rendered synthetic tags and against OpenCV on the demo images.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import ndimage

from ar_slam_tpu_torch.detect.dictionaries import get_dictionary


@dataclass
class Detection:
    id: str
    marker_id: int
    dict_name: str
    corners: np.ndarray  # (4, 2) float, pixel coords (top-left origin)

    def corners_centered(self, image_size) -> np.ndarray:
        w, h = image_size
        return self.corners - np.array([w / 2.0, h / 2.0])


def to_grayscale(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return img.astype(np.float32)
    # BGR (cv-style) or RGB — luma weights close enough for thresholding
    return img[..., :3].astype(np.float32) @ np.array([0.299, 0.587, 0.114],
                                                      dtype=np.float32)


def box_mean(img: np.ndarray, win: int) -> np.ndarray:
    """Windowed mean via integral image (win odd)."""
    pad = win // 2
    padded = np.pad(img, pad + 1, mode="edge").astype(np.float64)
    ii = padded.cumsum(axis=0).cumsum(axis=1)
    h, w = img.shape
    s = (
        ii[win:win + h, win:win + w]
        - ii[0:h, win:win + w]
        - ii[win:win + h, 0:w]
        + ii[0:h, 0:w]
    )
    return (s / (win * win)).astype(np.float32)


def adaptive_threshold(gray: np.ndarray, win: int = 23, c: float = 7.0):
    """Binary image: 1 where pixel is darker than local mean - c
    (markers are dark on light background)."""
    return (gray < box_mean(gray, win) - c)


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; points (N, 2) -> hull (M, 2) CCW in a y-up
    frame (appears CW in image coords where +y is down)."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 3:
        return pts.astype(float)
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(iterable):
        out = []
        for p in iterable:
            while len(out) >= 2 and cross2(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1], dtype=float)


def decimate_to_quad(hull: np.ndarray) -> np.ndarray | None:
    """Iteratively remove the hull vertex whose removal loses the least
    area until 4 remain — converges to the 4 extreme corners for
    perspective squares with rounded/noisy corners."""
    pts = list(hull.astype(float))
    if len(pts) < 4:
        return None
    while len(pts) > 4:
        n = len(pts)
        best_i, best_loss = 0, None
        for i in range(n):
            a, b, c = pts[(i - 1) % n], pts[i], pts[(i + 1) % n]
            loss = abs(
                (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
            ) * 0.5
            if best_loss is None or loss < best_loss:
                best_i, best_loss = i, loss
        pts.pop(best_i)
    return np.array(pts)


def polygon_area(quad: np.ndarray) -> float:
    x, y = quad[:, 0], quad[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def order_clockwise_from_topleft(quad: np.ndarray) -> np.ndarray:
    """Order corners clockwise in image coords (y down), starting from the
    corner most toward top-left.  Decode canonicalization later rotates the
    start to the marker's canonical TL."""
    center = quad.mean(axis=0)
    ang = np.arctan2(quad[:, 1] - center[1], quad[:, 0] - center[0])
    order = np.argsort(ang)  # CCW in y-up == CW in image frame? no:
    # arctan2 ascending = CCW in standard axes; with y down it appears CW.
    quad = quad[order]
    start = np.argmin(quad.sum(axis=1))
    return np.roll(quad, -start, axis=0)


def homography_unit_square(quad: np.ndarray) -> np.ndarray:
    """Homography mapping unit square (0,0),(1,0),(1,1),(0,1) to quad
    corners 0..3 (TL, TR, BR, BL)."""
    src = np.array([[0.0, 0], [1, 0], [1, 1], [0, 1]])
    rows, rhs = [], []
    for (x, y), (u, v) in zip(src, quad):
        rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        rhs.append(u)
        rows.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        rhs.append(v)
    h8 = np.linalg.solve(np.array(rows), np.array(rhs))
    return np.concatenate([h8, [1.0]]).reshape(3, 3)


def sample_bits(gray: np.ndarray, quad: np.ndarray, marker_size: int,
                border_bits: int = 1, sub: int = 3,
                min_otsu_std: float = 12.0, cell_margin: float = 0.13,
                bilinear: bool = True, min_bit_margin: float = 0.3,
                border_frac: float = 0.65,
                min_strong_cell_frac: float = 0.25,
                strong_cell_dev: float = 0.35,
                min_cell_px: float = 2.0):
    """Sample the (s + 2b)² cell grid from the GRAY image: warp cell sample
    points through the quad homography, binarize with a per-quad Otsu
    threshold (like cv::aruco's perspective-removal + Otsu), majority-vote
    per cell.  Returns (bits, ok); low-contrast patches are rejected
    (≙ minOtsuStdDev).  Defaults mirror DetectParams (tpu_detect.py):
    bilinear taps, border ≙ cv2's 35% erroneous-border allowance."""
    n = marker_size + 2 * border_bits
    # min decodable cell size (same gate as the TPU detector): sub-taps of
    # cells under ~2 px alias the same pixels — no physical print decodes
    if np.min(np.linalg.norm(quad - np.roll(quad, -1, axis=0), axis=1)) \
            < min_cell_px * n:
        return None, False, None
    hmat = homography_unit_square(quad)
    # sample only the central band of each cell (cv2's
    # perspectiveRemoveIgnoredMarginPerCell=0.13): cell-boundary pixels are
    # blur-contaminated and flipped a 28-px marker's bits at sigma=1.2
    offs = cell_margin + (np.arange(sub) + 0.5) / sub * (1 - 2 * cell_margin)
    cell = np.arange(n)
    u = (cell[:, None] + offs[None, :]).reshape(-1) / n  # (n*sub,)
    uu, vv = np.meshgrid(u, u, indexing="xy")
    ones = np.ones_like(uu)
    pts = np.stack([uu, vv, ones], axis=-1) @ hmat.T
    xy = pts[..., :2] / pts[..., 2:3]
    h, w = gray.shape
    g = gray.astype(np.float32)
    if bilinear:
        xf = np.clip(xy[..., 0], 0.0, w - 1.0)
        yf = np.clip(xy[..., 1], 0.0, h - 1.0)
        x0 = np.clip(np.floor(xf).astype(int), 0, w - 2)
        y0 = np.clip(np.floor(yf).astype(int), 0, h - 2)
        fx = xf - x0
        fy = yf - y0
        samples = (g[y0, x0] * (1 - fx) * (1 - fy)
                   + g[y0, x0 + 1] * fx * (1 - fy)
                   + g[y0 + 1, x0] * (1 - fx) * fy
                   + g[y0 + 1, x0 + 1] * fx * fy)
    else:
        xi = np.clip(np.round(xy[..., 0]).astype(int), 0, w - 1)
        yi = np.clip(np.round(xy[..., 1]).astype(int), 0, h - 1)
        samples = g[yi, xi]
    if samples.std() < min_otsu_std:
        return None, False, None
    thresh = otsu_threshold(samples)
    dark = samples < thresh
    cells = dark.reshape(n, sub, n, sub).mean(axis=(1, 3))
    # bit decisiveness (same guard as the TPU detector): kill blur-only
    # regions; id discrimination itself comes from hamming matching
    if 2.0 * np.median(np.abs(cells - 0.5)) < min_bit_margin:
        return None, False, None
    # bimodality gate (same as DetectParams.min_strong_cell_frac): Otsu
    # slicing a textureless patch at its noise floor leaves almost no cell
    # decisive, yet chance-matches 16-bit words at corpus scale
    if np.mean(np.abs(cells - 0.5) >= strong_cell_dev) < min_strong_cell_frac:
        return None, False, None
    grid_dark = cells > 0.5  # True = dark
    b = border_bits
    border = np.concatenate([
        grid_dark[:b, :].reshape(-1), grid_dark[-b:, :].reshape(-1),
        grid_dark[:, :b].reshape(-1), grid_dark[:, -b:].reshape(-1),
    ])
    border_ok = border.mean() > border_frac
    inner = grid_dark[b:-b, b:-b]
    bits = (~inner).astype(np.uint8)  # white = 1 (canonical convention)
    # analog inner grid (whiteness) for cross-dictionary arbitration
    analog = 1.0 - cells[b:-b, b:-b]
    return bits, border_ok, analog


def otsu_threshold(values: np.ndarray) -> float:
    """Otsu's threshold over a sample array (256-bin histogram)."""
    v = values.reshape(-1)
    lo, hi = float(v.min()), float(v.max())
    if hi <= lo:
        return lo
    hist, edges = np.histogram(v, bins=256, range=(lo, hi))
    centers = 0.5 * (edges[:-1] + edges[1:])
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    m0 = np.cumsum(hist * centers)
    mt = m0[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        mu0 = m0 / w0
        mu1 = (mt - m0) / w1
        between = w0 * w1 * (mu0 - mu1) ** 2
    between = np.nan_to_num(between)
    return float(centers[int(np.argmax(between))])


def refine_corners(gray: np.ndarray, quad: np.ndarray, win: int = 5,
                   iters: int = 4) -> np.ndarray:
    """Subpixel corner refinement: gradient-weighted centroid condition
    (cornerSubPix-style normal-equation iteration)."""
    h, w = gray.shape
    gy, gx = np.gradient(gray.astype(np.float64))
    out = quad.copy()
    for ci in range(4):
        cx, cy = out[ci]
        for _ in range(iters):
            x0, x1 = int(round(cx)) - win, int(round(cx)) + win + 1
            y0, y1 = int(round(cy)) - win, int(round(cy)) + win + 1
            if x0 < 1 or y0 < 1 or x1 >= w - 1 or y1 >= h - 1:
                break
            gxs = gx[y0:y1, x0:x1]
            gys = gy[y0:y1, x0:x1]
            xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
            a = gxs * gxs
            b = gxs * gys
            c = gys * gys
            amat = np.array([[a.sum(), b.sum()], [b.sum(), c.sum()]])
            bvec = np.array([(a * xs + b * ys).sum(), (b * xs + c * ys).sum()])
            if np.linalg.cond(amat) > 1e8:
                break
            nxt = np.linalg.solve(amat, bvec)
            if not np.all(np.isfinite(nxt)):
                break
            shift = np.hypot(nxt[0] - cx, nxt[1] - cy)
            cx, cy = nxt
            if shift < 0.03:
                break
        out[ci] = (cx, cy)
    return out


def detect_markers(
    img: np.ndarray,
    dict_names=("4X4_50",),
    win_sizes=(23,),
    thresh_c: float = 7.0,
    min_corner_distance_rate: float = 0.1,
    min_perimeter_rate: float = 0.03,
    max_perimeter_rate: float = 4.0,
    max_hamming: int | dict | None = None,
    border_bits: int = 1,
    refine: bool = True,
    max_candidates: int = 256,
) -> list[Detection]:
    """Detect Aruco markers from the given dictionaries in one image."""
    gray = to_grayscale(img)
    h, w = gray.shape
    max_dim = max(h, w)
    dicts = [get_dictionary(n) for n in dict_names]
    if max_hamming is None:
        max_hamming = {}
    if isinstance(max_hamming, int):
        max_hamming = {n: max_hamming for n in dict_names}

    detections: list[Detection] = []
    seen_centers: list[tuple[str, np.ndarray]] = []

    for win in win_sizes:
        binary = adaptive_threshold(gray, win, thresh_c)
        labels, n_labels = ndimage.label(binary, structure=np.ones((3, 3)))
        if n_labels == 0:
            continue
        objects = ndimage.find_objects(labels)
        areas = ndimage.sum_labels(binary, labels, np.arange(1, n_labels + 1))
        order = np.argsort(-areas)[:max_candidates]
        for oi in order:
            lab = oi + 1
            sl = objects[oi]
            bh = sl[0].stop - sl[0].start
            bw = sl[1].stop - sl[1].start
            approx_perim = 2 * (bh + bw)
            if approx_perim < min_perimeter_rate * max_dim:
                continue
            if approx_perim > max_perimeter_rate * max_dim:
                continue
            ys, xs = np.nonzero(labels[sl] == lab)
            pts = np.stack([xs + sl[1].start, ys + sl[0].start], axis=1)
            hull = convex_hull(pts)
            quad = decimate_to_quad(hull)
            if quad is None:
                continue
            # hull must be reasonably quad-like: quad area close to hull area
            hull_area = polygon_area(hull)
            if hull_area <= 0 or polygon_area(quad) < 0.6 * hull_area:
                continue
            # the component must at least trace its hull boundary (large
            # markers threshold as hollow rings, so do NOT require fill)
            hull_perim = np.sum(
                np.linalg.norm(hull - np.roll(hull, -1, axis=0), axis=1)
            )
            if len(pts) < 0.5 * hull_perim:
                continue
            quad = order_clockwise_from_topleft(quad)
            perimeter = np.sum(
                np.linalg.norm(quad - np.roll(quad, -1, axis=0), axis=1)
            )
            min_dist = np.min(
                np.linalg.norm(quad - np.roll(quad, -1, axis=0), axis=1)
            )
            if min_dist < min_corner_distance_rate * perimeter:
                continue
            # include the half-pixel edge: component pixels are cell centers
            quad_s = expand_quad(quad, 0.5)
            # subpixel-refine BEFORE bit sampling: decimation corners can sit
            # ~2 px off, enough to flip a bit of a small far-away tag
            if refine:
                quad_s = refine_corners(gray, quad_s)
            # try every dictionary and keep the smallest ANALOG
            # disagreement with its matched word (same arbitration as the
            # device pipeline): a real marker re-sampled on another
            # dictionary's cell alignment can chance-match a word at a
            # lucky hamming distance, but its cells sit near 0.5 there
            # while the aligned decode is hard at 0/1
            matches = []
            for d in dicts:
                try:
                    bits, border_ok, analog = sample_bits(
                        gray, quad_s, d.marker_size, border_bits
                    )
                except np.linalg.LinAlgError:
                    # refinement can collapse a junk candidate's corners
                    break
                if not border_ok:
                    continue
                mh = max_hamming.get(d.name, _default_hamming(d))
                marker_id, rot = d.identify(bits, mh)
                if marker_id < 0:
                    continue
                # identify matched observed == rot90(canonical, rot), so
                # the matched word in the SAMPLED orientation is exactly
                # the precomputed rotation row
                word = d.rotations[rot, marker_id].reshape(
                    d.marker_size, d.marker_size)
                soft = float(np.mean(np.abs(analog - word)))
                matches.append((soft, d, marker_id, rot))
            if not matches:
                continue
            soft, d, marker_id, rot = min(matches, key=lambda m: m[0])
            # identify() found observed == rot90(canonical, rot); the
            # canonical top-left then sits at sampled corner index
            # (4 - rot) % 4, i.e. forward-roll by rot (verified against
            # cv::aruco corner order on the demo images)
            corners = np.roll(quad_s, rot, axis=0)
            center = corners.mean(axis=0)
            dup = False
            for name, c0 in seen_centers:
                if name == d.name and np.linalg.norm(center - c0) < 0.3 * perimeter / 4:
                    dup = True
                    break
            if dup:
                continue
            seen_centers.append((d.name, center))
            detections.append(
                Detection(
                    id=f"aruco_{d.name}_{marker_id}",
                    marker_id=marker_id,
                    dict_name=d.name,
                    corners=corners,
                )
            )
    return detections


def expand_quad(quad: np.ndarray, margin_px: float) -> np.ndarray:
    """Push corners outward from the centroid by margin_px along the corner
    direction (pixel-center → pixel-edge compensation)."""
    center = quad.mean(axis=0)
    d = quad - center
    norm = np.linalg.norm(d, axis=1, keepdims=True)
    return quad + d / np.maximum(norm, 1e-9) * margin_px * np.sqrt(2.0)


def _default_hamming(d) -> int:
    """Default error-correction budget: 0 bits for 4x4 (its 16-bit codes sit
    close together — cv::aruco's errorCorrectionRate*maxCorrectionBits also
    truncates to 0 — and every real 4x4 tag on the demo photos decodes at
    hamming 0 while every false positive needs 1), 2 bits for 5x5, 3 bits
    for 6x6 (= cv::aruco's default 0.6 * maxCorrectionBits=5)."""
    return {4: 0, 5: 2}.get(d.marker_size, 3)
