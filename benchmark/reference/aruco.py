"""The plain Aruco detector that the program's detections are held to.

A frozen copy of the program's NumPy oracle (``detect/reference.py``, itself
a from-scratch cv::aruco::detectMarkers): blockwise adaptive threshold at
each window, connected components, convex-hull quad decimation, subpixel
corner refinement, homography bit sampling, dictionary decode with
rotations and cross-dictionary arbitration.  It imports nothing of the
program; the dictionaries are the benchmark's copy (``scenes/markers.npz``).

Changed from the original, with the same results: the image gradient of the
corner refinement is taken once per photo, not once per candidate, and a
component's convex hull is taken over the leftmost and rightmost pixel of
each of its rows, which hold every vertex of the hull.

``precision="bf16"`` is the control: the corner arithmetic (gradients,
the refinement's sums and solve, the half-pixel expansion) rounded to
bfloat16, the precision below the float32 that the detector states.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy import ndimage

from benchmark.scenes.room import marker_bits

# errors corrected per dictionary (the configuration's max_hamming)
HAMMING = {"4X4_50": 0, "5X5_100": 2}


def _bf16(x):
    """``x`` rounded to the nearest bfloat16, to nearest even."""
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _exact(x):
    return x


@functools.lru_cache(maxsize=None)
def _rotations(name: str) -> np.ndarray:
    bits = marker_bits(name)
    return np.stack([np.stack([np.rot90(b, k) for b in bits]).reshape(
        len(bits), -1) for k in range(4)])  # (4, N, s*s)


def identify(name: str, grid: np.ndarray, max_hamming: int):
    """(marker id, rotations) of an observed (s, s) bit grid, or (-1, 0)."""
    rot = _rotations(name)
    dists = (rot != grid.reshape(-1).astype(np.uint8)[None, None]).sum(2)
    k, idx = np.unravel_index(np.argmin(dists), dists.shape)
    return (int(idx), int(k)) if dists[k, idx] <= max_hamming else (-1, 0)


def box_mean(img: np.ndarray, win: int) -> np.ndarray:
    pad = win // 2
    ii = np.pad(img, pad + 1, mode="edge").astype(np.float64)
    ii = ii.cumsum(axis=0).cumsum(axis=1)
    h, w = img.shape
    s = (ii[win:win + h, win:win + w] - ii[0:h, win:win + w]
         - ii[win:win + h, 0:w] + ii[0:h, 0:w])
    return (s / (win * win)).astype(np.float32)


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 3:
        return pts.astype(float)
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and cross2(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower, upper = half(pts), half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1], dtype=float)


def row_extremes(ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """The leftmost and rightmost pixel (x, y) of each row of a component
    (``np.nonzero``'s row-major order)."""
    first = np.r_[True, ys[1:] != ys[:-1]]
    last = np.r_[ys[1:] != ys[:-1], True]
    keep = first | last
    return np.stack([xs[keep], ys[keep]], axis=1)


def decimate_to_quad(hull: np.ndarray):
    pts = list(hull.astype(float))
    if len(pts) < 4:
        return None
    while len(pts) > 4:
        n = len(pts)
        best_i, best_loss = 0, None
        for i in range(n):
            a, b, c = pts[(i - 1) % n], pts[i], pts[(i + 1) % n]
            loss = abs((b[0] - a[0]) * (c[1] - a[1])
                       - (b[1] - a[1]) * (c[0] - a[0])) * 0.5
            if best_loss is None or loss < best_loss:
                best_i, best_loss = i, loss
        pts.pop(best_i)
    return np.array(pts)


def polygon_area(quad: np.ndarray) -> float:
    x, y = quad[:, 0], quad[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def order_clockwise_from_topleft(quad: np.ndarray) -> np.ndarray:
    center = quad.mean(axis=0)
    quad = quad[np.argsort(np.arctan2(quad[:, 1] - center[1],
                                      quad[:, 0] - center[0]))]
    return np.roll(quad, -np.argmin(quad.sum(axis=1)), axis=0)


def homography_unit_square(quad: np.ndarray) -> np.ndarray:
    rows, rhs = [], []
    for (x, y), (u, v) in zip(((0.0, 0.0), (1, 0), (1, 1), (0, 1)), quad):
        rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        rows.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        rhs += [u, v]
    h8 = np.linalg.solve(np.array(rows), np.array(rhs))
    return np.concatenate([h8, [1.0]]).reshape(3, 3)


def otsu_threshold(values: np.ndarray) -> float:
    v = values.reshape(-1)
    lo, hi = float(v.min()), float(v.max())
    if hi <= lo:
        return lo
    hist, edges = np.histogram(v, bins=256, range=(lo, hi))
    centers = 0.5 * (edges[:-1] + edges[1:])
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    m0 = np.cumsum(hist * centers)
    with np.errstate(divide="ignore", invalid="ignore"):
        between = w0 * w1 * (m0 / w0 - (m0[-1] - m0) / w1) ** 2
    return float(centers[int(np.argmax(np.nan_to_num(between)))])


def sample_bits(gray: np.ndarray, quad: np.ndarray, marker_size: int,
                border_bits: int = 1, sub: int = 3,
                min_otsu_std: float = 12.0, cell_margin: float = 0.13,
                min_bit_margin: float = 0.3, border_frac: float = 0.65,
                min_strong_cell_frac: float = 0.25,
                strong_cell_dev: float = 0.35, min_cell_px: float = 2.0):
    """(inner bits, border ok, analog inner grid) of a quad, or
    (None, False, None) where the patch does not decode."""
    n = marker_size + 2 * border_bits
    if np.min(np.linalg.norm(quad - np.roll(quad, -1, axis=0), axis=1)) \
            < min_cell_px * n:
        return None, False, None
    hmat = homography_unit_square(quad)
    offs = cell_margin + (np.arange(sub) + 0.5) / sub * (1 - 2 * cell_margin)
    u = (np.arange(n)[:, None] + offs[None, :]).reshape(-1) / n
    uu, vv = np.meshgrid(u, u, indexing="xy")
    pts = np.stack([uu, vv, np.ones_like(uu)], axis=-1) @ hmat.T
    xy = pts[..., :2] / pts[..., 2:3]
    h, w = gray.shape
    xf = np.clip(xy[..., 0], 0.0, w - 1.0)
    yf = np.clip(xy[..., 1], 0.0, h - 1.0)
    x0 = np.clip(np.floor(xf).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(yf).astype(int), 0, h - 2)
    fx, fy = xf - x0, yf - y0
    samples = (gray[y0, x0] * (1 - fx) * (1 - fy)
               + gray[y0, x0 + 1] * fx * (1 - fy)
               + gray[y0 + 1, x0] * (1 - fx) * fy
               + gray[y0 + 1, x0 + 1] * fx * fy)
    if samples.std() < min_otsu_std:
        return None, False, None
    cells = (samples < otsu_threshold(samples)).reshape(
        n, sub, n, sub).mean(axis=(1, 3))
    if 2.0 * np.median(np.abs(cells - 0.5)) < min_bit_margin:
        return None, False, None
    if np.mean(np.abs(cells - 0.5) >= strong_cell_dev) < min_strong_cell_frac:
        return None, False, None
    dark = cells > 0.5
    b = border_bits
    border = np.concatenate([dark[:b].reshape(-1), dark[-b:].reshape(-1),
                             dark[:, :b].reshape(-1),
                             dark[:, -b:].reshape(-1)])
    inner = dark[b:-b, b:-b]
    return ((~inner).astype(np.uint8), border.mean() > border_frac,
            1.0 - cells[b:-b, b:-b])


def refine_corners(gx: np.ndarray, gy: np.ndarray, quad: np.ndarray, q,
                   win: int = 5, iters: int = 4) -> np.ndarray:
    """cornerSubPix-style refinement on the photo's gradient; ``q`` rounds
    the arithmetic (``_exact`` or ``_bf16``)."""
    h, w = gx.shape
    out = quad.copy()
    for ci in range(4):
        cx, cy = out[ci]
        for _ in range(iters):
            x0, x1 = int(round(cx)) - win, int(round(cx)) + win + 1
            y0, y1 = int(round(cy)) - win, int(round(cy)) + win + 1
            if x0 < 1 or y0 < 1 or x1 >= w - 1 or y1 >= h - 1:
                break
            gxs, gys = gx[y0:y1, x0:x1], gy[y0:y1, x0:x1]
            xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
            xs, ys = q(xs), q(ys)
            a, b, c = q(gxs * gxs), q(gxs * gys), q(gys * gys)
            amat = q(np.array([[a.sum(), b.sum()], [b.sum(), c.sum()]]))
            bvec = q(np.array([q(a * xs + b * ys).sum(),
                               q(b * xs + c * ys).sum()]))
            if np.linalg.cond(amat) > 1e8:
                break
            nxt = q(np.linalg.solve(amat, bvec))
            if not np.all(np.isfinite(nxt)):
                break
            shift = np.hypot(nxt[0] - cx, nxt[1] - cy)
            cx, cy = nxt
            if shift < 0.03:
                break
        out[ci] = (cx, cy)
    return out


def expand_quad(quad: np.ndarray, margin_px: float) -> np.ndarray:
    d = quad - quad.mean(axis=0)
    norm = np.linalg.norm(d, axis=1, keepdims=True)
    return quad + d / np.maximum(norm, 1e-9) * margin_px * np.sqrt(2.0)


def detect(img: np.ndarray, dict_names=("4X4_50", "5X5_100"),
           win_sizes=(3, 13, 23), thresh_c: float = 7.0,
           min_corner_distance_rate: float = 0.1,
           min_perimeter_rate: float = 0.03, max_perimeter_rate: float = 4.0,
           max_candidates: int = 64, precision: str = "f32") -> list:
    """[(tag id, corners (4, 2) pixel coords)] of a uint8 photo."""
    q = _bf16 if precision == "bf16" else _exact
    gray = img.astype(np.float32)
    h, w = gray.shape
    max_dim = max(h, w)
    gy, gx = np.gradient(gray.astype(np.float64))
    gy, gx = q(gy), q(gx)
    found, seen = [], []
    for win in win_sizes:
        binary = gray < box_mean(gray, win) - thresh_c
        labels, n_labels = ndimage.label(binary, structure=np.ones((3, 3)))
        if n_labels == 0:
            continue
        objects = ndimage.find_objects(labels)
        areas = ndimage.sum_labels(binary, labels, np.arange(1, n_labels + 1))
        for oi in np.argsort(-areas)[:max_candidates]:
            sl = objects[oi]
            bh, bw = sl[0].stop - sl[0].start, sl[1].stop - sl[1].start
            perim_box = 2 * (bh + bw)
            if not (min_perimeter_rate * max_dim <= perim_box
                    <= max_perimeter_rate * max_dim):
                continue
            ys, xs = np.nonzero(labels[sl] == oi + 1)
            n_pts = len(ys)
            hull = convex_hull(row_extremes(ys + sl[0].start,
                                            xs + sl[1].start))
            quad = decimate_to_quad(hull)
            if quad is None:
                continue
            hull_area = polygon_area(hull)
            if hull_area <= 0 or polygon_area(quad) < 0.6 * hull_area:
                continue
            if n_pts < 0.5 * np.sum(np.linalg.norm(
                    hull - np.roll(hull, -1, axis=0), axis=1)):
                continue
            quad = order_clockwise_from_topleft(quad)
            edges = np.linalg.norm(quad - np.roll(quad, -1, axis=0), axis=1)
            perimeter = np.sum(edges)
            if np.min(edges) < min_corner_distance_rate * perimeter:
                continue
            quad_s = refine_corners(gx, gy, q(expand_quad(quad, 0.5)), q)
            matches = []
            for name in dict_names:
                size = marker_bits(name).shape[1]
                try:
                    bits, border_ok, analog = sample_bits(gray, quad_s, size)
                except np.linalg.LinAlgError:
                    break
                if not border_ok:
                    continue
                mid, rot = identify(name, bits, HAMMING[name])
                if mid < 0:
                    continue
                word = _rotations(name)[rot, mid].reshape(size, size)
                matches.append((float(np.mean(np.abs(analog - word))), name,
                                mid, rot))
            if not matches:
                continue
            _, name, mid, rot = min(matches, key=lambda m: m[0])
            corners = np.roll(quad_s, rot, axis=0)
            center = corners.mean(axis=0)
            if any(n == name and np.linalg.norm(center - c0)
                   < 0.3 * perimeter / 4 for n, c0 in seen):
                continue
            seen.append((name, center))
            found.append((f"aruco_{name}_{mid}", corners))
    return found
