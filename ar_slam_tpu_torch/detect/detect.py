"""Batched Aruco detection: port of detect/tpu_detect.py:detect_batch.

The stages are torch ops around five kernels (each with a plain PyTorch
version that the CPU runs use):

- the frames go to the card as they come (uint8: a quarter of the bytes of
  float32) and are converted there;
- adaptive threshold at every window and 2x count-pool decimation of the
  binary planes, stacked on the batch axis: one launch of K1
  (``detect.box.threshold_batch``) on uint8 frames;
- connected components with K2, or K3 on planes above
  ``FUSED_CCL_PIXEL_LIMIT`` (``detect.ccl``), both under the round cap
  ``ccl_iters``;
- top-K component ranking on a min-pooled label grid, each run of the
  sorted labels scored by K6 (``detect.rank``);
- extreme-point quads with K4 (``detect.extract``), ordered, expanded and
  filtered;
- compaction of the window sweep to 2K slots with cross-window dedup;
- subpixel corner refinement on field maps box-filtered by K1;
- one shared homography projection + bilinear sample for all dictionaries,
  Otsu binarization, hamming matching, cross-dictionary arbitration and
  duplicate suppression.

On the card the whole detector is one compiled program, as the
reference's jitted ``detect_batch`` is (ar_slam_tpu/detect/tpu_detect.py:
695): a call is a load (the frames copied into the program's own uint8
buffer: host photos each copied straight into its frame, with no
stacked host batch, the padding rows zeroed on the card) and one replay
of the CUDA graph of the stage ``detect`` (every step above, K1-K4 and
K6 inside), captured once per (card, batch shape, dtype, ``DetectParams``,
dictionaries) (``programs.py``).  Nothing in the stage
reads the card from the host or makes a tensor from host data: the
threshold and dictionary tables are on the card before the capture, and
the kernel wrappers read only shapes.  ``graphs=False`` and the CPU run
the same stage eagerly.

Every sort whose order reaches the output is a stable sort (the
reference's ``lax.sort(is_stable=True)``, ``jnp.argsort`` and ``lax.top_k``
are deterministic; ``torch.topk`` and unstable ``torch.sort`` are not).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ar_slam_tpu_torch.detect import box, ccl, extract, rank
from ar_slam_tpu_torch.detect.dictionaries import get_dictionary
from ar_slam_tpu_torch.device import resolve_device
from ar_slam_tpu_torch.programs import CACHE, Program, graphed

BIG = 2**30
# largest padded decimated plane (padded as the reference pads it) that goes
# to the fused CCL (K2); above it the strip-scan CCL (K3) runs; both with
# the round cap params.ccl_iters (tpu_detect.py:775-786,
# pallas_ccl.FUSED_CCL_PIXEL_LIMIT)
FUSED_CCL_PIXEL_LIMIT = 1_000_000
# the kernel wrappers' launch counts, which a replay adds to as the
# captured stage did, and the per-plane rounds each replay points them at
COUNTED = ((box, "launches"), (box, "threshold_launches"),
           (ccl, "launches"), (ccl, "strip_launches"),
           (ccl, "strip_kernel_launches"), (extract, "launches"),
           (rank, "launches"))
POINTERS = ((ccl, "_fused_rounds"), (ccl, "_strip_flags"))
_TABLES = {}  # (dict_names, device) -> dict_tables


class DetectParams(NamedTuple):
    """tpu_detect.DetectParams' fields and defaults (see there for the
    reasoning behind each gate), less ``ccl_backend`` (kernel or plain
    version follows the tensor's device).  ``ccl_iters`` bounds the rounds
    of both CCLs (K2 and K3)."""

    win: int = 23
    win_sizes: tuple = ()
    thresh_c: float = 7.0
    max_candidates: int = 32
    ccl_iters: int = 24
    min_perimeter_rate: float = 0.03
    max_perimeter_rate: float = 4.0
    min_corner_distance_rate: float = 0.1
    min_otsu_std: float = 12.0
    min_cell_px: float = 2.0
    border_frac: float = 0.65
    min_bit_margin: float = 0.3
    bilinear: bool = True
    cell_margin: float = 0.13
    sub: int = 3
    refine: bool = True
    refine_win: int = 5
    refine_iters: int = 4
    ccl_decimate: int = 2
    topk_subsample: int = 2
    max_area_frac: float = 0.25
    min_strong_cell_frac: float = 0.25
    strong_cell_dev: float = 0.35
    cross_dict_arbitration: bool = True


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis as sqrt(sum(v*v)) (jnp.linalg.norm)."""
    return torch.sqrt((v * v).sum(dim=-1))


def _hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.hypot's formula: max * sqrt(1 + (min/max)^2)."""
    a, b = a.abs(), b.abs()
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    r = lo / torch.where(hi == 0, torch.ones_like(hi), hi)
    return torch.where(hi == 0, hi, hi * torch.sqrt(1 + r * r))


def _stable_desc(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Indices of a stable descending sort (ties keep the lower index first,
    like lax.top_k)."""
    return torch.sort(x, dim=dim, descending=True, stable=True).indices


# ---------------------------------------------------------------------------
# candidate ranking and extraction
# ---------------------------------------------------------------------------


def top_k_components(labels_flat: torch.Tensor, k: int, grid_w: int,
                     max_area: float | None = None):
    """Batched tpu_detect._top_k_components: (B, P) labels -> top-k roots
    (B, k) int32 and their raw areas (B, k) float32 (0 for empty slots).
    Each row sorted stably, its runs scored by K6 (``detect.rank``), the
    top k taken by a stable descending sort (equal scores: lower label)."""
    s, sp = torch.sort(labels_flat, dim=1, stable=True)
    score, area_f = rank.run_scores(s, sp, grid_w, max_area)
    top_pos = _stable_desc(score, dim=1)[:, :k]
    top_score = torch.gather(score, 1, top_pos)
    has = top_score > 0
    top_area = torch.where(has, torch.gather(area_f, 1, top_pos),
                           torch.zeros_like(top_score))
    roots = torch.where(has, torch.gather(s, 1, top_pos),
                        torch.full_like(top_pos, BIG, dtype=s.dtype))
    return roots.to(torch.int32), top_area


def pool_labels(labels: torch.Tensor, subsample: int):
    """(B, H, W) labels -> the s x s min-pooled grid as (B, P) rows (the
    plane padded with 2^30 to a multiple of s) and the grid's width."""
    s = max(int(subsample), 1)
    b, h, w = labels.shape
    if s <= 1:
        return labels.reshape(b, -1), w
    hp, wp = -(-h // s) * s, -(-w // s) * s
    lab = labels
    if (hp, wp) != (h, w):
        lab = torch.full((b, hp, wp), BIG, dtype=labels.dtype,
                         device=labels.device)
        lab[:, :h, :w] = labels
    pooled = lab.reshape(b, hp // s, s, wp // s, s).amin(dim=(2, 4))
    return pooled.reshape(b, -1), wp // s


def top_k_subsampled(labels: torch.Tensor, k: int, subsample: int,
                     max_area_frac: float | None = None):
    """Batched tpu_detect._top_k_subsampled over (B, H, W) labels: rank on
    an s x s min-pooled grid (every component keeps a cell), areas scaled
    back by s^2."""
    s = max(int(subsample), 1)
    _, h, w = labels.shape
    max_area = (float(max_area_frac) * h * w
                if max_area_frac is not None else None)
    pooled, grid_w = pool_labels(labels, s)
    roots, top_area = top_k_components(
        pooled, k, grid_w, max_area / (s * s) if max_area is not None
        else None)
    return roots, top_area * float(s * s)


def postprocess_quads(quad: torch.Tensor, top_area: torch.Tensor, h: int,
                      w: int, params: DetectParams, scale: int = 1):
    """Batched tpu_detect._postprocess_quads over (..., K, 4, 2) quads:
    back to full-res pixels, clockwise from top-left, expanded by half a
    pixel, geometric filters.  Returns (quads, areas, valid)."""
    if scale > 1:
        quad = quad * float(scale) + (scale - 1) / 2.0
        top_area = top_area * float(scale * scale)
    center = quad.mean(dim=-2, keepdim=True)
    ang = torch.atan2(quad[..., 1] - center[..., 1],
                      quad[..., 0] - center[..., 0])
    order = torch.sort(ang, dim=-1, stable=True).indices
    quad = torch.gather(quad, -2, order[..., None].expand_as(quad))
    start = torch.argmin(quad.sum(dim=-1), dim=-1)
    roll_idx = (torch.arange(4, device=quad.device) + start[..., None]) % 4
    quad = torch.gather(quad, -2, roll_idx[..., None].expand_as(quad))

    centerq = quad.mean(dim=-2, keepdim=True)
    d = quad - centerq
    norm = _norm(d)[..., None]
    quad = quad + d / torch.clamp(norm, min=1e-9) * (0.5 * np.sqrt(2.0))

    valid = top_area > 0
    edges = _norm(quad - torch.roll(quad, -1, dims=-2))
    perimeter = edges.sum(dim=-1)
    max_dim = float(max(h, w))
    valid &= perimeter >= 4 * params.min_perimeter_rate * max_dim * 0.5
    valid &= perimeter <= 4 * params.max_perimeter_rate * max_dim
    valid &= edges.amin(dim=-1) >= params.min_corner_distance_rate * perimeter
    valid &= top_area >= 0.5 * perimeter
    return quad, top_area, valid


# ---------------------------------------------------------------------------
# corner refinement and decode
# ---------------------------------------------------------------------------


def _gradient(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.gradient along one axis (unit spacing, first-order edges)."""
    n = x.shape[dim]
    upper = x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1)
    inner = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) * 0.5
    lower = x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)
    return torch.cat([upper, inner, lower], dim=dim)


def refine_corners_batched(grays: torch.Tensor, corners: torch.Tensor,
                           win: int, iters: int) -> torch.Tensor:
    """Gradient-based subpixel corner refinement (tpu_detect.
    refine_corners_batched): the five window sums of the cornerSubPix
    normal equations are box-filtered field maps (K1, one launch for all
    five planes), read at each corner once per iteration."""
    n, h, w = grays.shape
    gy, gx = _gradient(grays, 1), _gradient(grays, 2)
    x = torch.arange(w, dtype=torch.float32, device=grays.device)[None, None]
    y = torch.arange(h, dtype=torch.float32, device=grays.device)[None, :,
                                                                    None]
    gxx, gxy, gyy = gx * gx, gx * gy, gy * gy
    planes = torch.stack([gxx, gxy, gyy, gxx * x + gxy * y,
                          gxy * x + gyy * y], dim=1)  # (N, 5, H, W)
    fields = box.box_sum_batch(planes.reshape(n * 5, h, w).contiguous(),
                               2 * win + 1).reshape(n, 5, h * w)

    c = corners.reshape(n, -1, 2)
    for _ in range(iters):
        cx, cy = c[..., 0], c[..., 1]
        x0 = torch.clamp(torch.round(cx).to(torch.int64), win + 1, w - win - 2)
        y0 = torch.clamp(torch.round(cy).to(torch.int64), win + 1, h - win - 2)
        idx = (y0 * w + x0)[:, None, :].expand(n, 5, -1)
        a, b, d, bx, by = torch.gather(fields, 2, idx).unbind(1)
        det = a * d - b * b
        ok = torch.abs(det) > 1e-6
        safe = torch.where(ok, det, torch.ones_like(det))
        nx = torch.where(ok, (d * bx - b * by) / safe, cx)
        ny = torch.where(ok, (a * by - b * bx) / safe, cy)
        keep = ok & (_hypot(nx - cx, ny - cy) < 2.0 * win)
        c = torch.stack([torch.where(keep, nx, cx),
                         torch.where(keep, ny, cy)], dim=-1)
    return c.reshape(corners.shape)


def make_tables(dict_names, device):
    """Rotation-expanded dictionary tables: {name: ((4*N, s*s) float32
    words, n_markers, s, max_hamming)}."""
    out = {}
    for name in dict_names:
        d = get_dictionary(name)
        # reference._default_hamming: 0 bits for 4x4, 2 for 5x5, 3 beyond
        mh = {4: 0, 5: 2}.get(d.marker_size, 3)
        words = torch.as_tensor(
            d.rotations.reshape(4 * d.n_markers, -1).astype(np.float32),
            device=device)
        out[name] = (words, d.n_markers, d.marker_size, float(mh))
    return out


def grid_points(n: int, sub: int, cm: float, device) -> torch.Tensor:
    """Unit-square sample points of an n x n cell grid, sub^2 taps per cell
    in the central (1 - 2 cm) band; (P, 3) homogeneous, row-major over
    (cell_v, tap_v, cell_u, tap_u)."""
    offs = cm + (torch.arange(sub, dtype=torch.float32, device=device)
                 + 0.5) / sub * (1.0 - 2.0 * cm)
    cell = torch.arange(n, dtype=torch.float32, device=device)
    u = (cell[:, None] + offs[None, :]).reshape(-1) / n
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    return torch.stack([uu, vv, torch.ones_like(uu)], dim=-1).reshape(-1, 3)


def homography_unit_square_batch(quads: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) quads -> (..., 3, 3) homographies (unit square -> quad),
    exact 8x8 DLT solves in float32."""
    q = quads.to(torch.float32)
    src = ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0))
    zero = torch.zeros_like(q[..., 0, 0])
    one = torch.ones_like(zero)
    rows, rhs = [], []
    for i, (sx, sy) in enumerate(src):
        u, v = q[..., i, 0], q[..., i, 1]
        xs, ys = zero + sx, zero + sy
        rows.append(torch.stack([xs, ys, one, zero, zero, zero,
                                 -u * sx, -u * sy], dim=-1))
        rhs.append(u)
        rows.append(torch.stack([zero, zero, zero, xs, ys, one,
                                 -v * sx, -v * sy], dim=-1))
        rhs.append(v)
    a = torch.stack(rows, dim=-2)
    b = torch.stack(rhs, dim=-1)
    h8 = torch.linalg.solve_ex(a, b).result
    return torch.cat([h8, one[..., None]], dim=-1).reshape(
        q.shape[:-2] + (3, 3))


def project_points(quads: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Unit-square points through per-quad homographies: quads (..., 4, 2),
    pts (P, 3) -> pixel coords (..., P, 2), full float32 products."""
    hmat = homography_unit_square_batch(quads)
    proj = torch.einsum("...ij,pj->...pi", hmat, pts)
    zz = proj[..., 2:3]
    return proj[..., :2] / torch.clamp(zz.abs(), min=1e-9) * torch.sign(
        zz + 1e-30)


def bilinear_payload(grays: torch.Tensor) -> torch.Tensor:
    """(N, H*W, 4) stack of each pixel's bilinear neighbours [g(y,x),
    g(y,x+1), g(y+1,x), g(y+1,x+1)], so one gathered row serves a tap."""
    n, h, w = grays.shape
    flat = grays.reshape(n, -1)
    return torch.stack([flat, torch.roll(flat, -1, 1), torch.roll(flat, -w, 1),
                        torch.roll(flat, -(w + 1), 1)], dim=-1)


def sample_points(grays: torch.Tensor, xy: torch.Tensor, params: DetectParams,
                  payload4: torch.Tensor | None = None) -> torch.Tensor:
    """Sample each image at its projected points: xy (N, K, P, 2) ->
    (N, K, P)."""
    n, h, w = grays.shape
    bidx = torch.arange(n, device=grays.device)[:, None, None]
    if params.bilinear:
        xf = torch.clamp(xy[..., 0], 0.0, w - 1.0)
        yf = torch.clamp(xy[..., 1], 0.0, h - 1.0)
        x0 = torch.clamp(torch.floor(xf).to(torch.int64), 0, w - 2)
        y0 = torch.clamp(torch.floor(yf).to(torch.int64), 0, h - 2)
        fx = xf - x0.to(xf.dtype)
        fy = yf - y0.to(yf.dtype)
        if payload4 is None:
            payload4 = bilinear_payload(grays)
        s4 = payload4[bidx, y0 * w + x0]  # (N, K, P, 4): one gather
        w4 = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                          (1 - fx) * fy, fx * fy], dim=-1)
        return (s4 * w4).sum(dim=-1)
    xi = torch.clamp(torch.round(xy[..., 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(xy[..., 1]).to(torch.int64), 0, h - 1)
    return grays.reshape(n, -1)[bidx, yi * w + xi]


def otsu_batch(samples: torch.Tensor, bins: int = 32) -> torch.Tensor:
    """Otsu threshold along the last axis: (..., S) -> (...)."""
    lo = samples.amin(dim=-1, keepdim=True)
    hi = samples.amax(dim=-1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp(((samples - lo) / span * bins).to(torch.int32), 0,
                    bins - 1)
    levels = torch.arange(bins, dtype=torch.float32, device=samples.device)
    # one_hot's counts, without its range check (a host read on the CPU)
    hist = (q[..., None] == levels.to(torch.int32)).to(
        torch.float32).sum(dim=-2)
    centers = lo + (levels + 0.5) / bins * span
    w0 = torch.cumsum(hist, dim=-1)
    w1 = w0[..., -1:] - w0
    m0 = torch.cumsum(hist * centers, dim=-1)
    mt = m0[..., -1:]
    mu0 = m0 / torch.clamp(w0, min=1e-9)
    mu1 = (mt - m0) / torch.clamp(w1, min=1e-9)
    between = w0 * w1 * (mu0 - mu1) ** 2
    best = torch.argmax(between, dim=-1)
    return torch.gather(centers, -1, best[..., None])[..., 0]


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median (method 'midpoint') along the last axis."""
    s = torch.sort(x, dim=-1).values
    m = x.shape[-1]
    return (s[..., (m - 1) // 2] + s[..., m // 2]) * 0.5


def decode_bits(samples, quads, valid, table, params: DetectParams):
    """tpu_detect._decode_bits over (N, K): threshold the sampled grids and
    match one dictionary.  samples (N, K, P) in grid_points order.

    Returns (marker_id, rot, corners, ok, soft_dist)."""
    words, n_markers, s, max_hamming = table
    n = s + 2  # border_bits = 1
    sub = params.sub
    nb, k = quads.shape[:2]
    flat = samples.reshape(nb, k, -1)
    std_ok = flat.std(dim=-1, correction=0) >= params.min_otsu_std
    edges = _norm(quads - torch.roll(quads, -1, dims=-2))
    std_ok &= edges.amin(dim=-1) / n >= params.min_cell_px
    thresh = otsu_batch(flat)
    dark = flat < thresh[..., None]
    cells = dark.reshape(nb, k, n, sub, n, sub).to(torch.float32).mean(
        dim=(3, 5))  # (N, K, n, n)
    grid_dark = cells > 0.5
    dev_c = torch.abs(cells - 0.5).reshape(nb, k, -1)
    margin_ok = 2.0 * _median(dev_c) >= params.min_bit_margin
    strong_ok = ((dev_c >= params.strong_cell_dev).to(torch.float32).mean(-1)
                 >= params.min_strong_cell_frac)

    cell = torch.arange(n, device=samples.device)
    inside = (cell > 0) & (cell < n - 1)
    border = ~(inside[:, None] & inside[None, :])
    border_frac = (grid_dark & border).sum(dim=(-2, -1)) / border.sum()
    border_ok = border_frac > params.border_frac

    inner = grid_dark[..., 1:-1, 1:-1]
    bits = (~inner).reshape(nb, k, s * s).to(torch.float32)  # white = 1
    dist = bits @ (1.0 - words).T + (1.0 - bits) @ words.T  # (N, K, 4M)
    flat_idx = torch.argmin(dist, dim=-1)
    min_dist = torch.gather(dist, -1, flat_idx[..., None])[..., 0]
    rot = torch.div(flat_idx, n_markers, rounding_mode="floor")
    marker_id = flat_idx % n_markers

    analog = 1.0 - cells[..., 1:-1, 1:-1].reshape(nb, k, s * s)
    soft_dist = torch.abs(analog - words[flat_idx]).mean(dim=-1)

    ok = (valid & std_ok & border_ok & margin_ok & strong_ok
          & (min_dist <= max_hamming))
    roll_idx = (torch.arange(4, device=quads.device) - rot[..., None]) % 4
    corners = torch.gather(quads, -2, roll_idx[..., None].expand_as(quads))
    return marker_id, rot, corners, ok, soft_dist


def suppress_duplicates(ids, corners, ok):
    """tpu_detect._suppress_duplicates over (N, K): of repeated detections
    of one marker (from different threshold windows) keep the one of
    largest perimeter, lower slot on equal perimeters."""
    centers = corners.mean(dim=-2)
    perim = _norm(corners - torch.roll(corners, -1, dims=-2)).sum(dim=-1)
    k = ids.shape[-1]
    ar = torch.arange(k, device=ids.device)
    same = (ids[..., :, None] == ids[..., None, :]) & ok[..., :, None] & ok[
        ..., None, :]
    dist = _norm(centers[..., :, None, :] - centers[..., None, :, :])
    close = dist < 0.5 * torch.minimum(perim[..., :, None],
                                       perim[..., None, :]) / 4.0
    dup = same & close & (ar[:, None] != ar[None, :])
    beats = dup & ((perim[..., None, :] > perim[..., :, None])
                   | ((perim[..., None, :] == perim[..., :, None])
                      & (ar[None, :] < ar[:, None])))
    return ok & ~beats.any(dim=-1)


# ---------------------------------------------------------------------------
# the batch detector
# ---------------------------------------------------------------------------


def dict_tables(dict_names, device) -> dict:
    """``make_tables`` on ``device``, kept per (dict_names, card) from its
    first call on: a compiled program holds the tables it was built with,
    since an upload cannot be captured."""
    key = (tuple(dict_names), torch.device(device))
    if key not in _TABLES:
        _TABLES[key] = make_tables(key[0], key[1])
    return _TABLES[key]


def batch_shape(images) -> tuple:
    """The (N, H, W) shape and the torch dtype of a batch of frames: an
    (N, H, W) array or tensor, or a sequence of (H, W) arrays or tensors
    of one shape and dtype.  Frames that differ raise ValueError, as
    ``np.stack`` does."""
    if isinstance(images, torch.Tensor):
        return tuple(images.shape), images.dtype
    if isinstance(images, np.ndarray):
        return images.shape, _torch_dtype(images.dtype)
    shapes = {tuple(np.shape(x)) for x in images}
    dtypes = {_torch_dtype(x.dtype) for x in images}
    if len(shapes) != 1 or len(dtypes) != 1:
        raise ValueError("the frames of a batch must have one shape and "
                         f"dtype, not {sorted(shapes)} "
                         f"{sorted(map(str, dtypes))}")
    return (len(images), *shapes.pop()), dtypes.pop()


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _stacked(images, shape) -> torch.Tensor:
    """The batch as one tensor of ``shape``, zero frames past the
    images."""
    if isinstance(images, (np.ndarray, torch.Tensor)):
        frames = torch.as_tensor(images)
    else:
        frames = torch.from_numpy(np.stack([np.asarray(x) for x in images]))
    if shape[0] > len(frames):
        frames = torch.cat([frames, frames.new_zeros(
            (shape[0] - len(frames), *shape[1:]))])
    return frames


def detect_batch(images, *, params: DetectParams = DetectParams(),
                 dict_names=("4X4_50", "5X5_100"), device=None,
                 graphs: bool = True, pad_to=None):
    """Detect markers in a batch of grayscale images.

    Args:
      images: (N, H, W) uint8/float grayscale, numpy or torch, or the N
        (H, W) images as a sequence of host arrays of one shape and dtype
        (a photo each, as decoded: on the card each is copied straight
        into its frame of the program's buffer, and no stacked host batch
        is made).
      device: where to run (default: the card; raises without one unless
        "cpu" is asked for).  On a CUDA device the kernels run; on the CPU
        their plain versions.
      graphs: on a CUDA device the call replays the detector's CUDA
        graph for this (card, batch shape, dtype, ``params``,
        ``dict_names``), captured at its first call (``programs.CACHE``,
        kind ``"detect"``); False, and the CPU, run the same stage
        eagerly (``programs.graphed``).
      pad_to: run a batch of this many frames (at least N), the frames
        past the N images zero (made on the card, copied from nowhere):
        each batch shape is a program of its own, so a caller with
        varying batch sizes pads to a few.

    Returns {dict_name: {"ids" (N', K') int64 (-1 invalid), "corners"
    (N', K', 4, 2) float32 pixel coords in canonical corner order, "valid"
    (N', K') bool}}, N' = max(N, pad_to), tensors of their own (a later
    call does not overwrite them).
    """
    device = resolve_device(device)
    shape, dtype = batch_shape(images)
    shape = (max(shape[0], pad_to or 0), *shape[1:])
    replay = graphed(device, graphs)
    if device.type != "cuda":
        return _detect_call(images, shape, dtype, params, tuple(dict_names),
                            device, replay)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    # the kernels launch on the current device's stream: make it the
    # frames' card (a mesh shard may live on any of them)
    with torch.cuda.device(device):
        return _detect_call(images, shape, dtype, params, tuple(dict_names),
                            device, replay)


def _detect_call(images, shape: tuple, dtype, params: DetectParams,
                 dict_names: tuple, device, graphed: bool) -> dict:
    """One call of the detector's program: load the frames (when graphed
    an upload into the program's own buffer, a host frame at a time), run
    its stage, return copies of its outputs."""
    kind = "detect"

    def make():
        return Program({"detect": _stage(params, dict_names, device)},
                       graphed, counted=COUNTED, pointers=POINTERS,
                       label=f"detect {shape} {dtype}", kind=kind,
                       rows={"frames": (shape, dtype)})

    if graphed:
        prog = CACHE.get(kind, device, (shape, dtype, params, dict_names),
                         make)
    else:
        prog = make()
        images = _stacked(images, shape).to(device).contiguous()
    with prog.lock:
        prog.load(frames=images)
        prog.run("detect")
        return {name: dict(zip(("ids", "corners", "valid"),
                               map(prog.out, prog.t[name])))
                for name in dict_names}


def _stage(params: DetectParams, dict_names: tuple, device):
    """The detector as one stage over a program's tensors: every table it
    reads is on the card before the first capture."""
    tables = dict_tables(dict_names, device)
    windows = tuple(params.win_sizes) or (params.win,)
    if device.type == "cuda":
        box.device_table(windows, params.thresh_c, device)

    def detect(t):
        out = _detect(t["frames"], tables, params, dict_names, device)
        return {name: (d["ids"], d["corners"], d["valid"])
                for name, d in out.items()}
    return detect


def uses_fused_ccl(h: int, w: int, params: DetectParams) -> bool:
    """Whether the binary planes of h x w frames go to K2: their decimated
    size, padded as the reference pads it, within
    ``FUSED_CCL_PIXEL_LIMIT`` (K3 above it)."""
    d = max(int(params.ccl_decimate), 1)
    hd, wd = -(-h // d), -(-w // d)
    hw_pad = (-(-hd // 128) * 128 if hd > 128 else -(-hd // 8) * 8) * (
        -(-wd // 128) * 128)
    return hw_pad <= FUSED_CCL_PIXEL_LIMIT


def _detect(frames, tables, params: DetectParams, dict_names, device):
    windows = tuple(params.win_sizes) or (params.win,)
    n, h, w = frames.shape
    k = params.max_candidates
    nw = len(windows)

    d = max(int(params.ccl_decimate), 1)
    binary_b = box.threshold_batch(frames, windows, params.thresh_c, d)
    images = frames.to(torch.float32)  # for refine and decode
    if uses_fused_ccl(h, w, params):
        labels_b = ccl.connected_components_batch(binary_b, params.ccl_iters)
    else:
        labels_b = ccl.connected_components_strip_batch(binary_b,
                                                        params.ccl_iters)
    roots_b, area_b = top_k_subsampled(labels_b, k, params.topk_subsample,
                                       params.max_area_frac)
    raw_q = extract.extreme_quads(labels_b, roots_b)
    q, _, v = postprocess_quads(raw_q, area_b, h, w, params, scale=d)

    if nw > 1:
        quads_b = q.reshape(nw, n, k, 4, 2).transpose(0, 1).reshape(
            n, nw * k, 4, 2)
        valid_b = v.reshape(nw, n, k).transpose(0, 1).reshape(n, nw * k)
        perim = _norm(quads_b - torch.roll(quads_b, -1, dims=2)).sum(dim=2)
        centers = quads_b.mean(dim=2)
        cdist = _norm(centers[:, :, None] - centers[:, None, :])
        pmin = torch.minimum(perim[:, :, None], perim[:, None, :])
        pmax = torch.maximum(perim[:, :, None], perim[:, None, :])
        both = valid_b[:, :, None] & valid_b[:, None, :]
        m = perim.shape[1]
        ar = torch.arange(m, device=device)
        dup = (both & (cdist < 0.1 * pmin / 4.0) & (pmax < 1.1 * pmin)
               & (ar[:, None] != ar[None, :])[None])
        beaten = (dup & ((perim[:, None, :] > perim[:, :, None])
                         | ((perim[:, None, :] == perim[:, :, None])
                            & (ar[None, None, :] < ar[None, :, None])))
                  ).any(dim=2)
        bonus = torch.where(beaten, torch.zeros_like(perim),
                            torch.full_like(perim, 1e6))
        key = torch.where(valid_b, perim + bonus, torch.full_like(perim, -1.0))
        kdec = min(2 * k, nw * k)
        order = torch.sort(-key, dim=1, stable=True).indices[:, :kdec]
        quads_b = torch.gather(quads_b, 1,
                               order[..., None, None].expand(-1, -1, 4, 2))
        valid_b = torch.gather(valid_b, 1, order)
    else:
        quads_b, valid_b = q, v

    if params.refine:
        quads_b = refine_corners_batched(images, quads_b, params.refine_win,
                                         params.refine_iters)

    pts, splits = [], [0]
    for name in dict_names:
        pts.append(grid_points(tables[name][2] + 2, params.sub,
                               params.cell_margin, device))
        splits.append(splits[-1] + pts[-1].shape[0])
    xy = project_points(quads_b, torch.cat(pts))  # (N, K', P_all, 2)
    payload4 = bilinear_payload(images) if params.bilinear else None
    samples_all = sample_points(images, xy, params, payload4)

    decoded = [decode_bits(samples_all[..., splits[i]:splits[i + 1]],
                           quads_b, valid_b, tables[name], params)
               for i, name in enumerate(dict_names)]
    if len(dict_names) > 1 and params.cross_dict_arbitration:
        inf = torch.full((), math.inf, device=device)
        soft = torch.stack([torch.where(ok, sd, inf)
                            for (_, _, _, ok, sd) in decoded])
        best = torch.argmin(soft, dim=0)
        decoded = [(mid, rot, crn, ok & (best == i), sd)
                   for i, (mid, rot, crn, ok, sd) in enumerate(decoded)]
    out = {}
    for i, name in enumerate(dict_names):
        mid, _, corners, ok, _ = decoded[i]
        if nw > 1:
            ok = suppress_duplicates(mid, corners, ok)
        out[name] = {"ids": torch.where(ok, mid, torch.full_like(mid, -1)),
                     "corners": corners, "valid": ok}
    return out
