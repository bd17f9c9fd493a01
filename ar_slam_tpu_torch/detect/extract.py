"""K4: per-candidate extreme-point quads (port of detect/pallas_extract.py).

For each (image, root) slot: A = the member farthest from the centroid,
C = the member farthest from A, B / D = the members of largest / smallest
signed distance from line AC; ties go to the lowest linear index (the
first-index rule of argmax).  Output (N, K, 4, 2) float32 (x, y) in A, B,
C, D order.  An empty slot (root 2^30) gives (0, 0) for all four points.

``extreme_quads`` launches ``csrc/extract.cu`` on a CUDA tensor and runs
``extreme_quads_plain`` (a PyTorch version of the reference's XLA
``tpu_detect._extreme_quads``) on a CPU tensor.  The kernel reads each
plane once for every root's sums and box, then sweeps only the boxes; a
root held by several slots fills each of them.

Replaces: ar_slam_tpu/detect/pallas_extract.py ``_extract_kernel`` (via
``_call`` <- ``extreme_quads_pallas``).
"""

from __future__ import annotations

import torch

from ar_slam_tpu_torch import cuda

BIG = 2**30
NEG = -3.0e38
WS_WORDS = 12  # 64-bit workspace words per slot (csrc/extract.cu kWs)
launches = 0  # wrapper calls since the last reset (CUDA path only)


def _extreme_one(labels_flat: torch.Tensor, roots: torch.Tensor, h: int,
                 w: int) -> torch.Tensor:
    """(P,) labels, (K,) roots -> (K, 4, 2).

    The reference's masked (K, P) reductions, evaluated over each root's
    member list instead of the whole plane: one stable sort of the labels
    puts every component's pixels in a contiguous run, in ascending linear
    index, so argmax's first-index tie-break still picks the lowest index.
    """
    dev = labels_flat.device
    order = torch.sort(labels_flat, stable=True).indices
    s = labels_flat[order]
    start = torch.searchsorted(s, roots, side="left")
    count = torch.where(roots != BIG,
                        torch.searchsorted(s, roots, side="right") - start, 0)
    span = max(int(count.max().item()) if count.numel() else 0, 1)
    j = torch.arange(span, device=dev)
    lin = order[torch.clamp(start[:, None] + j[None, :], max=h * w - 1)]
    member = j[None, :] < count[:, None]  # (K, L)
    xf = (lin % w).to(torch.float32)
    yf = (lin // w).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)

    area = member.to(torch.float32).sum(dim=1)
    area_safe = torch.clamp(area, min=1.0)[:, None]
    cx = torch.where(member, xf, zero).sum(dim=1, keepdim=True) / area_safe
    cy = torch.where(member, yf, zero).sum(dim=1, keepdim=True) / area_safe

    def arg_extreme(score):
        idx = torch.argmax(torch.where(member, score, neg), dim=1, keepdim=True)
        return torch.cat([torch.gather(xf, 1, idx), torch.gather(yf, 1, idx)],
                         dim=1)

    def sq_dist(px, py):
        dx, dy = xf - px, yf - py
        return dx * dx + dy * dy

    a = arg_extreme(sq_dist(cx, cy))
    c = arg_extreme(sq_dist(a[:, 0:1], a[:, 1:2]))
    nx = -(c[:, 1:2] - a[:, 1:2])
    ny = c[:, 0:1] - a[:, 0:1]
    sdist = nx * (xf - a[:, 0:1]) + ny * (yf - a[:, 1:2])
    b = arg_extreme(sdist)
    d = arg_extreme(-sdist)
    quads = torch.stack([a, b, c, d], dim=1)
    return torch.where((count > 0)[:, None, None], quads, zero)


def extreme_quads_plain(labels: torch.Tensor, roots: torch.Tensor
                        ) -> torch.Tensor:
    """(N, H, W) int32 labels, (N, K) int32 roots -> (N, K, 4, 2) float32."""
    n, h, w = labels.shape
    return torch.stack([_extreme_one(labels[i].reshape(-1), roots[i], h, w)
                        for i in range(n)])


def extreme_quads(labels: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """(N, H, W) int32 labels, (N, K) int32 roots -> (N, K, 4, 2) float32."""
    global launches
    if labels.device.type == "cpu":
        return extreme_quads_plain(labels, roots)
    cuda.require(labels, "labels", torch.int32, 3)
    cuda.require(roots, "roots", torch.int32, 2)
    n, h, w = labels.shape
    k = roots.shape[1]
    if roots.shape[0] != n or roots.device != labels.device:
        raise ValueError("roots must be (N, K) on the labels' device")
    dev = labels.device
    out = torch.empty((n, k, 4, 2), dtype=torch.float32, device=dev)
    # per-slot sums, box and argmax keys; the sweep tiles' prefix
    ws = torch.empty((n, k, WS_WORDS), dtype=torch.int64, device=dev)
    tile_start = torch.empty(n * k + 1, dtype=torch.int32, device=dev)
    cuda.check(cuda.library().arslam_extract(
        labels.data_ptr(), roots.data_ptr(), out.data_ptr(), ws.data_ptr(),
        tile_start.data_ptr(), n, h, w, k, cuda.stream()), "arslam_extract")
    launches += 1
    return out
