"""K2: 8-connected component labels (port of detect/pallas_ccl.py).

Label = the component's minimum linear index in the true width; background
= 2^30.  ``connected_components_batch`` launches the union-find CUDA kernel
``csrc/ccl.cu`` on a CUDA tensor and runs ``connected_components_plain`` on
a CPU tensor.

The plain version iterates the reference's round (3x3 min-pool, then
segmented min scans along rows and columns) until nothing changes, with no
round cap, because union-find always resolves fully.  The reference stops
after ``ccl_iters`` rounds; the two agree wherever the reference reaches its
fixpoint (a deliberate divergence only on shapes needing more rounds).

Replaces: ar_slam_tpu/detect/pallas_ccl.py ``_ccl_fused_kernel`` (via
``connected_components_fused_batch``).  The strip kernels of the same file
(K3, used above ``FUSED_CCL_PIXEL_LIMIT``) are not ported yet.
"""

from __future__ import annotations

import torch

from ar_slam_tpu_torch import cuda

BIG = 2**30
launches = 0  # kernel launches since the last reset (CUDA path only)


def _shift(x: torch.Tensor, delta: int, dim: int, fill) -> torch.Tensor:
    """Shift ``x`` by +delta along ``dim`` (values move to higher indices),
    filling the vacated cells."""
    size = x.shape[dim]
    if abs(delta) >= size:
        return torch.full_like(x, fill)
    pad_shape = list(x.shape)
    pad_shape[dim] = abs(delta)
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if delta > 0:
        return torch.cat([pad, x.narrow(dim, 0, size - delta)], dim=dim)
    return torch.cat([x.narrow(dim, -delta, size + delta), pad], dim=dim)


def _run_min_scan(labels: torch.Tensor, dim: int) -> torch.Tensor:
    """Min over each full foreground run along ``dim`` (both directions) by
    log-step doubling; foreground = label < BIG."""
    size = labels.shape[dim]
    steps = max(size - 1, 1).bit_length()
    fg = labels < BIG
    for direction in (1, -1):
        val, reach = labels, fg
        for k in range(steps):
            span = direction * (1 << k)
            val = torch.where(reach, torch.minimum(val, _shift(val, span, dim,
                                                                BIG)), val)
            reach = reach & _shift(reach, span, dim, False)
        labels = torch.minimum(labels, val)
    return labels


def _min_pool3(labels: torch.Tensor) -> torch.Tensor:
    m = torch.minimum(labels, torch.minimum(_shift(labels, 1, 1, BIG),
                                            _shift(labels, -1, 1, BIG)))
    return torch.minimum(m, torch.minimum(_shift(m, 1, 2, BIG),
                                          _shift(m, -1, 2, BIG)))


def connected_components_plain(binary: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool -> (N, H, W) int32 labels, plain PyTorch."""
    n, h, w = binary.shape
    idx = torch.arange(h * w, dtype=torch.int32,
                       device=binary.device).reshape(1, h, w)
    big = torch.tensor(BIG, dtype=torch.int32, device=binary.device)
    labels = torch.where(binary, idx, big)
    while True:
        new = torch.where(binary, torch.minimum(labels, _min_pool3(labels)),
                          big)
        new = _run_min_scan(_run_min_scan(new, 2), 1)
        if torch.equal(new, labels):
            return labels
        labels = new


def connected_components_batch(binary: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool -> (N, H, W) int32 component labels."""
    global launches
    if binary.device.type == "cpu":
        return connected_components_plain(binary)
    cuda.require(binary, "binary", torch.bool, 3)
    n, h, w = binary.shape
    labels = torch.empty((n, h, w), dtype=torch.int32, device=binary.device)
    cuda.check(cuda.library().arslam_ccl(binary.data_ptr(), labels.data_ptr(),
                                         n, h, w, cuda.stream()),
               "arslam_ccl")
    launches += 1
    return labels
