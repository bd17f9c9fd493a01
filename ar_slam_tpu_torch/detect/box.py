"""K1: edge-padded win x win box sums (port of detect/pallas_box.py).

``box_sum_batch`` launches the CUDA kernel ``csrc/box.cu`` on a CUDA tensor
and runs ``box_sum_plain`` on a CPU tensor.  Both form every output as a
direct sum of its taps, rows first and then columns, in the same order, so
no large prefix sum is cancelled in float32 (the reference's prefix-sum
difference loses ~1e-4 relative on the corner-refine field maps).

Replaces: ar_slam_tpu/detect/pallas_box.py ``_row_kernel``/``_col_kernel``
(via ``_scan_pass`` <- ``_box_1d`` <- ``box_sum_batch``).
"""

from __future__ import annotations

import torch

from ar_slam_tpu_torch import cuda

launches = 0  # kernel launches since the last reset (CUDA path only)


def _box_1d_plain(x: torch.Tensor, win: int, dim: int) -> torch.Tensor:
    size = x.shape[dim]
    r = win // 2
    idx = torch.arange(-r, size + r, device=x.device).clamp_(0, size - 1)
    padded = x.index_select(dim, idx)
    out = padded.narrow(dim, 0, size).clone()
    for k in range(1, win):
        out += padded.narrow(dim, k, size)
    return out


def box_sum_plain(imgs: torch.Tensor, win: int) -> torch.Tensor:
    """(N, H, W) edge-padded window sums, plain PyTorch, in the input's
    floating dtype (float32 for other inputs)."""
    x = imgs if imgs.is_floating_point() else imgs.to(torch.float32)
    return _box_1d_plain(_box_1d_plain(x, win, 2), win, 1)


def box_sum_batch(imgs: torch.Tensor, win: int) -> torch.Tensor:
    """(N, H, W) float32 edge-padded win x win sums (win odd)."""
    global launches
    if win % 2 == 0:
        raise ValueError(f"box window must be odd, got {win}")
    if imgs.device.type == "cpu":
        return box_sum_plain(imgs, win)
    cuda.require(imgs, "imgs", torch.float32, 3)
    lib = cuda.library()
    if win // 2 > lib.arslam_box_max_radius():
        raise ValueError(f"box window {win} exceeds the kernel's maximum")
    n, h, w = imgs.shape
    tmp = torch.empty_like(imgs)
    out = torch.empty_like(imgs)
    cuda.check(lib.arslam_box_sum(imgs.data_ptr(), tmp.data_ptr(),
                                  out.data_ptr(), n, h, w, win, cuda.stream()),
               "arslam_box_sum")
    launches += 1
    return out


def box_mean_batch(imgs: torch.Tensor, win: int) -> torch.Tensor:
    return box_sum_batch(imgs, win) / float(win * win)
