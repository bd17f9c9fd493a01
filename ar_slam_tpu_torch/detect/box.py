"""K1: edge-padded win x win box sums (port of detect/pallas_box.py), in
the detection path's two uses.

- ``threshold_batch``: the adaptive threshold of the (N, H, W) frames at
  every window, count-pooled d x d, as (len(windows) * N, ceil(H / d),
  ceil(W / d)) bool planes, window-major.  On uint8 frames on the card one
  launch of ``csrc/box.cu:threshold_tile`` reads each frame once with exact
  integer box sums and takes the float32 compare from ``threshold_table``;
  float frames take ``box_sum_batch`` and torch ops.
- ``box_sum_batch``: float32 box sums (the corner-refine field maps), one
  launch of ``csrc/box.cu:box_tile``.

Every box sum is a direct sum of its taps, rows first and then columns, in
the same order in kernel and plain version, so no large prefix sum is
cancelled in float32 (the reference's prefix-sum difference loses ~1e-4
relative on the corner-refine field maps).  On a CPU tensor each wrapper
runs its plain version.

Replaces: ar_slam_tpu/detect/pallas_box.py ``_row_kernel``/``_col_kernel``
(via ``_scan_pass`` <- ``_box_1d`` <- ``box_sum_batch``), which the
reference calls in ``tpu_detect.detect_batch`` (threshold) and
``refine_corners_batched`` (field maps).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ar_slam_tpu_torch import cuda

launches = 0  # box_sum_batch kernel launches since the last reset
threshold_launches = 0  # threshold_batch kernel launches since the last reset
_tables = {}  # (windows, thresh_c, device) -> device_table


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
    out = torch.empty_like(imgs)
    cuda.check(lib.arslam_box_sum(imgs.data_ptr(), out.data_ptr(), n, h, w,
                                  win, cuda.stream()), "arslam_box_sum")
    launches += 1
    return out


def _threshold(frames: torch.Tensor, windows, thresh_c: float, d: int,
               box_sum) -> torch.Tensor:
    """Dark where pixel < box mean - thresh_c in float32 (the division a
    true division: a CPU-scalar divisor would make a CUDA kernel multiply
    by its reciprocal), then the d x d count pool."""
    x = frames.to(torch.float32)
    area = [torch.full((), float(win * win), device=x.device)
            for win in windows]
    binary = torch.cat([x < box_sum(x, win) / a - thresh_c
                        for win, a in zip(windows, area)])
    if d > 1:
        m, h, w = binary.shape
        hd, wd = -(-h // d), -(-w // d)
        if (hd * d, wd * d) != (h, w):
            pad = torch.zeros((m, hd * d, wd * d), dtype=torch.bool,
                              device=x.device)
            pad[:, :h, :w] = binary
            binary = pad
        counts = binary.reshape(m, hd, d, wd, d).to(torch.int32).sum((2, 4))
        binary = counts >= (d * d + 1) // 2
    return binary.contiguous()


def threshold_plain(frames: torch.Tensor, windows, thresh_c: float,
                    decimate: int) -> torch.Tensor:
    """``threshold_batch`` in plain PyTorch (float32 direct box sums, exact
    on integer frames)."""
    return _threshold(frames, tuple(windows), thresh_c, max(int(decimate), 1),
                      box_sum_plain)


def threshold_table(windows, thresh_c: float) -> np.ndarray:
    """(len(windows), 256) int32: for each window and pixel value p, the
    least window sum s with p < s / win^2 - thresh_c in float32 (true
    division, as ``threshold_plain`` computes it), or 255 * win^2 + 1 where
    no sum reaches it.  The compare is monotone in s, so on integer frames
    ``sum >= table[p]`` is that float32 compare exactly."""
    out = np.empty((len(windows), 256), np.int32)
    for i, win in enumerate(windows):
        area = win * win
        sums = np.arange(255 * area + 1, dtype=np.float32)
        mean_c = sums / np.float32(area) - np.float32(thresh_c)
        out[i] = np.searchsorted(mean_c, np.arange(256, dtype=np.float32),
                                 side="right")
    return out


def device_table(windows, thresh_c: float, device) -> torch.Tensor:
    """``threshold_table`` on ``device``, kept per (windows, constant,
    card) from its first upload on: a compiled program (detect/detect.py)
    fetches it when it is built, since an upload cannot be captured."""
    key = (tuple(int(win) for win in windows), float(thresh_c),
           torch.device(device))
    if key not in _tables:
        _tables[key] = torch.from_numpy(threshold_table(
            key[0], key[1])).to(key[2])
    return _tables[key]


def threshold_batch(frames: torch.Tensor, windows, thresh_c: float,
                    decimate: int) -> torch.Tensor:
    """(N, H, W) frames -> (len(windows) * N, ceil(H / d), ceil(W / d))
    bool, window-major: pixel < edge-padded win x win mean - thresh_c
    (float32), then dark where >= (d^2 + 1) // 2 of each d x d block is
    (zero padding beyond the frame); d = max(decimate, 1)."""
    global threshold_launches
    windows = tuple(int(win) for win in windows)
    d = max(int(decimate), 1)
    if any(win % 2 == 0 for win in windows):
        raise ValueError(f"box windows must be odd, got {windows}")
    if frames.device.type == "cpu":
        return threshold_plain(frames, windows, thresh_c, d)
    if frames.dtype != torch.uint8:
        return _threshold(frames, windows, thresh_c, d, box_sum_batch)
    cuda.require(frames, "frames", torch.uint8, 3)
    lib = cuda.library()
    if (len(windows) > lib.arslam_threshold_max_windows()
            or max(windows) // 2 > lib.arslam_box_max_radius()):
        raise ValueError(f"windows {windows} exceed the kernel's maximum")
    table = device_table(windows, thresh_c, frames.device)
    n, h, w = frames.shape
    out = torch.empty((len(windows) * n, -(-h // d), -(-w // d)),
                      dtype=torch.bool, device=frames.device)
    wins = (ctypes.c_int * len(windows))(*windows)
    cuda.check(lib.arslam_threshold(frames.data_ptr(), table.data_ptr(),
                                    out.data_ptr(), n, h, w, wins,
                                    len(windows), d, cuda.stream()),
               "arslam_threshold")
    threshold_launches += 1
    return out
