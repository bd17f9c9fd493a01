"""K6: the run scores of top-K component ranking (``top_k_components``).

A stable sort of each row of pooled labels puts every component's cells
in one run, in grid order.  At the end of each run of a label other than
2^30 the ranking needs the run's length (the component's area) and its
row span, from the largest first position of the runs up to it (the
reference's cummax; a lower label can first appear later in the grid):
``score = area * (2 - min(fill, 1))``, ``fill = area / span^2``, with
components above ``max_area`` demoted to ``0.5 + area / (2P + 1)``.
Every other cell scores 0.

``run_scores`` launches ``csrc/rank.cu`` on a CUDA tensor (one pass, a
thread for 8 cells, the grid over every cell of every row) and runs
``run_scores_plain`` (the reference's two scans and the chain around
them, in PyTorch) on a CPU tensor.  The kernel equals the plain version
on the CPU bit for bit.

Replaces: ar_slam_tpu/detect/tpu_detect.py ``_top_k_components``' two
``lax.cummax`` scans and the elementwise chain around them (XLA).
"""

from __future__ import annotations

import numpy as np
import torch

from ar_slam_tpu_torch import cuda

BIG = 2**30
TILE = 2048  # cells a block (csrc/rank.cu kTile)
launches = 0  # wrapper calls since the last reset (CUDA path only)


def run_scores_plain(s: torch.Tensor, sp: torch.Tensor, grid_w: int,
                     max_area: float | None = None):
    """(B, P) sorted labels and their grid positions -> (score, area),
    both (B, P) float32: the reference's cummax of the run starts and the
    chain after it."""
    b, p = s.shape
    pos = torch.arange(p, dtype=torch.int64, device=s.device).expand(b, p)
    one = torch.ones((b, 1), dtype=torch.bool, device=s.device)
    diff = s[:, 1:] != s[:, :-1]
    is_start = torch.cat([one, diff], dim=1)
    is_end = torch.cat([diff, one], dim=1)
    neg1 = torch.full_like(pos, -1)
    start_pos = torch.cummax(torch.where(is_start, pos, neg1), dim=1).values
    cand_len = torch.where(is_end & (s != BIG), pos - start_pos + 1,
                           torch.zeros_like(pos))
    first_gp = torch.cummax(torch.where(is_start, sp, neg1), dim=1).values
    span = torch.div(sp, grid_w, rounding_mode="floor") - torch.div(
        first_gp, grid_w, rounding_mode="floor") + 1
    area_f = cand_len.to(torch.float32)
    fill = area_f / torch.clamp(span * span, min=1).to(torch.float32)
    score = area_f * (2.0 - torch.clamp(fill, max=1.0))
    if max_area is not None:
        score = torch.where(area_f <= max_area, score,
                            0.5 + area_f / (2.0 * float(p) + 1.0))
    return score, area_f


def run_scores(s: torch.Tensor, sp: torch.Tensor, grid_w: int,
               max_area: float | None = None):
    """(B, P) int32 labels sorted along each row, (B, P) int64 grid
    positions in [0, P) -> (score, area), both (B, P) float32."""
    global launches
    if s.device.type == "cpu":
        return run_scores_plain(s, sp, grid_w, max_area)
    cuda.require(s, "s", torch.int32, 2)
    cuda.require(sp, "sp", torch.int64, 2)
    if sp.shape != s.shape or sp.device != s.device:
        raise ValueError("sp must have the shape and device of s")
    b, p = s.shape
    if p >= 2**31 - 1 or grid_w <= 0:
        raise ValueError(f"rows of {p} cells, grid width {grid_w}")
    score = torch.empty((b, p), dtype=torch.float32, device=s.device)
    area = torch.empty_like(score)
    if b * p == 0:
        return score, area
    # each tile's published word, then the counter of started tiles
    ws = torch.empty(b * -(-p // TILE) + 1, dtype=torch.int64,
                     device=s.device)
    # the chain compares float32 areas with max_area rounded to float32
    limit = float(np.float32(max_area)) if max_area is not None else 0.0
    cuda.check(cuda.library().arslam_run_scores(
        s.data_ptr(), sp.data_ptr(), score.data_ptr(), area.data_ptr(),
        ws.data_ptr(), b, p, int(grid_w), int(max_area is not None), limit,
        cuda.stream()), "arslam_run_scores")
    launches += 1
    return score, area
