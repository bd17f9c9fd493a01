"""Per-block reprojection audit (port of ar_slam_tpu/utils/audit.py;
≙ ``ArSlamSolver::compareProjections`` / ``compareProjection``,
ar_slam_util.cpp:576-589 and :175-189).

The reference prints the projected vs. detected corners of every block.
Here the whole block table projects in one batched call of the solver's
residual function (``residuals_only``) on the device, and the audit
returns structured rows (capture uid, tag id, per-corner error, block
RMSE) for logging, assertions or the CLI table.
"""

from __future__ import annotations

import numpy as np
import torch

from ar_slam_tpu_torch.convert import arrays_from_numpy
from ar_slam_tpu_torch.graph.arrays import export_arrays
from ar_slam_tpu_torch.graph.store import MapStore


def compare_projections(store: MapStore, aruco_size: float = 0.0635,
                        dtype=torch.float64, device=None) -> list[dict]:
    """Return one audit row per block, ordered by descending block RMSE.
    Runs on ``device`` (default: the card; the CPU when asked for)."""
    from ar_slam_tpu_torch.solve.residuals import residuals_only

    if not store.blocks:
        return []
    t = arrays_from_numpy(export_arrays(store, dtype=np.float64), device,
                          dtype)
    r = residuals_only(t["camera"], t["cap_poses"], t["tag_poses"],
                       t["cap_idx"], t["tag_idx"], t["corners"],
                       t["block_mask"], aruco_size)
    r = r.cpu().numpy()[: len(store.blocks)].reshape(-1, 4, 2)
    rows = []
    for bh, block in enumerate(store.blocks):
        err = r[bh]
        rows.append({
            "capture": store.captures[block.cap_idx].uid,
            "aruco": store.arucos[block.tag_idx].id,
            "corner_err_px": [float(np.hypot(*e)) for e in err],
            "rmse_px": float(np.sqrt(np.mean(err ** 2) * 2.0)),
            "observed": np.asarray(block.corners, dtype=float).tolist(),
            "projected": (np.asarray(block.corners, dtype=float)
                          + err).tolist(),
        })
    rows.sort(key=lambda d: -d["rmse_px"])
    return rows


def format_audit(rows: list[dict], limit: int = 0) -> str:
    """Human-readable audit table (worst blocks first)."""
    out = []
    shown = rows[:limit] if limit else rows
    for d in shown:
        corners = " ".join(f"{e:6.2f}" for e in d["corner_err_px"])
        out.append(
            f"{d['capture']:>12s} {d['aruco']:>18s}  rmse {d['rmse_px']:7.3f}"
            f" px  corners [{corners}]"
        )
    if limit and len(rows) > limit:
        out.append(f"... {len(rows) - limit} more blocks")
    return "\n".join(out)
