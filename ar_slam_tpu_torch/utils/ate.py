# Copied from ar_slam_tpu/utils/ate.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Absolute trajectory error (ATE) between two maps.

BASELINE.json bounds map quality by "ATE/reprojection": reprojection RMSE
comes from the solver; this module provides the trajectory side — RMSE of
camera positions after the best similarity (Umeyama) alignment, since the
gauge (and with unknown intrinsics the scale) is free.
"""

from __future__ import annotations

import numpy as np


def camera_positions(store) -> np.ndarray:
    """(C, 3) world positions of the cameras: p = -t_inv in the stored
    inverse-pose convention (rotation applies after translation, so the
    camera center is where p_w + t_inv = 0)."""
    return np.stack([-c.inv_pose[0:3] for c in store.captures])


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Similarity transform (s, R, t) minimizing ||y - (s R x + t)||²."""
    mx, my = x.mean(axis=0), y.mean(axis=0)
    xc, yc = x - mx, y - my
    cov = yc.T @ xc / len(x)
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1
    rot = u @ s_fix @ vt
    if with_scale:
        var_x = (xc**2).sum() / len(x)
        scale = float(np.trace(np.diag(d) @ s_fix) / var_x)
    else:
        scale = 1.0
    t = my - scale * rot @ mx
    return scale, rot, t


def ate_rmse(positions_a: np.ndarray, positions_b: np.ndarray,
             with_scale: bool = True) -> float:
    """RMSE of aligned camera positions (meters)."""
    if len(positions_a) != len(positions_b):
        raise ValueError("trajectories must have equal length")
    if len(positions_a) < 3:
        raise ValueError("need at least 3 poses for similarity alignment")
    s, r, t = umeyama_alignment(positions_a, positions_b, with_scale)
    aligned = (s * (r @ positions_a.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - positions_b) ** 2, axis=1))))


def map_ate(store_a, store_b, with_scale: bool = True) -> float:
    """ATE between two maps' camera trajectories, matched by capture uid."""
    uids = [c.uid for c in store_a.captures if c.uid in store_b.capture_map]
    if len(uids) < 3:
        raise ValueError("fewer than 3 shared captures")
    pa = np.stack([-store_a.captures[store_a.capture_map[u]].inv_pose[0:3]
                   for u in uids])
    pb = np.stack([-store_b.captures[store_b.capture_map[u]].inv_pose[0:3]
                   for u in uids])
    return ate_rmse(pa, pb, with_scale)
