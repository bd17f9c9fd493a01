"""Batched linearization of the reprojection problem (port of
ar_slam_tpu/solve/residuals.py).

Per block (one tag seen in one capture): 8 residuals and Jacobian blocks
for the camera (3), the capture's inverse pose (6) and the tag pose (6),
like the reference's AutoDiffCostFunction<..., 8, 3, 6, 6>.  Derivatives
come from ``torch.func.jacfwd`` vmapped over the block table, as the
reference uses ``jax.jacfwd``.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from ar_slam_tpu_torch.core.projection import block_residual


def robust_weights(r, loss: str = "trivial", scale: float = 1.0):
    """Per-block IRLS weight and robust cost from raw (B, 8) residuals:
    (w (B,), rho (B,)).  'huber' is ceres' HuberLoss with a = scale."""
    s = torch.sum(r * r, dim=1)
    if loss == "trivial":
        return torch.ones_like(s), s
    if loss != "huber":
        raise ValueError(f"unknown loss {loss!r}")
    d2 = scale * scale
    root = torch.sqrt(torch.clamp(s, min=1e-30))
    rho = torch.where(s <= d2, s, 2.0 * scale * root - d2)
    w = torch.where(s <= d2, torch.ones_like(s), torch.sqrt(scale / root))
    return w, rho


def linearize(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
              block_mask, aruco_size, distortion=False,
              loss: str = "trivial", loss_scale: float = 1.0):
    """Residuals + Jacobian blocks for every row of the padded table.

    Returns r (B, 8), jc (B, 8, 3), jp (B, 8, 6), jt (B, 8, 6) and the
    per-block robust cost rho (B,); masked rows are zero, and with a
    robust loss residuals and Jacobian rows are IRLS-weighted.
    """

    def res(cam, cap_pose, tag_pose, crn):
        r = block_residual(cam, cap_pose, tag_pose, crn, aruco_size,
                           distortion)
        return r, r

    jac = jacfwd(res, argnums=(0, 1, 2), has_aux=True)
    (jc, jp, jt), r = vmap(jac, in_dims=(None, 0, 0, 0))(
        camera, cap_poses[cap_idx], tag_poses[tag_idx], corners)
    # where-based masking: padded rows may hold inf/NaN garbage
    m = block_mask[:, None]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    r = torch.where(m, r, zero)
    jc = torch.where(m[:, :, None], jc, zero)
    jp = torch.where(m[:, :, None], jp, zero)
    jt = torch.where(m[:, :, None], jt, zero)
    w, rho = robust_weights(r, loss, loss_scale)
    rho = torch.where(block_mask, rho, zero)
    if loss != "trivial":
        r = r * w[:, None]
        jc = jc * w[:, None, None]
        jp = jp * w[:, None, None]
        jt = jt * w[:, None, None]
    return r, jc, jp, jt, rho


def residuals_only(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
                   block_mask, aruco_size, distortion=False):
    """(B, 8) masked raw residuals without Jacobians."""
    r = block_residual(camera, cap_poses[cap_idx], tag_poses[tag_idx],
                       corners, aruco_size, distortion)
    return torch.where(block_mask[:, None], r,
                       torch.zeros((), dtype=r.dtype, device=r.device))


def residuals_and_rho(camera, cap_poses, tag_poses, cap_idx, tag_idx,
                      corners, block_mask, aruco_size, distortion=False,
                      loss: str = "trivial", loss_scale: float = 1.0):
    """(weighted residuals (B, 8), per-block robust cost (B,))."""
    r = residuals_only(camera, cap_poses, tag_poses, cap_idx, tag_idx,
                       corners, block_mask, aruco_size, distortion)
    w, rho = robust_weights(r, loss, loss_scale)
    rho = torch.where(block_mask, rho, torch.zeros_like(rho))
    if loss != "trivial":
        r = r * w[:, None]
    return r, rho


def total_cost(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
               block_mask, aruco_size, distortion=False,
               loss: str = "trivial", loss_scale: float = 1.0):
    """0.5 * sum of (robust) block costs (ceres cost convention)."""
    _, rho = residuals_and_rho(camera, cap_poses, tag_poses, cap_idx,
                               tag_idx, corners, block_mask, aruco_size,
                               distortion, loss, loss_scale)
    return 0.5 * torch.sum(rho)
