"""Camera model and reprojection residuals (port of
ar_slam_tpu/core/projection.py).

Tag corners sit at (+-size/2, +-size/2, 0) in the tag frame; world point
p_w = R(tag_rot) c + tag_t; camera point from the capture's stored INVERSE
pose, translate then rotate: p_c = R(inv_rot) (p_w + inv_t); pinhole
uv = focal (x/z, y/z) in centered pixel coordinates, with the reference's
carried-but-disabled radial terms behind ``distortion``.  Corner order
TL, TR, BR, BL.  Functions broadcast over leading axes, and
``project_corners`` / ``block_residual`` take jets (core/jet.py) for the
camera and the poses, which gives the residuals' Jacobians with them.
"""

from __future__ import annotations

import torch

from ar_slam_tpu_torch.core import jet as J
from ar_slam_tpu_torch.core.lie import axis_angle_rotate

ARUCO_DIRECTIONS = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0))


def aruco_directions(dtype=torch.float64, device=None) -> torch.Tensor:
    """(4, 2) ``ARUCO_DIRECTIONS`` made by fills on ``device``: no copy
    from the host, so the solver's CUDA graphs can capture it."""
    d = torch.full((4, 2), -1.0, dtype=dtype, device=device)
    d[1:3, 0].fill_(1.0)
    d[2:4, 1].fill_(1.0)
    return d


def tag_corners_local(aruco_size, dtype=torch.float32, device=None):
    """(4, 3) tag-frame corner positions."""
    xy = 0.5 * aruco_size * aruco_directions(dtype, device)
    return torch.cat([xy, torch.zeros((4, 1), dtype=dtype, device=device)],
                     dim=-1)


def project_corners(camera, inv_cap_pose, tag_pose, aruco_size,
                    distortion: bool = False):
    """Project the 4 corners of a tag into a capture.

    camera (..., 3) [focal, l1, l2]; inv_cap_pose, tag_pose (..., 6)
    [t(3), axis-angle(3)].  Returns (..., 4, 2) centered pixel coords.
    """
    corners = tag_corners_local(aruco_size, tag_pose.dtype, tag_pose.device)
    corners_w = (axis_angle_rotate(tag_pose[..., None, 3:6], corners)
                 + tag_pose[..., None, 0:3])
    corners_c = axis_angle_rotate(inv_cap_pose[..., None, 3:6],
                                  corners_w + inv_cap_pose[..., None, 0:3])
    # sign-preserving depth clamp keeps padded/garbage rows finite
    z = corners_c[..., 2:3]
    zv = J.value(z)
    z_safe = J.where(torch.abs(zv) < 1e-9,
                     torch.where(zv < 0, -1e-9, 1e-9).to(zv.dtype), z)
    xy = corners_c[..., 0:2] / z_safe
    if distortion:
        r2 = J.sum(xy * xy, dim=-1, keepdim=True)
        xy = xy * (1.0 + r2 * (camera[..., None, 1:2]
                               + camera[..., None, 2:3] * r2))
    return camera[..., None, 0:1] * xy


def block_residual(camera, inv_cap_pose, tag_pose, observed, aruco_size,
                   distortion: bool = False):
    """(..., 8) residual projected - observed, interleaved (x0, y0, ...)
    like the reference ArucoReprojectionError."""
    projected = project_corners(camera, inv_cap_pose, tag_pose, aruco_size,
                                distortion)
    return (projected - observed).reshape(projected.shape[:-2] + (8,))


def reprojection_residuals(camera, inv_cap_poses, tag_poses, blocks,
                           aruco_size):
    """(B, 8) residuals over a padded block table: ``blocks`` holds
    ``cap_idx`` (B,), ``tag_idx`` (B,), ``corners`` (B, 4, 2) and ``mask``
    (B,) bool; rows with mask False are zeroed."""
    r = block_residual(camera, inv_cap_poses[blocks["cap_idx"]],
                       tag_poses[blocks["tag_idx"]], blocks["corners"],
                       aruco_size)
    return r * blocks["mask"][:, None].to(r.dtype)
