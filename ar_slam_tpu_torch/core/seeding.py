"""Pose seeding (port of ar_slam_tpu/core/seeding.py).

Two families, and the choice between them by residual:

1. the reference's frontal heuristics (calcInitValues / initCapturePose /
   initArPose, ar_slam_util.cpp:52-128): depth from the longest rect edge,
   x/y from the corner centroid, in-plane rotation from a running average
   of per-corner angles; no out-of-plane rotation;
2. the tag homography (Zhang) decomposed with K = diag(f, f, 1): the full
   6-DoF tag pose in the camera frame.

``seed_tag_pose`` / ``seed_capture_pose`` keep the candidate of lower
reprojection residual ("hybrid"), or the frontal one ("frontal", parity).
Functions broadcast over leading axes (several corner sets at once).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from ar_slam_tpu_torch.core.lie import (axis_angle_rotate,
                                        axis_angle_to_quaternion,
                                        compose_axis_angle,
                                        matrix_to_axis_angle,
                                        normalize_angle,
                                        quaternion_to_axis_angle)
from ar_slam_tpu_torch.core.projection import aruco_directions, block_residual


def calc_init_values(corners, focal, aruco_size):
    """(..., 4, 2) rect -> (..., 4) [local_x, local_y, local_z, rot_z] of
    the tag in the camera frame."""
    nxt = torch.roll(corners, shifts=-1, dims=-2)
    edge_sq = torch.sum((corners - nxt) ** 2, dim=-1)
    max_edge = torch.sqrt(torch.amax(edge_sq, dim=-1))
    center = torch.mean(corners, dim=-2)
    d = aruco_directions(corners.dtype, corners.device)
    expected = torch.atan2(d[:, 1], d[:, 0])
    actual = torch.atan2(corners[..., 1] - center[..., None, 1],
                         corners[..., 0] - center[..., None, 0])
    delta = normalize_angle(actual - expected)
    # sequential running average, order-dependent through the normalize
    avg = delta[..., 0]
    for idx in range(1, 4):
        avg = avg + normalize_angle(delta[..., idx] - avg) / (idx + 1)
    local_z = focal * aruco_size / max_edge
    local_x = center[..., 0] * local_z / focal
    local_y = center[..., 1] * local_z / focal
    return torch.stack([local_x, local_y, local_z, avg], dim=-1)


def _z_rot(angle):
    zero = torch.zeros_like(angle)
    return torch.stack([zero, zero, angle], dim=-1)


def init_capture_pose(corners, camera, ar_pose, aruco_size):
    """A capture's INVERSE pose from one observed tag of known pose
    (≙ initCapturePose, ar_slam_util.cpp:91-108)."""
    vals = calc_init_values(corners, camera[..., 0], aruco_size)
    inv_rot = compose_axis_angle(_z_rot(vals[..., 3]), -ar_pose[..., 3:6])
    inv_t = axis_angle_rotate(-inv_rot, vals[..., 0:3]) - ar_pose[..., 0:3]
    return torch.cat([inv_t, inv_rot], dim=-1)


def init_ar_pose(corners, camera, inv_cap_pose, aruco_size):
    """A tag's pose from one observing capture of known pose
    (≙ initArPose, ar_slam_util.cpp:111-128)."""
    vals = calc_init_values(corners, camera[..., 0], aruco_size)
    cap_rotation = -inv_cap_pose[..., 3:6]
    ar_t = axis_angle_rotate(cap_rotation, vals[..., 0:3]) - inv_cap_pose[
        ..., 0:3]
    ar_rot = compose_axis_angle(cap_rotation, _z_rot(vals[..., 3]))
    return torch.cat(torch.broadcast_tensors(ar_t, ar_rot), dim=-1)


def homography_from_corners(corners, aruco_size):
    """Exact DLT homography tag plane -> observed corners, (..., 3, 3)."""
    dtype = corners.dtype
    src = aruco_directions(dtype, corners.device) * (0.5 * aruco_size)
    one = torch.ones_like(corners[..., 0, 0])
    zero = torch.zeros_like(one)
    rows, rhs = [], []
    for i in range(4):
        x, y = src[i, 0] + zero, src[i, 1] + zero
        u, v = corners[..., i, 0], corners[..., i, 1]
        rows.append(torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y],
                                dim=-1))
        rows.append(torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y],
                                dim=-1))
        rhs += [u, v]
    # solve_ex: a singular system gives non-finite values, as in the
    # reference, instead of raising
    h8 = torch.linalg.solve_ex(torch.stack(rows, dim=-2),
                               torch.stack(rhs, dim=-1)).result
    return torch.cat([h8, one[..., None]], dim=-1).reshape(
        corners.shape[:-2] + (3, 3))


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def tag_pose_in_camera_homography(corners, focal, aruco_size):
    """(rot_aa (..., 3), t (..., 3)) with p_cam = R(rot) p_tag + t."""
    h = homography_from_corners(corners, aruco_size)
    f = focal[..., None]
    m = torch.stack([h[..., 0, :] / f, h[..., 1, :] / f, h[..., 2, :]],
                    dim=-2)
    m1, m2, m3 = m[..., :, 0], m[..., :, 1], m[..., :, 2]
    lam = 2.0 / (_norm(m1) + _norm(m2) + 1e-30)
    # projective sign: the tag sits in front of the camera
    sign = torch.where(m3[..., 2:3] * lam > 0, 1.0, -1.0).to(m.dtype)
    m1, m2, m3 = sign * m1, sign * m2, sign * m3
    t = lam * m3
    r1 = m1 / (_norm(m1) + 1e-30)
    r2 = m2 - r1 * torch.sum(r1 * m2, dim=-1, keepdim=True)
    r2 = r2 / (_norm(r2) + 1e-30)
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    rot = torch.stack([r1, r2, r3], dim=-1)  # columns
    return matrix_to_axis_angle(rot), t


def init_ar_pose_homography(corners, camera, inv_cap_pose, aruco_size):
    """Tag world pose: p_world = R(-inv_rot)(R_cam p_tag + t_cam) - inv_t."""
    rot_cam, t_cam = tag_pose_in_camera_homography(corners, camera[..., 0],
                                                   aruco_size)
    cap_rotation = -inv_cap_pose[..., 3:6]
    ar_t = axis_angle_rotate(cap_rotation, t_cam) - inv_cap_pose[..., 0:3]
    ar_rot = compose_axis_angle(cap_rotation, rot_cam)
    return torch.cat(torch.broadcast_tensors(ar_t, ar_rot), dim=-1)


def init_capture_pose_homography(corners, camera, ar_pose, aruco_size):
    """Capture INVERSE pose: R_inv = R_cam R_wt^T, t_inv = R(-inv_rot) t_cam
    - ar_t."""
    rot_cam, t_cam = tag_pose_in_camera_homography(corners, camera[..., 0],
                                                   aruco_size)
    inv_rot = compose_axis_angle(rot_cam, -ar_pose[..., 3:6])
    inv_t = axis_angle_rotate(-inv_rot, t_cam) - ar_pose[..., 0:3]
    return torch.cat([inv_t, inv_rot], dim=-1)


def _rect_cost(camera, inv_cap_pose, tag_pose, corners, aruco_size):
    r = block_residual(camera, inv_cap_pose, tag_pose, corners, aruco_size)
    c = torch.sum(r * r, dim=-1)
    return torch.where(torch.isfinite(c), c, torch.full_like(c, float("inf")))


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def seed_tag_pose(corners, camera, inv_cap_pose, aruco_size,
                  mode: str = "hybrid"):
    """Seed tag world poses from one observing capture: (..., 4, 2) ->
    (..., 6)."""
    frontal = init_ar_pose(corners, camera, inv_cap_pose, aruco_size)
    if mode == "frontal":
        return frontal
    homog = _finite_or_zero(init_ar_pose_homography(corners, camera,
                                                    inv_cap_pose, aruco_size))
    c_f = _rect_cost(camera, inv_cap_pose, frontal, corners, aruco_size)
    c_h = _rect_cost(camera, inv_cap_pose, homog, corners, aruco_size)
    return torch.where((c_h < c_f)[..., None], homog, frontal)


def seed_capture_pose(corners, camera, ar_pose, aruco_size,
                      mode: str = "hybrid"):
    """Seed capture inverse poses from one observed known tag each."""
    frontal = init_capture_pose(corners, camera, ar_pose, aruco_size)
    if mode == "frontal":
        return frontal
    homog = _finite_or_zero(init_capture_pose_homography(corners, camera,
                                                         ar_pose, aruco_size))
    c_f = _rect_cost(camera, frontal, ar_pose, corners, aruco_size)
    c_h = _rect_cost(camera, homog, ar_pose, corners, aruco_size)
    return torch.where((c_h < c_f)[..., None], homog, frontal)


def seed_capture_pose_multi(anchor_corners, camera, anchor_tag_poses,
                            anchor_mask, aruco_size, mode: str = "hybrid"):
    """Seed one capture's inverse pose from ALL its observations of
    already-initialized tags: per-anchor candidates plus their masked
    position / quaternion mean, the one of lowest total anchor cost, then
    three guarded Gauss-Newton steps against the anchors.  With exactly
    one valid anchor the single-anchor candidate is returned as it is
    (the reference's init_block seed).

    anchor_corners (S, 4, 2), anchor_tag_poses (S, 6), anchor_mask (S,).
    """
    dtype = anchor_corners.dtype
    cands = seed_capture_pose(anchor_corners, camera, anchor_tag_poses,
                              aruco_size, mode=mode)  # (S, 6)
    m = anchor_mask.to(dtype)
    denom = torch.clamp(m.sum(), min=1.0)
    pos_mean = (cands[:, 0:3] * m[:, None]).sum(0) / denom
    q = axis_angle_to_quaternion(cands[:, 3:6])
    first_i = torch.argmax(anchor_mask.to(torch.int32))
    q0 = q[first_i]
    sign = torch.where(torch.sum(q * q0, dim=-1, keepdim=True) < 0.0, -1.0,
                       1.0).to(dtype)
    qm = (q * sign * m[:, None]).sum(0)
    qm = qm / torch.clamp(_norm(qm), min=1e-12)
    mean_pose = torch.cat([pos_mean, quaternion_to_axis_angle(qm)])
    all_cands = torch.cat([cands, mean_pose[None]], dim=0)  # (S+1, 6)

    def total_cost(pose):
        costs = _rect_cost(camera, pose[..., None, :], anchor_tag_poses,
                           anchor_corners, aruco_size)
        return torch.sum(torch.where(anchor_mask, costs,
                                     torch.zeros_like(costs)), dim=-1)

    scores = total_cost(all_cands)  # (S+1,)
    scores = torch.cat([torch.where(anchor_mask, scores[:-1],
                                    torch.full_like(scores[:-1],
                                                    float("inf"))),
                        scores[-1:]])
    best = all_cands[torch.argmin(scores)]

    def anchor_residuals(pose):
        rs = block_residual(camera, pose, anchor_tag_poses, anchor_corners,
                            aruco_size)  # (S, 8)
        rs = torch.where(anchor_mask[:, None], rs, torch.zeros_like(rs))
        return _finite_or_zero(rs).reshape(-1)

    eye = torch.eye(6, dtype=dtype, device=best.device)
    for _ in range(3):
        r = anchor_residuals(best)
        jac = jacfwd(anchor_residuals)(best)  # (S*8, 6)
        h = jac.T @ jac + 1e-4 * eye
        new = best - torch.linalg.solve_ex(h, jac.T @ r).result
        new = torch.where(torch.isfinite(new), new, best)
        best = torch.where(total_cost(new) < total_cost(best), new, best)
    return torch.where(m.sum() == 1.0, cands[first_i], best)
