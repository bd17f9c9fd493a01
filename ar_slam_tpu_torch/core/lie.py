"""Axis-angle rotation algebra, autodiff-safe at theta -> 0 (port of
ar_slam_tpu/core/lie.py).

Conventions are the reference's: an axis-angle vector's direction is the
rotation axis and its norm the angle; quaternions are (w, x, y, z).

Every function works on the last axis and broadcasts over leading axes, so
the same code serves one block and a whole batch.  ``axis_angle_rotate``
also takes jets (core/jet.py) for its operands, which gives the rotated
points' forward-mode derivatives with their values.  Each sin/cos ratio
switches to its Taylor series under ``theta^2 < 1e-12`` with the
double-where trick, so values and forward-mode derivatives stay finite
at exactly zero.
"""

from __future__ import annotations

import math

import torch

import ar_slam_tpu_torch.device  # noqa: F401  (switches TF32 off)
from ar_slam_tpu_torch.core import jet as J

_SMALL_SQ = 1e-12


def _safe_ratio(theta_sq, closed_form_fn, series_fn):
    """closed_form_fn(theta_sq) where theta_sq is large, the series
    elsewhere, with NaN-free derivatives (double-where trick); a tensor
    or a jet."""
    t2 = J.value(theta_sq)
    small = t2 < _SMALL_SQ
    safe = J.where(small, torch.ones_like(t2), theta_sq)
    return J.where(small, series_fn(theta_sq), closed_form_fn(safe))


def axis_angle_rotate(aa, p):
    """Rotate points ``p`` (..., 3) by axis-angle ``aa`` (..., 3):
    R p = p cos t + (aa x p) sin(t)/t + aa (aa . p) (1 - cos t)/t^2.
    Either operand may be a jet; the result is one if either is."""
    theta_sq = J.sum(aa * aa, dim=-1, keepdim=True)
    cos_t = _safe_ratio(theta_sq, lambda t2: J.cos(J.sqrt(t2)),
                        lambda t2: 1.0 - t2 / 2.0 + t2 * t2 / 24.0)
    sinc = _safe_ratio(theta_sq,
                       lambda t2: J.sin(J.sqrt(t2)) / J.sqrt(t2),
                       lambda t2: 1.0 - t2 / 6.0 + t2 * t2 / 120.0)
    one_minus_cos_over_sq = _safe_ratio(
        theta_sq, lambda t2: (1.0 - J.cos(J.sqrt(t2))) / t2,
        lambda t2: 0.5 - t2 / 24.0 + t2 * t2 / 720.0)
    dot = J.sum(aa * p, dim=-1, keepdim=True)
    return (p * cos_t + J.cross(aa, p) * sinc
            + aa * (dot * one_minus_cos_over_sq))


def axis_angle_to_quaternion(aa):
    """(..., 3) axis-angle -> (..., 4) quaternion (w, x, y, z)."""
    theta_sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    w = _safe_ratio(theta_sq, lambda t2: torch.cos(0.5 * torch.sqrt(t2)),
                    lambda t2: 1.0 - t2 / 8.0 + t2 * t2 / 384.0)
    k = _safe_ratio(
        theta_sq, lambda t2: torch.sin(0.5 * torch.sqrt(t2)) / torch.sqrt(t2),
        lambda t2: 0.5 - t2 / 48.0 + t2 * t2 / 3840.0)
    return torch.cat([w, aa * k], dim=-1)


def quaternion_to_axis_angle(q):
    """(..., 4) quaternion -> (..., 3) axis-angle, the short representation
    (hemisphere flipped when w < 0, like ceres::QuaternionToAngleAxis)."""
    w = q[..., :1]
    v = q[..., 1:]
    n_sq = torch.sum(v * v, dim=-1, keepdim=True)
    small = n_sq < _SMALL_SQ
    n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    two_theta = 2.0 * torch.where(w < 0.0, torch.atan2(-n, -w),
                                  torch.atan2(n, w))
    closed = two_theta / n
    w_safe = torch.where(torch.abs(w) < 1e-30, torch.ones_like(w), w)
    series = 2.0 / w_safe * (1.0 - n_sq / (3.0 * w * w))
    return v * torch.where(small, series, closed)


def quaternion_product(q1, q2):
    """Hamilton product, (w, x, y, z) order (≙ ceres::QuaternionProduct)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def compose_axis_angle(rot1, rot2):
    """q(rot1) * q(rot2) as axis-angle (applying the result == applying
    rot2 first; the reference's composeAxisAngle)."""
    q1 = axis_angle_to_quaternion(rot1)
    q2 = axis_angle_to_quaternion(rot2)
    q1, q2 = torch.broadcast_tensors(q1, q2)
    return quaternion_to_axis_angle(quaternion_product(q1, q2))


def invert_axis_angle(aa):
    """The inverse rotation: the negated axis-angle."""
    return -aa


def axis_angle_to_matrix(aa):
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    cols = [axis_angle_rotate(aa, eye[i]) for i in range(3)]
    return torch.stack(cols, dim=-1)


def matrix_to_quaternion(m):
    """(..., 3, 3) rotation matrix -> (..., 4) quaternion, robust at every
    angle (Shepperd's method, branch-free)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def s_of(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

    s = s_of(1.0 + tr)
    cand_w = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                          (m10 - m01) / s], dim=-1)
    s = s_of(1.0 + m00 - m11 - m22)
    cand_x = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                          (m02 + m20) / s], dim=-1)
    s = s_of(1.0 - m00 + m11 - m22)
    cand_y = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                          (m12 + m21) / s], dim=-1)
    s = s_of(1.0 - m00 - m11 + m22)
    cand_z = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                          0.25 * s], dim=-1)
    use_w = (tr > m00) & (tr > m11) & (tr > m22) | (tr > 0.0)
    use_x = (m00 >= m11) & (m00 >= m22) & ~use_w
    use_y = (m11 > m00) & (m11 >= m22) & ~use_w
    q = torch.where(use_w[..., None], cand_w,
                    torch.where(use_x[..., None], cand_x,
                                torch.where(use_y[..., None], cand_y, cand_z)))
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def matrix_to_axis_angle(m):
    """(..., 3, 3) rotation matrix -> (..., 3) axis-angle."""
    return quaternion_to_axis_angle(matrix_to_quaternion(m))


def normalize_angle(angle):
    """Wrap to [-pi, pi) (≙ normalize_angle, ar_slam_util.hpp:348-351)."""
    two_pi = 2.0 * math.pi
    return torch.remainder(torch.remainder(angle, two_pi) + 3.0 * math.pi,
                           two_pi) - math.pi
