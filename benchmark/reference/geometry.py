"""The plain reference of the reprojection model, in PyTorch.

A tag's corners sit at (+-s/2, +-s/2, 0) in its frame (order TL, TR, BR,
BL); a world point is R(tag_rot) c + tag_t; a capture stores its INVERSE
pose, so the camera point is R(inv_rot) (p_w + inv_t); the pinhole gives
centered pixels focal * (x/z, y/z).  Rotations are axis-angle vectors,
turned into matrices by Rodrigues' formula and applied by matrix products.

Jacobians are written out: d(R(r) p)/dr = -R(r) [p]x Jr(r), with Jr the
right Jacobian of SO(3).  ``precision`` selects the arithmetic:
"f64" (float64), "f32" (float32), or "tf32" / "bf16" (float32 with the
operands of every matrix product rounded to 10 / 7 mantissa bits, as a
tensor core reads them; the control of the benchmark's comparisons).

Imports nothing of the program under test.
"""

from __future__ import annotations

import torch

DIRECTIONS = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0))
MANTISSA_BITS = {"tf32": 10, "bf16": 7}


def dtype_of(precision: str) -> torch.dtype:
    return torch.float64 if precision == "f64" else torch.float32


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a tensor core of ``precision`` reads it: float32 with the
    mantissa rounded to nearest (ties to even) at MANTISSA_BITS."""
    bits = MANTISSA_BITS.get(precision)
    if bits is None:
        return x
    drop = 23 - bits
    i = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (i >> drop) & 1
    i = (i + ((1 << (drop - 1)) - 1) + lsb) & ~((1 << drop) - 1)
    return i.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b with both operands rounded to ``precision``."""
    return rounded(a, precision) @ rounded(b, precision)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices [v]x."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.stack([z, -w, y], -1),
                        torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def _coefficients(r: torch.Tensor):
    """sin(t)/t, (1 - cos t)/t^2, (t - sin t)/t^3 of t = |r|, by their
    series where t is small."""
    t2 = (r * r).sum(-1)
    small = t2 < 1e-6
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (t - torch.sin(t)) / (t2s * t))
    return a, b, c


def rotation(r: torch.Tensor, precision: str = "f64") -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrices."""
    a, b, _ = _coefficients(r)
    k = skew(r)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + a[..., None, None] * k + b[..., None, None] * mm(
        k, k, precision)


def right_jacobian(r: torch.Tensor, precision: str = "f64") -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) Jr(r): R(r + d) ~ R(r) Exp(Jr(r) d)."""
    _, b, c = _coefficients(r)
    k = skew(r)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye - b[..., None, None] * k + c[..., None, None] * mm(
        k, k, precision)


def corners_local(aruco_size: float, dtype, device) -> torch.Tensor:
    """(4, 3) tag-frame corners."""
    d = torch.tensor(DIRECTIONS, dtype=dtype, device=device)
    return torch.cat([0.5 * aruco_size * d,
                      torch.zeros((4, 1), dtype=dtype, device=device)], 1)


def project(focal, inv_caps, tags, aruco_size: float, precision: str = "f64",
            jacobians: bool = False):
    """Centered pixels (B, 4, 2) of each block's tag corners, for
    ``inv_caps`` (B, 6) and ``tags`` (B, 6) and a scalar ``focal``.

    With ``jacobians``: also the depths (B, 4) and d uv / d focal (B, 8, 1),
    d uv / d inv_cap (B, 8, 6), d uv / d tag (B, 8, 6), the residual rows
    interleaved x0, y0, x1, ... as ``residuals`` lays them out."""
    dt, dev = inv_caps.dtype, inv_caps.device
    c = corners_local(aruco_size, dt, dev)
    rt = rotation(tags[:, 3:6], precision)
    rc = rotation(inv_caps[:, 3:6], precision)
    p_w = mm(c.expand(tags.shape[0], 4, 3), rt.transpose(1, 2),
             precision) + tags[:, None, 0:3]
    q = p_w + inv_caps[:, None, 0:3]
    p_c = mm(q, rc.transpose(1, 2), precision)
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    xy = torch.stack([x / z, y / z], -1)
    uv = focal * xy
    if not jacobians:
        return uv
    b = tags.shape[0]
    zero = torch.zeros_like(z)
    inv_z = 1.0 / z
    # d uv / d p_c: (B, 4, 2, 3)
    d_pc = focal * torch.stack([
        torch.stack([inv_z, zero, -x * inv_z * inv_z], -1),
        torch.stack([zero, inv_z, -y * inv_z * inv_z], -1)], -2)
    rc4 = rc[:, None].expand(b, 4, 3, 3)
    # d p_c / d inv_cap = [R_c, -R_c [q]x Jr(r_c)]
    d_cap_rot = -mm(mm(rc4, skew(q), precision),
                    right_jacobian(inv_caps[:, 3:6], precision)[:, None],
                    precision)
    d_cap = torch.cat([mm(d_pc, rc4, precision),
                       mm(d_pc, d_cap_rot, precision)], -1)
    # d p_w / d tag = [I, -R_t [c]x Jr(r_t)], then through R_c
    d_tag_rot = -mm(mm(rt[:, None].expand(b, 4, 3, 3),
                       skew(c).expand(b, 4, 3, 3), precision),
                    right_jacobian(tags[:, 3:6], precision)[:, None],
                    precision)
    d_pc_w = mm(d_pc, rc4, precision)
    d_tag = torch.cat([d_pc_w, mm(d_pc_w, d_tag_rot, precision)], -1)
    return (uv, z, xy.reshape(b, 8, 1), d_cap.reshape(b, 8, 6),
            d_tag.reshape(b, 8, 6))


def residuals(focal, inv_caps, tags, observed, aruco_size: float,
              precision: str = "f64") -> torch.Tensor:
    """(B, 8) projected - observed, interleaved x0, y0, x1, ..."""
    uv = project(focal, inv_caps, tags, aruco_size, precision)
    return (uv - observed).reshape(observed.shape[0], 8)


def cost(focal, cap_poses, tag_poses, cap_idx, tag_idx, observed,
         aruco_size: float, chunk: int = 1 << 18) -> float:
    """0.5 * the sum of squared residuals, in float64, over blocks
    (cap_idx, tag_idx, observed (B, 4, 2)), in chunks of blocks."""
    f64 = torch.float64
    caps, tags = cap_poses.to(f64), tag_poses.to(f64)
    focal = torch.as_tensor(focal, dtype=f64, device=caps.device)
    total = torch.zeros((), dtype=f64, device=caps.device)
    for s in range(0, cap_idx.shape[0], chunk):
        ci, ti = cap_idx[s:s + chunk], tag_idx[s:s + chunk]
        r = residuals(focal, caps[ci], tags[ti],
                      observed[s:s + chunk].to(f64), aruco_size)
        total += (r * r).sum()
    return 0.5 * float(total)
