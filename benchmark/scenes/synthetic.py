"""A large synthetic tag map, as plain arrays, from seeds.

The benchmark's own copy of the program's ``utils/synthetic.
make_synthetic_map``: tags on a planar grid facing +z with a slight tilt and
a random in-plane turn, cameras above the plane looking down along a
serpentine sweep, each capture seeing the tags whose four corners project in
front of it and inside the image.  Changed from the original: the layout
(tag and camera poses) draws from ``layout_seed`` exactly as the original
does, so the same blocks exist; the projection runs in float64 on
``device``; the pixel noise draws from a ``torch.Generator`` on that device
seeded by ``noise_seed``; and instead of a map store it returns the block
table, tags and captures numbered as the store numbers them (captures with
fewer than ``min_tags_per_cap`` tags left out, tags by first sighting).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.geometry import corners_local, rotation


def layout(n_tags: int, n_caps: int, tag_spacing: float, height: float,
           layout_seed: int):
    """Tag poses (T, 6) and inverse capture poses (C, 6), float64."""
    rng = np.random.default_rng(layout_seed)
    side = int(np.ceil(np.sqrt(n_tags)))
    tag_poses = np.zeros((n_tags, 6))
    for t in range(n_tags):
        gx, gy = t % side, t // side
        tag_poses[t, 0] = (gx - (side - 1) / 2) * tag_spacing
        tag_poses[t, 1] = (gy - (side - 1) / 2) * tag_spacing
        tag_poses[t, 3:5] = rng.normal(scale=0.05, size=2)
        tag_poses[t, 5] = rng.normal(scale=0.3)
    extent = side * tag_spacing
    cap_poses = np.zeros((n_caps, 6))
    sweep_rows = max(int(np.sqrt(n_caps)), 1)
    sweep_cols = (n_caps + sweep_rows - 1) // sweep_rows
    for c in range(n_caps):
        r_i, c_i = divmod(c, sweep_cols)
        if r_i % 2 == 1:
            c_i = sweep_cols - 1 - c_i
        fx = c_i / max(sweep_cols - 1, 1)
        fy = r_i / max(sweep_rows - 1, 1)
        cx = (fx - 0.5) * extent * 0.9 + rng.normal(scale=0.05)
        cy = (fy - 0.5) * extent * 0.9 + rng.normal(scale=0.05)
        cz = height + rng.normal(scale=0.1)
        rot = np.array([np.pi, 0.0, 0.0]) + rng.normal(scale=0.08, size=3)
        cap_poses[c, 0:3] = -np.array([cx, cy, cz])
        cap_poses[c, 3:6] = rot
    return tag_poses, cap_poses


def synthetic_map(n_tags: int, n_caps: int, focal: float,
                  image_size: tuple, aruco_size: float, tag_spacing: float,
                  height: float, noise_px: float, layout_seed: int,
                  noise_seed: int, device, min_tags_per_cap: int = 2,
                  chunk: int = 64) -> dict:
    """{"cap_idx" (B,), "tag_idx" (B,) int64, "corners" (B, 4, 2) float64
    observed centered pixels, "cap_poses" (C, 6), "tag_poses" (T, 6) float64
    truth, "focal"} on ``device``; blocks in capture order, then tag
    order."""
    f64 = torch.float64
    tag_np, cap_np = layout(n_tags, n_caps, tag_spacing, height, layout_seed)
    tags = torch.as_tensor(tag_np, dtype=f64, device=device)
    caps = torch.as_tensor(cap_np, dtype=f64, device=device)
    p_w = (corners_local(aruco_size, f64, device)[None]
           @ rotation(tags[:, 3:6]).transpose(1, 2)
           + tags[:, None, 0:3]).reshape(-1, 3)  # (T * 4, 3)
    half_w, half_h = image_size[0] / 2.0, image_size[1] / 2.0
    gen = torch.Generator(device=device)
    gen.manual_seed(int(noise_seed) % (1 << 63))
    cap_idx, tag_idx, corners = [], [], []
    for c0 in range(0, n_caps, chunk):
        r = rotation(caps[c0:c0 + chunk, 3:6])
        p_c = ((p_w[None] + caps[c0:c0 + chunk, None, 0:3])
               @ r.transpose(1, 2)).reshape(r.shape[0], n_tags, 4, 3)
        z_ok = (p_c[..., 2] > 0.1).all(-1)
        uv = focal * p_c[..., 0:2] / p_c[..., 2:3]
        vis = (z_ok & (uv[..., 0].abs() <= half_w).all(-1)
               & (uv[..., 1].abs() <= half_h).all(-1))
        ks, ts = torch.nonzero(vis, as_tuple=True)
        cap_idx.append(ks + c0)
        tag_idx.append(ts)
        corners.append(uv[ks, ts])
    cap_idx = torch.cat(cap_idx)
    tag_idx = torch.cat(tag_idx)
    corners = torch.cat(corners)
    corners = corners + noise_px * torch.randn(
        corners.shape, generator=gen, dtype=f64, device=device)
    # captures with too few tags are left out, as the map store does
    keep = (torch.bincount(cap_idx, minlength=n_caps)
            >= min_tags_per_cap)[cap_idx]
    cap_idx, tag_idx, corners = cap_idx[keep], tag_idx[keep], corners[keep]
    used_caps = torch.unique(cap_idx)  # sorted: capture order
    cap_new = torch.full((n_caps,), -1, dtype=torch.int64, device=device)
    cap_new[used_caps] = torch.arange(used_caps.numel(), device=device)
    # tags numbered by first sighting, in block order
    first = torch.full((n_tags,), cap_idx.numel(), dtype=torch.int64,
                       device=device)
    first.scatter_reduce_(0, tag_idx, torch.arange(
        tag_idx.numel(), device=device), reduce="amin")
    used_tags = torch.nonzero(first < cap_idx.numel())[:, 0]
    used_tags = used_tags[torch.argsort(first[used_tags])]
    tag_new = torch.full((n_tags,), -1, dtype=torch.int64, device=device)
    tag_new[used_tags] = torch.arange(used_tags.numel(), device=device)
    return {"cap_idx": cap_new[cap_idx], "tag_idx": tag_new[tag_idx],
            "corners": corners, "cap_poses": caps[used_caps],
            "tag_poses": tags[used_tags], "focal": float(focal)}
