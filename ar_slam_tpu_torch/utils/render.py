"""Rendered AR-tag scenes for the port's checks (NumPy only, no PIL).

``room_scene`` places printed tags (marker plus a white paper margin) on
two walls meeting in a corner and renders grayscale frames from cameras on
an arc, with the engine's own camera model (inverse capture poses, focal
in pixels about the image center).  Markers are warped onto each frame by
inverse-homography sampling, as tests/test_detect.py:place_marker does,
but only inside each quad's bounding box and with 2x2 supersampling.
"""

from __future__ import annotations

import numpy as np

from ar_slam_tpu_torch.detect.dictionaries import get_dictionary

_DIRS = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])


def render_marker(dict_name: str, marker_id: int, cell_px: int = 8,
                  margin_cells: int = 1) -> np.ndarray:
    """One marker as uint8 (0 = black) with ``margin_cells`` white cells of
    paper around its black border."""
    d = get_dictionary(dict_name)
    n = d.marker_size + 2
    grid = np.full((n + 2 * margin_cells,) * 2, 255, np.uint8)
    inner = np.zeros((n, n), np.uint8)
    inner[1:-1, 1:-1] = d.bits[marker_id] * 255
    grid[margin_cells:margin_cells + n, margin_cells:margin_cells + n] = inner
    return np.kron(grid, np.ones((cell_px, cell_px), np.uint8))


def _homography_unit_square(quad: np.ndarray) -> np.ndarray:
    rows, rhs = [], []
    for (x, y), (u, v) in zip(((0, 0), (1, 0), (1, 1), (0, 1)), quad):
        rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        rows.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        rhs += [u, v]
    h8 = np.linalg.solve(np.array(rows, float), np.array(rhs, float))
    return np.append(h8, 1.0).reshape(3, 3)


def place_marker(canvas: np.ndarray, marker: np.ndarray,
                 quad: np.ndarray) -> None:
    """Warp ``marker`` onto float ``canvas`` at ``quad`` (TL, TR, BR, BL
    pixel coords), in place, 2x2 supersampled."""
    h, w = canvas.shape
    x0, y0 = np.floor(quad.min(axis=0)).astype(int)
    x1, y1 = np.ceil(quad.max(axis=0)).astype(int) + 1
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
    if x0 >= x1 or y0 >= y1:
        return
    hinv = np.linalg.inv(_homography_unit_square(quad))
    mh, mw = marker.shape
    acc = np.zeros((y1 - y0, x1 - x0))
    hit = np.zeros_like(acc)
    for oy in (-0.25, 0.25):
        for ox in (-0.25, 0.25):
            ys, xs = np.mgrid[y0:y1, x0:x1]
            pts = np.stack([xs + ox, ys + oy, np.ones(xs.shape)], axis=-1)
            uvw = pts @ hinv.T
            uv = uvw[..., :2] / uvw[..., 2:3]
            inside = ((uv[..., 0] >= 0) & (uv[..., 0] < 1)
                      & (uv[..., 1] >= 0) & (uv[..., 1] < 1))
            mx = np.clip((uv[..., 0] * mw).astype(int), 0, mw - 1)
            my = np.clip((uv[..., 1] * mh).astype(int), 0, mh - 1)
            acc += np.where(inside, marker[my, mx], 0.0)
            hit += inside
    region = canvas[y0:y1, x0:x1]
    cover = hit / 4.0
    region[:] = region * (1.0 - cover) + acc / 4.0


def _rotvec_to_matrix(r: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(r))
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def project(focal: float, inv_cap_pose: np.ndarray, tag_pose: np.ndarray,
            half_side: float) -> np.ndarray:
    """Centered pixel coords (4, 2) and camera depths (4,) of a square of
    half-side ``half_side`` in the tag frame (the engine's projection
    model, distortion off)."""
    local = np.concatenate([half_side * _DIRS, np.zeros((4, 1))], axis=1)
    p_w = local @ _rotvec_to_matrix(tag_pose[3:6]).T + tag_pose[0:3]
    p_c = (p_w + inv_cap_pose[0:3]) @ _rotvec_to_matrix(inv_cap_pose[3:6]).T
    return focal * p_c[:, 0:2] / p_c[:, 2:3], p_c[:, 2]


# a 12 MP phone photo (4032x3024, the default output of most phone
# cameras) through a 26 mm-equivalent lens: focal 26/36 * 4032 ~ 2900 px.
# The room's tags then have sides of ~145-230 px at 63.5 mm (~115-180 px at
# 50 mm), above the detector's perimeter gate of 4 * 0.03 * 4032 * 0.5
# ~ 242 px (a ~60 px side).
PHONE_12MP = dict(width=4032, height=3024, focal=2900.0)


def room_scene(n_frames: int = 16, width: int = 1020, height: int = 768,
               focal: float = 900.0, aruco_size: float = 0.0635,
               seed: int = 0, noise: float = 2.0, arc=None):
    """Render ``n_frames`` views of 24 tags (12 4X4_50, 12 5X5_100) on two
    walls (``room_scene(n, **PHONE_12MP)`` for 12 MP phone photos).
    ``arc`` gives each frame's place on the camera arc in [0, 1] (default:
    evenly spaced in frame order).  Returns (frames (N, H, W) uint8, truth) where truth["frames"]
    lists, per frame, (dict_name, marker_id, corners (4, 2) pixel coords,
    min side px) of every tag fully inside it, and truth holds the tag
    poses, inverse capture poses and focal."""
    rng = np.random.default_rng(seed)
    ids4 = rng.choice(50, 12, replace=False)
    ids5 = rng.choice(100, 12, replace=False)
    tags = []  # (dict_name, id, pose)
    theta2 = np.deg2rad(50.0)
    hinge = np.array([0.55, 0.0, 1.1])
    axis2 = np.array([np.cos(theta2), 0.0, -np.sin(theta2)])
    for i in range(24):
        row, col = divmod(i % 12, 4)
        wall = i // 12
        tilt = rng.normal(scale=0.06, size=3)
        if wall == 0:  # facing the cameras, plane z = 1.1
            pos = np.array([-0.35 + 0.2 * col, -0.2 + 0.2 * row, 1.1])
            rot = tilt
        else:  # swung 50 degrees toward the cameras about the hinge
            pos = hinge + (0.08 + 0.16 * col) * axis2 + np.array(
                [0.0, -0.2 + 0.2 * row, 0.0])
            rot = np.array([0.0, theta2, 0.0]) + tilt
        name, mid = (("4X4_50", ids4[i % 12]) if (i + wall) % 2 == 0
                     else ("5X5_100", ids5[i % 12]))
        tags.append((name, int(mid), np.concatenate([pos, rot])))

    markers = {(n, m): render_marker(n, m) for n, m, _ in tags}
    margin = {n: (get_dictionary(n).marker_size + 4) / (
        get_dictionary(n).marker_size + 2) for n, _, _ in tags}
    center = np.array([width / 2.0, height / 2.0])
    yy, xx = np.mgrid[0:height, 0:width]
    shading = 175.0 + 40.0 * (xx / width) - 25.0 * (yy / height)
    del yy, xx
    frames, truth_frames, cap_poses = [], [], []
    for k in range(n_frames):
        a = k / max(n_frames - 1, 1) if arc is None else float(arc[k])
        cam_pos = np.array([-0.15 + 0.55 * a, 0.04 * np.sin(5 * a),
                            0.05 * a])
        yaw = np.deg2rad(-5.0 + 40.0 * a)
        inv_pose = np.concatenate([-cam_pos, [0.0, -yaw, 0.0]])
        inv_pose[3:6] += rng.normal(scale=0.02, size=3)
        cap_poses.append(inv_pose)
        img = shading.copy()
        seen = []
        for name, mid, pose in tags:
            crn, z = project(focal, inv_pose, pose, 0.5 * aruco_size)
            if np.any(z < 0.2):
                continue
            crn = crn + center
            paper, _ = project(focal, inv_pose, pose,
                               0.5 * aruco_size * margin[name])
            paper = paper + center
            x2, y2 = crn[:, 0], crn[:, 1]
            area = 0.5 * np.sum(x2 * np.roll(y2, -1) - np.roll(x2, -1) * y2)
            if area <= 0 or np.any(paper < 4) or np.any(
                    paper[:, 0] > width - 5) or np.any(paper[:, 1] > height - 5):
                continue
            place_marker(img, markers[(name, mid)], paper)
            side = np.linalg.norm(crn - np.roll(crn, -1, axis=0), axis=1).min()
            seen.append((name, mid, crn, float(side)))
        img += rng.normal(scale=noise, size=img.shape)
        np.round(img, out=img)
        frames.append(np.clip(img, 0, 255, out=img).astype(np.uint8))
        truth_frames.append(seen)
    return np.stack(frames), {
        "frames": truth_frames,
        "tag_poses": [(n, m, p) for n, m, p in tags],
        "cap_poses": np.stack(cap_poses),
        "focal": focal,
        "aruco_size": aruco_size,
    }
