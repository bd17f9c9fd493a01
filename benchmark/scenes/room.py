"""Rendered photos of a room of printed AR tags, from seeds.

The benchmark's own copy of the program's ``utils/render.room_scene``, so
that later changes of the program cannot move the inputs: 24 tags (12 of
4X4_50, 12 of 5X5_100) with a white paper margin on two walls meeting in a
corner, photographed from cameras on an arc with the engine's camera model
(inverse capture poses, focal in pixels about the image center).  Markers
are warped onto each photo by inverse-homography sampling inside each
quad's bounding box with 2x2 supersampling, then Gaussian noise is added.

Changed from the copy's original: the layout (tags, camera jitter) and the
pixel noise draw from seeds of their own, every photo from a generator of
its own, so one photo renders without the others; the arithmetic of a photo
is float32.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

_MARKERS = os.path.join(os.path.dirname(__file__), "markers.npz")
_DIRS = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])


def marker_bits(dict_name: str) -> np.ndarray:
    """(N, s, s) uint8 bit tables of a dictionary (a copy of the program's
    dictionaries.npz for 4X4_50 and 5X5_100)."""
    with np.load(_MARKERS) as data:
        return data[dict_name]


def render_marker(dict_name: str, marker_id: int, cell_px: int = 8,
                  margin_cells: int = 1) -> np.ndarray:
    """One marker as uint8 (0 = black) with ``margin_cells`` white cells of
    paper around its black border."""
    bits = marker_bits(dict_name)[marker_id]
    n = bits.shape[0] + 2
    grid = np.full((n + 2 * margin_cells,) * 2, 255, np.uint8)
    inner = np.zeros((n, n), np.uint8)
    inner[1:-1, 1:-1] = bits * 255
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
    ys, xs = np.mgrid[y0:y1, x0:x1]
    for oy in (-0.25, 0.25):
        for ox in (-0.25, 0.25):
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
            half_side: float):
    """Centered pixel coords (4, 2) and camera depths (4,) of a square of
    half-side ``half_side`` in the tag frame (distortion off)."""
    local = np.concatenate([half_side * _DIRS, np.zeros((4, 1))], axis=1)
    p_w = local @ _rotvec_to_matrix(tag_pose[3:6]).T + tag_pose[0:3]
    p_c = (p_w + inv_cap_pose[0:3]) @ _rotvec_to_matrix(inv_cap_pose[3:6]).T
    return focal * p_c[:, 0:2] / p_c[:, 2:3], p_c[:, 2]


@dataclass
class Room:
    """The scene: tags [(dict_name, id, pose (6,))], the photos' inverse
    poses (N, 6), the camera, and the seed of the pixel noise."""

    tags: list
    inv_poses: np.ndarray
    width: int
    height: int
    focal: float
    aruco_size: float
    noise: float
    noise_seed: int


def room(layout_seed: int, n_photos: int, width: int, height: int,
         focal: float, aruco_size: float, noise: float = 2.0,
         noise_seed: int = 0) -> Room:
    """The room and its ``n_photos`` cameras, evenly along the arc, laid
    out from ``layout_seed``; the photos' pixel noise draws from
    ``noise_seed``."""
    rng = np.random.default_rng([seed_word(layout_seed), 0])
    ids4 = rng.choice(50, 12, replace=False)
    ids5 = rng.choice(100, 12, replace=False)
    tags = []
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
    poses = []
    for k in range(n_photos):
        a = k / max(n_photos - 1, 1)
        cam_pos = np.array([-0.15 + 0.55 * a, 0.04 * np.sin(5 * a),
                            0.05 * a])
        yaw = np.deg2rad(-5.0 + 40.0 * a)
        inv_pose = np.concatenate([-cam_pos, [0.0, -yaw, 0.0]])
        inv_pose[3:6] += np.random.default_rng([seed_word(layout_seed), 1, k]).normal(
            scale=0.02, size=3)
        poses.append(inv_pose)
    return Room(tags, np.stack(poses), width, height, focal, aruco_size,
                noise, noise_seed)


def _margin(name: str) -> float:
    s = marker_bits(name).shape[1]
    return (s + 4) / (s + 2)


def sightings(scene: Room, k: int) -> list:
    """(dict_name, id, corners (4, 2) pixel coords, min side px, paper quad)
    of every tag whose paper lies fully inside photo ``k``."""
    center = np.array([scene.width / 2.0, scene.height / 2.0])
    out = []
    for name, mid, pose in scene.tags:
        crn, z = project(scene.focal, scene.inv_poses[k], pose,
                         0.5 * scene.aruco_size)
        if np.any(z < 0.2):
            continue
        crn = crn + center
        paper, _ = project(scene.focal, scene.inv_poses[k], pose,
                           0.5 * scene.aruco_size * _margin(name))
        paper = paper + center
        x2, y2 = crn[:, 0], crn[:, 1]
        area = 0.5 * np.sum(x2 * np.roll(y2, -1) - np.roll(x2, -1) * y2)
        if area <= 0 or np.any(paper < 4) or np.any(
                paper[:, 0] > scene.width - 5) or np.any(
                paper[:, 1] > scene.height - 5):
            continue
        side = np.linalg.norm(crn - np.roll(crn, -1, axis=0), axis=1).min()
        out.append((name, mid, crn, float(side), paper))
    return out


def render(scene: Room, k: int) -> np.ndarray:
    """Photo ``k`` as (H, W) uint8."""
    h, w = scene.height, scene.width
    yy = np.arange(h, dtype=np.float32)[:, None] / h
    xx = np.arange(w, dtype=np.float32)[None, :] / w
    img = 175.0 + 40.0 * xx - 25.0 * yy
    for name, mid, _, _, paper in sightings(scene, k):
        place_marker(img, render_marker(name, mid), paper)
    rng = np.random.default_rng([seed_word(scene.noise_seed), 2, k])
    img += scene.noise * rng.standard_normal(img.shape, dtype=np.float32)
    np.round(img, out=img)
    return np.clip(img, 0, 255, out=img).astype(np.uint8)


def seed_word(seed: int) -> int:
    """A seed as the non-negative word numpy's generators take."""
    return int(seed) % (1 << 64)
