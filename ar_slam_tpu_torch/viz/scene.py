# Copied from ar_slam_tpu/viz/scene.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""3-D scene rendering: the headless equivalent of the reference's Foxglove
layout (3D panel with tag markers + camera frusta, SURVEY.md §2.2).

Renders the map's tags as filled squares and each capture as a camera
frustum into a PNG via matplotlib (no display required).
"""

from __future__ import annotations

import numpy as np

from ar_slam_tpu_torch.graph.store import MapStore


def _rot_apply(aa, pts):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(np.asarray(aa, dtype=float)).apply(pts)


def render_scene(store: MapStore, out_path: str, aruco_size: float = 0.0635,
                 frustum_depth: float = 0.3) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")

    half = aruco_size / 2.0
    square = np.array([
        [-half, -half, 0], [half, -half, 0], [half, half, 0],
        [-half, half, 0],
    ])
    for tag in store.arucos:
        corners = _rot_apply(tag.pose[3:6], square) + tag.pose[0:3]
        ax.add_collection3d(Poly3DCollection(
            [corners], facecolor="red", edgecolor="black", alpha=0.8,
        ))
        c = tag.pose[0:3]
        ax.text(c[0], c[1], c[2], tag.id.split("_")[-1], fontsize=7)

    # camera frusta: position = -R_inv^T t_inv... world camera center is
    # p_w with R_inv(p_w + t_inv) = 0 -> p_w = -t_inv
    focal = float(store.camera.params[0])
    if store.camera.size:
        w, h = store.camera.size
    else:
        w, h = 1000, 750
    fx = frustum_depth * (w / 2) / focal
    fy = frustum_depth * (h / 2) / focal
    cam_pts = np.array([
        [0, 0, 0],
        [-fx, -fy, frustum_depth], [fx, -fy, frustum_depth],
        [fx, fy, frustum_depth], [-fx, fy, frustum_depth],
    ])
    for cap in store.captures:
        inv_t, inv_r = cap.inv_pose[0:3], cap.inv_pose[3:6]
        # camera->world: p_w = R(-inv_r) p_c - inv_t
        pts = _rot_apply(-inv_r, cam_pts) - inv_t
        faces = [[pts[0], pts[i], pts[i % 4 + 1]] for i in range(1, 5)]
        ax.add_collection3d(Poly3DCollection(
            faces, facecolor="cyan", edgecolor="blue", alpha=0.25,
        ))
        ax.text(*pts[0], cap.uid, fontsize=7, color="blue")

    all_pts = np.array(
        [t.pose[0:3] for t in store.arucos]
        + [-c.inv_pose[0:3] for c in store.captures]
    )
    if len(all_pts):
        lo, hi = all_pts.min(axis=0) - 0.3, all_pts.max(axis=0) + 0.3
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(lo[2], hi[2])
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    ax.set_title(f"ar_slam map: {len(store.arucos)} tags, "
                 f"{len(store.captures)} captures, f={focal:.0f}px")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
