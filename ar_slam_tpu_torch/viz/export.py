# Copied from ar_slam_tpu/viz/export.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Pose / intrinsics / marker artifact export.

≙ the ROS-outputs adapter (ar_slam_util.cpp:1027-1162) re-targeted to plain
dicts (JSON/YAML-serializable; a viz bridge can convert to TF / CameraInfo /
MarkerArray messages):

- ``transforms``: world→tag and world→capture; the capture TF negates the
  stored inverse pose (translation = R_inv^T applied... see
  ar_slam_util.cpp:1060-1074: the transform publishes the camera pose =
  inverse of the stored inverse transform).
- ``camera_info``: plumb_bob, fx = fy = focal, principal point at image
  center (ar_slam_util.cpp:1080-1128).
- ``marker_array``: one cube per tag, aruco_size² x 0.01 m, red
  (ar_slam_util.cpp:1131-1162).

Quaternions are (w, x, y, z), ceres order (ar_slam_util.cpp:1046).
"""

from __future__ import annotations

import numpy as np

from ar_slam_tpu_torch.graph.store import MapStore


def _aa_to_quat(aa) -> list[float]:
    theta = float(np.linalg.norm(aa))
    if theta < 1e-12:
        return [1.0, 0.0, 0.0, 0.0]
    axis = np.asarray(aa) / theta
    return [float(np.cos(theta / 2))] + list(np.sin(theta / 2) * axis)


def _rotate_aa(aa, p):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(np.asarray(aa, dtype=float)).apply(p)


def transforms(store: MapStore) -> list[dict]:
    """World→tag and world→capture transforms."""
    out = []
    for tag in store.arucos:
        out.append({
            "parent": "world",
            "child": tag.id,
            "translation": [float(v) for v in tag.pose[0:3]],
            "rotation_wxyz": _aa_to_quat(tag.pose[3:6]),
        })
    for cap in store.captures:
        # stored: p_cam = R_inv (p_world + t_inv).  Camera pose in world:
        # R = R_inv^T, t = -t_inv... rotated: world position of camera =
        # solve p_cam=0 -> p_world = -t_inv; orientation = -inv rotation.
        inv_t = cap.inv_pose[0:3]
        inv_r = cap.inv_pose[3:6]
        out.append({
            "parent": "world",
            "child": cap.uid,
            "translation": [float(v) for v in -inv_t],
            "rotation_wxyz": _aa_to_quat(-inv_r),
        })
    return out


def camera_info(store: MapStore) -> dict:
    focal = float(store.camera.params[0])
    if store.camera.size is not None:
        w, h = store.camera.size
    else:
        w = h = 0
    cx, cy = w / 2.0, h / 2.0
    k = [focal, 0.0, cx, 0.0, focal, cy, 0.0, 0.0, 1.0]
    return {
        "distortion_model": "plumb_bob",
        "d": [0.0, 0.0, 0.0, 0.0, 0.0],
        "width": int(w),
        "height": int(h),
        "k": k,
        "p": [k[0], k[1], k[2], 0.0, k[3], k[4], k[5], 0.0, k[6], k[7], k[8], 0.0],
    }


def marker_array(store: MapStore, aruco_size: float) -> list[dict]:
    out = [{"action": "deleteall"}]
    for tag in store.arucos:
        out.append({
            "action": "add",
            "id": tag.id,
            "type": "cube",
            "frame_locked": True,
            "pose": {
                "translation": [float(v) for v in tag.pose[0:3]],
                "rotation_wxyz": _aa_to_quat(tag.pose[3:6]),
            },
            "scale": [aruco_size, aruco_size, 0.01],
            "color_rgba": [1.0, 0.0, 0.0, 1.0],
        })
    return out
