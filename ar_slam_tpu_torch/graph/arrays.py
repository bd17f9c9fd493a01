# Copied from ar_slam_tpu/graph/arrays.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Padded array export of the constraint graph for device-side solvers.

The host graph (MapStore) is ragged and stringly-keyed; the device wants
static-shape integer-indexed arrays.  Sizes are padded to buckets (powers of
two past a floor) so the incremental solver re-jits only O(log n) times as
the map grows (SURVEY.md §7 hard part #2).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ar_slam_tpu_torch.graph.store import MapStore


class BlockArrays(NamedTuple):
    """Device-ready padded view of the problem.

    All arrays are NumPy on export; solvers move them to device.  Padded
    entries have mask False and index 0 (safe gather).
    """

    camera: np.ndarray  # (3,)
    cap_poses: np.ndarray  # (C_pad, 6) inverse capture poses
    tag_poses: np.ndarray  # (T_pad, 6)
    cap_idx: np.ndarray  # (B_pad,) int32
    tag_idx: np.ndarray  # (B_pad,) int32
    corners: np.ndarray  # (B_pad, 4, 2)
    block_mask: np.ndarray  # (B_pad,) bool
    cap_mask: np.ndarray  # (C_pad,) bool
    tag_mask: np.ndarray  # (T_pad,) bool
    n_caps: int
    n_tags: int
    n_blocks: int


def bucket_size(n: int, floor: int = 8) -> int:
    """Padding bucket: power-of-two up to 4096, then multiples of 1024.

    Pow2 jumps bound recompiles to O(log n) while the map grows, but at
    large sizes a 2x jump wastes real HBM and bandwidth (a 10k-tag map
    would pad to 16384 — 1.66x on every (T*S, 6, 6) array in the solver's
    hot loop); 1024-step buckets keep waste <= ~10% there at a still-tiny
    recompile count."""
    size = floor
    while size < n and size < 4096:
        size *= 2
    if size >= n:
        return size
    return -(-n // 1024) * 1024


def obs_bucket(n: int) -> int:
    """Bucket for per-tag observation slots: multiples of 8 up to 64 (the
    padding multiplies T_pad, so pow2 jumps are expensive), power-of-two
    beyond."""
    n = max(n, 1)
    if n <= 64:
        return -(-n // 8) * 8
    return bucket_size(n)


def export_arrays(
    store: MapStore,
    dtype=np.float64,
    cap_order: list[int] | None = None,
    block_filter: list[int] | None = None,
    pad: bool = True,
) -> BlockArrays:
    """Export the (sub)problem to padded arrays.

    Args:
      cap_order: optional capture indices to include (e.g. BFS prefix); the
        export keeps original indices — it masks, not renumbers — so pose
        rows always align with store indices.
      block_filter: optional explicit block indices to include; default =
        all blocks whose capture is included.
    """
    n_caps = len(store.captures)
    n_tags = max(len(store.arucos), 1)
    c_pad = bucket_size(n_caps) if pad else n_caps
    t_pad = bucket_size(n_tags) if pad else n_tags

    cap_poses = np.zeros((c_pad, 6), dtype=dtype)
    for cap in store.captures:
        cap_poses[cap.index] = cap.inv_pose
    tag_poses = np.zeros((t_pad, 6), dtype=dtype)
    for tag in store.arucos:
        tag_poses[tag.index] = tag.pose

    native = getattr(store, "_native", None)
    if native is not None and block_filter is None and cap_order is None:
        # bulk export via the C++ core
        ci, ti, crn = native.export_blocks()
        n_blocks = ci.shape[0]
        b_pad = bucket_size(n_blocks) if pad else max(n_blocks, 1)
        cap_idx = np.zeros(b_pad, dtype=np.int32)
        tag_idx = np.zeros(b_pad, dtype=np.int32)
        corners = np.zeros((b_pad, 4, 2), dtype=dtype)
        block_mask = np.zeros(b_pad, dtype=bool)
        cap_idx[:n_blocks] = ci
        tag_idx[:n_blocks] = ti
        corners[:n_blocks] = crn
        block_mask[:n_blocks] = True
        blocks = store.blocks
    else:
        if block_filter is not None:
            blocks = [store.blocks[i] for i in block_filter]
        elif cap_order is not None:
            included = set(cap_order)
            blocks = [b for b in store.blocks if b.cap_idx in included]
        else:
            blocks = list(store.blocks)

        n_blocks = len(blocks)
        b_pad = bucket_size(n_blocks) if pad else max(n_blocks, 1)

        cap_idx = np.zeros(b_pad, dtype=np.int32)
        tag_idx = np.zeros(b_pad, dtype=np.int32)
        corners = np.zeros((b_pad, 4, 2), dtype=dtype)
        block_mask = np.zeros(b_pad, dtype=bool)
        for i, b in enumerate(blocks):
            cap_idx[i] = b.cap_idx
            tag_idx[i] = b.tag_idx
            corners[i] = b.corners
            block_mask[i] = True

    cap_mask = np.zeros(c_pad, dtype=bool)
    if cap_order is not None:
        cap_mask[list(cap_order)] = True
    else:
        cap_mask[:n_caps] = True
    tag_mask = np.zeros(t_pad, dtype=bool)
    if cap_order is not None:
        seen_tags = sorted({b.tag_idx for b in blocks}) if blocks else []
        tag_mask[seen_tags] = True
    else:
        tag_mask[: len(store.arucos)] = True

    return BlockArrays(
        camera=np.asarray(store.camera.params, dtype=dtype).copy(),
        cap_poses=cap_poses,
        tag_poses=tag_poses,
        cap_idx=cap_idx,
        tag_idx=tag_idx,
        corners=corners,
        block_mask=block_mask,
        cap_mask=cap_mask,
        tag_mask=tag_mask,
        n_caps=n_caps,
        n_tags=len(store.arucos),
        n_blocks=n_blocks,
    )


def write_back(store: MapStore, camera, cap_poses, tag_poses) -> None:
    """Write optimized parameters back into the host store."""
    camera = np.asarray(camera, dtype=float)
    cap_poses = np.asarray(cap_poses, dtype=float)
    tag_poses = np.asarray(tag_poses, dtype=float)
    store.camera.params[:] = camera
    for cap in store.captures:
        cap.inv_pose[:] = cap_poses[cap.index]
    for tag in store.arucos:
        tag.pose[:] = tag_poses[tag.index]
