# Copied from ar_slam_tpu/detect/dictionaries.py and kept equal to it (a CPU
# test checks that), except that it reads the JAX package's dictionaries.npz
# by file path (the data is not duplicated and the package is not imported).
"""Aruco dictionary bit tables (4X4_50, 5X5_100, 6X6_250) with rotations.

These are the three dictionaries the reference's ``aruco_dict`` detector
parameter accepts (aruco_detector.cpp:59-78); the pipeline default runs the
first two concurrently (ar_slam_launch.py:75-95).

Tables are committed as ``dictionaries.npz`` (generated once by
tools/gen_dictionaries.py from the public dictionary constants); this module
loads them and precomputes all 4 rotations for decode-time matching, the
pure-data equivalent of cv::aruco's identify() step
(≙ dictionary usage at ar_slam_util.cpp:249-252, aruco_detector.cpp:59-78).
"""

from __future__ import annotations

import functools
import os

import numpy as np

DICT_NAMES = ("4X4_50", "5X5_100", "6X6_250")

_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                    "ar_slam_tpu", "detect", "dictionaries.npz")


class Dictionary:
    """Marker bit patterns plus rotation-expanded matching tables."""

    def __init__(self, name: str, bits: np.ndarray):
        self.name = name
        self.bits = bits  # (N, s, s) uint8
        self.n_markers = bits.shape[0]
        self.marker_size = bits.shape[1]
        # (4, N, s*s): rotations k=0..3 (np.rot90 applied k times)
        rots = [
            np.stack([np.rot90(b, k) for b in bits]).reshape(self.n_markers, -1)
            for k in range(4)
        ]
        self.rotations = np.stack(rots)  # (4, N, s*s)

    def identify(self, bit_grid: np.ndarray, max_hamming: int):
        """Match a (s, s) observed bit grid against the dictionary.

        Returns (marker_id, rotation_k) or (-1, 0).  rotation_k is the
        number of CCW 90° rotations that maps the canonical marker onto the
        observed grid — detections are reported with corners rotated so
        corner 0 is the canonical top-left, like cv::aruco.
        """
        flat = bit_grid.reshape(-1).astype(np.uint8)
        dists = (self.rotations != flat[None, None, :]).sum(axis=2)  # (4, N)
        k, idx = np.unravel_index(np.argmin(dists), dists.shape)
        if dists[k, idx] <= max_hamming:
            return int(idx), int(k)
        return -1, 0


@functools.lru_cache(maxsize=None)
def get_dictionary(name: str) -> Dictionary:
    data = np.load(_NPZ)
    if name not in data:
        raise KeyError(f"unknown dictionary {name}; have {list(data)}")
    return Dictionary(name, data[name])
