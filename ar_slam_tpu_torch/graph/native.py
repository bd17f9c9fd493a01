# Copied from ar_slam_tpu/graph/native.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""ctypes binding for the native C++ graph core (native/graph_core.cpp).

Loads ``libarslam_graph.so`` if built (``make -C native``); callers fall
back to the pure-Python MapStore when unavailable.  Semantics are identical
— the native core accelerates uid interning, adjacency bookkeeping, BFS
ordering, and bulk block export for large maps.
"""

from __future__ import annotations

import ctypes as C
import os

import numpy as np

_LIB = None


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                        "libarslam_graph.so")
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise OSError(f"native graph core not built: {path} (make -C native)")
    lib = C.CDLL(path)
    lib.arslam_graph_new.restype = C.c_void_p
    lib.arslam_graph_free.argtypes = [C.c_void_p]
    for name, res, args in [
        ("arslam_num_captures", C.c_int32, [C.c_void_p]),
        ("arslam_num_arucos", C.c_int32, [C.c_void_p]),
        ("arslam_num_blocks", C.c_int32, [C.c_void_p]),
        ("arslam_add_capture", C.c_int32,
         [C.c_void_p, C.c_char_p, C.c_char_p]),
        ("arslam_find_capture", C.c_int32, [C.c_void_p, C.c_char_p]),
        ("arslam_get_or_add_aruco", C.c_int32, [C.c_void_p, C.c_char_p]),
        ("arslam_find_aruco", C.c_int32, [C.c_void_p, C.c_char_p]),
        ("arslam_add_block", C.c_int32,
         [C.c_void_p, C.c_int32, C.c_int32, C.POINTER(C.c_double)]),
        ("arslam_bulk_add_blocks", None,
         [C.c_void_p, C.c_int32, C.POINTER(C.c_int32), C.POINTER(C.c_int32),
          C.POINTER(C.c_double)]),
        ("arslam_set_camera", None,
         [C.c_void_p, C.POINTER(C.c_double), C.c_int32, C.c_int32]),
        ("arslam_get_camera", None,
         [C.c_void_p, C.POINTER(C.c_double), C.POINTER(C.c_int32)]),
        ("arslam_set_capture_pose", None,
         [C.c_void_p, C.c_int32, C.POINTER(C.c_double)]),
        ("arslam_get_capture_pose", None,
         [C.c_void_p, C.c_int32, C.POINTER(C.c_double)]),
        ("arslam_set_tag_pose", None,
         [C.c_void_p, C.c_int32, C.POINTER(C.c_double)]),
        ("arslam_get_tag_pose", None,
         [C.c_void_p, C.c_int32, C.POINTER(C.c_double)]),
        ("arslam_capture_uid", C.c_char_p, [C.c_void_p, C.c_int32]),
        ("arslam_capture_img_fn", C.c_char_p, [C.c_void_p, C.c_int32]),
        ("arslam_aruco_id", C.c_char_p, [C.c_void_p, C.c_int32]),
        ("arslam_capture_num_blocks", C.c_int32, [C.c_void_p, C.c_int32]),
        ("arslam_capture_with_most_blocks", C.c_int32, [C.c_void_p]),
        ("arslam_bfs_order", C.c_int32,
         [C.c_void_p, C.c_int32, C.POINTER(C.c_int32), C.POINTER(C.c_int32)]),
        ("arslam_export_blocks", None,
         [C.c_void_p, C.POINTER(C.c_int32), C.POINTER(C.c_int32),
          C.POINTER(C.c_double)]),
        ("arslam_export_poses", None,
         [C.c_void_p, C.POINTER(C.c_double), C.POINTER(C.c_double)]),
        ("arslam_import_poses", None,
         [C.c_void_p, C.POINTER(C.c_double), C.POINTER(C.c_double),
          C.POINTER(C.c_double)]),
        ("arslam_capture_blocks", None,
         [C.c_void_p, C.c_int32, C.POINTER(C.c_int32)]),
    ]:
        f = getattr(lib, name)
        f.restype = res
        f.argtypes = args
    _LIB = lib
    return lib


def available() -> bool:
    try:
        _lib()
        return True
    except OSError:
        return False


def _dptr(a):
    return a.ctypes.data_as(C.POINTER(C.c_double))


def _iptr(a):
    return a.ctypes.data_as(C.POINTER(C.c_int32))


class NativeGraph:
    """Thin RAII wrapper over the C core."""

    def __init__(self):
        self.lib = _lib()
        self.ptr = self.lib.arslam_graph_new()

    def __del__(self):
        if getattr(self, "ptr", None):
            self.lib.arslam_graph_free(self.ptr)
            self.ptr = None

    # counts
    @property
    def n_captures(self):
        return self.lib.arslam_num_captures(self.ptr)

    @property
    def n_arucos(self):
        return self.lib.arslam_num_arucos(self.ptr)

    @property
    def n_blocks(self):
        return self.lib.arslam_num_blocks(self.ptr)

    # mutation
    def add_capture(self, uid: str, img_fn: str = "") -> int:
        return self.lib.arslam_add_capture(
            self.ptr, uid.encode(), img_fn.encode()
        )

    def find_capture(self, uid: str) -> int:
        return self.lib.arslam_find_capture(self.ptr, uid.encode())

    def get_or_add_aruco(self, tag_id: str) -> int:
        return self.lib.arslam_get_or_add_aruco(self.ptr, tag_id.encode())

    def find_aruco(self, tag_id: str) -> int:
        return self.lib.arslam_find_aruco(self.ptr, tag_id.encode())

    def add_block(self, cap_idx: int, tag_idx: int, corners) -> int:
        c = np.ascontiguousarray(corners, dtype=np.float64).reshape(8)
        return self.lib.arslam_add_block(self.ptr, cap_idx, tag_idx, _dptr(c))

    def bulk_add_blocks(self, cap_idx, tag_idx, corners) -> None:
        ci = np.ascontiguousarray(cap_idx, dtype=np.int32)
        ti = np.ascontiguousarray(tag_idx, dtype=np.int32)
        c = np.ascontiguousarray(corners, dtype=np.float64).reshape(-1, 8)
        self.lib.arslam_bulk_add_blocks(self.ptr, ci.shape[0], _iptr(ci),
                                        _iptr(ti), _dptr(c))

    # camera / poses
    def set_camera(self, params, width=-1, height=-1):
        p = np.ascontiguousarray(params, dtype=np.float64)
        self.lib.arslam_set_camera(self.ptr, _dptr(p), width, height)

    def get_camera(self):
        p = np.zeros(3)
        wh = np.zeros(2, dtype=np.int32)
        self.lib.arslam_get_camera(self.ptr, _dptr(p), _iptr(wh))
        return p, (int(wh[0]), int(wh[1]))

    def set_capture_pose(self, idx, pose):
        p = np.ascontiguousarray(pose, dtype=np.float64)
        self.lib.arslam_set_capture_pose(self.ptr, idx, _dptr(p))

    def get_capture_pose(self, idx):
        p = np.zeros(6)
        self.lib.arslam_get_capture_pose(self.ptr, idx, _dptr(p))
        return p

    def set_tag_pose(self, idx, pose):
        p = np.ascontiguousarray(pose, dtype=np.float64)
        self.lib.arslam_set_tag_pose(self.ptr, idx, _dptr(p))

    def get_tag_pose(self, idx):
        p = np.zeros(6)
        self.lib.arslam_get_tag_pose(self.ptr, idx, _dptr(p))
        return p

    # queries
    def capture_uid(self, idx) -> str:
        return self.lib.arslam_capture_uid(self.ptr, idx).decode()

    def aruco_id(self, idx) -> str:
        return self.lib.arslam_aruco_id(self.ptr, idx).decode()

    def capture_with_most_blocks(self) -> int:
        return self.lib.arslam_capture_with_most_blocks(self.ptr)

    def bfs_order(self, seed_cap: int):
        n = self.n_captures
        order = np.zeros(n, dtype=np.int32)
        init_blocks = np.zeros(n, dtype=np.int32)
        count = self.lib.arslam_bfs_order(
            self.ptr, seed_cap, _iptr(order), _iptr(init_blocks)
        )
        return order[:count], init_blocks[:count]

    def export_blocks(self):
        b = self.n_blocks
        cap_idx = np.zeros(b, dtype=np.int32)
        tag_idx = np.zeros(b, dtype=np.int32)
        corners = np.zeros((b, 4, 2))
        self.lib.arslam_export_blocks(
            self.ptr, _iptr(cap_idx), _iptr(tag_idx), _dptr(corners)
        )
        return cap_idx, tag_idx, corners

    def export_poses(self):
        cap_poses = np.zeros((self.n_captures, 6))
        tag_poses = np.zeros((self.n_arucos, 6))
        self.lib.arslam_export_poses(self.ptr, _dptr(cap_poses),
                                     _dptr(tag_poses))
        return cap_poses, tag_poses

    def import_poses(self, camera, cap_poses, tag_poses):
        c = np.ascontiguousarray(camera, dtype=np.float64)
        cp = np.ascontiguousarray(cap_poses, dtype=np.float64)
        tp = np.ascontiguousarray(tag_poses, dtype=np.float64)
        self.lib.arslam_import_poses(self.ptr, _dptr(c), _dptr(cp), _dptr(tp))

    def capture_blocks(self, cap_idx):
        n = self.lib.arslam_capture_num_blocks(self.ptr, cap_idx)
        out = np.zeros(n, dtype=np.int32)
        self.lib.arslam_capture_blocks(self.ptr, cap_idx, _iptr(out))
        return out
