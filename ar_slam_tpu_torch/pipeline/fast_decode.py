# Copied from ar_slam_tpu/pipeline/fast_decode.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""Native JPEG decode binding (native/jpeg_decode.cpp via ctypes).

The reference's ImageLoader decodes with native cv::imread
(image_loader.cpp:174); the Python-only PIL path costs ~4.3 ms per
768x1020 frame — slower than the device detection batch it feeds.  The
native decoder goes straight to grayscale (libjpeg JCS_GRAYSCALE) and the
ctypes call releases the GIL, so ``ingest_many`` parallelizes decodes
across a thread pool.

Falls back silently when the library is not built (``make -C native``) or
for non-JPEG inputs; set AR_SLAM_NATIVE=0 to disable.
"""

from __future__ import annotations

import ctypes as C
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("AR_SLAM_NATIVE", "1") == "0":
        return None
    path = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", "native",
                     "libarslam_jpeg.so"))
    if not os.path.exists(path):
        return None
    try:
        lib = C.CDLL(path)
        lib.arslam_jpeg_dims.restype = C.c_int
        lib.arslam_jpeg_dims.argtypes = [
            C.c_char_p, C.POINTER(C.c_int), C.POINTER(C.c_int)]
        lib.arslam_jpeg_decode_gray.restype = C.c_int
        lib.arslam_jpeg_decode_gray.argtypes = [
            C.c_char_p, C.POINTER(C.c_ubyte), C.c_long,
            C.POINTER(C.c_int), C.POINTER(C.c_int)]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _lib() is not None


def decode_gray(path: str) -> np.ndarray | None:
    """Decode a JPEG to (H, W) uint8 grayscale, or None if the native
    decoder is unavailable or the file is not a decodable JPEG."""
    lib = _lib()
    if lib is None:
        return None
    if not path.lower().endswith((".jpg", ".jpeg")):
        return None
    w = C.c_int()
    h = C.c_int()
    p = path.encode()
    if lib.arslam_jpeg_dims(p, C.byref(w), C.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value), dtype=np.uint8)
    rc = lib.arslam_jpeg_decode_gray(
        p, out.ctypes.data_as(C.POINTER(C.c_ubyte)), out.size,
        C.byref(w), C.byref(h))
    if rc != 0 or (h.value, w.value) != out.shape:
        # shape changed between the dims probe and the decode (file being
        # rewritten under a watch loop) — rows would be sheared
        return None
    return out
