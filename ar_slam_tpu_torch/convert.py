"""Carry state across from the JAX package's host structures.

``store_from_jax`` copies a JAX-package ``MapStore`` (numpy fields) into
the port's ``MapStore``; ``arrays_from_numpy`` turns the numpy
``BlockArrays`` of ``graph.arrays.export_arrays`` (either package's) into
device tensors.  The parity tests use both so that the two packages start
from identical state.  Neither function imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ar_slam_tpu_torch.device import resolve_device, resolve_dtype
from ar_slam_tpu_torch.graph.store import MapStore


def store_from_jax(jax_store, native: bool | None = None) -> MapStore:
    """A port ``MapStore`` with the same captures, tags, blocks, camera and
    unsolved pool as ``jax_store`` (indices preserved)."""
    store = MapStore(initial_focal=float(jax_store.camera.params[0]),
                     native=native)
    for cap in jax_store.captures:
        c = store.add_capture(cap.uid, cap.img_fn)
        c.inv_pose = np.array(cap.inv_pose, dtype=float)
        c.init_block = cap.init_block
    for tag in jax_store.arucos:
        t = store.add_aruco(tag.id)
        t.pose = np.array(tag.pose, dtype=float)
        t.initialized = tag.initialized
    if jax_store.blocks:
        store.bulk_add_blocks(
            np.stack([b.corners for b in jax_store.blocks]),
            np.array([b.cap_idx for b in jax_store.blocks], np.int32),
            np.array([b.tag_idx for b in jax_store.blocks], np.int32))
    store.camera.params = np.array(jax_store.camera.params, dtype=float)
    store.camera.size = (None if jax_store.camera.size is None
                         else tuple(jax_store.camera.size))
    store.camera.focal_calibrated = jax_store.camera.focal_calibrated
    store.unsolved_captures = set(jax_store.unsolved_captures)
    return store


def arrays_from_numpy(block_arrays, device=None, dtype=None) -> dict:
    """Device tensors for every array field of ``block_arrays``: float
    fields in ``dtype``, index fields int64, masks bool; the counts stay
    Python ints."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    out = {}
    for name, v in block_arrays._asdict().items():
        if not isinstance(v, np.ndarray):
            out[name] = v
        elif v.dtype == np.bool_:
            out[name] = torch.as_tensor(v, device=device)
        elif np.issubdtype(v.dtype, np.integer):
            out[name] = torch.as_tensor(v.astype(np.int64), device=device)
        else:
            out[name] = torch.as_tensor(v, device=device, dtype=dtype)
    return out
