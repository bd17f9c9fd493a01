"""Where the port's mesh path used to differ from the JAX package's, it
now does as the JAX package does (CPU):

- a mesh asked for more devices than there are is the mesh of them all
  (the JAX package's ``devices[:n]``);
- a mesh solve given an ``assemble_fn`` ignores it and assembles grouped;
- under a process group, detection splits the batch over every process's
  shards and every process gathers the whole batch's detections (two
  gloo processes, against one process's detect_batch).
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ar_slam_tpu.parallel import block_mesh as j_block_mesh
from ar_slam_tpu.parallel.detect import image_mesh as j_image_mesh
from ar_slam_tpu_torch.config import ArSlamConfig, SolverConfig
from ar_slam_tpu_torch.convert import store_from_jax
from ar_slam_tpu_torch.detect.detect import DetectParams, detect_batch
from ar_slam_tpu_torch.parallel import block_mesh
from ar_slam_tpu_torch.parallel.detect import image_mesh
from ar_slam_tpu_torch.solve.batch import solve
from ar_slam_tpu.utils.synthetic import make_synthetic_map
from test_torch_detect import _frames

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


@pytest.mark.parametrize("make,j_make", [(block_mesh, j_block_mesh),
                                         (image_mesh, j_image_mesh)])
@pytest.mark.parametrize("extra", [0, 3])
def test_mesh_above_device_count_shrinks(monkeypatch, make, j_make, extra):
    """More devices than there are (and exactly as many): the mesh of
    every device, the size of the JAX package's mesh over its devices."""
    n = len(jax.devices())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    mesh = make(n + extra)
    assert mesh.devices == [torch.device("cuda", i) for i in range(n)]
    assert mesh.n_shards == j_make(n + extra).devices.size == n


def test_mesh_without_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="device_count"):
        block_mesh(2)


def test_mesh_solve_ignores_assemble_fn():
    """solve over a two-shard mesh with an assemble_fn: the hook is never
    called and the map is the mesh solve's without it, bit for bit."""
    js, _ = make_synthetic_map(n_tags=12, n_caps=5, seed=10, noise_px=0.3)
    cfg = ArSlamConfig(solver=SolverConfig(dtype="float64"))
    calls = []

    def assemble_fn(*args):
        calls.append(args)
        raise AssertionError("the mesh path must not assemble flat")

    maps = []
    for fn in (None, assemble_fn):
        store = store_from_jax(js)
        out = solve(store, cfg, device="cpu", assemble_fn=fn,
                    mesh=block_mesh(devices=["cpu"] * 2))
        maps.append((out, [c.inv_pose.copy() for c in store.captures],
                     [t.pose.copy() for t in store.arucos]))
    assert not calls
    (o0, c0, t0), (o1, c1, t1) = maps
    assert o0 == o1 and o1["waves"] == 5
    for a, b in zip(c0 + t0, c1 + t1):
        assert np.array_equal(a, b)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_detect_like_one(tmp_path):
    """Two gloo processes, one CPU shard each, detect 3 frames (the
    second process's share holds 1 frame and 1 of padding): both hold
    every detection of the batch, equal to one process's detect_batch."""
    frames, _ = _frames(n=3)
    np.save(tmp_path / "frames.npy", frames)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_multihost_detect.py"),
         str(port), str(rank), "2", str(tmp_path / "frames.npy"),
         str(tmp_path / f"out{rank}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            p.kill()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank}:\n{out}\n{err}"
    ref = detect_batch(frames, params=DetectParams(
        win=3, win_sizes=(3, 13, 23), max_candidates=64), device="cpu")
    for rank in range(2):
        got = np.load(tmp_path / f"out{rank}.npz")
        assert int(got["n_shards"]) == 2 and int(got["n_local"]) == 1
        assert got["local_images"].tolist() == [[2], [1]][rank]
        for name, d in ref.items():
            for key, v in d.items():
                assert np.array_equal(got[f"{name}.{key}"], v.numpy()), (
                    rank, name, key)
