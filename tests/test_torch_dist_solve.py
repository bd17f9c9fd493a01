"""Port parity: the batch and incremental solve drivers with a mesh
(solve/batch.py's mesh branch over parallel/dist_lm.py), float64 on the
CPU, on the maps and mesh sizes of tests/test_dist.py:71-176.

tests/test_dist.py holds the JAX package's mesh drivers to its
single-device drivers; these tests hold the port's mesh drivers to the
JAX package's single-device drivers and to the port's own.  They do not
call JAX's mesh drivers: on the CPU (8 virtual devices), in a process
that has imported torch and set its threads to 1, the first mesh solve
sometimes returns a NaN cost, the same inputs giving the map below in
other runs (ROADMAP.md, Queue 3).

The synthetic maps carry 0.3 px of corner noise.  Measured: the port's
mesh solves agree with JAX's mesh and single-device solves, and with the
port's single-device solves, to 2e-14 relative in rmse, 1e-7 in every
pose and 4e-8 relative in the focal (LM stops on the function
tolerance, at points that differ by reduction order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.config import SolverConfig as JSolver
from ar_slam_tpu.solve.batch import solve as j_solve
from ar_slam_tpu.solve.batch import solve_incremental as j_inc
from ar_slam_tpu_torch.config import ArSlamConfig, DistConfig, SolverConfig
from ar_slam_tpu_torch.parallel import block_mesh
from ar_slam_tpu_torch.solve.batch import _WaveRunner, solve, solve_incremental
from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map

torch.set_num_threads(1)
RMSE_RTOL, POSE_ATOL, FOCAL_RTOL = 1e-10, 1e-6, 1e-6


def _store(n_tags, n_caps, seed):
    return make_synthetic_map(n_tags=n_tags, n_caps=n_caps, seed=seed,
                              noise_px=0.3)[0]


def _poses(store):
    return (np.stack([c.inv_pose for c in store.captures]),
            np.stack([t.pose for t in store.arucos]),
            np.asarray(store.camera.params, float))


def _same(a, b, out_a, out_b):
    assert out_a["waves"] == out_b["waves"]
    assert abs(out_a["rmse"] - out_b["rmse"]) <= RMSE_RTOL * out_b["rmse"]
    caps_a, tags_a, cam_a = _poses(a)
    caps_b, tags_b, cam_b = _poses(b)
    np.testing.assert_allclose(caps_a, caps_b, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(tags_a, tags_b, rtol=0, atol=POSE_ATOL)
    # the focal in pixels (and the radial terms, 0)
    np.testing.assert_allclose(cam_a, cam_b, rtol=FOCAL_RTOL, atol=0)


@pytest.mark.parametrize("fn, j_fn, n, map_args, by_config", [
    (solve, j_solve, 3, (12, 6, 3), False),
    (solve_incremental, j_inc, 4, (10, 5, 7), True),
], ids=["solve-3", "solve_incremental-4"])
def test_mesh_solve_matches_jax(fn, j_fn, n, map_args, by_config):
    """The same waves, rmse and poses as JAX's single-device driver and
    the port's.  The port's mesh is given, or built from
    config.dist.num_devices on device "cpu" (``by_config``: n repeated
    CPU shards)."""
    kw = dict(max_iterations=20, dtype="float64")
    j_store, t_store, t_single = (_store(*map_args) for _ in range(3))
    ref = j_fn(j_store, JConfig(solver=JSolver(**kw)), dtype=np.float64)
    cfg = ArSlamConfig(solver=SolverConfig(**kw))
    if by_config:
        got = fn(t_store, dataclasses.replace(
            cfg, dist=DistConfig(num_devices=n)), device="cpu")
    else:
        got = fn(t_store, cfg, mesh=block_mesh(devices=["cpu"] * n))
    single = fn(t_single, cfg, device="cpu")
    if fn is solve_incremental:
        assert got["unsolved"] == ref["unsolved"] == 0
    _same(t_store, j_store, got, ref)
    _same(t_store, t_single, got, single)


def test_mesh_solve_cg_matches_single_device():
    """linear_solver="cg" with a tight tolerance (its steps exact, so the
    LM path does not follow rounding): the mesh driver's map is the
    single-device CG driver's."""
    cfg = ArSlamConfig(solver=SolverConfig(
        max_iterations=20, dtype="float64", linear_solver="cg",
        cg_tolerance=1e-10, cg_max_iterations=60))
    a, b = _store(8, 4, 3), _store(8, 4, 3)
    got = solve(a, cfg, mesh=block_mesh(devices=["cpu"] * 2))
    ref = solve(b, cfg, device="cpu")
    _same(a, b, got, ref)


def test_mesh_wave_budget_and_polish():
    """A mesh wave respects the per-wave budget, not the static bound the
    polish inflates, and the polish pass runs on the mesh (≙
    tests/test_dist.py:106-159)."""
    scfg = SolverConfig(max_iterations=6, final_polish_iterations=40,
                        dtype="float64", warmup_new_captures=False)
    store = _store(12, 6, 3)
    runner = _WaveRunner(store, scfg, 0.0635, torch.float64,
                         torch.device("cpu"),
                         mesh=block_mesh(devices=["cpu"] * 8))
    info = runner.run_wave(store.capture_with_most_blocks(), None)
    assert int(info["iterations"]) <= 6
    info2 = runner.polish(40)
    assert int(info2["iterations"]) > 6
    assert float(info2["cost"]) <= float(info["cost"]) * (1 + 1e-12)
