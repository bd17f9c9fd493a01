"""Port parity: the batch and incremental solves with
``linear_solver="cg"`` (the CG row tables of solve/batch.py, the row-split
CG in every wave) against the JAX package, float64 on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.solve.batch import solve as j_solve
from ar_slam_tpu.solve.batch import solve_incremental as j_inc
from ar_slam_tpu.utils.synthetic import make_synthetic_map
from ar_slam_tpu_torch.config import ArSlamConfig as TConfig
from ar_slam_tpu_torch.convert import store_from_jax
from ar_slam_tpu_torch.solve.batch import solve as t_solve
from ar_slam_tpu_torch.solve.batch import solve_incremental as t_inc

torch.set_num_threads(1)


def _cg(config):
    """``config`` with the CG solver at a tolerance it meets within its cap:
    at the default 0.3 / 25 the waves' inexact steps stop LM at points of
    a shallow valley that follow rounding (seed 10, 8 captures: rmse 4e-4
    apart), and every later wave is seeded from them."""
    return dataclasses.replace(config, solver=dataclasses.replace(
        config.solver, linear_solver="cg", cg_tolerance=1e-12,
        cg_max_iterations=50))


@pytest.mark.parametrize("which", ["solve", "solve_incremental"])
def test_solve_cg_matches(which):
    """The batch and incremental solves with linear_solver="cg" (row-split
    CG in every wave, warmups included): the same waves, rmse within 1e-6
    of the JAX package's."""
    js, _ = make_synthetic_map(n_tags=12, n_caps=5, seed=10, noise_px=0.3)
    ts = store_from_jax(js)
    j_fn, t_fn = {"solve": (j_solve, t_solve),
                  "solve_incremental": (j_inc, t_inc)}[which]
    ref = j_fn(js, _cg(JConfig()), dtype=np.float64)
    got = t_fn(ts, _cg(TConfig()), dtype=torch.float64, device="cpu")
    assert got["waves"] == ref["waves"] == 5
    assert abs(got["rmse"] - ref["rmse"]) <= 1e-6 * ref["rmse"]
    assert got["rmse"] < 1.0
