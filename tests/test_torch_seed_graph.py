"""The seeds as program stages, float64 on the CPU.

A flush's seeds are the padded slot tables of the JAX package's wave
program (``pack_waves``) applied by one stage with no host read
(``seed_waves``), which the card replays as a CUDA graph; localize seeds
its queries in the stage ``init``.  Here the stage, run eagerly, matches
the JAX package's ``apply_wave_seeds_multi`` on the same tables within
1e-10; neither stage reads the host; and the drivers that apply them
(``solve`` with multi-wave flushes, ``solve_incremental``) match the JAX
package's at the parity tests' 1e-6.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.solve import batch as jbatch
from ar_slam_tpu.utils.synthetic import make_synthetic_map
from ar_slam_tpu_torch import programs
from ar_slam_tpu_torch.config import ArSlamConfig as TConfig
from ar_slam_tpu_torch.convert import store_from_jax
from ar_slam_tpu_torch.graph.arrays import obs_bucket
from ar_slam_tpu_torch.solve import batch as tbatch
from ar_slam_tpu_torch.solve import graphs
from ar_slam_tpu_torch.solve.lm import LMConfig
from test_torch_lm_graph import NoHostSync, _queries
from torch_cases import bfs_waves, synthetic_arrays

torch.set_num_threads(1)
SIZE = 0.0635
TOL = 1e-6  # the solve drivers' parity (test_torch_batch, _incremental)


def _case(single: bool = False):
    """(arrays, three waves that each initialize tags, the slot count)."""
    a = synthetic_arrays(seed=7, n_tags=40, n_caps=10, perturb=0.05)
    waves = bfs_waves(a, [3, 1, 5], single)
    assert all(w[2] for w in waves) and waves[1][1] >= 0
    return a, waves, obs_bucket(int(np.bincount(a.cap_idx[a.block_mask])
                                    .max()))


@pytest.mark.parametrize("mode,single", [("hybrid", False),
                                         ("frontal", True)])
def test_seed_stage_matches_jax(mode, single):
    """Three waves padded to W = 4 (one padding wave) and S = obs_per_cap:
    the stage equals the JAX package's scan within 1e-10, and
    ``apply_wave_seeds_multi`` (the CPU's path) is the stage."""
    a, waves, slots = _case(single)
    tab = tbatch.pack_waves(waves, slots, w_min=1)
    assert tab.shape == (4, 2 + 5 * slots)
    t = {k: torch.as_tensor(getattr(a, k)) for k in (
        "camera", "cap_poses", "tag_poses", "corners")}
    tag_idx = torch.as_tensor(a.tag_idx).long()
    got = tbatch.seed_waves(t["camera"], t["cap_poses"], t["tag_poses"],
                            tag_idx, t["corners"], torch.as_tensor(tab),
                            aruco_size=SIZE, seed_mode=mode)
    via = tbatch.apply_wave_seeds_multi(
        t["camera"], t["cap_poses"], t["tag_poses"], tag_idx, t["corners"],
        waves, SIZE, mode, slots=slots)
    cols = [jnp.asarray(c, jnp.int32) for c in (
        tab[:, 0], tab[:, 1], *np.split(tab[:, 2:], 5, axis=1))]
    cols[4], cols[6] = cols[4] != 0, cols[6] != 0
    ref = jax.jit(partial(jbatch.apply_wave_seeds_multi, aruco_size=SIZE,
                          seed_mode=mode))(
        *map(jnp.asarray, (a.camera, a.cap_poses, a.tag_poses, a.cap_idx,
                           a.tag_idx, a.corners)), *cols)
    for g, v, r, before in zip(got, via, ref, (a.cap_poses, a.tag_poses)):
        assert torch.equal(g, v)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-10)
        assert not np.array_equal(g.numpy(), before)
    # the root wave (-1) keeps its capture; the padding wave changes nothing
    assert torch.equal(got[0][3], t["cap_poses"][3])


def test_seed_program_stage_is_seed_waves():
    """The program's ``seed`` stage, run eagerly, is ``seed_waves``."""
    a, waves, slots = _case()
    tab = torch.as_tensor(tbatch.pack_waves(waves, slots, 8))
    args = [torch.as_tensor(x) for x in (a.camera, a.cap_poses,
                                         a.tag_poses)]
    args += [torch.as_tensor(a.tag_idx).long(), torch.as_tensor(a.corners),
             tab]
    ref = tbatch.seed_waves(*args, aruco_size=SIZE, seed_mode="hybrid")
    got = graphs.seed_waves_graphed(*args, aruco_size=SIZE,
                                    seed_mode="hybrid", graphed=False)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        graphs.seed_waves_graphed(*args, aruco_size=SIZE, seed_mode="hybrid")


def test_seed_and_init_stages_read_nothing_back(monkeypatch):
    """The seed stage and localize's ``init`` run under NoHostSync: no
    host read, no tensor made from host data."""
    a, waves, slots = _case()
    tab = torch.as_tensor(tbatch.pack_waves(waves, slots, 1))
    args = [torch.as_tensor(x) for x in (a.camera, a.cap_poses, a.tag_poses)]
    args += [torch.as_tensor(a.tag_idx).long(), torch.as_tensor(a.corners),
             tab]
    with NoHostSync():
        tbatch.seed_waves(*args, aruco_size=SIZE, seed_mode="hybrid")
    ran = []
    run = programs.Program.run

    def guarded(self, name):
        ran.append(name)
        with NoHostSync():
            run(self, name)

    monkeypatch.setattr(programs.Program, "run", guarded)
    graphs.localize_graphed(*[torch.as_tensor(x) for x in _queries()],
                            aruco_size=SIZE, config=LMConfig(),
                            graphed=False)
    assert ran[0] == "init" and "iterate" in ran


def _solver(config, **fields):
    return dataclasses.replace(config, solver=dataclasses.replace(
        config.solver, **fields))


def _poses(store):
    return (np.stack([c.inv_pose for c in store.captures]),
            np.stack([t.pose for t in store.arucos]), store.camera.params)


@pytest.mark.parametrize("fields", [
    dict(optimize_every=3),
    dict(optimize_every=2, seed_anchors="single")])
def test_solve_multi_wave_flushes_match_jax(fields):
    """``solve`` whose flushes carry several waves (seed tables padded to
    the optimize_every bucket) against the JAX package's."""
    js, _ = make_synthetic_map(n_tags=16, n_caps=8, seed=3, noise_px=0.3)
    ts = store_from_jax(js)
    ref = jbatch.solve(js, _solver(JConfig(), **fields), dtype=np.float64)
    got = tbatch.solve(ts, _solver(TConfig(), **fields),
                       dtype=torch.float64, device="cpu")
    assert got["waves"] == ref["waves"] == 8 and got["rmse"] < 0.5
    assert abs(got["rmse"] - ref["rmse"]) <= TOL * ref["rmse"]
    for g, r in zip(_poses(ts), _poses(js)):
        np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL)


def test_solve_incremental_matches_jax():
    """``solve_incremental`` from nothing solved, one attachment a flush,
    against the JAX package's."""
    js, _ = make_synthetic_map(n_tags=12, n_caps=6, seed=13, noise_px=0.3)
    ts = store_from_jax(js)
    ref = jbatch.solve_incremental(js, JConfig(), dtype=np.float64)
    got = tbatch.solve_incremental(ts, TConfig(), dtype=torch.float64,
                                   device="cpu")
    assert got["waves"] == ref["waves"] and got["unsolved"] == 0
    assert abs(got["rmse"] - ref["rmse"]) <= TOL * ref["rmse"]
    for g, r in zip(_poses(ts), _poses(js)):
        np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL)
