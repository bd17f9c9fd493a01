"""Port parity: the flat solver path (solve/schur.py assemble,
schur_solve, quad_form_flat; lm_solve's flat block hooks and assemble_fn)
and ``solve``'s assemble_fn, against the JAX package, float64 on the
CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.solve import lm as jlm
from ar_slam_tpu.solve import residuals as jres
from ar_slam_tpu.solve import schur as jschur
from ar_slam_tpu.solve.batch import solve as j_solve
from ar_slam_tpu.utils.synthetic import make_synthetic_map
from ar_slam_tpu_torch.config import ArSlamConfig as TConfig
from ar_slam_tpu_torch.convert import arrays_from_numpy, store_from_jax
from ar_slam_tpu_torch.solve import lm as tlm
from ar_slam_tpu_torch.solve import residuals as tres
from ar_slam_tpu_torch.solve import schur as tschur
from ar_slam_tpu_torch.solve.batch import solve as t_solve
from torch_cases import synthetic_arrays

torch.set_num_threads(1)
SIZE = 0.0635


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("lam", [1e-4, 10.0])
def test_assemble_schur_solve_quad_form_flat_match(lam):
    """Every NormalEqs field (the dense hpt included), the flat Schur solve
    with one capture frozen and the quad form of its step: within 1e-9."""
    a = synthetic_arrays(seed=4)
    n_caps, n_tags = a.cap_poses.shape[0], a.tag_poses.shape[0]
    cap_act = a.cap_mask.copy()
    cap_act[0] = False

    def jax_side(cam, cp, tp, ci, ti, crn, bm, ca, ta):
        r, jc, jp, jt, _ = jres.linearize(cam, cp, tp, ci, ti, crn, bm, SIZE)
        eqs = jschur.assemble(r, jc, jp, jt, ci, ti, n_caps, n_tags)
        d = jschur.schur_solve(eqs, lam, True, ca, ta)
        return eqs, d, jschur.quad_form_flat(eqs, *d)

    eqs_r, d_r, q_r = jax.jit(jax_side)(*map(jnp.asarray, (
        a.camera, a.cap_poses, a.tag_poses, a.cap_idx, a.tag_idx, a.corners,
        a.block_mask, cap_act, a.tag_mask)))
    t = arrays_from_numpy(a, "cpu", torch.float64)
    r, jc, jp, jt, _ = tres.linearize(t["camera"], t["cap_poses"],
                                      t["tag_poses"], t["cap_idx"],
                                      t["tag_idx"], t["corners"],
                                      t["block_mask"], SIZE)
    eqs = tschur.assemble(r, jc, jp, jt, t["cap_idx"], t["tag_idx"], n_caps,
                          n_tags)
    d = tschur.schur_solve(eqs, lam, True, torch.as_tensor(cap_act),
                           t["tag_mask"])
    for name in eqs._fields:
        assert _rel(getattr(eqs, name), getattr(eqs_r, name)) < 1e-9, name
    for g, ref in zip(d, d_r):
        assert _rel(g, ref) < 1e-9
    for g, ref in zip(tschur.quad_form_flat(eqs, *d), q_r):
        assert _rel(g, ref) < 1e-9


@pytest.fixture(scope="module")
def flat_problem():
    a = synthetic_arrays(seed=3)
    args = (a.camera, a.cap_poses, a.tag_poses, a.cap_idx, a.tag_idx,
            a.corners, a.block_mask, True, a.cap_mask, a.tag_mask)
    t = arrays_from_numpy(a, "cpu", torch.float64)
    targs = [t[k] for k in ("camera", "cap_poses", "tag_poses", "cap_idx",
                            "tag_idx", "corners", "block_mask")]
    return args, targs + [True, t["cap_mask"], t["tag_mask"]]


def _same_solve(got, ref):
    c_ref, c_got = float(ref[3]["cost"]), float(got[3]["cost"])
    assert abs(c_got - c_ref) <= 1e-8 * c_ref
    assert got[3]["iterations"] == int(ref[3]["iterations"])
    assert int(got[3]["termination"]) == int(ref[3]["termination"])
    assert float(got[3]["initial_cost"]) > 10 * c_got


def test_lm_solve_without_bounds_runs_flat_hooks(flat_problem, monkeypatch):
    """Without obs_per_tag lm_solve runs the flat block hooks (never the
    grouped ones), as the reference's flat branch does: the same
    iterations and termination, cost within 1e-8."""
    args, targs = flat_problem
    ref = jlm.lm_solve(*map(jnp.asarray, args), aruco_size=SIZE)
    built = []
    make_block_hooks = tlm.make_block_hooks

    def spy(*a, **k):
        built.append("flat")
        return make_block_hooks(*a, **k)

    def no_grouped(*a, **k):
        raise AssertionError("the grouped hooks ran")

    monkeypatch.setattr(tlm, "make_block_hooks", spy)
    monkeypatch.setattr(tlm, "make_grouped_hooks", no_grouped)
    got = tlm.lm_solve(*targs, aruco_size=SIZE)
    assert built == ["flat"]
    _same_solve(got, ref)


def test_lm_solve_assemble_fn_runs_flat(flat_problem):
    """A custom assemble_fn wins over obs_per_tag: every linearization goes
    through it on the flat path, as in the reference."""
    args, targs = flat_problem
    bounds = dict(obs_per_tag=16, obs_per_cap=24)
    ref = jlm.lm_solve(*map(jnp.asarray, args), aruco_size=SIZE,
                       assemble_fn=jschur.assemble, **bounds)
    calls = []

    def assemble_fn(*a):
        calls.append(a[0].shape)
        return tschur.assemble(*a)

    got = tlm.lm_solve(*targs, aruco_size=SIZE, assemble_fn=assemble_fn,
                       **bounds)
    n_blocks = targs[3].shape[0]
    assert calls and set(calls) == {(n_blocks, 8)}
    _same_solve(got, ref)


def test_solve_with_assemble_fn_matches():
    """``solve`` passes ``assemble_fn`` to every wave's LM (the flat
    hooks): the same waves and rmse within 1e-6 of the JAX package's."""
    js, _ = make_synthetic_map(n_tags=12, n_caps=3, seed=10, noise_px=0.3)
    ts = store_from_jax(js)
    calls = []

    def assemble_fn(*a):
        calls.append(1)
        return tschur.assemble(*a)

    ref = j_solve(js, JConfig(), dtype=np.float64,
                  assemble_fn=jschur.assemble)
    got = t_solve(ts, TConfig(), dtype=torch.float64, device="cpu",
                  assemble_fn=assemble_fn)
    assert calls and got["waves"] == ref["waves"] == 3
    assert abs(got["rmse"] - ref["rmse"]) <= 1e-6 * ref["rmse"]
