"""Port parity: the implicit-Schur CG solver (solve/schur.py row-split
packing and schur_solve_grouped_cg, lm_solve's CG branch) against the JAX
package, float64 on the CPU (the batch and incremental solves with CG are
in test_torch_cg_solve.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_slam_tpu.solve import lm as jlm
from ar_slam_tpu.solve import schur as jschur
from ar_slam_tpu_torch.convert import arrays_from_numpy
from ar_slam_tpu_torch.solve import lm as tlm
from ar_slam_tpu_torch.solve import schur as tschur
from torch_cases import slot_bounds, synthetic_arrays

torch.set_num_threads(1)
SIZE = 0.0635
ROW_SLOTS = 2  # small, so that every tag and capture spans several rows


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _grouping_case(n_rows_short):
    """50 blocks over 7 tags (~6 each), 80 % of them masked in."""
    rng = np.random.default_rng(0)
    tag_idx = rng.integers(0, 7, size=50)
    mask = rng.random(50) < 0.8
    counts = np.bincount(tag_idx[mask], minlength=7)
    need = int((-(-counts // ROW_SLOTS)).sum())
    max_rows = int(-(-counts.max() // ROW_SLOTS))
    return tag_idx, mask, need - n_rows_short, max_rows


@pytest.mark.parametrize("n_rows_short", [0, 3])
def test_group_blocks_by_tag_rows_equal(n_rows_short):
    """Every field exactly the reference's, also when the row budget is 3
    rows short and blocks are dropped."""
    tag_idx, mask, n_rows, max_rows = _grouping_case(n_rows_short)
    args = (7, ROW_SLOTS, n_rows, max_rows)
    got = tschur.group_blocks_by_tag_rows(torch.as_tensor(tag_idx),
                                          torch.as_tensor(mask), *args)
    ref = jax.jit(lambda t, m: jschur.group_blocks_by_tag_rows(t, m, *args))(
        jnp.asarray(tag_idx), jnp.asarray(mask))
    gather, gmask, rows = got
    np.testing.assert_array_equal(gather.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(ref[1]))
    for name in tschur.TagRows._fields:
        np.testing.assert_array_equal(getattr(rows, name).numpy(),
                                      np.asarray(getattr(ref[2], name)))
    if n_rows_short:
        assert int(gmask.sum()) < mask.sum()
    else:
        assert int(gmask.sum()) == mask.sum()


def test_rows_to_tags_and_back_equal():
    tag_idx, mask, n_rows, max_rows = _grouping_case(0)
    args = (7, ROW_SLOTS, n_rows, max_rows)
    _, _, rows = tschur.group_blocks_by_tag_rows(
        torch.as_tensor(tag_idx), torch.as_tensor(mask), *args)
    # integer values: the sums are exact in any order
    rng = np.random.default_rng(1)
    per_row = rng.integers(-999, 999, size=(n_rows, 6, 6)).astype(float)
    per_tag = rng.integers(-999, 999, size=(7, 6)).astype(float)

    def ref(t, m, x_rows, x_tags):
        _, _, jrows = jschur.group_blocks_by_tag_rows(t, m, *args)
        return (jschur.rows_to_tags(x_rows, jrows),
                jschur.tags_to_rows(x_tags, jrows))

    r_tags, r_rows = jax.jit(ref)(*map(jnp.asarray, (tag_idx, mask, per_row,
                                                     per_tag)))
    np.testing.assert_array_equal(
        tschur.rows_to_tags(torch.as_tensor(per_row), rows).numpy(),
        np.asarray(r_tags))
    np.testing.assert_array_equal(
        tschur.tags_to_rows(torch.as_tensor(per_tag), rows).numpy(),
        np.asarray(r_rows))


@pytest.fixture(scope="module")
def problem():
    """A map LM with CG solves in 10 iterations, and capture 0 frozen for
    the CG solves: numpy arrays, that mask and the slot bounds.  CG's
    inexact steps make the LM path follow rounding where it creeps along a
    shallow valley: from seed 3 (30 iterations) both packages stop after
    the same iterations 7e-7 apart in cost, from seed 7 within 1e-13."""
    a = synthetic_arrays(seed=7)
    cap_act = a.cap_mask.copy()
    cap_act[0] = False
    return a, cap_act, slot_bounds(a, ROW_SLOTS)


def _layout(split, bounds):
    s_tag, s_cap, n_rows, n_cap_rows = bounds
    if not split:
        return dict(row_slots=None, n_rows=None, n_cap_rows=None)
    return dict(row_slots=ROW_SLOTS, n_rows=n_rows, n_cap_rows=n_cap_rows)


@pytest.fixture(scope="module", params=[False, True], ids=["unsplit",
                                                           "row_split"])
def cg_case(request, problem):
    """Both packages' grouped equations of ``problem`` (row-split or not),
    and the two CG solvers as functions of (lam, x0, tol, iters)."""
    a, cap_act, bounds = problem
    n_caps, n_tags = a.cap_poses.shape[0], a.tag_poses.shape[0]
    layout = _layout(request.param, bounds)

    def hooks(cam, cp, tp, ci, ti, crn, bm):
        lin, _, ctx = jlm.make_grouped_hooks(ci, ti, crn, bm, SIZE, n_caps,
                                             n_tags, *bounds[:2], **layout)
        return lin(cam, cp, tp)[0], ctx

    eqs_r, ctx_r = jax.jit(hooks)(*map(jnp.asarray, (
        a.camera, a.cap_poses, a.tag_poses, a.cap_idx, a.tag_idx, a.corners,
        a.block_mask)))
    t = arrays_from_numpy(a, "cpu", torch.float64)
    lin, _, ctx = tlm.make_grouped_hooks(
        t["cap_idx"], t["tag_idx"], t["corners"], t["block_mask"], SIZE,
        n_caps, n_tags, *bounds[:2], **layout)
    eqs, _ = lin(t["camera"], t["cap_poses"], t["tag_poses"])
    jit_cache = {}

    def ref(lam, x0, tol, iters):
        if (tol, iters) not in jit_cache:
            def f(eqs, ctx, lam, x0, ca, ta):
                return jschur.schur_solve_grouped_cg(
                    eqs, ctx[0], ctx[1], ctx[2], lam, True, ca, ta,
                    cg_tol=tol, cg_iters=iters, x0=x0, rows=ctx[3],
                    cap_rows=ctx[4])
            jit_cache[tol, iters] = jax.jit(f)
        return jit_cache[tol, iters](eqs_r, ctx_r, lam, jnp.asarray(x0),
                                     jnp.asarray(cap_act),
                                     jnp.asarray(a.tag_mask))

    def got(lam, x0, tol, iters):
        return tschur.schur_solve_grouped_cg(
            eqs, ctx[0], ctx[1], ctx[2], lam, True, torch.as_tensor(cap_act),
            t["tag_mask"], cg_tol=tol, cg_iters=iters,
            x0=None if not x0.any() else torch.as_tensor(x0), rows=ctx[3],
            cap_rows=ctx[4])

    return eqs, eqs_r, ref, got, 3 + 6 * n_caps


def test_assemble_grouped_rows_match(cg_case):
    """Every grouped block within 1e-9, with rows / cap_rows or without."""
    eqs, eqs_r = cg_case[:2]
    for name in eqs._fields:
        assert _rel(getattr(eqs, name), getattr(eqs_r, name)) < 1e-9, name


@pytest.mark.parametrize("lam", [1e-4, 10.0])
@pytest.mark.parametrize("tol,iters", [(0.3, 25), (1e-10, 100)],
                         ids=["default_cap", "tight"])
@pytest.mark.parametrize("warm", [False, True], ids=["x0_zero", "x0_warm"])
def test_schur_solve_grouped_cg_matches(cg_case, lam, tol, iters, warm):
    """The four outputs within 1e-8: under the default cap that binds and
    at a tight tolerance, from x0 = 0 and from a warm start."""
    _, _, ref, got, nr = cg_case
    x0 = (np.random.default_rng(2).normal(scale=1e-3, size=nr) if warm
          else np.zeros(nr))
    for g, r in zip(got(lam, x0, tol, iters), ref(lam, x0, tol, iters)):
        assert _rel(g, r) <= 1e-8


@pytest.mark.parametrize("split", [False, True], ids=["unsplit",
                                                      "row_split"])
def test_lm_solve_cg_matches(problem, split):
    """lm_solve(linear_solver="cg"): the same iterations and termination,
    cost within 1e-8."""
    a, _, bounds = problem
    s_tag, s_cap, n_rows, n_cap_rows = bounds
    rows = (dict(row_slots=ROW_SLOTS, tag_rows=n_rows, cap_rows=n_cap_rows)
            if split else {})
    config = jlm.LMConfig(linear_solver="cg")
    args = (a.camera, a.cap_poses, a.tag_poses, a.cap_idx, a.tag_idx,
            a.corners, a.block_mask, True, a.cap_mask, a.tag_mask)
    ref = jlm.lm_solve(*map(jnp.asarray, args), aruco_size=SIZE,
                       config=config, obs_per_tag=s_tag, obs_per_cap=s_cap,
                       **rows)
    t = arrays_from_numpy(a, "cpu", torch.float64)
    got = tlm.lm_solve(t["camera"], t["cap_poses"], t["tag_poses"],
                       t["cap_idx"], t["tag_idx"], t["corners"],
                       t["block_mask"], True, t["cap_mask"], t["tag_mask"],
                       aruco_size=SIZE, config=tlm.LMConfig(linear_solver="cg"),
                       obs_per_tag=s_tag, obs_per_cap=s_cap, **rows)
    c_ref, c_got = float(ref[3]["cost"]), float(got[3]["cost"])
    assert abs(c_got - c_ref) <= 1e-8 * c_ref
    assert got[3]["iterations"] == int(ref[3]["iterations"])
    assert int(got[3]["termination"]) == int(ref[3]["termination"])
    assert float(got[3]["initial_cost"]) > 10 * c_got
