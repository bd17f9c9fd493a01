"""The flat LM's program stages and its fixed-order sums on the CPU,
float64.

``lm_solve`` without observation bounds, or with an ``assemble_fn``, runs
the flat block hooks (``lm.flat_solver``); on the card as the stages
``setup`` / ``step`` / ``accept`` / ``reject`` of solve/graphs.py, which
replay CUDA graphs.  Here the same stages run eagerly and must give
``lm_core``'s results over the same hooks bit for bit, through every
termination the synthetic cases reach, and agree with the JAX package's
flat ``lm_solve`` within 1e-9 in cost; the flat assembly's sums
(``schur.segment_plan``, which replace ``index_add_``) agree with
``index_add_`` within 1e-12 and repeat bit for bit whatever order the
blocks come in; no stage reads the host; and host-stepped progress
through the stages prints the eager stepping's lines.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ar_slam_tpu.solve.lm as jlm_module
import ar_slam_tpu_torch.solve.batch as tbatch
from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.solve import lm as jlm
from ar_slam_tpu.solve import schur as jschur
from ar_slam_tpu.solve.batch import solve as j_solve
from ar_slam_tpu.utils.synthetic import make_synthetic_map
from ar_slam_tpu_torch.config import ArSlamConfig as TConfig
from ar_slam_tpu_torch.convert import store_from_jax
from ar_slam_tpu_torch.solve import graphs
from ar_slam_tpu_torch.solve import lm as tlm
from ar_slam_tpu_torch.solve import residuals as tres
from ar_slam_tpu_torch.solve import schur as tschur
from test_torch_lm_graph import CASES, NoHostSync, _args, _assert_equal
from test_torch_lm_graph import _torch_args
from test_torch_progress import _progress_run
from torch_cases import synthetic_arrays

torch.set_num_threads(1)
SIZE = 0.0635


@pytest.fixture(scope="module")
def arrs():
    return synthetic_arrays(seed=3, n_tags=20, n_caps=10, perturb=0.01)


def _custom(*a):
    return tschur.assemble(*a)


def _flat_ref(targs, config, custom, **kw):
    """``lm_core`` over the flat hooks (``flat_solver``), eagerly."""
    hooks = tlm.flat_solver(
        *targs[3:], aruco_size=SIZE, config=config,
        n_caps=targs[1].shape[0], n_tags=targs[2].shape[0],
        assemble_fn=_custom if custom else None)
    lin_fn, quality_fn, solve_fn, _ = hooks
    return tlm.lm_core(*targs[:3], *targs[7:], lin_fn, quality_fn, config,
                       solve_fn=solve_fn, **kw)


@pytest.mark.parametrize("custom", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_flat_stages_equal_lm_core(arrs, case, custom):
    """The flat stages driven by the graphs' host loop give ``lm_core``'s
    results over the same hooks bit for bit (state, cost, lambda, nu,
    flags, termination, iterations, gradient), with and without an
    assemble_fn, through every termination."""
    overrides, term = CASES[case]
    config = tlm.LMConfig(**overrides)
    args, kw = _args(arrs, case)
    targs = _torch_args(args)
    ref = _flat_ref(targs, config, custom, **kw)
    got = graphs.lm_solve_graphed(
        *targs, aruco_size=SIZE, config=config, graphed=False,
        assemble_fn=_custom if custom else None, **kw)
    _assert_equal(got, ref)
    if term is not None:
        assert int(got[3]["termination"]) == term
    iters = got[3]["iterations"]
    assert iters == {"budget_1": 1, "full_budget": 6, "disabled": 0,
                     "gradient_at_start": 0}.get(case, iters)


@pytest.mark.parametrize("custom", [False, True])
def test_flat_stages_resume_damping(arrs, custom):
    """lam0 / nu0 (host-stepped progress) resume the schedule through the
    flat stages as through ``lm_core``."""
    config = tlm.LMConfig()
    targs = _torch_args(_args(arrs, "function")[0])
    kw = dict(iter_budget=2, lam0=3e-3, nu0=8.0)
    ref = _flat_ref(targs, config, custom, **kw)
    got = graphs.lm_solve_graphed(
        *targs, aruco_size=SIZE, config=config, graphed=False,
        assemble_fn=_custom if custom else None, **kw)
    _assert_equal(got, ref)


@pytest.mark.parametrize("custom", [False, True])
def test_flat_stages_match_jax(arrs, custom):
    """The flat stages against the JAX package's flat ``lm_solve`` (and
    with ``schur.assemble`` as its assemble_fn): the same iterations and
    termination, cost within 1e-9 relative."""
    args, _ = _args(arrs, "function")
    ref = jlm.lm_solve(*map(jnp.asarray, args), aruco_size=SIZE,
                       **(dict(assemble_fn=jschur.assemble) if custom
                          else {}))
    got = graphs.lm_solve_graphed(
        *_torch_args(args), aruco_size=SIZE, config=tlm.LMConfig(),
        graphed=False, assemble_fn=_custom if custom else None)
    c_ref, c_got = float(ref[3]["cost"]), float(got[3]["cost"])
    assert abs(c_got - c_ref) <= 1e-9 * c_ref
    assert got[3]["iterations"] == int(ref[3]["iterations"])
    assert int(got[3]["termination"]) == int(ref[3]["termination"])
    assert float(got[3]["initial_cost"]) > 10 * c_got


def _products(a):
    """The flat assembly's inputs at the arrays' poses."""
    t = _torch_args((a.camera, a.cap_poses, a.tag_poses, a.cap_idx,
                     a.tag_idx, a.corners, a.block_mask))
    r, jc, jp, jt, _ = tres.linearize(*t[:7], SIZE)
    return r, jc, jp, jt, t[3], t[4]


def _index_add_eqs(r, jc, jp, jt, ci, ti, n_caps, n_tags):
    """The flat normal equations summed with ``index_add_``."""
    def seg(x, i, n):
        return x.new_zeros((n,) + x.shape[1:]).index_add_(0, i, x)

    o = tschur._outer_rsum
    six = torch.arange(6)
    rows = ci[:, None, None] * 6 + six[None, :, None]
    cols = ti[:, None, None] * 6 + six[None, None, :]
    hpt_b = o(jp, jt)
    flat = (rows * (6 * n_tags) + cols).expand(hpt_b.shape).reshape(-1)
    hpt = hpt_b.new_zeros(36 * n_caps * n_tags).index_add_(
        0, flat, hpt_b.reshape(-1)).reshape(6 * n_caps, 6 * n_tags)
    return dict(hcp=seg(o(jc, jp), ci, n_caps), hpp=seg(o(jp, jp), ci, n_caps),
                g_p=seg((jp * r[:, :, None]).sum(1), ci, n_caps),
                hct=seg(o(jc, jt), ti, n_tags), htt=seg(o(jt, jt), ti, n_tags),
                g_t=seg((jt * r[:, :, None]).sum(1), ti, n_tags), hpt=hpt)


def test_fixed_order_sums_match_index_add(arrs):
    """Every summed field of the flat normal equations within 1e-12
    (relative to its largest entry) of the ``index_add_`` sums; and
    ``segment_sum`` on its own, keys with no rows, one row and all rows
    included."""
    n_caps, n_tags = arrs.cap_poses.shape[0], arrs.tag_poses.shape[0]
    r, jc, jp, jt, ci, ti = _products(arrs)
    eqs = tschur.assemble(r, jc, jp, jt, ci, ti, n_caps, n_tags)
    for name, ref in _index_add_eqs(r, jc, jp, jt, ci, ti, n_caps,
                                    n_tags).items():
        got = getattr(eqs, name)
        assert got.shape == ref.shape
        assert (got - ref).abs().max() <= 1e-12 * ref.abs().max(), name
    gen = torch.Generator().manual_seed(0)
    for b, n in ((1, 3), (2, 2), (37, 5), (1000, 40), (513, 1)):
        idx = torch.randint(0, n, (b,), generator=gen)
        x = torch.randn(b, 7, dtype=torch.float64, generator=gen)
        ref = x.new_zeros(n, 7).index_add_(0, idx, x)
        got = tschur.segment_sum(x, tschur.segment_plan(idx, n))
        assert (got - ref).abs().max() <= 1e-12 * ref.abs().max()


def test_fixed_order_sums_ignore_the_blocks_order(arrs):
    """The blocks fed in a permuted order, each with its own indices and
    mask (the same real blocks per capture, tag and pair): the hooks'
    normal equations bit for bit the same; and run twice, the same."""
    n_caps, n_tags = arrs.cap_poses.shape[0], arrs.tag_poses.shape[0]
    prods = _products(arrs)
    mask = torch.as_tensor(arrs.block_mask)

    def eqs(p, m):
        plans = tschur.flat_plans(p[4], p[5], n_caps, n_tags, m)
        return tschur.assemble(*p, n_caps, n_tags, plans=plans)

    ref = eqs(prods, mask)
    perm = torch.randperm(mask.shape[0],
                          generator=torch.Generator().manual_seed(1))
    for got in (eqs([x[perm] for x in prods], mask[perm]), eqs(prods, mask)):
        for name in ref._fields:
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
    loose = tschur.assemble(*prods, n_caps, n_tags)  # no mask: zero rows in
    for name in ref._fields:
        r = getattr(ref, name)
        assert (getattr(loose, name) - r).abs().max() <= 1e-12 * r.abs().max()


@pytest.mark.parametrize("custom", [False, True])
def test_flat_stages_read_nothing_back(arrs, monkeypatch, custom):
    """No flat stage reads a value to the host or makes a tensor from host
    data: each runs under NoHostSync, the host loop between them does
    not."""
    ran = []
    run = graphs.Program.run

    def guarded(self, name):
        ran.append(name)
        with NoHostSync():
            run(self, name)

    monkeypatch.setattr(graphs.Program, "run", guarded)
    for case in ("function", "stall", "warmup_masks"):
        args, kw = _args(arrs, case)
        graphs.lm_solve_graphed(
            *_torch_args(args), aruco_size=SIZE,
            config=tlm.LMConfig(**CASES[case][0]), graphed=False,
            assemble_fn=_custom if custom else None, **kw)
    assert {"setup", "step", "accept", "reject"} <= set(ran)


def test_progress_through_the_stages(capsys):
    """Host-stepped progress with each one-iteration call through the
    stages (as the card replays them): the printed lines and each call's
    cost bit for bit the eager stepping's, and within 1e-9 relative of
    the JAX package's stepped costs, with the same lines."""
    js, _ = make_synthetic_map(n_tags=12, n_caps=3, seed=10, noise_px=0.3)
    stores = [store_from_jax(js) for _ in range(2)]
    ref, r_costs, r_iters, r_terms = _progress_run(
        j_solve, js, JConfig(), jlm_module, capsys, dtype=np.float64)
    eager = _progress_run(tbatch.solve, stores[0], TConfig(), tbatch, capsys,
                          dtype=torch.float64, device="cpu")
    plain = tbatch.lm_solve

    def staged(*a, graphs=True, **kw):
        bounds = tlm.grouped_bounds(
            a[2].shape[0], kw["config"], kw.pop("obs_per_tag"),
            kw.pop("obs_per_cap"), kw.pop("row_slots"), kw.pop("tag_rows"),
            kw.pop("cap_rows"))
        return graph_lm(*a, graphed=False, **bounds, **kw)

    graph_lm = graphs.lm_solve_graphed
    tbatch.lm_solve = staged
    try:
        got = _progress_run(tbatch.solve, stores[1], TConfig(), tbatch,
                            capsys, dtype=torch.float64, device="cpu")
    finally:
        tbatch.lm_solve = plain

    def cols(lines):  # not the times
        return [ln.split()[:5] for ln in lines]

    assert got[1] == eager[1] and len(got[1]) == len(r_costs) > 4
    assert cols(got[2]) == cols(eager[2]) and got[3] == eager[3]
    assert got[0]["rmse"] == eager[0]["rmse"]
    for g, r in zip(got[1], r_costs):
        assert abs(g - r) <= 1e-9 * r
    assert [[ln.split()[i] for i in (0, 1, 3, 4)] for ln in got[2]] == [
        [ln.split()[i] for i in (0, 1, 3, 4)] for ln in r_iters]
    assert got[3] == r_terms
