"""The solver's CUDA-graph stages on the CPU, float64.

solve/graphs.py replays the LM iteration as the stages ``lm_step`` /
``lm_accept`` / ``lm_reject`` and localize's as ``localize_iteration``.
Here the same stages run eagerly, driven by the same host loop (the
CPU's only path): through every termination they agree with the JAX
package's jitted ``lm_solve`` and ``localize_kernel`` within 1e-10, with
the same iterations and terminations; a run resumed at its returned
damping continues it bit for bit; and no operation that a CUDA graph
cannot capture runs inside a stage.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ar_slam_tpu.solve import lm as jlm
from ar_slam_tpu.solve import localize as jloc
from ar_slam_tpu_torch import programs
from ar_slam_tpu_torch.solve import graphs
from ar_slam_tpu_torch.solve import lm as tlm
from torch_cases import localize_queries as _queries
from torch_cases import slot_bounds, synthetic_arrays

torch.set_num_threads(1)
SIZE = 0.0635
ROW_SLOTS = 2

# each case names the termination it must reach (TERMINATION_REASONS)
CASES = {
    "function": (dict(), 1),
    "parameter": (dict(function_tolerance=0.0, parameter_tolerance=1e-3), 2),
    "gradient": (dict(function_tolerance=0.0, gradient_tolerance=5e3), 3),
    "gradient_at_start": (dict(gradient_tolerance=1e12), 3),
    # every step rejected until lambda passes the stall bound
    "stall": (dict(min_relative_decrease=10.0, stall_lambda=1e-2), 4),
    "budget_1": (dict(), 0),
    "full_budget": (dict(function_tolerance=0.0, parameter_tolerance=0.0,
                         max_iterations=6), 0),
    "disabled": (dict(), 5),
    "warmup_masks": (dict(), None),
}
# CG solved to 1e-14 in up to 200 steps, where its inexact steps would
# otherwise follow rounding (at 1e-12 in 60, the parameter case's one
# step from far off the optimum lands 1.7e-9 apart in cost)
EXACT_CG = dict(cg_tolerance=1e-14, cg_max_iterations=200)


@pytest.fixture(scope="module")
def problem():
    a = synthetic_arrays(seed=3, n_tags=20, n_caps=10, perturb=0.01)
    s_tag, s_cap, n_rows, n_cap_rows = slot_bounds(a, ROW_SLOTS)
    return a, dict(obs_per_tag=s_tag, obs_per_cap=s_cap,
                   row_slots=ROW_SLOTS, tag_rows=n_rows,
                   cap_rows=n_cap_rows)


def _args(a, case):
    """(positional lm_solve args as numpy, keywords) of a case."""
    cam, cap_m, tag_m = True, a.cap_mask, a.tag_mask
    kw = {}
    if case == "warmup_masks":  # register-then-refine: camera frozen
        cam = False
        cap_m = a.cap_mask & (np.arange(a.cap_mask.size) % 3 == 0)
        tag_m = a.tag_mask & (np.arange(a.tag_mask.size) % 2 == 0)
    if case == "budget_1":
        kw["iter_budget"] = 1
    if case == "disabled":
        kw["enabled"] = False
    return (a.camera, a.cap_poses, a.tag_poses, a.cap_idx, a.tag_idx,
            a.corners, a.block_mask, cam, cap_m, tag_m), kw


def _torch_args(args):
    """numpy arrays as float64 / int64 tensors; the camera flag stays."""
    out = []
    for x in args:
        if isinstance(x, np.ndarray):
            x = torch.as_tensor(x)
            x = (x.to(torch.float64) if x.is_floating_point() else
                 x.to(torch.int64) if x.dtype == torch.int32 else x)
        out.append(x)
    return out


def _assert_equal(got, ref):
    for g, r in zip(got[:3], ref[:3]):
        assert torch.equal(g, r)
    for k, r in ref[3].items():
        g = got[3][k]
        assert (torch.equal(g, r) if isinstance(r, torch.Tensor)
                else g == r), k


def _jax_lm(args, bounds, config, kw):
    """The JAX package's jitted ``lm_solve`` of a case's arguments;
    ``enabled``, the budget and the masks are traced, so the cases of one
    config share a compile."""
    return jlm.lm_solve(
        *map(jnp.asarray, args), aruco_size=SIZE,
        config=jlm.LMConfig(**config._asdict()),
        enabled=jnp.asarray(kw.get("enabled", True)),
        iter_budget=jnp.asarray(kw.get("iter_budget", config.max_iterations),
                                jnp.int32), **bounds)


def _staged(a, args, bounds, config, **kw):
    """The staged LM of a case's arguments, eagerly."""
    return graphs.lm_solve_graphed(
        *_torch_args(args), aruco_size=SIZE, config=config, graphed=False,
        **tlm.grouped_bounds(a.tag_poses.shape[0], config, **bounds), **kw)


def _assert_agree(got, ref):
    """The same iterations and termination, the cost within 1e-10
    relative."""
    c_ref, c_got = float(ref[3]["cost"]), float(got[3]["cost"])
    assert abs(c_got - c_ref) <= 1e-10 * c_ref
    assert got[3]["iterations"] == int(ref[3]["iterations"])
    assert int(got[3]["termination"]) == int(ref[3]["termination"])


def _assert_case(got, case):
    """The termination and iterations the case must reach."""
    term = CASES[case][1]
    if term is not None:
        assert int(got[3]["termination"]) == term
    iters = got[3]["iterations"]
    assert iters == {"budget_1": 1, "full_budget": 6, "disabled": 0,
                     "gradient_at_start": 0}.get(case, iters)


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_stages_match_jax_terminations(problem, solver, case):
    """The stages driven by the graphs' host loop against the JAX
    package's ``lm_solve`` under the same config, through every
    termination: the same iterations and termination, cost within 1e-10
    relative."""
    a, bounds = problem
    config = tlm.LMConfig(linear_solver=solver, **EXACT_CG, **CASES[case][0])
    args, kw = _args(a, case)
    got = _staged(a, args, bounds, config, **kw)
    _assert_agree(got, _jax_lm(args, bounds, config, kw))
    _assert_case(got, case)


def test_split_stages_resume_damping(problem):
    """lam0 / nu0 (the host-stepped progress mode) resume the schedule:
    a budget of 2 ends bit for bit where a budget of 1, resumed for 1 at
    its returned lambda and nu, ends."""
    a, bounds = problem
    config = tlm.LMConfig()
    args = _args(a, "function")[0]

    def run(args, lam0, nu0, budget):
        return _staged(a, args, bounds, config, iter_budget=budget,
                       lam0=lam0, nu0=nu0)

    _assert_resumes(run, args)


def _assert_resumes(run, args):
    """``run(args, lam0, nu0, budget)`` for 2 iterations from lam0 / nu0
    ends bit for bit where 1 iteration, resumed for 1 at the returned
    lambda and nu, ends (what host-stepped progress relies on)."""
    whole = run(args, 3e-3, 8.0, 2)
    first = run(args, 3e-3, 8.0, 1)
    rest = run((*first[:3], *args[3:]), float(first[3]["lambda"]),
               float(first[3]["nu"]), 1)
    assert first[3]["iterations"] == rest[3]["iterations"] == 1
    info = {k: v for k, v in rest[3].items() if k != "initial_cost"}
    _assert_equal(whole, (*rest[:3], {**info, "iterations": 2}))


def test_graphed_lm_needs_cuda(problem):
    a, bounds = problem
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        graphs.lm_solve_graphed(*_torch_args(_args(a, "function")[0]),
                                aruco_size=SIZE, config=tlm.LMConfig(),
                                **bounds)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_split_stages_match_jax(problem, solver):
    """The staged LM against the JAX package's lm_solve: the same
    iterations and termination, cost within 1e-10 (CG solved to
    ``EXACT_CG``); the dense solve's parameters within 1e-8 (CG's stop
    1e-7 apart along the optimum's shallow directions, at the same
    cost)."""
    a, bounds = problem
    config = tlm.LMConfig(linear_solver=solver, **EXACT_CG)
    args, kw = _args(a, "function")
    ref = _jax_lm(args, bounds, config, kw)
    got = _staged(a, args, bounds, config)
    _assert_agree(got, ref)
    if solver == "dense":
        for g, r in zip(got[:3], ref[:3]):
            assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-8


LOC_CASES = {"default": dict(), "stall": dict(min_relative_decrease=10.0,
                                              stall_lambda=1e-2),
             "budget": dict(function_tolerance=0.0, parameter_tolerance=0.0,
                            max_iterations=4)}


def _localize(config):
    """The staged localize of the queries, eagerly, and the JAX package's
    ``localize_kernel`` under the same config."""
    q = _queries()
    got = graphs.localize_graphed(*[torch.as_tensor(x) for x in q],
                                  aruco_size=SIZE, config=config,
                                  graphed=False)
    ref = jloc.localize_kernel(*map(jnp.asarray, q), aruco_size=SIZE,
                               config=jlm.LMConfig(**config._asdict()))
    return got, ref


def _assert_localize_agree(got, ref):
    """Poses within 1e-10, costs within 1e-10 relative, the same
    iteration counts."""
    assert np.abs(got[0].numpy() - np.asarray(ref[0])).max() <= 1e-10
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-10, atol=1e-20)
    assert got[2].tolist() == np.asarray(ref[2]).tolist()


@pytest.mark.parametrize("case", list(LOC_CASES))
def test_localize_stage_matches_jax_terminations(case):
    """The staged localize (one stage an iteration) against the JAX
    package's ``localize_kernel`` under each case's config: converged,
    stalled and cut at its budget."""
    got, ref = _localize(tlm.LMConfig(**LOC_CASES[case]))
    _assert_localize_agree(got, ref)
    if case == "budget":
        assert got[2][:-1].tolist() == [4] * (len(got[2]) - 1)
    assert got[2][-1] == 0  # the query without blocks


def test_localize_stage_matches_jax():
    """The staged localize against the JAX package's localize_kernel:
    poses within 1e-10, costs within 1e-10 relative, the same iteration
    counts."""
    _assert_localize_agree(*_localize(tlm.LMConfig()))


class NoHostSync(TorchDispatchMode):
    """Raises on what a CUDA graph cannot capture: a read of a value to
    the host (``item``, ``bool()``: ``_local_scalar_dense``), an output
    sized by the data (``nonzero``), a tensor made from host data
    (``torch.tensor``, ``as_tensor`` of Python values: ``lift_fresh``) or
    a copy between devices.  (``tolist`` and ``numpy`` of a CPU tensor do
    not dispatch; the card tests catch those under
    ``set_sync_debug_mode``.)"""

    BANNED = {torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.nonzero.default,
              torch.ops.aten.item.default,
              torch.ops.aten.lift_fresh.default,
              torch.ops.aten.lift_fresh_copy.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.BANNED:
            raise AssertionError(f"{func} inside a captured stage")
        if func in (torch.ops.aten._to_copy.default,
                    torch.ops.aten.copy_.default):
            src = args[1] if func is torch.ops.aten.copy_.default else args[0]
            dst = (args[0].device if func is torch.ops.aten.copy_.default
                   else kwargs.get("device") or src.device)
            if torch.device(dst) != src.device:
                raise AssertionError(f"{func} from {src.device} to {dst}")
        return func(*args, **kwargs)


def test_no_host_sync_mode_catches_reads():
    x = torch.ones(3)
    with NoHostSync():
        torch.full((), 2.0) * x  # fills are fine
        for bad in (lambda: bool(x.sum() > 0), lambda: torch.nonzero(x),
                    lambda: torch.as_tensor(2.0), lambda: x.sum().item()):
            with pytest.raises(AssertionError):
                bad()


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_stages_read_nothing_back(problem, monkeypatch, solver):
    """No stage (setup, step, accept, reject, localize's iteration) reads
    a value to the host or makes a tensor from host data: each runs under
    NoHostSync, the host loop between them does not."""
    ran = []
    run = programs.Program.run

    def guarded(self, name):
        ran.append(name)
        with NoHostSync():
            run(self, name)

    monkeypatch.setattr(programs.Program, "run", guarded)
    a, bounds = problem
    for case in ("function", "stall", "warmup_masks"):
        config = tlm.LMConfig(linear_solver=solver, **CASES[case][0])
        args, kw = _args(a, case)
        graphs.lm_solve_graphed(
            *_torch_args(args), aruco_size=SIZE, config=config,
            graphed=False, **kw,
            **tlm.grouped_bounds(a.tag_poses.shape[0], config, **bounds))
    graphs.localize_graphed(*[torch.as_tensor(x) for x in _queries()],
                            aruco_size=SIZE, config=tlm.LMConfig(),
                            graphed=False)
    assert {"setup", "step", "accept", "reject", "init", "iterate"} <= set(ran)


def test_graph_cache_keeps_one_program_per_kind():
    """The cache holds one program per (kind, device): the same signature
    gets it back, another signature replaces it and frees it, and the
    kinds are kept apart."""
    import weakref

    made = []

    def make():
        made.append(programs.Program({}, True))
        return made[-1]

    programs.CACHE.clear()
    try:
        first = weakref.ref(programs.CACHE.get("lm", "cuda:0", 1, make))
        assert programs.CACHE.get("lm", "cuda:0", 1, make) is first()
        made.clear()
        lm = programs.CACHE.get("lm", "cuda:0", 2, make)
        loc = programs.CACHE.get("localize", "cuda:0", 1, make)
        assert first() is None and len(made) == 2 and lm is not loc
        assert programs.CACHE.get("lm", "cuda:0", 2, make) is lm
        assert programs.CACHE.get("lm", "cuda:1", 2, make) is not lm
        assert programs.CACHE.stats()["programs"] == 3
    finally:
        programs.CACHE.clear()
