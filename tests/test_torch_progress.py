"""Port parity: the host-stepped progress solve (solve/batch.py with
minimizer_progress_to_stdout) against the JAX package, float64 on the CPU;
and the CLI flags ``--iterative-schur`` / ``--progress``."""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import ar_slam_tpu.solve.lm as jlm_module
import ar_slam_tpu_torch.solve.batch as tbatch
from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.solve.batch import solve as j_solve
from ar_slam_tpu.utils.synthetic import make_synthetic_map
from ar_slam_tpu_torch.config import ArSlamConfig as TConfig
from ar_slam_tpu_torch.convert import store_from_jax

torch.set_num_threads(1)


def _progress_run(solve_fn, store, config, patch, capsys, **kw):
    """Run ``solve_fn`` with minimizer_progress_to_stdout on (and a
    function tolerance of 1e-4, so that the waves end early), recording
    the cost of every one-iteration LM call (through the ``lm_solve``
    attribute of module ``patch``).  Returns (summary, costs, printed
    iteration lines, printed terminating lines)."""
    costs = []
    orig = patch.lm_solve

    def rec(*a, **k):
        out = orig(*a, **k)
        costs.append(float(out[3]["cost"]))
        return out

    config = dataclasses.replace(config, solver=dataclasses.replace(
        config.solver, minimizer_progress_to_stdout=True,
        function_tolerance=1e-4))
    patch.lm_solve = rec
    try:
        summary = solve_fn(store, config, **kw)
    finally:
        patch.lm_solve = orig
    lines = capsys.readouterr().out.splitlines()
    iters = [ln for ln in lines if ln.split() and ln.split()[0].isdigit()]
    terms = [ln for ln in lines if ln.startswith("terminating: ")]
    return summary, costs, iters, terms


def test_host_stepped_progress_matches(capsys, caplog):
    """minimizer_progress_to_stdout host-steps every joint LM, one
    iteration a call: the same printed iteration lines and terminating
    lines as the reference, each call's cost within 1e-8, and no
    warning."""
    js, _ = make_synthetic_map(n_tags=12, n_caps=3, seed=10, noise_px=0.3)
    ts = store_from_jax(js)
    ref, r_costs, r_iters, r_terms = _progress_run(
        j_solve, js, JConfig(), jlm_module, capsys, dtype=np.float64)
    caplog.set_level(logging.WARNING)
    got, g_costs, g_iters, g_terms = _progress_run(
        tbatch.solve, ts, TConfig(), tbatch, capsys, dtype=torch.float64,
        device="cpu")
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
    assert len(g_iters) == len(r_iters) == len(r_costs) == len(g_costs) > 4
    # iteration, cost, |gradient|, tr_radius; not cost_change, whose zero
    # after a rejected step is rounding noise in the reference
    def cols(lines):
        return [[ln.split()[i] for i in (0, 1, 3, 4)] for ln in lines]

    assert cols(g_iters) == cols(r_iters)
    for g, r in zip(g_costs, r_costs):
        assert abs(g - r) <= 1e-8 * r
    assert g_terms == r_terms and len(g_terms) >= 1
    assert abs(got["rmse"] - ref["rmse"]) <= 1e-6 * ref["rmse"]


def test_cli_map_iterative_schur_progress(tmp_path, capsys):
    """``map --iterative-schur --progress`` re-solves a saved map with CG,
    printing the per-iteration lines; --cpu-detector and --devices 2 stay
    refused."""
    from ar_slam_tpu_torch.cli import main
    from ar_slam_tpu_torch.graph.yamlio import save_yaml
    from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map as tmap

    store, _ = tmap(n_tags=12, n_caps=3, seed=10, noise_px=0.3)
    src = str(tmp_path / "src.yaml")
    save_yaml(store, src)
    out = str(tmp_path / "map.yaml")
    assert main(["map", src, "-o", out, "--device", "cpu",
                 "--iterative-schur", "--progress"]) == 0
    printed = capsys.readouterr().out
    assert printed.count("iter      cost") == 3  # one header per wave
    assert "terminating: " in printed
    assert float(printed.split("rmse ")[1].split(" px")[0]) < 1.0
    for flags in (["--cpu-detector"], ["--devices", "2"]):
        with pytest.raises(SystemExit, match="not ported"):
            main(["map", src, "-o", out, "--device", "cpu", *flags])
