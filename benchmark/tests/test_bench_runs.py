"""Whole runs of the harness on the CPU at small sizes: what a run loads,
the result line, each fault that a cell can have turning ``correct``
false, and the control (the plain reference put in the program's place: the
detector's corner arithmetic in bfloat16, the solvers in TF32) failing the
limits.  The solve driver, which no cell runs yet, is driven directly.

The sizes: the room at 1020x768 (focal 900, required tags >= 40 px, the
program's room-16 size), the synthetic map at 500 tags and 200 captures.
At 1020x768 most room layouts land the program's map in a local minimum
of the reprojection cost (PERF.md, Open questions); layout 5 is one where
it does not, so the map cell's runs here use it.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness

ROOM = {"width": 1020, "height": 768, "focal": 900.0, "min_side_px": 40.0}
SIZES = {"room_12mp.localize": ROOM,
         "room_12mp.map": {**ROOM, "layout_seed": 5}}
SEEDS = dict.fromkeys(SIZES, 2 ** 31 + 99)
WARM = {"warm_calls": 1, "warm_solves": 1}
FAULTS = {"room_12mp.localize": ("unchanged", "half", "answer", "ids",
                                 "corners"),
          "room_12mp.map": ("unchanged", "answer", "ids", "corners")}
PRECISION = "tf32"  # float32 with TF32 off is what the program states
# a grid map of tags on a floor for the solve driver, at a test's size
GRID_MAP = {"name": "grid_500", "tags": 500, "captures": 200,
            "focal": 3000.0, "image_size": [4000, 3000],
            "aruco_size": 0.0635, "tag_spacing": 0.25, "height": 1.8,
            "noise_px": 0.3, "layout_seed": 0, "noise_seed": 2,
            "start_sigma": 0.005, "start_seed": 1,
            "solver": {"linear_solver": "cg", "cg_tolerance": 0.3,
                       "cg_max_iterations": 25, "row_slots": 8,
                       "max_iterations": 50, "dtype": "float32"}}
GRID_LIMITS = {"cost_gap": 5e-2, "cost_echo": 2e-3}


def run(cell: str, fault=None, trace: int = 0) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(["--workload", cell, "--seed", str(SEEDS[cell]),
                           "--seconds", "0.1", "--trace", str(trace)],
                          device="cpu", sizes=SIZES[cell], mix_sizes=WARM,
                          fault=fault)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", list(SIZES))
def test_sound_run_is_correct(cell):
    rc, res, err = run(cell)
    assert rc == 0, err[-3000:]
    assert res["correct"], err[-3000:]
    assert list(res)[-1] == "check" and res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    limits = harness.resolve(harness.load_json(os.path.join(
        harness.ROOT, "BENCHMARK.json")), cell)["limits"]
    assert set(res["check"]) == set(limits)
    tail = err.strip().splitlines()[-len(limits):]
    assert all(line.startswith("check ") for line in tail)


def test_traced_run_reads_per_layer_metrics():
    rc, res, err = run("room_12mp.localize", trace=1)
    assert rc == 0 and res["correct"], err[-3000:]
    assert {"detect_ms_per_photo.localize",
            "localize_ms_per_call.localize"} <= set(res["metrics"])
    assert "breakdown" in res and "window_s" in res["device"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs])
def test_fault_is_not_correct(cell, fault):
    rc, res, err = run(cell, fault)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["check"]


@pytest.mark.parametrize("cell", list(SIZES))
def test_control_fails_a_limit(cell):
    """The plain reference put in the program's place, in TF32: at least
    one number above its limit."""
    manifest = harness.load_json(os.path.join(harness.ROOT,
                                              "BENCHMARK.json"))
    files = harness.resolve(manifest, cell)
    cfg = {**files["config"], **SIZES[cell]}
    mix = {**files["mix"], **WARM}
    driver = harness.load_module(files["driver"], "control_" + mix["driver"])
    ctx = SimpleNamespace(cfg=cfg, mix=mix, seed=SEEDS[cell], device="cpu",
                          chips=1, spans=None, fault=None)
    c = driver.Cell(ctx)
    records = [c.after(c.op())]
    truth = c.release()
    got = driver.control(ctx, truth, records, PRECISION)
    over = {k: (got[k], lim) for k, lim in files["limits"].items()
            if not got[k] <= lim}
    assert over, got


def _solve(fault=None):
    from benchmark.drivers import solve

    mix = harness.load_json(os.path.join(harness.ROOT, "benchmark",
                                         "traffic", "solve.json"))
    ctx = SimpleNamespace(cfg=GRID_MAP, mix=mix, seed=2 ** 31 + 99,
                          device="cpu", chips=1, spans=None, fault=fault)
    c = solve.Cell(ctx)
    records = [c.after(c.op())]
    return solve, ctx, c.release(), records


@pytest.mark.parametrize("fault", [None, "unchanged", "answer"])
def test_solve_driver(fault):
    """The solve driver's sound run is within the limits; each fault is
    not."""
    solve, ctx, truth, records = _solve(fault)
    got = solve.check(ctx, truth, records, GRID_LIMITS)
    assert records[0]["iterations"] >= 1
    within = all(v <= lim for v, lim in got.values())
    assert within is (fault is None), got


def test_solve_control_fails_a_limit():
    solve, ctx, truth, records = _solve()
    got = solve.control(ctx, truth, records, PRECISION)
    assert any(not got[k] <= lim for k, lim in GRID_LIMITS.items()), got


def test_nothing_forbidden_is_imported():
    """No module the harness, its readers, drivers or the reference import
    has the top-level name jax, jaxlib, flax or ar_slam_tpu (whole names);
    the reference imports nothing of ar_slam_tpu_torch either."""
    code = (
        "import sys, glob, os\n"
        "from benchmark.reference import geometry, lm, detections, aruco\n"
        "ref = {m.split('.')[0] for m in sys.modules}\n"
        "from benchmark import harness, trace, roofline, rooms\n"
        "for p in sorted(glob.glob('benchmark/drivers/*.py')"
        " + glob.glob('benchmark/metrics/*.py')):\n"
        "    harness.load_module(p, 'm_' + os.path.basename(p)[:-3]"
        ".replace('.', '_'))\n"
        "import ar_slam_tpu_torch.pipeline.engine, "
        "ar_slam_tpu_torch.solve.lm\n"
        "print(sorted(ref)); print(sorted({m.split('.')[0] "
        "for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True, check=True)
    ref, every = (set(eval(line)) for line in out.stdout.splitlines()[-2:])
    assert not ref & {"jax", "jaxlib", "flax", "ar_slam_tpu",
                      "ar_slam_tpu_torch"}
    assert not every & set(harness.FORBIDDEN)
