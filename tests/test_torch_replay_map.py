"""The replay cell ``synthetic_500.replay`` and the one-photo localize cell
``room_12mp.localize1`` on the CPU, at test sizes.

- The port's batch map (a fresh engine, ``store.add_detections`` of every
  capture of a synthetic floor map, ``engine.solve()``) against the plain
  reference's float64 bundle adjustment, for two seeds and two wave
  schedules: in float64 within 1e-8 of the reference's optimum, in
  float32 within the cell's ``cost_gap`` limit, every capture and tag in
  the map.
- The solve drivers' counters (``lm.calls``, ``lm.steps``,
  ``solve.waves``, ``solve.flushes``, the span ``solve.flush``) against
  the stages the host loop ran, and the host waits of a solve the same
  with the counters as without them.
- Whole runs of the harness for both cells (a sound run, the replay cell's
  faults), and the replay cell's control (the plain reference in TF32 and
  in bfloat16) failing its limits.

The harness refuses to report in a process that has loaded ``jax`` (the
test process has, through ``conftest.py``), so its runs are made one
after another in a fresh interpreter (``runs``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.drivers import replay  # noqa: E402

torch.set_num_threads(1)
CELL = "synthetic_500.replay"
LOCALIZE1 = "room_12mp.localize1"
SEED = 2 ** 31 + 91
# the floor map at a test's size: every width as configured, 40 tags and
# 16 captures
SMALL = {"tags": 40, "captures": 16}
ROOM = {"width": 1020, "height": 768, "focal": 900.0, "min_side_px": 40.0}
# (name, cell, fault, sizes, mix overrides)
RUNS = (("sound", CELL, None, SMALL, {}),
        ("unchanged", CELL, "unchanged", SMALL, {"warm_calls": 0}),
        ("answer", CELL, "answer", SMALL, {"warm_calls": 0}),
        ("localize1", LOCALIZE1, None, ROOM, {"warm_calls": 1}))


def manifest() -> dict:
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_files(cell: str = CELL) -> dict:
    return harness.resolve(manifest(), cell)


def ctx_of(cfg: dict, fault=None) -> SimpleNamespace:
    return SimpleNamespace(cfg=cfg, mix={"warm_calls": 0}, seed=SEED,
                           device="cpu", chips=1, spans=None, fault=fault)


def small_cfg(noise_seed: int, dtype: str, every: int) -> dict:
    cfg = {**cell_files()["config"], **SMALL, "noise_seed": noise_seed}
    cfg["solver"] = {**cfg["solver"], "dtype": dtype,
                     "optimize_every": every}
    return cfg


def runs() -> None:
    """The ``RUNS`` in this process, one JSON line each: the exit code, the
    result line and the end of standard error."""
    torch.set_num_threads(1)
    for name, cell, fault, sizes, mix in RUNS:
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = harness.main(["--workload", cell, "--seed", str(SEED),
                               "--seconds", "0.1", "--trace", "0"],
                              device="cpu", sizes=sizes, mix_sizes=mix,
                              fault=fault)
        lines = out.getvalue().strip().splitlines()
        print(json.dumps({"name": name, "rc": rc,
                          "result": json.loads(lines[-1]) if lines else None,
                          "err": err.getvalue()[-3000:]}), flush=True)


@pytest.fixture(scope="module")
def done():
    """{run name: its record} of the harness runs in a fresh interpreter."""
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import test_torch_replay_map as t; t.runs()" % (ROOT, TESTS))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith('{"name"')]
    return {r["name"]: r for r in recs}


def test_cells_resolve_to_their_files():
    m = manifest()
    files = cell_files()
    cfg = files["config"]
    assert files["cell"]["chips"] == 1 and cfg["name"] == "synthetic_500"
    assert (cfg["tags"], cfg["captures"], cfg["focal"], cfg["noise_px"],
            cfg["image_size"]) == (500, 200, 3000.0, 0.3, [4000, 3000])
    assert cfg["solver"] == {"linear_solver": "dense", "max_iterations": 50,
                             "dtype": "float32", "optimize_every": 8}
    assert cfg["reduced"] == ["hosts"] and cfg["hosts"] == 1
    assert files["driver"].endswith(os.path.join("drivers", "replay.py"))
    assert set(files["limits"]) == {"cost_gap", "rmse_gap_px",
                                    "unsolved_captures", "missing_tags"}
    assert files["limits"]["unsolved_captures"] == files["limits"][
        "missing_tags"] == 0
    ends = {e["name"] for e in harness.metrics_of(m, CELL, False)}
    assert ends == {"map_s", "setup_s"}
    traced = {e["name"] for e in harness.metrics_of(m, CELL, True)}
    assert traced == {"solve_ms_per_map.map", "host_waits_per_op.map",
                      "idle_pct.map", "engine_host_ms_per_op.map",
                      "lm_steps_per_map.map", "lm_device_ms_per_step.map"}
    one = cell_files(LOCALIZE1)
    assert one["mix"]["queries_per_call"] == 1
    assert one["config"] == harness.resolve(m, "room_12mp.localize")[
        "config"]
    assert one["limits"] == harness.resolve(m, "room_12mp.localize")[
        "limits"]
    assert {e["name"] for e in harness.metrics_of(m, LOCALIZE1, True)} == {
        e["name"] for e in m["per_layer"] if e["name"].endswith(".localize")}


def test_event_log_holds_every_sighting_in_capture_order():
    cfg = small_cfg(1, "float32", 8)
    truth = replay.S.scene(cfg, "cpu")
    log = replay.event_log(truth, cfg["image_size"])
    ci = truth["cap_idx"].numpy()
    assert [r["uid"] for r in log] == [replay.uid_of(k)
                                       for k in np.unique(ci)]
    assert sum(len(r["detections"]) for r in log) == ci.size
    first = log[0]["detections"][0]
    assert np.array_equal(np.asarray(first["corners"]).reshape(4, 2),
                          truth["corners"][0].numpy())
    assert (log[0]["width"], log[0]["height"]) == (4000, 3000)


@pytest.mark.parametrize("every", [1, 8])
@pytest.mark.parametrize("noise_seed", [1, 7])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_map_reaches_the_reference_optimum(dtype, noise_seed, every):
    """The replayed map's float64 cost at its poses against the plain
    reference's optimum: float64 within 1e-8 relative, float32 within the
    cell's ``cost_gap`` limit; no capture or tag left out.  In float64 the
    LM's function and parameter tolerances are tightened to 1e-12: at the
    engine's (1e-6, 1e-8, ceres' defaults) its last step may stop ~1e-7
    above the optimum."""
    cfg = small_cfg(noise_seed, dtype, every)
    cell = replay.Cell(ctx_of(cfg))
    if dtype == "float64":
        cell.config = dataclasses.replace(
            cell.config, solver=dataclasses.replace(
                cell.config.solver, function_tolerance=1e-12,
                parameter_tolerance=1e-12))
    rec = cell.after(cell.op())
    assert not rec["failed"]
    got = replay.map_numbers(cell.truth, [rec], cfg)
    limit = 1e-8 if dtype == "float64" else cell_files()["limits"][
        "cost_gap"]
    assert -1e-10 <= got["cost_gap"] <= limit, got
    assert got["unsolved_captures"] == got["missing_tags"] == 0
    assert got["rmse_gap_px"] <= cell_files()["limits"]["rmse_gap_px"]


def _traced_solve(monkeypatch, counters: bool = True):
    """One replayed map's solve with the tracer on: (its counts, the
    ``step`` and ``setup`` runs of LM programs, the waves and flushes the
    runner ran).  Without ``counters`` the solve drivers' counters are
    dropped before they reach the tracer."""
    from ar_slam_tpu_torch import programs
    from ar_slam_tpu_torch.solve import batch
    from ar_slam_tpu_torch.utils.metrics import TRACE

    cfg = small_cfg(1, "float32", 4)
    cell = replay.Cell(ctx_of(cfg))
    ran = {"step": 0, "setup": 0, "waves": 0, "flushes": 0}
    run, wave, flush = (programs.Program.run, batch._WaveRunner.run_wave,
                        batch._WaveRunner._flush)

    def spy_run(prog, name):
        if prog.kind == "lm" and name in ran:
            ran[name] += 1
        return run(prog, name)

    def spy_wave(runner, *a, **k):
        ran["waves"] += 1
        return wave(runner, *a, **k)

    def spy_flush(runner, lm_enabled, iter_budget=None):
        ran["flushes"] += bool(runner._pending) and lm_enabled
        return flush(runner, lm_enabled, iter_budget)

    monkeypatch.setattr(programs.Program, "run", spy_run)
    monkeypatch.setattr(batch._WaveRunner, "run_wave", spy_wave)
    monkeypatch.setattr(batch._WaveRunner, "_flush", spy_flush)
    if not counters:
        count = TRACE.count

        def only_waits(name, n=1):
            if name.startswith("host_wait."):
                count(name, n)
        monkeypatch.setattr(TRACE, "count", only_waits)
    was = TRACE.enabled
    try:
        TRACE.reset()
        TRACE.enabled = True
        rec = cell.after(cell.op())
        s = TRACE.summary()
    finally:
        TRACE.enabled = was
        TRACE.reset()
    assert not rec["failed"]
    return s, ran


def test_counters_follow_the_host_loop(monkeypatch):
    s, ran = _traced_solve(monkeypatch)
    c = s["counts"]
    assert c["lm.steps"] == ran["step"] > 0
    assert c["lm.calls"] == ran["setup"] > 0
    # 16 captures flushed every 4th wave: 4 flushes, each after the first
    # with a warmup LM
    assert c["solve.waves"] == ran["waves"] == 16
    assert c["solve.flushes"] == ran["flushes"] == 4
    assert c["lm.calls"] == 2 * 4 - 1
    assert s["spans"]["solve.flush"]["calls"] == 4
    # each step reads its flags once, each LM its converged flag once: the
    # counters read nothing
    assert c["host_wait.lm.flags"] == c["lm.steps"]
    assert c["host_wait.lm.converged"] == c["lm.calls"]


def test_counters_add_no_host_wait(monkeypatch):
    with monkeypatch.context() as m:
        with_counters, _ = _traced_solve(m)
    without, _ = _traced_solve(monkeypatch, counters=False)
    waits = {k: v for k, v in with_counters["counts"].items()
             if k.startswith("host_wait.")}
    assert waits == without["counts"]
    assert "lm.steps" not in without["counts"]


def test_tracing_off_counts_nothing():
    from ar_slam_tpu_torch.utils.metrics import TRACE

    cfg = small_cfg(1, "float32", 8)
    cell = replay.Cell(ctx_of(cfg))
    was = TRACE.enabled
    try:
        TRACE.enabled = False
        TRACE.reset()
        cell.after(cell.op())
        assert TRACE.summary() == {"spans": {}, "counts": {}}
    finally:
        TRACE.enabled = was


@pytest.mark.parametrize("reader,counts,spans,want", [
    ("lm_steps_per_map.map", {"lm.steps": 90}, {}, 45.0),
    ("lm_steps_per_map.map", {"host_wait.lm.flags": 90}, {}, None),
    ("lm_device_ms_per_step.map", {"lm.steps": 4},
     {"program.lm.step": {"device_ms": 2.0},
      "program.lm.accept": {"device_ms": 1.0},
      "program.lm.reject": {"device_ms": 1.0}}, 1.0),
    ("lm_device_ms_per_step.map", {"lm.steps": 4},
     {"program.lm.step": {"host_ms": 2.0}}, None),
    ("lm_device_ms_per_step.map", {}, {"program.lm.step": {
        "device_ms": 2.0}}, None),
])
def test_readers(monkeypatch, reader, counts, spans, want):
    """The two readers of the solve drivers' counters: None where the
    counter is absent (the parent) or no device time was taken (the
    CPU)."""
    from benchmark import program_trace

    monkeypatch.setattr(program_trace, "summary",
                        lambda: {"spans": spans, "counts": counts})
    monkeypatch.setattr(program_trace, "ops", lambda run: 2)
    assert harness.reader(reader).read(SimpleNamespace(trace=None)) == want


def test_sound_replay_run_is_correct(done):
    rec = done["sound"]
    res = rec["result"]
    assert rec["rc"] == 0 and res is not None, rec["err"]
    assert res["correct"], rec["err"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"map_s", "setup_s"}
    assert set(res["check"]) == set(cell_files()["limits"])


@pytest.mark.parametrize("fault", ["unchanged", "answer"])
def test_replay_fault_is_not_correct(done, fault):
    rec = done[fault]
    assert rec["rc"] == 0 and rec["result"] is not None, rec["err"]
    assert rec["result"]["correct"] is False, rec["result"]["check"]


@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_replay_control_fails_a_limit(precision):
    """The plain reference in the program's place, in the precisions below
    float32: at least one number above the cell's limits."""
    cfg = {**cell_files()["config"], **SMALL}
    ctx = ctx_of(cfg)
    truth = replay.S.scene(cfg, "cpu")
    got = replay.control(ctx, truth, [], precision)
    limits = cell_files()["limits"]
    assert any(not got[k] <= lim for k, lim in limits.items()), got


def test_one_photo_localize_run_is_correct(done):
    rec = done["localize1"]
    res = rec["result"]
    assert rec["rc"] == 0 and res is not None, rec["err"]
    assert res["correct"], rec["err"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"localize_photos_per_s",
                                   "localize_p95_ms", "setup_s"}
