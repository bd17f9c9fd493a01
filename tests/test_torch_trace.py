"""The port's tracer (utils/metrics.TRACE) on the CPU: off it records
nothing; on, an eager map (``add_decoded`` + ``solve``) and an eager
``localize_decoded`` of a small rendered room record every span, counter
and host wait the program names; a load of rows' counters; the
benchmark's readers of those records; ``--metrics`` and ``--profile``."""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ar_slam_tpu_torch import programs
from ar_slam_tpu_torch.graph.arrays import export_arrays
from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture
from ar_slam_tpu_torch.utils import metrics
from ar_slam_tpu_torch.utils.metrics import TRACE
from ar_slam_tpu_torch.utils.render import room_scene

torch.set_num_threads(1)
H, W = 480, 640
ENGINE = ("engine.stack", "engine.unpack", "store.add")
DETECT = ("program.detect.load", "program.detect.detect")
SOLVER = ("program.seed.load", "program.seed.seed", "program.lm.load",
          "program.lm.setup", "program.lm.step", "program.lm.accept")
LOCALIZE = ("localize.gather", "localize.writeback", "program.localize.load",
            "program.localize.init", "program.localize.iterate")
SOLVE = ("solve.calibrate", "solve.plan", "solve.export",
         "solve.seed_inputs", "solve.lm_inputs", "solve.writeback")
MAP_WAITS = ("detect.out", "arrays.upload", "solve.tables", "solve.masks",
             "lm.converged", "lm.flags", "solve.out", "solve.cost")
LOC_WAITS = ("detect.out", "localize.upload", "localize.active",
             "localize.out")
READERS = ("engine_host_ms_per_op", "detect_device_ms_per_photo",
           "upload_gb_per_s", "host_waits_per_op")


@pytest.fixture(scope="module")
def phases():
    """The tracer's summary of each phase on a fresh engine: a detection
    with tracing off, then with it on a map of frames 0-2 and a localize
    call of frames 3-4; with the engine.  The solver's seeds, LM and
    localize run through their programs (solve/graphs.py) eagerly, the
    CPU's path through the stages the card replays."""
    frames, _ = room_scene(n_frames=5, width=W, height=H, focal=565.0)
    caps = [IngestedCapture(f"f{k}", f"f{k}.png", frames[k])
            for k in range(5)]
    engine = ArSlamEngine(device="cpu")
    was = TRACE.enabled
    out = {}
    try:
        TRACE.enabled = False
        TRACE.reset()
        engine.detect_decoded(caps[:1])
        out["off"] = TRACE.summary()
        TRACE.enabled = True
        engine.add_decoded(caps[:3])
        engine.solve()
        out["map"] = TRACE.summary()
        TRACE.reset()
        out["result"] = engine.localize_decoded(caps[3:])
        out["localize"] = TRACE.summary()
    finally:
        TRACE.enabled = was
        TRACE.reset()
    return SimpleNamespace(engine=engine, **out)


def test_off_records_nothing(phases):
    assert not TRACE.on
    assert phases.off == {"spans": {}, "counts": {}}
    assert TRACE.span("anything") is metrics._OFF
    assert TRACE.span("program.lm.step", "cuda:0") is metrics._OFF
    TRACE.count("detect.photos", 3)
    assert TRACE.wait("site", sum, [1, 2]) == 3
    assert TRACE.summary() == {"spans": {}, "counts": {}}


@pytest.mark.parametrize("phase,spans,waits", [
    ("map", ENGINE + DETECT + SOLVE + SOLVER, MAP_WAITS),
    ("localize", ENGINE + DETECT + LOCALIZE, LOC_WAITS)])
def test_spans_and_counters_are_recorded(phases, phase, spans, waits):
    got = getattr(phases, phase)
    names = set(spans) | {"host_wait." + w for w in waits}
    assert names <= set(got["spans"]), names - set(got["spans"])
    for w in waits:
        assert got["counts"]["host_wait." + w] == got["spans"][
            "host_wait." + w]["calls"] >= 1
    # an eager load copies nothing: no bytes counted
    assert "detect.photos" in got["counts"]
    assert not any(".bytes_" in k for k in got["counts"])
    # the CPU times no device work
    assert not any("device_ms" in v for v in got["spans"].values())
    # the engine's timers are spans too
    assert got["spans"]["detect"]["calls"] == 1


@pytest.mark.parametrize("phase,photos,padded", [("map", 3, 4),
                                                 ("localize", 2, 2)])
def test_detect_bytes_are_the_padded_frames(phases, phase, photos, padded):
    """The photos detected count before the padding; a graphed load of the
    padded frames counts their bytes once a load, whether it clones them
    (the first call) or copies them into the program's buffer.  The CPU
    stands in for the card: the program's graphs are taken as captured."""
    assert getattr(phases, phase)["counts"]["detect.photos"] == photos
    frames = torch.zeros((padded, H, W), dtype=torch.uint8)
    prog = programs.Program({"detect": dict}, graphed=True, kind="detect")
    prog.key, prog.graphs = ("detect", "cpu", None), {"detect": None}
    TRACE.enabled = True
    try:
        prog.load(frames=frames)
        prog.load(frames=frames)
        counts = TRACE.summary()["counts"]
    finally:
        TRACE.enabled = False
        TRACE.reset()
    assert counts["program.detect.bytes_h2d"] == 2 * np.zeros(
        (padded, H, W), np.uint8).nbytes
    assert counts["program.detect.bytes_d2d"] == 0
    assert counts["host_wait.detect.upload"] == 2


def test_row_load_counts_the_photos():
    """A graphed program's load of rows, the CPU standing in for the card
    (its graphs taken as captured): 3 photos into 4 frames copy the
    photos' bytes and zero the last frame; a host batch of 2 then zeroes
    2; each load is one upload wait; more photos than frames raise."""
    rng = np.random.default_rng(0)
    photos = [rng.integers(0, 255, (48, 64), dtype=np.uint8)
              for _ in range(3)]
    zero = np.zeros((1, 48, 64), np.uint8)
    prog = programs.Program({"detect": dict}, graphed=True, kind="detect",
                            rows={"frames": ((4, 48, 64), torch.uint8)})
    prog.key, prog.graphs = ("detect", "cpu", None), {"detect": None}
    TRACE.enabled = True
    try:
        prog.load(frames=photos)
        first = prog.t["frames"].clone()
        prog.load(frames=np.stack(photos[1:]))
        counts = TRACE.summary()["counts"]
    finally:
        TRACE.enabled = False
        TRACE.reset()
    assert torch.equal(first, torch.from_numpy(
        np.concatenate([np.stack(photos), zero])))
    assert torch.equal(prog.t["frames"], torch.from_numpy(
        np.concatenate([np.stack(photos[1:]), zero, zero])))
    assert counts["program.detect.bytes_h2d"] == 5 * 48 * 64
    assert counts["program.detect.bytes_d2d"] == 0
    assert counts["host_wait.detect.upload"] == 2
    with pytest.raises(ValueError, match="5 rows for a program of 4"):
        prog.load(frames=photos + photos[:2])


def test_host_waits_are_the_sites_hit(phases):
    """Each site's count is the number of times the call passed it."""
    loc = phases.localize["counts"]
    iters = max(phases.result["iterations"].values())
    assert 0 < iters < 50  # below the LM budget: one check more
    assert {k: v for k, v in loc.items() if k.startswith("host_wait.")} == {
        "host_wait.detect.out": 6,  # ids, corners, valid of 2 dictionaries
        "host_wait.detect.k2_rounds": 1,  # K2's planes (640x480 frames)
        "host_wait.localize.upload": 6,
        "host_wait.localize.active": iters + 1,  # one a replay
        "host_wait.localize.out": 3}
    spans = phases.localize["spans"]
    assert spans["program.localize.iterate"]["calls"] == iters
    got = phases.map["counts"]
    fields = sum(isinstance(v, np.ndarray) for v in export_arrays(
        phases.engine.store, dtype=np.float64)._asdict().values())
    assert got["host_wait.arrays.upload"] == fields
    # three waves, each a flush: one upload of its seed tables, one of its
    # masks
    assert got["host_wait.solve.tables"] == 3
    assert got["host_wait.solve.masks"] == 3
    assert got["host_wait.solve.out"] == 3
    assert got["host_wait.solve.cost"] == 2
    assert got["host_wait.detect.out"] == 6
    assert got["host_wait.detect.k2_rounds"] == 1
    # the LM's: a load a call, one read after its setup, one after each
    # step
    spans = phases.map["spans"]
    assert got["host_wait.lm.converged"] == spans["program.lm.load"][
        "calls"] == spans["program.lm.setup"]["calls"] >= 1
    assert got["host_wait.lm.flags"] == spans["program.lm.step"]["calls"]


def _view(ops: int):
    trace = SimpleNamespace(spans=lambda name: [(0.0, 1.0)] * ops
                            if name == "op" else [])
    return SimpleNamespace(trace=trace, spans={}, counters={})


def _on_card(summary: dict) -> dict:
    """The records as a card gives them: the program's spans with device
    time, and a GB copied in by the detector's loads."""
    out = json.loads(json.dumps(summary))
    for name, v in out["spans"].items():
        if name.startswith("program."):
            v.update(device_calls=v["calls"], device_ms=0.5 * v["calls"])
    out["counts"]["program.detect.bytes_h2d"] = 10**9
    return out


@pytest.mark.parametrize("phase", ["map", "localize"])
def test_readers_read_the_records(phases, phase, monkeypatch):
    from benchmark import harness, program_trace

    got = getattr(phases, phase)
    assert program_trace.summary() is None
    for name in READERS:
        assert harness.reader(name).read(_view(1)) is None  # empty tracer
    monkeypatch.setattr(program_trace, "summary", lambda: _on_card(got))
    values = {name: harness.reader(name).read(_view(2)) for name in READERS}
    engine_ms = sum(got["spans"].get(n, {}).get("host_ms", 0.0)
                    for n in ENGINE + SOLVE + ("localize.gather",
                                               "localize.writeback"))
    assert values["engine_host_ms_per_op"] == pytest.approx(engine_ms / 2)
    assert values["host_waits_per_op"] == sum(
        v for k, v in got["counts"].items() if k.startswith("host_wait.")) / 2
    assert values["detect_device_ms_per_photo"] == pytest.approx(
        0.5 / got["counts"]["detect.photos"])
    assert values["upload_gb_per_s"] == pytest.approx(
        1e3 / got["spans"]["program.detect.load"]["host_ms"])
    # the CPU's own records hold no device time
    monkeypatch.setattr(program_trace, "summary", lambda: got)
    assert harness.reader("detect_device_ms_per_photo").read(_view(2)) is None
    assert harness.reader("upload_gb_per_s").read(_view(2)) is None


def test_metrics_flag_prints_the_trace(phases, tmp_path, capsys):
    from ar_slam_tpu_torch.cli import main

    src, out = str(tmp_path / "in.yaml"), str(tmp_path / "out.yaml")
    phases.engine.save_map(src)
    waves = len(phases.engine.store.captures)
    try:
        assert main(["map", src, "-o", out, "--device", "cpu",
                     "--metrics"]) == 0
    finally:
        TRACE.enabled = False
        TRACE.reset()
    printed = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert printed["metrics"]["waves_solved"] == waves
    assert {"solve.plan", "solve.export",
            "host_wait.lm.flags"} <= set(printed["trace"]["spans"])
    assert printed["trace"]["counts"]["host_wait.solve.out"] == 3


def test_profile_traces_each_engine_call(phases, tmp_path):
    """--profile: one chrome trace per localize call, holding the
    program's spans (a nested add_decoded writes none of its own)."""
    engine = phases.engine
    d = str(tmp_path / "profile")
    config = engine.config
    engine.config = dataclasses.replace(config, pipeline=dataclasses.replace(
        config.pipeline, profile_trace_dir=d))
    frames, _ = room_scene(n_frames=5, width=W, height=H, focal=565.0)
    try:
        engine.localize_decoded([IngestedCapture("g4", "g4.png", frames[4])])
    finally:
        engine.config = config
        TRACE.reset()
    [name] = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"engine.stack", "program.detect.detect", "localize.gather",
            "host_wait.localize.out"} <= names
