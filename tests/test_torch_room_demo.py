"""The demo-camera cell ``room_demo.localize`` on the CPU, at the
configuration's own sizes (1020x768 frames, focal 900, required tags >= 40
px): what the cell is made of, whole runs of the harness (a sound run, each
fault the localize driver can plant, a traced run), K2's counters of the
program's tracer and their reader, and the roofline reader of the
connected-components kernels on a trace made by hand.  On a card, the
control (the plain reference in the precision below the configuration's)
fails the cell's limits on three seeds.

The harness refuses to report in a process that has loaded ``jax`` (the
test process has, through ``conftest.py``), so its runs are made one after
another in a fresh interpreter (``runs``), which detects the query photos
with the plain detector once for all of them: every run compares with the
same scene's plain detections.  Only ``--seconds`` and the mix's
``warm_calls`` are cut, and in the traced run ``trace_ops`` (one call).
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

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness, roofline  # noqa: E402
from benchmark.trace import Profile  # noqa: E402

torch.set_num_threads(1)
CELL = "room_demo.localize"
SEED = 2 ** 31 + 77
# (name, --trace, fault, mix overrides)
FAULTS = ("unchanged", "half", "answer", "corners", "ids")
RUNS = (("sound", 0, None, {"warm_calls": 1}),
        *((f, 0, f, {"warm_calls": 0}) for f in FAULTS),
        ("traced", 1, None, {"warm_calls": 0, "trace_ops": 1}))
K2 = ("(anonymous namespace)::ccl_fused(unsigned char const*, int*, int*, "
      "int*, int, int, int, int)")


def manifest() -> dict:
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def runs() -> None:
    """The cell's ``RUNS`` in this process, one JSON line each: the exit
    code, the result line, the end of standard error and, traced, the
    tracer's counters."""
    from benchmark import rooms
    from ar_slam_tpu_torch.utils.metrics import TRACE

    torch.set_num_threads(1)
    plain, memo = rooms.plain_detections, {}

    def plain_once(truth, photos, cfg, precision="f32"):
        key = (tuple(photos), precision)
        if key not in memo:
            memo[key] = plain(truth, photos, cfg, precision)
        return memo[key]

    rooms.plain_detections = plain_once
    for name, trace, fault, mix in RUNS:
        TRACE.reset()
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = harness.main(["--workload", CELL, "--seed", str(SEED),
                               "--seconds", "0.1", "--trace", str(trace)],
                              device="cpu", mix_sizes=mix, fault=fault)
        lines = out.getvalue().strip().splitlines()
        print(json.dumps({"name": name, "rc": rc,
                          "result": json.loads(lines[-1]) if lines else None,
                          "err": err.getvalue()[-3000:],
                          "counts": TRACE.summary()["counts"]}), flush=True)


@pytest.fixture(scope="module")
def done():
    """{run name: its record} of the cell's runs in a fresh interpreter."""
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import test_torch_room_demo as t; t.runs()" % (ROOT, TESTS))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith('{"name"')]
    return {r["name"]: r for r in recs}


def test_cell_resolves_to_its_files():
    m = manifest()
    files = harness.resolve(m, CELL)
    assert files["cell"]["config"] == "room_demo" and files["cell"][
        "chips"] == 1
    assert files["config"] == harness.load_json(os.path.join(
        ROOT, "benchmark", "configs", "room_demo.json"))
    assert (files["config"]["width"], files["config"]["height"],
            files["config"]["focal"]) == (1020, 768, 900.0)
    assert files["mix"] == harness.load_json(os.path.join(
        ROOT, "benchmark", "traffic", "localize.json"))
    assert files["limits"] == harness.load_json(os.path.join(
        ROOT, "benchmark", "limits", CELL + ".json"))
    assert files["limits"]["missed_tags"] == files["limits"][
        "foreign_ids"] == 0
    assert files["driver"].endswith(os.path.join("drivers", "localize.py"))
    names = {e["name"] for e in harness.metrics_of(m, CELL, False)}
    assert names == {"localize_photos_per_s", "localize_p95_ms", "setup_s"}
    traced = {e["name"] for e in harness.metrics_of(m, CELL, True)}
    # the localize cells' per-layer metrics, and K2's two
    assert traced == {e["name"] for e in m["per_layer"]
                      if "room_12mp.localize" in e.get("workloads", ())} | {
        "ccl_rounds_per_plane.room_demo", "ccl_roofline_pct.room_demo"}
    assert len(traced) == 14
    for name in traced:
        assert harness.reader(name) is not None


def test_sound_run_is_correct(done):
    rec = done["sound"]
    res = rec["result"]
    assert rec["rc"] == 0 and res is not None, rec["err"]
    assert res["correct"], rec["err"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"localize_photos_per_s",
                                   "localize_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"
    limits = harness.resolve(manifest(), CELL)["limits"]
    assert set(res["check"]) == set(limits)


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(done, fault):
    rec = done[fault]
    assert rec["rc"] == 0 and rec["result"] is not None, rec["err"]
    assert rec["result"]["correct"] is False, rec["result"]["check"]


def test_traced_run_counts_k2_rounds(done):
    """Each call's 4 photos give 12 K2 planes (3 windows), each run for 1
    to 24 rounds; the reader gives their ratio."""
    rec = done["traced"]
    res, counts = rec["result"], rec["counts"]
    assert rec["rc"] == 0 and res["correct"], rec["err"]
    photos, planes = counts["detect.photos"], counts["detect.k2.planes"]
    rounds = counts["detect.k2.rounds"]
    assert photos == 4 and planes == 3 * photos
    assert planes <= rounds <= 24 * planes
    assert counts["host_wait.detect.k2_rounds"] == 1
    got = res["metrics"]["ccl_rounds_per_plane.room_demo"]["value"]
    assert got == pytest.approx(rounds / planes)
    # the CPU gives no device trace: the roofline reads nothing
    assert "ccl_roofline_pct.room_demo" not in res["metrics"]


@pytest.mark.parametrize("size,fused", [((768, 1020), True),
                                        ((3024, 4032), False)])
def test_route_by_plane_size(size, fused):
    from ar_slam_tpu_torch.detect.detect import DetectParams, uses_fused_ccl

    assert uses_fused_ccl(*size, DetectParams()) is fused


def test_cpu_twin_keeps_each_planes_rounds():
    """On the CPU, K2's plain version leaves its rounds where the kernel
    leaves its own: one a plane, as ``fused_plane_plain`` runs them."""
    from ar_slam_tpu_torch.detect import ccl

    g = torch.Generator().manual_seed(5)
    binary = torch.rand((3, 40, 150), generator=g) < 0.55
    labels = ccl.connected_components_batch(binary, 24)
    want = [ccl.fused_plane_plain(p, 24) for p in binary]
    assert torch.equal(labels, torch.stack([lab for lab, _ in want]))
    assert ccl._fused_rounds.tolist() == [r for _, r in want]
    assert ccl.fused_plane_rounds() == [r for _, r in want]


@pytest.fixture(scope="module")
def frame():
    from benchmark import rooms
    from benchmark.scenes import room as R

    cfg = harness.resolve(manifest(), CELL)["config"]
    return cfg, R.render(rooms.scene_of(cfg), cfg["query_photos"][0])


def test_tracing_off_reads_no_rounds(frame, monkeypatch):
    """Off, a detection passes no new wait site and reads no rounds; on,
    it reads them once, after the outputs, and counts the call's planes."""
    from benchmark import rooms
    from ar_slam_tpu_torch.detect import ccl
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
    from ar_slam_tpu_torch.utils.metrics import TRACE

    cfg, img = frame
    engine = ArSlamEngine(rooms.engine_config(cfg), device="cpu")
    names = tuple(cfg["detect"]["dictionaries"])
    sites, wait = [], TRACE.wait

    def spy(site, fn, *a, **k):
        sites.append(site)
        return wait(site, fn, *a, **k)

    monkeypatch.setattr(TRACE, "wait", spy)
    was, reads = TRACE.enabled, ccl.fused_round_reads
    try:
        TRACE.enabled = False
        TRACE.reset()
        off = engine._run_detector([img], names)
        assert not TRACE.on and sites == ["detect.out"] * 6
        TRACE.enabled = True
        on = engine._run_detector([img], names)
        counts = TRACE.summary()["counts"]
    finally:
        TRACE.enabled = was
        TRACE.reset()
    assert ccl.fused_round_reads == reads
    assert sites[6:] == ["detect.out"] * 6 + ["detect.k2_rounds"]
    assert counts["detect.k2.planes"] == 3  # 1 photo x 3 windows
    assert counts["host_wait.detect.k2_rounds"] == 1
    assert [sorted(t for t, _ in d) for d in off[0].values()] == [
        sorted(t for t, _ in d) for d in on[0].values()]


def test_k3_call_reads_no_k2_rounds(frame, monkeypatch):
    """Traced, a detection whose planes go to K3 (the limit set to 0 here,
    as 12 MP frames exceed it) reads no K2 rounds and counts none."""
    from benchmark import rooms
    from ar_slam_tpu_torch.detect import ccl, detect
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
    from ar_slam_tpu_torch.utils.metrics import TRACE

    cfg, img = frame
    engine = ArSlamEngine(rooms.engine_config(cfg), device="cpu")
    monkeypatch.setattr(detect, "FUSED_CCL_PIXEL_LIMIT", 0)

    def no_k2(*a, **k):
        raise AssertionError("K2 ran on planes above the limit")

    monkeypatch.setattr(ccl, "connected_components_batch", no_k2)
    was = TRACE.enabled
    try:
        TRACE.enabled = True
        TRACE.reset()
        engine._run_detector([img], tuple(cfg["detect"]["dictionaries"]))
        counts = TRACE.summary()["counts"]
    finally:
        TRACE.enabled = was
        TRACE.reset()
    assert counts["host_wait.detect.out"] == 6
    assert not any("k2" in k for k in counts), counts


def _profile(kernels: list, detect=((0.0, 1000.0),)) -> Profile:
    """A profiled stretch of one card made by hand: the benchmark's
    ``detect`` spans, and kernels (start, end, name) in microseconds."""
    p = Profile.__new__(Profile)
    p.cards, p.launches = [0], []
    p.device = {0: list(kernels)}
    p.ranges = [(0.0, 5000.0, "stretch")] + [(s, e, "detect")
                                              for s, e in detect]
    p.t0, p.t1 = 0.0, 5000.0
    return p


def _view(trace) -> SimpleNamespace:
    return SimpleNamespace(
        trace=trace, counters={"detect_shapes": [(4, 768, 1020)] * 3,
                               "windows": 3},
        cfg={"detect": {"candidates": 64}}, spans={}, records=[],
        window_s=5.0)


def test_ccl_roofline_reads_the_components_kernels():
    read = harness.reader("ccl_roofline_pct.room_demo").read
    trace = _profile([
        (100.0, 300.0, K2),  # 0.2 ms
        (400.0, 500.0, K2),  # 0.1 ms
        (500.0, 900.0, "void at::native::vectorized_elementwise_kernel"),
        (600.0, 650.0, "Memcpy HtoD (Pageable -> Device)"),
        (2000.0, 2500.0, K2),  # outside every detect span
    ])
    least = roofline.detect_roles(4, 768, 1020)["components"]
    assert read(_view(trace)) == pytest.approx(100.0 * least / 0.3)
    # two detect spans: twice the least time over both spans' kernels
    two = _profile([(100.0, 300.0, K2), (2100.0, 2200.0,
                                         "(anonymous namespace)::strip_row("
                                         "int const*, int*, int*, int, "
                                         "int, int, int)")],
                   detect=((0.0, 1000.0), (2000.0, 3000.0)))
    assert read(_view(two)) == pytest.approx(200.0 * least / 0.3)
    # no connected-components kernel, no trace, no detect span: nothing
    assert read(_view(_profile([(100.0, 900.0, "other_kernel")]))) is None
    assert read(_view(None)) is None
    assert read(_view(_profile([(100.0, 300.0, K2)], detect=()))) is None


def test_rounds_reader_needs_the_counters(monkeypatch):
    from benchmark import program_trace

    read = harness.reader("ccl_rounds_per_plane.room_demo").read
    monkeypatch.setattr(program_trace, "summary", lambda: None)
    assert read(_view(None)) is None
    monkeypatch.setattr(program_trace, "summary", lambda: {
        "spans": {}, "counts": {"detect.photos": 4}})
    assert read(_view(None)) is None  # the parent: no K2 counters
    monkeypatch.setattr(program_trace, "summary", lambda: {
        "spans": {}, "counts": {"detect.k2.planes": 12,
                                "detect.k2.rounds": 90}})
    assert read(_view(None)) == 7.5


CONTROL_SEEDS = (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
def test_control_fails_the_limits(seed, capsys):
    """The plain reference in the program's place, in the precision below
    what the configuration states (the detector's corner arithmetic in
    bfloat16, the pose-only LM in TF32), through the cell's own comparison:
    at least one number lies above its limit.  Prints each reading beside
    its limit.  Run on a card with ``--noconftest``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import rooms
    from benchmark.drivers import localize

    files = harness.resolve(manifest(), CELL)
    cfg, limits = files["config"], files["limits"]
    ctx = SimpleNamespace(cfg=cfg, mix=files["mix"], seed=seed,
                          device="cuda", chips=1, spans=None, fault=None)
    truth = rooms.Truth(rooms.scene_of(cfg),
                        list(cfg["map_photos"]) + list(cfg["query_photos"]))
    q = list(cfg["query_photos"])
    records = [{"photos": q[i:i + 4]} for i in range(0, len(q), 4)]
    got = localize.control(ctx, truth, records, "tf32")
    with capsys.disabled():
        print(json.dumps({"control": CELL, "seed": seed,
                          **{k: [got[k], lim] for k, lim in limits.items()}}))
    assert any(not got[k] <= lim for k, lim in limits.items()), got
