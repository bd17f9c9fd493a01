"""The serve slice's stream and commands on rendered PNG frames (CPU): the
pipelined ingest → detect → merge → solve stream against the sequential
loop, ``arslam-torch serve`` on stdin in both modes with its artifacts,
event log and debug images, ``replay`` from the log, the load-images /
make-map service and its clients, and the make-map fulfilment.  Nothing
here asserts wall time or overlap."""

import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from ar_slam_tpu_torch.cli import _make_map_response, build_parser, main
from ar_slam_tpu_torch.graph.store import MapStore
from ar_slam_tpu_torch.graph.yamlio import load_yaml
from ar_slam_tpu_torch.utils.render import room_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    from PIL import Image

    frames, _ = room_scene(n_frames=5, width=640, height=480, focal=565.0)
    d = tmp_path_factory.mktemp("frames")
    paths = []
    for k, frame in enumerate(frames):
        p = str(d / f"img{k}.png")
        Image.fromarray(frame).save(p)
        paths.append(p)
    return paths


def _blocks(store):
    return sorted((store.captures[b.cap_idx].uid, store.arucos[b.tag_idx].id)
                  for b in store.blocks)


def _load(path):
    store = MapStore()
    load_yaml(store, path)
    return store


def test_stream_pipeline_equals_sequential(pngs, tmp_path):
    """StreamPipeline (batches of 3 + 2) against add_images +
    solve_incremental over the same batches: the same uids in the same
    order, the same stats, poses equal to 1e-9, and every uid published by
    the merge stage.  The pipelined engine snapshots its map after the
    first solve (the first snapshot is always due; the next one an hour
    later)."""
    from ar_slam_tpu_torch.config import ArSlamConfig, PipelineConfig
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
    from ar_slam_tpu_torch.pipeline.stream import StreamPipeline

    snapshot = str(tmp_path / "snapshot.yaml")
    piped = ArSlamEngine(ArSlamConfig(pipeline=PipelineConfig(
        output_map_fn=snapshot, snapshot_every_s=3600.0)), device="cpu")
    solved = []
    pipe = StreamPipeline(piped, batch_size=3, on_solve=lambda summary, uids:
                          solved.append((summary, uids)))
    try:
        pipe.submit(pngs)
        pipe.drain()
    finally:
        pipe.close()
    assert not pipe._ingest_t.is_alive() and not pipe._detect_t.is_alive()

    seq = ArSlamEngine(device="cpu")
    summaries = []
    for batch in (pngs[:3], pngs[3:]):
        seq.add_images(batch)
        summaries.append(seq.solve_incremental())

    uids = [f"img{k}" for k in range(5)]
    assert [c.uid for c in piped.store.captures] == uids
    assert [c.uid for c in seq.store.captures] == uids
    assert pipe.merge.inner.published == set(uids)
    assert [u for _, u in solved] == [uids[:3], uids[3:]]
    for (got, _), ref in zip(solved, summaries):
        assert got.keys() == ref.keys() and got["waves"] == ref["waves"]
        assert abs(got["rmse"] - ref["rmse"]) <= 1e-9
    assert piped.store.stats() == seq.store.stats()
    assert piped.store.stats()["unsolved"] == 0
    assert [c.uid for c in _load(snapshot).captures] == uids[:3]
    for a, b in zip(piped.store.captures + piped.store.arucos,
                    seq.store.captures + seq.store.arucos):
        pose_a = getattr(a, "inv_pose", getattr(a, "pose", None))
        pose_b = getattr(b, "inv_pose", getattr(b, "pose", None))
        np.testing.assert_allclose(pose_a, pose_b, rtol=0, atol=1e-9)


SERVED = 3  # frames fed to serve on stdin


@pytest.fixture(scope="module")
def served(pngs, tmp_path_factory):
    """``serve --device cpu`` on stdin with the first SERVED frames,
    sequential and pipelined (the latter with --embed-images), each with
    --artifacts, --event-log and --debug-images.  Returns {mode: (rc,
    output dir)}."""
    out = {}
    for mode, flags in (("sequential", ["--sequential"]),
                        ("pipelined", ["--embed-images"])):
        d = tmp_path_factory.mktemp(mode)
        argv = ["serve", "-o", str(d / "map.yaml"), "--device", "cpu",
                "--artifacts", str(d / "art.jsonl"),
                "--event-log", str(d / "events.jsonl"),
                "--debug-images", str(d / "dbg"), *flags]
        mp = pytest.MonkeyPatch()
        mp.setattr("sys.stdin",
                   io.StringIO("\n".join(pngs[:SERVED]) + "\n"))
        try:
            out[mode] = (main(argv), d)
        finally:
            mp.undo()
    return out


@pytest.mark.parametrize("mode", ["sequential", "pipelined"])
def test_serve_on_stdin(served, mode):
    """rc 0, one artifact record per solved batch (a stdin line is a
    batch), one debug PNG per capture, the map saved with every capture
    solved."""
    rc, d = served[mode]
    assert rc == 0
    with open(d / "art.jsonl") as f:
        records = [json.loads(line) for line in f]
    uids = [f"img{k}" for k in range(SERVED)]
    assert [r["solved_uids"] for r in records] == [[u] for u in uids]
    last = records[-1]
    assert last["summary"]["unsolved"] == 0 and last["summary"]["rmse"] < 1.0
    assert {"transforms", "camera_info", "markers"} <= last.keys()
    assert sorted(os.listdir(d / "dbg")) == [f"{u}_annotated.png"
                                             for u in uids]
    store = _load(str(d / "map.yaml"))
    assert [c.uid for c in store.captures] == uids
    assert not store.unsolved_captures


def test_serve_modes_agree(served):
    seq, piped = (_load(str(served[m][1] / "map.yaml"))
                  for m in ("sequential", "pipelined"))
    assert _blocks(seq) == _blocks(piped)
    assert seq.stats() == piped.stats()


@pytest.mark.parametrize("mode,flags", [("sequential", []),
                                        ("pipelined", ["--redetect"])])
def test_replay_rebuilds_served_map(served, mode, flags, capsys):
    """replay of the recorded detections, and --redetect of the embedded
    images, rebuild the served map's captures and blocks."""
    _, d = served[mode]
    out = str(d / "replayed.yaml")
    assert main(["replay", str(d / "events.jsonl"), "-o", out,
                 "--device", "cpu", *flags]) == 0
    assert "replayed -> rmse" in capsys.readouterr().out
    assert _blocks(_load(out)) == _blocks(_load(str(d / "map.yaml")))


def test_replay_redetect_needs_embedded_images(served, capsys):
    _, d = served["sequential"]
    assert main(["replay", str(d / "events.jsonl"), "--redetect",
                 "-o", str(d / "x.yaml"), "--device", "cpu"]) == 1
    assert "no embedded image" in capsys.readouterr().err


def test_load_images_service_and_client(tmp_path, capsys):
    """≙ LoadImages.srv (img_fns[] -> success + message) over the unix
    socket, including the empty-request error, through the service's
    client and the load-images command (tests/test_pipeline.py:311-334)."""
    from ar_slam_tpu_torch.pipeline.service import (LoadImagesServer,
                                                    send_load_images)

    sock = str(tmp_path / "arslam.sock")
    server = LoadImagesServer(sock)
    try:
        resp = send_load_images(sock, ["a.jpg", "b.jpg"])
        assert resp["success"] and "2" in resp["message"]
        assert main(["load-images", "--sock", sock, "c.jpg"]) == 0
        assert "queued 1 images" in capsys.readouterr().out
        assert server.pop_batch() == ["a.jpg", "b.jpg", "c.jpg"]
        assert server.pop_batch() == []
        assert not send_load_images(sock, [])["success"]
        assert main(["load-images", "--sock", sock]) == 1
        send_load_images(sock, ["d.jpg", "e.jpg", "f.jpg"])
        assert server.pop_batch(max_items=2) == ["d.jpg", "e.jpg"]
        assert server.pop_batch() == ["f.jpg"]
    finally:
        server.close()
    assert not os.path.exists(sock)


def test_make_map_service_and_client(tmp_path, capsys):
    """A make_map request parks its client until the owner answers with
    the map YAML; the make-map command writes it
    (tests/test_pipeline.py:376-418)."""
    from ar_slam_tpu_torch.pipeline.service import (LoadImagesServer,
                                                    send_load_images,
                                                    send_make_map)

    sock = str(tmp_path / "arslam.sock")
    server = LoadImagesServer(sock)
    answered = []
    stop = threading.Event()

    def owner_loop():
        while len(answered) < 2 and not stop.is_set():
            for respond, fns in server.pop_make_map():
                answered.append(fns)
                respond({"success": True, "message": f"{len(fns)} images",
                         "yaml": "blocks: []\n"})
            stop.wait(0.02)

    owner = threading.Thread(target=owner_loop, daemon=True)
    owner.start()
    try:
        resp = send_make_map(sock, ["x.jpg", "y.jpg"], timeout=10.0)
        assert resp["success"] and resp["yaml"].startswith("blocks:")
        out = tmp_path / "mm.yaml"
        assert main(["make-map", "--sock", sock, "z.jpg", "-o", str(out),
                     "--timeout", "10"]) == 0
        assert out.read_text() == "blocks: []\n"
        owner.join(timeout=10)
        assert not owner.is_alive()
        assert answered == [["x.jpg", "y.jpg"], ["z.jpg"]]
        assert not send_make_map(sock, [], timeout=5.0)["success"]
        assert main(["make-map", "--sock", sock]) == 1
        resp = send_load_images(sock, ["a.jpg"])
        assert resp["success"] and server.pop_batch() == ["a.jpg"]
    finally:
        stop.set()
        server.close()


def test_make_map_response_on_pngs(pngs, tmp_path):
    """The serve-side MakeMap fulfilment on the serve's device: images in,
    solved map YAML out; an unreadable input reports and does not raise."""
    args = build_parser().parse_args(["serve", "--device", "cpu"])
    resp = _make_map_response(args, pngs[:3])
    assert resp["success"], resp
    assert resp["message"].startswith("solved 3 captures, rmse ")
    fn = tmp_path / "mm.yaml"
    fn.write_text(resp["yaml"])
    store = _load(str(fn))
    assert [c.uid for c in store.captures] == ["img0", "img1", "img2"]
    resp = _make_map_response(args, [str(tmp_path / "nope.png")])
    assert not resp["success"] and "make_map failed" in resp["message"]


def test_kernel_library_loads_once_across_threads(monkeypatch):
    """The stream's detect thread and the caller may both reach
    cuda.library() first: 32 threads with a short switch interval build
    and load it once and all get the same handle (nvcc and the card are
    stood in for by a slow fake build and a fake loader)."""
    import sys
    import types

    from ar_slam_tpu_torch import cuda

    builds = []

    def fake_build():
        builds.append(1)
        threading.Event().wait(0.01)
        return "libfake.so"

    monkeypatch.setattr(cuda, "_LIB", None)
    monkeypatch.setattr(cuda, "build", fake_build)
    monkeypatch.setattr(cuda.ctypes, "CDLL", lambda path: types.SimpleNamespace(
        **{name: types.SimpleNamespace() for name in cuda._SIGNATURES}))
    start = threading.Barrier(32)
    got = []

    def load():
        start.wait(timeout=10)
        got.append(cuda.library())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=load) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(got) == 32
    assert all(lib is got[0] for lib in got)


def test_profile_writes_a_trace(tmp_path):
    """--profile reaches the engine's config; profile_trace writes one
    chrome trace of the enclosed work and is a no-op without a directory."""
    from ar_slam_tpu_torch.cli import _config
    from ar_slam_tpu_torch.utils.metrics import profile_trace

    d = str(tmp_path / "trace")
    args = build_parser().parse_args(["replay", "events.jsonl",
                                      "--profile", d])
    assert _config(args).pipeline.profile_trace_dir == d
    with profile_trace(""):
        pass
    assert not os.path.exists(d)
    with profile_trace(d):
        torch.ones(8).cumsum(0)
    [name] = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        assert json.load(f)["traceEvents"]
