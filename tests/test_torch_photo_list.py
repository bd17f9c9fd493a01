"""Photos straight into the detector's program (programs.Program's
``rows`` inputs, detect.detect_batch on a list): on the CPU, a list of
photos detects as their stacked batch, alone and split over a mesh,
frames of unequal size raise, and the engine's maps and poses are those
of the stacked, zero-padded batch it detected before; on the card (marked
``cuda``, skipped without one), a list equals its stack bit for bit
through the same program with each photo's bytes counted once, a program
that served 4 photos and then serves 3 detects no stale photo, and two
calls back to back each read their own photos (numpy and the port only:
the card's run has no jax)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from ar_slam_tpu_torch import programs
from ar_slam_tpu_torch.detect import detect as tdet
from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture
from ar_slam_tpu_torch.utils.metrics import TRACE
from ar_slam_tpu_torch.utils.render import room_scene

torch.set_num_threads(1)
NAMES = ("4X4_50", "5X5_100")
PARAMS = tdet.DetectParams(win=3, win_sizes=(3, 13, 23), max_candidates=64)


def _equal(a, b):
    return a.keys() == b.keys() and all(
        torch.equal(a[n][k].cpu(), b[n][k].cpu()) for n in a for k in a[n])


def _padded(frames, n):
    """The stacked batch with zero frames to ``n``, as the engine made it
    before the detector took its photos as a list."""
    stack = np.stack(frames)
    return np.concatenate([stack, np.zeros((n - len(stack), *stack.shape[1:]),
                                           stack.dtype)])


@pytest.fixture(scope="module")
def small():
    frames, _ = room_scene(n_frames=5, width=640, height=480, focal=565.0)
    return frames


def test_list_equals_stack_on_cpu(small):
    """A list of 3 photos (read-only arrays, as decoded photos are), run
    as 4 frames, gives the zero-padded stack's outputs bit for bit."""
    photos = [f.copy() for f in small[:3]]
    for p in photos:
        p.setflags(write=False)
    got = tdet.detect_batch(photos, params=PARAMS, dict_names=NAMES,
                            device="cpu", pad_to=4)
    ref = tdet.detect_batch(_padded(photos, 4), params=PARAMS,
                            dict_names=NAMES, device="cpu")
    assert _equal(got, ref)
    assert got[NAMES[0]]["valid"][:3].any() and not any(
        got[n]["valid"][3].any() for n in NAMES)


@pytest.mark.parametrize("device", ["cpu", "card"])
def test_unequal_photos_raise(small, device):
    """Photos of another size or dtype in one batch raise, as np.stack
    raised for the engine, before anything reaches the device."""
    if device == "card":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        device = "cuda"
    for odd in (small[1][:, :320], small[1].astype(np.float32)):
        with pytest.raises(ValueError, match="one shape and dtype"):
            tdet.detect_batch([small[0], odd], params=PARAMS,
                              dict_names=NAMES, device=device)
    caps = [IngestedCapture("a", "a.png", small[0]),
            IngestedCapture("b", "b.png", small[1][:, :320])]
    with pytest.raises(ValueError, match="one shape and dtype"):
        ArSlamEngine(device="cpu").detect_decoded(caps)


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_list_equals_sharded_stack(small, shards):
    """The mesh detector given 3 photos as a list and run as 4 frames
    splits them as it split the zero-padded stack (a shard of 2 or of 3
    past the photos all padding) and returns the same 3 photos' outputs
    bit for bit."""
    from ar_slam_tpu_torch.parallel.detect import (detect_batch_sharded,
                                                   image_mesh)

    mesh = image_mesh(devices=["cpu"] * shards)
    got = detect_batch_sharded(list(small[:3]), mesh=mesh, params=PARAMS,
                               dict_names=NAMES, pad_to=4)
    ref = detect_batch_sharded(_padded(small[:3], 4), mesh=mesh,
                               params=PARAMS, dict_names=NAMES)
    assert _equal(got, {n: {k: v[:3] for k, v in d.items()}
                        for n, d in ref.items()})


def test_read_only_photos_load_without_a_warning():
    """A graphed load of read-only photos (as decoded photos are), the CPU
    standing in for the card, in a fresh process that makes every
    UserWarning an error: torch's warning on a tensor made of a read-only
    array, filtered once where the program is, does not arise."""
    code = (
        "import numpy as np, torch\n"
        "from ar_slam_tpu_torch import programs\n"
        "photos = [np.full((6, 8), k, np.uint8) for k in range(3)]\n"
        "for p in photos:\n"
        "    p.setflags(write=False)\n"
        "prog = programs.Program({'detect': dict}, graphed=True,\n"
        "    kind='detect', rows={'frames': ((4, 6, 8), torch.uint8)})\n"
        "prog.key, prog.graphs = ('detect', 'cpu', None), {'detect': None}\n"
        "prog.load(frames=photos)\n"
        "assert prog.t['frames'][:3].tolist() == np.stack(photos).tolist()\n"
        "assert not prog.t['frames'][3].any()\n")
    out = subprocess.run([sys.executable, "-W", "error::UserWarning", "-c",
                          code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def _map_and_localize(frames, monkeypatch, parent: bool):
    """A fresh engine's map of frames 0-2 (a batch padded to 4) and its
    localize call of frames 3-4; ``parent``: through detect_batch as the
    engine called it before (one stacked batch, zero frames
    concatenated)."""
    if parent:
        plain = tdet.detect_batch

        def stacked(images, pad_to=None, **kw):
            return plain(_padded(images, pad_to), **kw)
        monkeypatch.setattr(tdet, "detect_batch", stacked)
    caps = [IngestedCapture(f"f{k}", f"f{k}.png", frames[k])
            for k in range(5)]
    engine = ArSlamEngine(device="cpu")
    engine.add_decoded(caps[:3])
    solved = engine.solve()
    out = engine.localize_decoded(caps[3:])
    monkeypatch.undo()
    store = engine.store
    return {"blocks": [(b.cap_idx, b.tag_idx, b.corners) for b in
                       store.blocks],
            "poses": [c.inv_pose for c in store.captures],
            "tags": [t.pose for t in store.arucos],
            "focal": store.camera.params,
            "cost": (solved.get("cost"), out["cost"], out["iterations"])}


def test_engine_maps_and_localizes_as_before(small, monkeypatch):
    """add_decoded (3 photos, padded to 4), solve and localize_decoded (2
    photos) give the detections, poses and costs of the stacked batch bit
    for bit."""
    got = _map_and_localize(small, monkeypatch, parent=False)
    ref = _map_and_localize(small, monkeypatch, parent=True)
    assert len(got["blocks"]) == len(ref["blocks"]) > 0
    for (c, t, crn), (rc, rt, rcrn) in zip(got["blocks"], ref["blocks"]):
        assert (c, t) == (rc, rt) and np.array_equal(crn, rcrn)
    for key in ("poses", "tags"):
        assert len(got[key]) == len(ref[key]) > 0
        assert all(np.array_equal(a, b) for a, b in zip(got[key], ref[key]))
    assert np.array_equal(got["focal"], ref["focal"])
    assert got["cost"] == ref["cost"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def room():
    """8 rendered frames of room-16 (1020x768)."""
    return room_scene(n_frames=8)[0]


def _detect(images, dev, **kw):
    out = tdet.detect_batch(images, device=dev, **kw)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
def test_list_equals_stack_on_card(dev, room):
    """4 photos as a list and as their stack replay one program (the list
    first captures it) and give the eager stage's outputs bit for bit;
    the photos' bytes are counted once a load, none from a card, one
    upload wait a load."""
    programs.CACHE.clear()
    photos = list(room[:4])
    ref = _detect(room[:4], dev, graphs=False)
    TRACE.enabled = True
    try:
        got = _detect(photos, dev)
        again = _detect(room[:4], dev)
        counts = TRACE.summary()["counts"]
    finally:
        TRACE.enabled = False
        TRACE.reset()
    assert _equal(got, ref) and _equal(again, ref)
    assert programs.CACHE.stats()["kinds"]["detect"] == {"captures": 1,
                                                         "replays": 2}
    assert counts["program.detect.bytes_h2d"] == 2 * room[:4].nbytes
    assert counts["program.detect.bytes_d2d"] == 0
    assert counts["host_wait.detect.upload"] == 2
    programs.CACHE.clear()


@pytest.mark.cuda
def test_fewer_photos_zero_the_tail_frame(dev, room):
    """A program that served 4 photos, then given 3 (padded to 4), detects
    nothing in the fourth frame: its outputs are those of a fresh
    program given the 3 stacked with a zero frame, bit for bit."""
    programs.CACHE.clear()
    _detect(list(room[4:8]), dev)
    got = _detect(list(room[:3]), dev, pad_to=4)
    assert programs.CACHE.stats()["kinds"]["detect"] == {"captures": 1,
                                                         "replays": 2}
    programs.CACHE.clear()
    ref = _detect(_padded(room[:3], 4), dev)
    assert _equal(got, ref)
    assert not any(got[n]["valid"][3].any() for n in got)
    programs.CACHE.clear()


@pytest.mark.cuda
def test_back_to_back_calls_read_their_own_photos(dev, room):
    """Two calls queued behind a long sleep on the stream, with no
    synchronisation between them: the second call's photos are copied
    into the program's frames only after the first call's replay has read
    them (the copies queue behind it on the stream), so each returns its
    own photos' detections."""
    programs.CACHE.clear()
    ref_a = _detect(room[:4], dev, graphs=False)
    ref_b = _detect(room[4:8], dev, graphs=False)
    _detect(list(room[:4]), dev)  # captures
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the card's clock
    got_a = tdet.detect_batch(list(room[:4]), device=dev)
    got_b = tdet.detect_batch(list(room[4:8]), device=dev)
    torch.cuda.synchronize()
    assert _equal(got_a, ref_a) and _equal(got_b, ref_b)
    programs.CACHE.clear()
