"""The detector as a compiled program (detect/detect.py, programs.py) on
the CPU: its one stage run through a ``Program``, the engine's
power-of-two padding of the batch, the stage's freedom from host reads,
the sharded split, and the cache's rule of one program per signature
for the ``detect`` kind.  On the card the same stage is captured as one
CUDA graph and replayed (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from ar_slam_tpu.detect import tpu_detect as jdet
from ar_slam_tpu_torch import programs
from ar_slam_tpu_torch.detect import box, ccl, extract
from ar_slam_tpu_torch.detect import detect as tdet
from ar_slam_tpu_torch.parallel.detect import (detect_batch_sharded,
                                               image_mesh)
from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
from test_torch_detect import _frames
from test_torch_lm_graph import NoHostSync

torch.set_num_threads(1)
NAMES = ("4X4_50", "5X5_100")
KEYS = ("ids", "corners", "valid")
PARAMS = tdet.DetectParams(win=3, win_sizes=(3, 13, 23), max_candidates=64)


@pytest.fixture(scope="module")
def frames():
    return _frames()


def _stage_outputs(frames, params, names):
    """The ``detect`` stage run once through an eager Program."""
    prog = programs.Program(
        {"detect": tdet._stage(params, names, torch.device("cpu"))}, False)
    prog.load(frames=torch.from_numpy(frames))
    prog.run("detect")
    return {name: dict(zip(KEYS, prog.t[name])) for name in names}


def _equal(a, b, n=None):
    return all(torch.equal(a[name][k][:n], b[name][k][:n])
               for name in b for k in KEYS)


@pytest.mark.parametrize("n,names", [(1, NAMES), (3, NAMES),
                                     (3, ("5X5_100",))])
def test_stage_through_program_equals_detect_batch(frames, n, names):
    """The stage, through an eager Program on rendered 480x640 frames
    (windows 3/13/23), gives detect_batch's outputs bit for bit."""
    imgs, truth = frames
    got = _stage_outputs(imgs[:n], PARAMS, names)
    ref = tdet.detect_batch(imgs[:n], params=PARAMS, dict_names=names,
                            device="cpu")
    assert _equal(got, ref)
    for name in names:
        assert sorted(got[name]["ids"][0][got[name]["valid"][0]].tolist()) \
            == sorted(m for d, m in truth[0] if d == name)


def test_engine_pads_the_batch_to_a_power_of_two(frames, monkeypatch):
    """The engine detects 3 frames as a batch of 4 (the detector adds a
    zero frame last): the outputs are the zero-padded stack's bit for
    bit, the 3 frames' those of the unpadded batch, the zero frame
    detects nothing, and the engine's detections have the JAX detector's
    ids exactly and its corners within 0.25 px (the bound of
    test_torch_detect.py's detect_batch parity, for the same reason)."""
    imgs, _ = frames
    seen = []
    plain = tdet.detect_batch

    def spy(images, **kw):
        seen.append((len(images), kw["pad_to"], kw["params"]))
        seen.append(plain(images, **kw))
        return seen[-1]

    monkeypatch.setattr(tdet, "detect_batch", spy)
    engine = ArSlamEngine(device="cpu")
    per_image = engine._run_detector(imgs, NAMES)
    (n, pad_to, params), padded_out = seen
    assert (n, pad_to) == (3, 4)
    padded = np.concatenate([imgs, np.zeros_like(imgs[:1])])
    assert _equal(padded_out, plain(padded, params=params, dict_names=NAMES,
                                    device="cpu"))
    ref = plain(imgs, params=params, dict_names=NAMES, device="cpu")
    assert _equal(padded_out, ref, 3)
    for name in NAMES:
        assert not padded_out[name]["valid"][3].any()
    jax_ref = jdet.detect_batch(jnp.asarray(imgs), params=jdet.DetectParams(
        **params._asdict()), dict_names=NAMES)
    center = np.array([imgs.shape[2] / 2.0, imgs.shape[1] / 2.0])
    assert len(per_image) == 3
    for i, by_dict in enumerate(per_image):
        for name in NAMES:
            valid = np.asarray(jax_ref[name]["valid"][i])
            want = dict(zip(np.asarray(jax_ref[name]["ids"][i])[valid],
                            np.asarray(jax_ref[name]["corners"][i])[valid]))
            got = by_dict[f"aruco_{name}"]
            assert sorted(int(t.rsplit("_", 1)[1]) for t, _ in got) \
                == sorted(want)
            for tag, corners in got:
                mid = int(tag.rsplit("_", 1)[1])
                assert np.abs(corners + center - want[mid]).max() <= 0.25


def test_stage_reads_nothing_back(frames, monkeypatch):
    """Nothing around the kernels reads a value to the host or makes a
    tensor from host data: the stage runs under NoHostSync with each
    kernel wrapper replaced by a stand-in that runs its plain version
    outside the mode (the plain versions read the host; the kernels do
    not), on a K2-sized batch and on a plane above the fused limit
    (K3)."""
    called = []

    def stand_in(module, name):
        wrapper = getattr(module, name)

        def run(*args, **kw):
            called.append(name)
            with _disable_current_modes():
                return wrapper(*args, **kw)
        monkeypatch.setattr(module, name, run)

    for module, name in ((box, "threshold_batch"), (box, "box_sum_batch"),
                         (ccl, "connected_components_batch"),
                         (ccl, "connected_components_strip_batch"),
                         (extract, "extreme_quads")):
        stand_in(module, name)
    imgs, _ = frames
    big = np.zeros((1, 2400, 2400), np.uint8)
    for batch in (imgs[:2], big):
        prog = programs.Program(
            {"detect": tdet._stage(PARAMS, NAMES, torch.device("cpu"))},
            False)
        prog.load(frames=torch.from_numpy(batch))
        with NoHostSync():
            prog.run("detect")
    assert called == ["threshold_batch", "connected_components_batch",
                      "extreme_quads", "box_sum_batch"] + [
        "threshold_batch", "connected_components_strip_batch",
        "extreme_quads", "box_sum_batch"]


def test_sharded_detection_equals_unsharded(frames):
    """3 frames over 3 CPU shards (a frame each, one program shape) are
    the unsharded batch's outputs bit for bit."""
    imgs, _ = frames
    got = detect_batch_sharded(imgs, mesh=image_mesh(devices=["cpu"] * 3),
                               params=PARAMS, dict_names=NAMES)
    ref = tdet.detect_batch(imgs, params=PARAMS, dict_names=NAMES,
                            device="cpu")
    assert _equal(got, ref)


def test_detect_kind_keeps_one_program_per_signature():
    """The ``detect`` kind keeps a program per (card, signature), up to
    its bound, dropping the least recently used; the solver's kinds still
    keep one each; stats list what is held."""
    import weakref

    cache = programs.GraphCache()
    bound = programs.KEEP["detect"]

    def make():
        return programs.Program({}, True, label="stand-in")

    first = weakref.ref(cache.get("detect", "cuda:0", 0, make))
    for sig in range(1, bound):
        cache.get("detect", "cuda:0", sig, make)
    assert cache.get("detect", "cuda:0", 0, make) is first()  # now recent
    other = cache.get("detect", "cuda:1", 0, make)
    assert other is not first() and cache.stats()["programs"] == bound + 1
    cache.get("detect", "cuda:0", bound, make)  # drops signature 1
    assert first() is not None and cache.stats()["programs"] == bound + 1
    held = [p.signature for (k, d, _), p in cache._programs.items()
            if d == "cuda:0"]
    assert held == [*range(2, bound), 0, bound]
    lm = weakref.ref(cache.get("lm", "cuda:0", 1, make))
    assert cache.get("lm", "cuda:0", 2, make) is not lm() and lm() is None
    cache.get("seed", "cuda:0", 1, make)
    stats = cache.stats()
    assert stats["programs"] == bound + 3 and stats["pool_bytes"] == 0
    assert [h["program"] for h in stats["held"]] == ["stand-in"] * (
        bound + 3)
