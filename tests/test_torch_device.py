"""The port runs on the card unless the caller asks for the CPU: with no
CUDA device every entry point raises, and ``device="cpu"`` /
``--device cpu`` still run (CPU; CUDA is made absent by monkeypatching
``torch.cuda.is_available``)."""

import numpy as np
import pytest
import torch

from ar_slam_tpu_torch import device as tdevice
from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map

torch.set_num_threads(1)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("dev", [None, "cuda", "cuda:0"])
def test_resolve_device_raises_without_cuda(no_cuda, dev):
    with pytest.raises(RuntimeError, match="CUDA|cpu"):
        tdevice.resolve_device(dev)


def test_resolve_device_cpu_on_request(no_cuda):
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    assert tdevice.resolve_device(torch.device("cpu")).type == "cpu"


def _entry_points():
    from ar_slam_tpu_torch.convert import arrays_from_numpy
    from ar_slam_tpu_torch.detect.detect import detect_batch
    from ar_slam_tpu_torch.graph.arrays import export_arrays
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
    from ar_slam_tpu_torch.solve.batch import solve, solve_incremental
    from ar_slam_tpu_torch.solve.localize import localize_many

    store, _ = make_synthetic_map(n_tags=4, n_caps=3, seed=1)
    return {
        "engine": lambda **kw: ArSlamEngine(**kw),
        "detect_batch": lambda **kw: detect_batch(
            np.zeros((1, 64, 64), np.uint8), **kw),
        "solve": lambda **kw: solve(store, **kw),
        "solve_incremental": lambda **kw: solve_incremental(store, **kw),
        "localize_many": lambda **kw: localize_many(store, 2, **kw),
        "arrays_from_numpy": lambda **kw: arrays_from_numpy(
            export_arrays(store), **kw),
    }


@pytest.mark.parametrize("name", ["engine", "detect_batch", "solve",
                                  "solve_incremental", "localize_many",
                                  "arrays_from_numpy"])
def test_entry_points_refuse_silent_cpu(no_cuda, name):
    """Without ``device`` every entry point raises; with ``device="cpu"``
    it runs on the CPU."""
    fn = _entry_points()[name]
    with pytest.raises(RuntimeError, match="cpu"):
        fn()
    out = fn(device="cpu")
    if name == "engine":
        assert out.device == torch.device("cpu")


@pytest.mark.parametrize("cmd", ["map", "localize", "detect", "serve",
                                 "replay"])
def test_cli_without_device_does_not_run_on_cpu(no_cuda, tmp_path, cmd):
    """``arslam-torch`` without ``--device`` stops with the error rather
    than building a CPU engine (it fails before reading any input)."""
    from ar_slam_tpu_torch.cli import main

    args = {"map": ["map", "a.png", "-o", str(tmp_path / "m.yaml")],
            "localize": ["localize", "m.yaml", "a.png"],
            "detect": ["detect", "a.png"],
            "serve": ["serve", "-o", str(tmp_path / "m.yaml")],
            "replay": ["replay", "events.jsonl"]}[cmd]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(args)
