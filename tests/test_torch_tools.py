"""Port parity of the last host commands against the JAX package on the
same inputs, CPU: the reprojection audit (utils/audit.py on the port's
residuals_only, ``arslam-torch audit``), the 3-D scene render
(viz/scene.py, ``scene``), the tag sheets (detect/gen.py, ``gen``) and
the NumPy-oracle detector of ``--cpu-detector`` (detect/reference.py
through the engine)."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.detect.gen import generate_pages as j_gen
from ar_slam_tpu.pipeline.engine import ArSlamEngine as JEngine
from ar_slam_tpu.utils.audit import compare_projections as j_audit
from ar_slam_tpu.utils.audit import format_audit as j_format
from ar_slam_tpu.viz.scene import render_scene as j_scene
from ar_slam_tpu_torch import cli
from ar_slam_tpu_torch.config import ArSlamConfig, SolverConfig
from ar_slam_tpu_torch.graph.yamlio import save_yaml
from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine
from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture
from ar_slam_tpu_torch.solve.batch import solve
from ar_slam_tpu_torch.utils.audit import compare_projections, format_audit
from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map
from test_torch_detect import _frames

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """A solved 10-tag / 5-capture synthetic map, and its yaml."""
    store, _ = make_synthetic_map(n_tags=10, n_caps=5, seed=7, noise_px=0.3)
    solve(store, ArSlamConfig(solver=SolverConfig(dtype="float64")),
          device="cpu")
    path = str(tmp_path_factory.mktemp("map") / "map.yaml")
    save_yaml(store, path)
    return store, path


def test_audit_matches_jax(solved, capsys):
    """Every row equal to the JAX audit's (floats within 1e-9, the same
    order); the table and the CLI's output, text for text."""
    store, path = solved
    got = compare_projections(store, device="cpu")
    ref = j_audit(store)
    assert [(r["capture"], r["aruco"]) for r in got] == [
        (r["capture"], r["aruco"]) for r in ref]
    for key in ("corner_err_px", "rmse_px", "observed", "projected"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in ref], rtol=0, atol=1e-9)
    assert format_audit(got, limit=7) == j_format(ref, limit=7)
    assert cli.main(["audit", path, "--limit", "7", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == format_audit(got, limit=7) + "\n"
    assert cli.main(["audit", path, "--json", "--device", "cpu"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["aruco"] for r in rows] == [r["aruco"] for r in got]


def test_scene_matches_jax(solved, tmp_path, capsys):
    """The same PNG pixels as the JAX render of the same map, through the
    CLI."""
    store, path = solved
    out = str(tmp_path / "scene.png")
    assert cli.main(["scene", path, "-o", out]) == 0
    assert capsys.readouterr().out.strip() == out
    ref = j_scene(store, str(tmp_path / "ref.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  np.asarray(Image.open(ref)))


def test_gen_matches_jax(tmp_path, capsys):
    """The same pages, pixel for pixel, through the CLI."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    assert cli.main(["gen", "--dictionary", "4X4_50", "--out-dir",
                     str(tmp_path / "t")]) == 0
    got = capsys.readouterr().out.split()
    ref = j_gen(str(tmp_path / "j"), "4X4_50")
    assert len(got) == len(ref) == 9
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(Image.open(g)),
                                      np.asarray(Image.open(r)))


def test_cpu_detector_matches_jax_oracle():
    """use_device_detector=False (``--cpu-detector``) runs the NumPy
    oracle copy: the detections of the JAX engine's oracle branch,
    exactly, on two rendered frames."""
    frames, truth = _frames(n=2)
    caps = [IngestedCapture(f"f{i}", f"f{i}.png", frames[i])
            for i in range(len(frames))]
    got = ArSlamEngine(device="cpu",
                       use_device_detector=False).detect_decoded(caps)
    ref = JEngine(config=JConfig(),
                  use_tpu_detector=False).detect_decoded(caps)
    assert len(got) == len(ref) == 2
    for (uid, by_dict, size, _), (r_uid, r_by_dict, r_size, _) in zip(got,
                                                                      ref):
        assert (uid, size) == (r_uid, r_size)
        assert by_dict.keys() == r_by_dict.keys()
        for k in by_dict:
            assert [d[0] for d in by_dict[k]] == [d[0] for d in r_by_dict[k]]
            for d, r in zip(by_dict[k], r_by_dict[k]):
                np.testing.assert_array_equal(d[1], r[1])
    found = {tid for _, by_dict, _, _ in got for dets in by_dict.values()
             for tid, _ in dets}
    assert found == {f"aruco_{n}_{m}" for ids in truth for n, m in ids}
