"""The port's main path as a whole: the engine against the JAX engine on a
rendered multi-view scene, the no-jax import guarantee, and the host
modules the port copies from the JAX package (the CLI is in
test_torch_cli.py)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ar_slam_tpu.config import ArSlamConfig as JConfig
from ar_slam_tpu.pipeline.engine import ArSlamEngine as JEngine
from ar_slam_tpu_torch.config import ArSlamConfig as TConfig
from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine as TEngine
from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture
from ar_slam_tpu_torch.utils.render import room_scene

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene():
    return room_scene(n_frames=3, width=640, height=480, focal=565.0)


def _f64(config_cls):
    cfg = config_cls()
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, dtype="float64"))


def _map(engine, frames):
    caps = [IngestedCapture(f"f{k}", f"f{k}.png", frames[k])
            for k in range(len(frames))]
    for uid, by_dict, size, path in engine.detect_decoded(caps):
        engine.store.add_detections(
            uid, [d for dets in by_dict.values() for d in dets], size, path)
    return engine.solve()


def test_engine_matches_jax_engine(scene):
    """Port engine vs the JAX engine (its XLA detector on the CPU), both
    solving in float64: the same (capture, tag) observations, the true tag
    set, and |delta rmse| <= 0.1 px.  The bound: the JAX CPU path box-
    filters the corner-refine field maps through float32 integral images
    whose prefix sums reach ~1e11 (ulp ~1e4), which on these 30-40 px tags
    displaces single refined corners by px (measured on a 4-frame version
    of this scene: one corner 5.8 px from the rendered truth in the JAX map,
    0.75 px in the port's); the port's direct window sums do not cancel."""
    frames, truth = scene
    je = JEngine(config=_f64(JConfig), use_tpu_detector=True)
    te = TEngine(config=_f64(TConfig), device="cpu", dtype=torch.float64)
    ref = _map(je, frames)
    got = _map(te, frames)

    def obs(store):
        return {(store.captures[b.cap_idx].uid, store.arucos[b.tag_idx].id)
                for b in store.blocks}

    assert obs(te.store) == obs(je.store)
    true_tags = {f"aruco_{n}_{m}" for fr in truth["frames"]
                 for n, m, _, _ in fr}
    assert {a.id for a in te.store.arucos} == true_tags
    assert got["waves"] == ref["waves"] == len(frames)
    assert abs(got["rmse"] - ref["rmse"]) <= 0.1
    assert got["rmse"] < 1.0


PORT_MODULES = [
    "ar_slam_tpu_torch", "ar_slam_tpu_torch.cli", "ar_slam_tpu_torch.config",
    "ar_slam_tpu_torch.convert", "ar_slam_tpu_torch.cuda",
    "ar_slam_tpu_torch.device", "ar_slam_tpu_torch.core.calib",
    "ar_slam_tpu_torch.core.lie", "ar_slam_tpu_torch.core.projection",
    "ar_slam_tpu_torch.core.seeding", "ar_slam_tpu_torch.detect.box",
    "ar_slam_tpu_torch.detect.ccl", "ar_slam_tpu_torch.detect.detect",
    "ar_slam_tpu_torch.detect.dictionaries",
    "ar_slam_tpu_torch.detect.extract", "ar_slam_tpu_torch.graph.arrays",
    "ar_slam_tpu_torch.graph.native", "ar_slam_tpu_torch.graph.store",
    "ar_slam_tpu_torch.graph.yamlio", "ar_slam_tpu_torch.pipeline.engine",
    "ar_slam_tpu_torch.pipeline.fast_decode",
    "ar_slam_tpu_torch.pipeline.ingest", "ar_slam_tpu_torch.pipeline.merge",
    "ar_slam_tpu_torch.pipeline.messages",
    "ar_slam_tpu_torch.pipeline.service", "ar_slam_tpu_torch.pipeline.stream",
    "ar_slam_tpu_torch.parallel", "ar_slam_tpu_torch.parallel.detect",
    "ar_slam_tpu_torch.parallel.dist_lm", "ar_slam_tpu_torch.parallel.mesh",
    "ar_slam_tpu_torch.parallel.multihost",
    "ar_slam_tpu_torch.parallel.partition",
    "ar_slam_tpu_torch.detect.gen", "ar_slam_tpu_torch.detect.reference",
    "ar_slam_tpu_torch.utils.audit", "ar_slam_tpu_torch.viz.scene",
    "ar_slam_tpu_torch.solve.batch",
    "ar_slam_tpu_torch.solve.localize", "ar_slam_tpu_torch.solve.lm",
    "ar_slam_tpu_torch.solve.residuals",
    "ar_slam_tpu_torch.solve.schur", "ar_slam_tpu_torch.utils.ate",
    "ar_slam_tpu_torch.utils.metrics", "ar_slam_tpu_torch.utils.render",
    "ar_slam_tpu_torch.utils.synthetic", "ar_slam_tpu_torch.viz",
    "ar_slam_tpu_torch.viz.annotate", "ar_slam_tpu_torch.viz.export",
]


def test_port_imports_without_jax_yaml_pil():
    """Every module of the port (and chip_smoke) imports with jax, PyYAML,
    PIL and cv2 made unimportable, and pulls in no ar_slam_tpu module."""
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'yaml', 'PIL', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {PORT_MODULES!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'ar_slam_tpu'\n"
        "       or m.startswith('ar_slam_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


COPIES = ["graph/store.py", "graph/arrays.py", "graph/native.py",
          "pipeline/ingest.py", "pipeline/fast_decode.py",
          "pipeline/merge.py", "pipeline/messages.py", "pipeline/stream.py",
          "pipeline/service.py", "viz/export.py",
          "utils/synthetic.py", "utils/ate.py", "core/calib.py",
          "detect/dictionaries.py", "parallel/partition.py",
          "viz/scene.py", "detect/gen.py", "detect/reference.py"]


def _source(pkg, rel):
    with open(os.path.join(REPO, pkg, rel)) as f:
        return f.read()


# the only edits the port makes to its copies, as (original, copy) text
EDITS = {
    "config.py": [
        ("""    profile_trace_dir: str = ""  # jax.profiler trace output (xprof)
""", """    profile_trace_dir: str = ""  # torch.profiler chrome traces (--profile)
""")],
    "graph/yamlio.py": [
        ("""import numpy as np
import yaml

from ar_slam_tpu_torch.graph.store import MapStore


# libyaml C loader when built (3-4x the pure-Python parse); both are ~40x
# slower than the fast path below on large machine-written maps.
_YAML_LOADER = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
""", """import numpy as np

from ar_slam_tpu_torch.graph.store import MapStore
"""),
        ("""    doc = yaml.load(text, Loader=_YAML_LOADER)
""", """    # PyYAML only on this fallback branch: the fast path above needs no
    # third-party parser.  libyaml C loader when built (3-4x the
    # pure-Python parse); both are ~40x slower than the fast path on large
    # machine-written maps.
    import yaml

    doc = yaml.load(text, Loader=getattr(yaml, "CSafeLoader", yaml.SafeLoader))
""")],
}


@pytest.mark.parametrize("rel", COPIES + sorted(EDITS))
def test_host_copy_equals_original(rel):
    """Each copied host module is its original with the package renamed,
    under a header naming the original; yamlio imports PyYAML only on its
    fallback branch."""
    expected = _source("ar_slam_tpu", rel).replace("ar_slam_tpu.",
                                                   "ar_slam_tpu_torch.")
    for old, new in EDITS.get(rel, []):
        assert old in expected
        expected = expected.replace(old, new)
    copy = _source("ar_slam_tpu_torch", rel)
    head, body = copy.split('"""', 1)
    assert head.startswith(f"# Copied from ar_slam_tpu/{rel}")
    assert '"""' + body == expected


def test_dictionaries_data_is_a_byte_copy():
    """The port reads its own dictionaries.npz, byte-identical to the JAX
    package's."""
    from ar_slam_tpu_torch.detect import dictionaries

    with open(os.path.join(REPO, "ar_slam_tpu", "detect",
                           "dictionaries.npz"), "rb") as f:
        original = f.read()
    assert os.path.dirname(os.path.abspath(dictionaries._NPZ)) == os.path.join(
        REPO, "ar_slam_tpu_torch", "detect")
    with open(dictionaries._NPZ, "rb") as f:
        assert f.read() == original


def test_host_copies_behave_like_originals(tmp_path):
    from ar_slam_tpu.core import calib as j_calib
    from ar_slam_tpu.graph import yamlio as j_yaml
    from ar_slam_tpu.graph.arrays import export_arrays as j_export
    from ar_slam_tpu.utils import ate as j_ate
    from ar_slam_tpu.utils.synthetic import make_synthetic_map as j_make
    from ar_slam_tpu_torch.core import calib as t_calib
    from ar_slam_tpu_torch.graph import yamlio as t_yaml
    from ar_slam_tpu_torch.graph.arrays import export_arrays as t_export
    from ar_slam_tpu_torch.utils import ate as t_ate
    from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map as t_make

    js, jt = j_make(n_tags=12, n_caps=6, seed=2, noise_px=0.2)
    ts, tt = t_make(n_tags=12, n_caps=6, seed=2, noise_px=0.2)
    for k in jt:
        np.testing.assert_array_equal(jt[k], tt[k])
    for a, b in zip(j_export(js), t_export(ts)):
        np.testing.assert_array_equal(a, b)
    assert js.connected_component(0) == ts.connected_component(0)
    assert js.capture_with_most_blocks() == ts.capture_with_most_blocks()
    assert t_yaml.dumps_yaml(ts) == j_yaml.dumps_yaml(js)
    p = tmp_path / "m.yaml"
    t_yaml.save_yaml(ts, str(p))
    j_back = type(js)()
    j_yaml.load_yaml(j_back, str(p))
    t_back = type(ts)()
    t_yaml.load_yaml(t_back, str(p))
    assert t_yaml.dumps_yaml(t_back) == j_yaml.dumps_yaml(j_back)
    corners = [b.corners for b in js.blocks]
    assert t_calib.estimate_focal(corners, 0.0635) == j_calib.estimate_focal(
        corners, 0.0635)
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    for got, ref in ((t_ate.umeyama_alignment(a, b),
                      j_ate.umeyama_alignment(a, b)),
                     (t_ate.ate_rmse(a, b), j_ate.ate_rmse(a, b)),
                     (t_ate.camera_positions(ts), j_ate.camera_positions(js)),
                     (t_ate.map_ate(ts, t_back), j_ate.map_ate(js, j_back))):
        np.testing.assert_equal(got, ref)
    assert TConfig().to_dict() == JConfig().to_dict()
