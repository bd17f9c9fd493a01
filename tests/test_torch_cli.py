"""The port's ``arslam-torch map`` and ``localize`` commands on PNG files
(CPU)."""

import torch

from ar_slam_tpu_torch.utils.render import room_scene

torch.set_num_threads(1)


def test_cli_map_on_pngs(tmp_path, capsys):
    from PIL import Image

    from ar_slam_tpu_torch.cli import main
    from ar_slam_tpu_torch.graph.store import MapStore
    from ar_slam_tpu_torch.graph.yamlio import load_yaml

    frames, truth = room_scene(n_frames=3, width=640, height=480,
                               focal=565.0)
    paths = []
    for k in range(3):
        p = str(tmp_path / f"img{k}.png")
        Image.fromarray(frames[k]).save(p)
        paths.append(p)
    out = str(tmp_path / "map.yaml")
    assert main(["map", *paths, "-o", out, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "solved 3 captures" in printed and out in printed
    rmse = float(printed.split("rmse ")[1].split(" px")[0])
    assert rmse < 1.0
    store = MapStore()
    load_yaml(store, out)
    seen = {f"aruco_{n}_{m}" for fr in truth["frames"]
            for n, m, _, _ in fr}
    assert {a.id for a in store.arucos} == seen
    assert [c.uid for c in store.captures] == ["img0", "img1", "img2"]


def test_cli_localize_on_pngs(tmp_path, capsys):
    """Map three frames, then localize two more against the saved map:
    the reference's printout (per-uid status, then the summary line)."""
    from PIL import Image

    from ar_slam_tpu_torch.cli import main
    from ar_slam_tpu_torch.graph.store import MapStore
    from ar_slam_tpu_torch.graph.yamlio import load_yaml

    frames, _ = room_scene(n_frames=5, width=640, height=480, focal=565.0)
    paths = []
    for k in range(5):
        p = str(tmp_path / f"img{k}.png")
        Image.fromarray(frames[k]).save(p)
        paths.append(p)
    map_path = str(tmp_path / "map.yaml")
    assert main(["map", *paths[:3], "-o", map_path, "--device", "cpu"]) == 0
    capsys.readouterr()
    out = str(tmp_path / "localize.yaml")
    assert main(["localize", map_path, *paths[3:], "-o", out,
                 "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-3:-1] == ["img3: localized", "img4: localized"]
    assert lines[-1].startswith("localized 2 captures, rmse ")
    assert lines[-1].endswith(f" px -> {out}")
    # the queries see tags that only one or two of the three map frames
    # constrain, so their rmse sits near 1.7 px in both packages
    # (test_torch_slice.py::test_engine_localize_matches_jax_engine)
    assert float(lines[-1].split("rmse ")[1].split(" px")[0]) < 3.0
    store = MapStore()
    load_yaml(store, out)
    assert [c.uid for c in store.captures] == [f"img{k}" for k in range(5)]


def test_cli_detect_devices_splits_the_batch(tmp_path, capsys):
    """``detect --devices 3`` on four images (three CPU shards, one of
    them padding) prints what the unsplit batch prints."""
    from PIL import Image

    from ar_slam_tpu_torch.cli import main

    frames, _ = room_scene(n_frames=4, width=640, height=480, focal=565.0)
    paths = []
    for k in range(4):
        p = str(tmp_path / f"img{k}.png")
        Image.fromarray(frames[k]).save(p)
        paths.append(p)
    assert main(["detect", *paths, "--device", "cpu"]) == 0
    plain = capsys.readouterr().out
    assert main(["detect", *paths, "--device", "cpu", "--devices", "3"]) == 0
    assert capsys.readouterr().out == plain
    assert len(plain.splitlines()) == 4


def test_cli_accepts_the_mesh_flags():
    """map, localize, detect and serve take --devices, --multihost,
    --platform and --cpu-detector; gen, audit and scene exist."""
    from ar_slam_tpu_torch.cli import build_parser

    p = build_parser()
    flags = ["--devices", "2", "--multihost", "127.0.0.1:1234,2,0",
             "--platform", "cpu", "--cpu-detector"]
    for argv in (["map", "a.png"], ["localize", "m.yaml", "a.png"],
                 ["detect", "a.png"], ["serve"]):
        args = p.parse_args(argv + flags)
        assert (args.devices, args.multihost, args.platform,
                args.cpu_detector) == (2, "127.0.0.1:1234,2,0", "cpu", True)
    for argv in (["gen"], ["audit", "m.yaml"], ["scene", "m.yaml"]):
        assert p.parse_args(argv).fn.__name__ == f"cmd_{argv[0]}"
