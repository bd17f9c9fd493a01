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
