"""The port's ``arslam-torch map`` command on PNG files (CPU)."""

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
