"""The control on the card, at each cell's own size: the plain reference put
in the program's place, a stage at a time, in the precision below what the
configuration states: the plain detector's corner arithmetic in bfloat16
(the detector states float32), the solvers in TF32 (float32 with TF32 off),
on three seeds.  Prints each reading; at least one number of each seed's
control lies above its limit.  Then a whole run with every detection's
corners moved by a pixel where they are produced, which reads not correct.

    python -m pytest benchmark/tests/test_bench_control_chip.py -s

Skips where there is no card.
"""

from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, rooms
from benchmark.drivers import localize, map as map_driver

SEEDS = (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303)
MANIFEST = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _ctx(cell, seed, device):
    files = harness.resolve(MANIFEST, cell)
    return (SimpleNamespace(cfg=files["config"], mix=files["mix"],
                            seed=seed, device=device, chips=1, spans=None,
                            fault=None), files["limits"])


def _report(cell, seed, got, limits, seconds):
    print(json.dumps({"control": cell, "seed": seed, "seconds": seconds,
                      **{k: [got[k], limits[k]] for k in limits}}))
    assert any(not got[k] <= lim for k, lim in limits.items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_control_localize(card, seed):
    ctx, limits = _ctx("room_12mp.localize", seed, card)
    cfg = ctx.cfg
    truth = rooms.Truth(rooms.scene_of(cfg),
                        list(cfg["map_photos"]) + list(cfg["query_photos"]))
    q = list(cfg["query_photos"])
    records = [{"photos": q[i:i + 4]} for i in range(0, len(q), 4)]
    t0 = time.perf_counter()
    got = localize.control(ctx, truth, records, "tf32")
    _report("room_12mp.localize", seed, got, limits, time.perf_counter() - t0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_control_map(card, seed):
    ctx, limits = _ctx("room_12mp.map", seed, card)
    truth = rooms.Truth(rooms.scene_of(ctx.cfg), list(ctx.cfg["map_photos"]))
    t0 = time.perf_counter()
    got = map_driver.control(ctx, truth, [None], "tf32")
    _report("room_12mp.map", seed, got, limits, time.perf_counter() - t0)


@pytest.mark.cuda
def test_corner_fault_localize(card, capsys):
    """A whole run on the card with every detection's corners moved by one
    pixel where the detector produces them."""
    rc = harness.main(["--workload", "room_12mp.localize", "--seed",
                       str(2 ** 31 + 311), "--seconds", "5", "--trace", "0"],
                      fault="corners")
    out = capsys.readouterr().out.strip().splitlines()
    res = json.loads(out[-1])
    with capsys.disabled():
        print(json.dumps({"fault": "corners", "check": res["check"]}))
    assert rc == 0 and res["correct"] is False
