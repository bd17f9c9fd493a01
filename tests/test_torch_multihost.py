"""Two processes of the port's own command line join one gloo process
group over localhost and re-solve a saved map tag-sharded across them (≙
tests/test_multihost.py, which runs the JAX CLI the same way and is
marked slow; this one takes seconds).  Each process holds one CPU shard,
so every reduction crosses processes.  Float64: the two processes must
log the same cost, equal to the single-device solve's within 1e-10
relative (measured: 3e-14)."""

import os
import re
import socket
import subprocess
import sys

import torch

from ar_slam_tpu_torch.config import ArSlamConfig, SolverConfig
from ar_slam_tpu_torch.graph.store import MapStore
from ar_slam_tpu_torch.graph.yamlio import load_yaml, save_yaml
from ar_slam_tpu_torch.solve.batch import solve
from ar_slam_tpu_torch.utils.synthetic import make_synthetic_map

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_solve_like_one_device(tmp_path):
    store, _ = make_synthetic_map(n_tags=12, n_caps=6, seed=3, noise_px=0.3)
    save_yaml(store, str(tmp_path / "m.yaml"))
    (tmp_path / "f64.yaml").write_text("solver:\n  dtype: float64\n")

    ref_store = MapStore()
    load_yaml(ref_store, str(tmp_path / "m.yaml"))
    ref = solve(ref_store, ArSlamConfig(solver=SolverConfig(dtype="float64")),
                device="cpu")

    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ar_slam_tpu_torch.cli", "map", "m.yaml",
         "-o", "out.yaml", "--device", "cpu", "--config", "f64.yaml",
         "--multihost", f"127.0.0.1:{port},2,{rank}"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            p.kill()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank}:\n{out}\n{err}"
        assert f"multihost: process {rank}/2, 2 shards on cpu" in err
    costs = [float(re.search(r"solve done: cost=(\S+)", err).group(1))
             for _, err in outs]
    assert costs[0] == costs[1]
    assert abs(costs[0] - ref["cost"]) <= 1e-10 * ref["cost"]
    # process 0 publishes the map; the other writes to its scratch dir
    assert "solved 6 captures" in outs[0][0] and not outs[1][0]
    got = MapStore()
    load_yaml(got, str(tmp_path / "out.yaml"))
    assert {t.id for t in got.arucos} == {t.id for t in ref_store.arucos}
