"""The mesh's programs across cards, as far as the CPU can hold them.

On the card one graph a stage spans the mesh's cards: ``programs.Program``
with a ``mesh`` runs each shard's work on a branch stream of its own
(``programs.Branches``, through ``Mesh.map``), moves replicated values to
the shards' cards outside that work (``Mesh.put``) and keeps each shard
of a ``Sharded`` input on its own card.  Here, without a card: the load
keeps a shard on its device; the branch plan gives each shard its card
and stream slot; and the mesh's stages, with the shards' work run in
another order than shard order (as branches running side by side may
finish it), still give the plain loop's (``_lm_sharded``) results and
the seeds bit for bit, with the same reductions.
"""

import pytest
import torch

from ar_slam_tpu_torch import programs
from ar_slam_tpu_torch.parallel import block_mesh, dist_lm
from ar_slam_tpu_torch.parallel.mesh import Mesh, Sharded
from ar_slam_tpu_torch.solve.lm import LMConfig
from test_torch_lm_graph import CASES
from test_torch_mesh_graph import _equal, _placed, _seed_case
from torch_cases import synthetic_arrays

torch.set_num_threads(1)
SIZE = 0.0635


@pytest.fixture(scope="module")
def arrs():
    return synthetic_arrays(seed=3, n_tags=20, n_caps=10, perturb=0.01)


def test_load_keeps_each_shard_on_its_device():
    """A graphed program's load clones each shard of a ``Sharded`` input
    on that shard's own device (here one ``cpu`` and one ``meta``
    tensor), and a plain tensor on the program's card; later loads copy
    into the same tensors."""
    prog = programs.Program({}, graphed=True)
    prog.key = ("mesh_lm", "meta")
    prog.graphs = {"recorded": None}  # no capture without a card
    shards = Sharded([torch.arange(4.0), torch.empty(3, device="meta")])
    plain = torch.ones(2)
    prog.load(tags=shards, camera=plain)
    got = prog.t["tags"]
    assert isinstance(got, Sharded)
    assert [t.device.type for t in got] == ["cpu", "meta"]
    assert got[0] is not shards[0] and torch.equal(got[0], shards[0])
    assert prog.t["camera"].device.type == "meta"
    first = got[0]
    prog.load(tags=Sharded([torch.full((4,), 2.0), shards[1]]))
    assert prog.t["tags"][0] is first and torch.equal(first,
                                                      torch.full((4,), 2.0))


@pytest.mark.parametrize("devices,plan", [
    (["cuda:0"] * 3, [("cuda:0", 0), ("cuda:0", 1), ("cuda:0", 2)]),
    (["cuda:0", "cuda:1"], [("cuda:0", 0), ("cuda:1", 0)]),
    (["cuda:0", "cuda:1", "cuda:0", "cuda:1"],
     [("cuda:0", 0), ("cuda:1", 0), ("cuda:0", 1), ("cuda:1", 1)])])
def test_branch_plan(devices, plan):
    """Each shard's card and stream slot, home shard first, built without
    a card; a mesh of those cards plans the same."""
    want = [(torch.device(d), slot) for d, slot in plan]
    assert programs.branch_plan(devices) == want
    assert programs.branch_plan(Mesh(devices).devices) == want


class Reversed:
    """Stands in for the branch streams: runs the shards' work last shard
    first and returns it in shard order."""

    def __init__(self):
        self.calls = 0

    def map(self, fn, *cols):
        self.calls += 1
        rows = list(zip(*cols))
        out = [fn(*args) for args in reversed(rows)]
        return out[::-1]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("case", ["function", "stall", "warmup_masks",
                                  "budget_1"])
def test_mesh_stages_in_any_shard_order(arrs, case, solver, k):
    """The mesh's stages with every shard loop run in reverse (the hooks'
    ``Mesh.map``, as branch streams may run it) give ``_lm_sharded``'s
    results bit for bit, with the same reductions."""
    config = LMConfig(linear_solver=solver, **CASES[case][0])
    prob, args, kw = _placed(arrs, k, case)
    ref = dist_lm._lm_sharded(prob, SIZE, config, *args, **kw)
    plain = prob.mesh.reductions
    prob.mesh.branches = branches = Reversed()
    try:
        got = dist_lm.lm_solve_sharded(prob, SIZE, config, *args,
                                       graphs=False, **kw)
    finally:
        prob.mesh.branches = None
    _equal(got, ref)
    assert prob.mesh.reductions == 2 * plain and branches.calls > 0


@pytest.mark.parametrize("k", [2, 3])
def test_mesh_seeds_in_any_shard_order(k):
    """The ``seed`` stage with its shard loops reversed: the same seeds bit
    for bit and one reduction a wave."""
    a, waves, slots, prob, solver = _seed_case(k)
    camera, caps = prob.put_rep(a.camera, a.cap_poses)
    tags = prob.put_tags(a.tag_poses)
    ref = solver.seed_waves(camera, caps, tags, waves, slots=slots)
    before = prob.mesh.reductions
    prob.mesh.branches = Reversed()
    try:
        got = solver.seed_waves(camera, caps, tags, waves, slots=slots)
    finally:
        prob.mesh.branches = None
    assert torch.equal(got[0], ref[0])
    assert all(torch.equal(g, r) for g, r in zip(got[1], ref[1]))
    assert prob.mesh.reductions - before == 4


def test_mesh_put_copies_once_a_card():
    """``Mesh.put`` gives each shard the value on its device, one copy a
    device (the value itself on its own), and passes numbers through;
    ``Mesh.map`` calls over the shards' columns in shard order."""
    mesh = block_mesh(devices=["cpu", "meta", "cpu", "meta"])
    x = torch.arange(3.0)
    out = mesh.put(x)
    assert out[0] is x and out[2] is x
    assert out[1] is out[3] and out[1].device.type == "meta"
    assert mesh.put(0.5) == [0.5] * 4
    assert mesh.map(lambda a, b: a + b, [1, 2, 3, 4], [10] * 4) == [
        11, 12, 13, 14]
