"""CUDA graphs of the solver's programs: capture, cache and replay.

The port's counterpart of the JAX package's compiled solve programs: the
wave program ``solve_wave_multi`` (ar_slam_tpu/solve/batch.py:157), its
seed ``lax.scan`` and its LM ``lax.while_loop`` with the ``lax.cond``
relinearization (ar_slam_tpu/solve/lm.py:378, :424), and
``localize_kernel`` (ar_slam_tpu/solve/localize.py:32) with its seeding
and ``while_loop``.  PyTorch runs eagerly, so an LM iteration was some
980 small launches from Python; here it is at most two graph replays and
one host read, with the results of the eager loop bit for bit (the same
kernels on the same values, in the same order).

A ``Program`` holds a program's stage functions and one dict of the
tensors they read and write.  Graphed, the stages are captured once, in
their order, into one memory pool, after two warm-up rounds on the
capture stream (cuBLAS and cuSOLVER set up their workspaces outside the
capture); a replay then writes the same tensors in place, and the
caller's inputs are copied into the program's own before each call.
Eagerly (the CPU tests' mode) each stage's outputs replace the dict's
entries.

- seeds (``seed_waves_graphed``): one stage ``seed``, a flush's padded
  seed tables (solve/batch.py ``seed_waves``) applied in one replay.
- LM (``lm_solve_graphed``): stages ``setup`` (the regroup of the block
  table, the first linearization, the gradient test, the initial state),
  ``step`` (the damped solve, the proposal, its quality and the tests),
  ``accept`` (relinearize at an accepted proposal, the gradient test, the
  state update) and ``reject`` (the state update of any other step).
  The host loop (``lm_iterate``) reads the converged flag once after
  ``setup``; an iteration replays ``step``, reads its three flags
  (converged before the step, accept stage next, converged after it) in
  one copy to the host, and replays ``accept`` or ``reject``: the eager
  loop's lazy relinearization.  A step run after a convergence that only
  the gradient test shows is dropped, which leaves the state as the
  eager loop leaves it.
- localize (``localize_graphed``): stages ``init`` (each query's seed
  pose, cost and damping) and ``iterate``; a call replays ``init`` and
  then ``iterate`` once an iteration, each replay followed by one flag
  read (any query active).

- the mesh (parallel/dist_lm.py, on shards of one card): the kinds
  ``"mesh_lm"`` (the tag-sharded LM's stages, with the fused quality,
  through ``lm_iterate``) and ``"mesh_seed"``; a program counts the packed reductions its
  replays run on the mesh (``Program.counter``).

The cache (``CACHE``) holds one captured program per kind (``"seed"``,
``"lm"``, ``"localize"``, ``"mesh_seed"``, ``"mesh_lm"``) and device, as
``jax.jit`` caches its compiles: a solve's waves, its warmups and its
polish share one LM capture, and ``serve``'s per-batch solves reuse it
while their bucketed shapes repeat.  A call with another static signature (dtype, padded
shapes, slot bounds, ``LMConfig``, tag size, seed mode) replaces the
kind's program: the old graphs and tensors are freed into the kind's
memory pool, which the new capture reuses, so a map that grows through
its buckets holds one pool of about its largest signature's size, not
one per bucket.  Each stage is recorded with ``capture_begin`` /
``capture_end`` on the kind's own stream, in
``capture_error_mode="thread_local"``, after that stream has waited for
the current one (which waits for it after the recording): no
``torch.cuda.synchronize`` and no ``empty_cache``, which the
``torch.cuda.graph`` context manager would make, so the detect thread of
``serve`` keeps its queued kernels and cached blocks meanwhile.  One
thread solves at a time.  A capture or replay error raises; there is no
eager fallback on the card.
"""

from __future__ import annotations

import time

import torch

from ar_slam_tpu_torch.solve.lm import (LMConfig, LMState, _grad_inf_norm,
                                        grouped_solver, lm_accept, lm_init,
                                        lm_reject, lm_step)
from ar_slam_tpu_torch.solve.batch import seed_waves
from ar_slam_tpu_torch.solve.localize import localize_init, localize_iteration

WARMUP_ROUNDS = 2


class GraphCache:
    """The captured programs, one per (kind, device), with counts:
    captures, replays, and per capture the host milliseconds of each
    warm-up round's stages and of the graphs' recording."""

    def __init__(self):
        self._programs: dict = {}
        self._pools: dict = {}  # (kind, device) -> (MemPool, capture stream)
        self._retired: dict = {}  # (kind, device) -> dropped graphs
        self.captures = 0
        self.replays = 0
        self.capture_ms: list = []  # per capture: program, warmup, record

    def get(self, kind: str, device, signature, make) -> "Program":
        """The kind's program on ``device`` for ``signature``; another
        signature's program is dropped first, into the kind's pool."""
        key = (kind, str(device))
        prog = self._programs.get(key)
        if prog is None or prog.signature != signature:
            self._programs.pop(key, None)
            if prog is not None and prog.graphs:
                # the dropped graphs live on (their tensors are freed) until
                # the next capture into the pool has ended: the host
                # allocator asserts when a capture begins on a pool that no
                # graph holds any more (torch.cuda.graph empties the host
                # cache before each capture, which this module does not)
                self._retired[key] = prog.graphs
            del prog
            prog = self._programs[key] = make()
            prog.key, prog.signature = key, signature
        return prog

    def pool(self, key, device) -> tuple:
        """The (memory pool, capture stream) of a (kind, device)."""
        if key not in self._pools:
            with torch.cuda.device(device):
                self._pools[key] = (torch.cuda.MemPool(),
                                    torch.cuda.Stream(device))
        return self._pools[key]

    def stats(self) -> dict:
        """The counts, the programs held and their pools' reserved bytes
        (the allocator's segments of those pools)."""
        ids = {tuple(p.id) for p, _ in self._pools.values()}
        pool_bytes = sum(
            s["total_size"] for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", ())) in ids) if ids else 0
        return {"captures": self.captures, "replays": self.replays,
                "capture_ms": sum(sum(sum(r.values()) for r in c["warmup"])
                                  + c["record"] for c in self.capture_ms),
                "capture_split_ms": [dict(c) for c in self.capture_ms],
                "programs": len(self._programs), "pool_bytes": pool_bytes}

    def clear(self) -> None:
        self._programs.clear()
        self._retired.clear()
        self._pools.clear()
        self.captures = self.replays = 0
        self.capture_ms = []


CACHE = GraphCache()


def _copy_into(dst, src) -> None:
    """Copy ``src`` into the tensors of ``dst``, a tensor or a tuple or
    list of them (nested: NamedTuples, ``Sharded`` shards), leaf by leaf;
    None leaves stay."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


def _clone(x):
    """A copy of ``x`` (as ``_copy_into`` takes it) in memory of its
    own."""
    if isinstance(x, torch.Tensor):
        return x.clone(memory_format=torch.contiguous_format)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_clone, x))
    if isinstance(x, (tuple, list)):
        return type(x)(map(_clone, x))
    return x


def _write(t: dict, out: dict) -> None:
    """Store stage outputs: in place into tensors ``t`` already holds (a
    replayed graph writes the same memory), else as new entries."""
    for k, v in out.items():
        if t.get(k) is None:
            t[k] = v
        else:
            _copy_into(t[k], v)


class Program:
    """A loop's stages over one dict of tensors ``t``, run eagerly or as
    CUDA graphs (``graphed``, held by ``CACHE``; see the module
    docstring).  An entry of ``t`` is a tensor or a (nested) tuple or
    list of them: the mesh's ``Sharded`` state is copied, selected and
    cloned shard by shard.  ``counter``, which the caller of a graphed
    program sets to the call's ``parallel.Mesh``, counts the packed
    reductions the stages run: eagerly they count themselves; a captured
    stage records how many it holds and each replay adds that many (a
    capture's warm-up rounds and recording count none)."""

    def __init__(self, stages: dict, graphed: bool):
        self.stages = stages  # in capture order
        self.graphed = graphed
        self.counter = None
        self.key = self.signature = None
        self.t: dict = {}
        self.graphs: dict = {}
        self.reductions: dict = {}  # per captured stage

    def load(self, **inputs) -> None:
        """The call's inputs: copied into the program's own tensors when
        graphed (captured at the first call), taken as they are eagerly."""
        if not self.graphed:
            self.t.update(inputs)
            return
        for k, v in inputs.items():
            if k in self.t:
                _copy_into(self.t[k], v)
            else:
                self.t[k] = _clone(v)
        if not self.graphs:
            self._capture()

    def run(self, name: str) -> None:
        if self.graphed:
            self.graphs[name].replay()
            CACHE.replays += 1
            if self.counter is not None:
                self.counter.reductions += self.reductions[name]
        else:
            self.t.update(self.stages[name](self.t))

    def _capture(self) -> None:
        dev = torch.device(self.key[1])
        counter = self.counter
        counted = counter.reductions if counter is not None else 0
        pool, stream = CACHE.pool(self.key, dev)
        # the inputs were copied in on the current stream; the replays run
        # there too, after the capture
        stream.wait_stream(torch.cuda.current_stream(dev))
        warmup = []
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_ROUNDS):
                scratch, ms = dict(self.t), {}
                for name, fn in self.stages.items():
                    t0 = time.perf_counter()
                    scratch.update(fn(scratch))
                    ms[name] = (time.perf_counter() - t0) * 1e3
                warmup.append(ms)
                del scratch
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            for name, fn in self.stages.items():
                g = torch.cuda.CUDAGraph()
                before = counter.reductions if counter is not None else 0
                g.capture_begin(pool=pool.id,
                                capture_error_mode="thread_local")
                try:
                    _write(self.t, fn(self.t))
                finally:
                    g.capture_end()
                self.graphs[name] = g
                if counter is not None:
                    self.reductions[name] = counter.reductions - before
        if counter is not None:
            counter.reductions = counted
        torch.cuda.current_stream(dev).wait_stream(stream)
        CACHE._retired.pop(self.key, None)
        CACHE.captures += 1
        CACHE.capture_ms.append({"program": self.key[0], "warmup": warmup,
                                 "record": (time.perf_counter() - t0) * 1e3})

    def out(self, x):
        """A result that outlives the next replay: a copy when graphed."""
        return _clone(x) if self.graphed else x


_STATE = ("camera", "cap_poses", "tag_poses", "lam", "nu", "cost",
          "converged", "term")


def state_of(t: dict) -> LMState:
    """The LM state a program's tensors hold."""
    return LMState(**{k: t[k] for k in _STATE}, iteration=0)


def fields(state: LMState) -> dict:
    """An LM state as a program's entries."""
    return {k: getattr(state, k) for k in _STATE}


def lm_info(prog: "Program", iteration: int) -> dict:
    """``lm_core``'s info dict from an LM program's tensors (copies when
    graphed)."""
    t = prog.t
    return {"cost": prog.out(t["cost"]), "iterations": iteration,
            "lambda": prog.out(t["lam"]),
            "converged": prog.out(t["converged"]),
            "initial_cost": prog.out(t["cost0"]),
            "termination": prog.out(t["term"]), "nu": prog.out(t["nu"]),
            "grad_max": _grad_inf_norm(t["eqs"], t["cam_active"],
                                       t["cap_active"], t["tag_active"])}


def lm_iterate(prog: Program, config: LMConfig, iter_budget=None) -> int:
    """The host's loop over an LM program's stages once ``setup`` has run:
    one read of the converged flag, then per iteration a ``step``, one
    read of its flags (``lm.LMStep``) and an ``accept`` or ``reject``, to
    the budget or convergence.  Every process of a mesh reads the same
    flags, so all replay the same stages.  Returns the iterations run."""
    t = prog.t
    budget = min(config.max_iterations if iter_budget is None
                 else int(iter_budget), config.max_iterations)
    iteration = 0
    if bool(t["converged"]):
        return iteration
    while iteration < budget:
        prog.run("step")
        before, accepting, after = t["step"].flags.tolist()
        if before:
            break
        prog.run("accept" if accepting else "reject")
        iteration += 1
        if after:
            break
    return iteration


def _lm_stages(aruco_size: float, config: LMConfig, n_caps: int, n_tags: int,
               bounds: dict) -> dict:
    """The LM loop's stages over the tensors ``setup`` makes from the
    inputs; the hooks built by ``setup`` (its regroup tables) serve the
    later stages."""
    hooks = {}

    def setup(t):
        lin_fn, quality_fn, solve_fn, sol = grouped_solver(
            t["cap_idx"], t["tag_idx"], t["corners"], t["block_mask"],
            t["cam_active"], t["cap_active"], t["tag_active"],
            aruco_size=aruco_size, config=config, n_caps=n_caps,
            n_tags=n_tags, **bounds)
        hooks.update(lin=lin_fn, quality=quality_fn, solve=solve_fn)
        state, eqs = lm_init(t["in_camera"], t["in_cap_poses"],
                             t["in_tag_poses"], t["cam_active"],
                             t["cap_active"], t["tag_active"], lin_fn, config)
        # cost0 apart from the cost that the iterations overwrite in place
        return {**fields(state), "cost0": state.cost.clone(), "eqs": eqs,
                "sol": sol}

    def step(t):
        return {"step": lm_step(state_of(t), t["eqs"], t["sol"],
                                hooks["solve"], hooks["quality"], config)}

    def accept(t):
        state, eqs, sol = lm_accept(state_of(t), t["step"], hooks["lin"],
                                    t["cam_active"], t["cap_active"],
                                    t["tag_active"], config)
        return {**fields(state), "eqs": eqs, "sol": sol}

    def reject(t):
        state, sol = lm_reject(state_of(t), t["step"])
        return {**fields(state), "sol": sol}

    return {"setup": setup, "step": step, "accept": accept, "reject": reject}


def lm_solve_graphed(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
                     block_mask, cam_active, cap_active, tag_active, *,
                     aruco_size: float, config: LMConfig, obs_per_tag: int,
                     obs_per_cap: int, row_slots=None, tag_rows=None,
                     cap_rows=None, enabled=True, iter_budget=None, lam0=None,
                     nu0=None, graphed: bool = True):
    """``lm_solve``'s grouped LM through the split stages: replayed CUDA
    graphs (``graphed``, a CUDA device), or the same stages run eagerly.
    Bounds as ``lm.grouped_bounds`` gives them.  Returns (camera,
    cap_poses, tag_poses, info) as ``lm_core`` does, bit for bit."""
    dev = cap_poses.device
    if graphed and dev.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")
    n_caps, n_tags = cap_poses.shape[0], tag_poses.shape[0]
    bounds = dict(obs_per_tag=obs_per_tag, obs_per_cap=obs_per_cap,
                  row_slots=row_slots, tag_rows=tag_rows, cap_rows=cap_rows)
    if not isinstance(cam_active, torch.Tensor):
        cam_active = torch.full((), bool(cam_active), dtype=torch.bool,
                                device=dev)

    def make():
        return Program(_lm_stages(aruco_size, config, n_caps, n_tags, bounds),
                       graphed)

    if graphed:
        prog = CACHE.get("lm", dev, (cap_poses.dtype, n_caps, n_tags,
                                     cap_idx.shape[0], tuple(bounds.items()),
                                     config, float(aruco_size)), make)
    else:
        prog = make()
    prog.load(in_camera=camera, in_cap_poses=cap_poses,
              in_tag_poses=tag_poses, cap_idx=cap_idx, tag_idx=tag_idx,
              corners=corners, block_mask=block_mask, cam_active=cam_active,
              cap_active=cap_active, tag_active=tag_active)
    t = prog.t
    prog.run("setup")
    if lam0 is not None:
        t["lam"].fill_(lam0)
    if nu0 is not None:
        t["nu"].fill_(nu0)
    if not enabled:
        t["converged"].fill_(True)
        t["term"].fill_(5)
    iteration = lm_iterate(prog, config, iter_budget)
    return (prog.out(t["camera"]), prog.out(t["cap_poses"]),
            prog.out(t["tag_poses"]), lm_info(prog, iteration))


def seed_waves_graphed(camera, cap_poses, tag_poses, tag_idx, corners,
                       tables, *, aruco_size: float, seed_mode: str,
                       graphed: bool = True):
    """``batch.seed_waves`` as the ``seed`` stage of a program: a replayed
    CUDA graph (``graphed``, a CUDA device) or the stage run eagerly.
    Returns new (cap_poses, tag_poses), bit for bit ``seed_waves``'s."""
    dev = cap_poses.device
    if graphed and dev.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")

    def seed(t):
        cap, tag = seed_waves(t["camera"], t["in_cap_poses"],
                              t["in_tag_poses"], t["tag_idx"], t["corners"],
                              t["tables"], aruco_size=aruco_size,
                              seed_mode=seed_mode)
        return {"cap_poses": cap, "tag_poses": tag}

    def make():
        return Program({"seed": seed}, graphed)

    if graphed:
        prog = CACHE.get("seed", dev, (
            cap_poses.dtype, cap_poses.shape[0], tag_poses.shape[0],
            corners.shape[0], *tables.shape, float(aruco_size), seed_mode),
            make)
    else:
        prog = make()
    prog.load(camera=camera, in_cap_poses=cap_poses, in_tag_poses=tag_poses,
              tag_idx=tag_idx, corners=corners, tables=tables)
    prog.run("seed")
    return prog.out(prog.t["cap_poses"]), prog.out(prog.t["tag_poses"])


_LOC_STATE = ("pose", "lam", "nu", "cost", "it", "conv")


def localize_graphed(camera, tag_poses, q_tag_idx, q_corners, q_block_mask,
                     q_seed_slot, *, aruco_size: float, config: LMConfig,
                     seed_mode: str = "hybrid", graphed: bool = True):
    """``localize_batch`` as the stages ``init`` (the seeds) and
    ``iterate`` (one iteration): replayed CUDA graphs (``graphed``, a
    CUDA device) or the same stages run eagerly.  Returns (poses, costs,
    iterations), bit for bit ``localize_batch``'s."""
    dev = camera.device
    if graphed and dev.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")

    def init(t):
        s = localize_init(t["camera"], t["tag_poses"], t["q_tag_idx"],
                          t["q_corners"], t["q_block_mask"], t["q_seed_slot"],
                          aruco_size=aruco_size, config=config,
                          seed_mode=seed_mode)
        return {**s, "any_active": (~s["conv"]).any()}

    def iterate(t):
        new = localize_iteration(
            t["camera"], t["q_corners"], t["tps"], t["maskf"],
            *(t[k] for k in _LOC_STATE), aruco_size=aruco_size,
            config=config)
        return {**new, "any_active": (~new["conv"]).any()}

    def make():
        return Program({"init": init, "iterate": iterate}, graphed)

    if graphed:
        prog = CACHE.get("localize", dev, (
            camera.dtype, tuple(q_tag_idx.shape), tag_poses.shape[0], config,
            float(aruco_size), seed_mode), make)
    else:
        prog = make()
    prog.load(camera=camera, tag_poses=tag_poses, q_tag_idx=q_tag_idx,
              q_corners=q_corners, q_block_mask=q_block_mask,
              q_seed_slot=q_seed_slot)
    t = prog.t
    prog.run("init")
    active = bool(t["any_active"])
    for _ in range(config.max_iterations):
        if not active:
            break
        prog.run("iterate")
        active = bool(t["any_active"])
    return prog.out(t["pose"]), prog.out(t["cost"]), prog.out(t["it"])
