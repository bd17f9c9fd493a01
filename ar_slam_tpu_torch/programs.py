"""Compiled programs on the card: CUDA graphs of a loop's stages, with
their capture, cache and replay.

The port's counterpart of ``jax.jit``'s compile cache.  PyTorch runs
eagerly, so a program of the JAX package (the detector, an LM iteration,
a wave's seeds) is hundreds of small launches from Python; here it is one
replay of a graph a stage, with the eager stages' results bit for bit
(the same kernels on the same values, in the same order).  The solver's
stages are in solve/graphs.py and parallel/dist_lm.py, the detector's in
detect/detect.py; this module imports none of them.

A ``Program`` holds a program's stage functions and one dict of the
tensors they read and write.  Graphed, the stages are captured once, in
their order, into one memory pool, after two warm-up rounds on the
capture stream and into the program's pool (cuBLAS and cuSOLVER set up
their workspaces outside the capture, which reuses the warm-ups' memory);
a replay then writes the same tensors in place, and the
caller's inputs are copied into the program's own before each call.
Eagerly (the CPU's mode, and ``graphs=False``) each stage's outputs
replace the dict's entries.

The cache (``CACHE``) holds the captured programs, as ``jax.jit`` caches
its compiles:

- the solver's kinds (``"seed"``, ``"lm"``, ``"localize"``,
  ``"mesh_seed"``, ``"mesh_lm"``) keep one program per (kind, card): a
  call with another static signature replaces the kind's program, whose
  graphs and tensors are freed into the kind's memory pool, which the new
  capture reuses, so a map that grows through its buckets holds one pool
  of about its largest signature's size;
- the kinds of ``KEEP`` (``"detect"``) keep one program per signature
  and card, up to the kind's bound, the least recently used dropped
  first, each program with its own pool and capture stream: a serve loop
  that alternates between two batch shapes replays two programs.

Each stage is recorded with ``capture_begin`` / ``capture_end`` on the
program's capture stream, in ``capture_error_mode="thread_local"``, after
that stream has waited for the current one (which waits for it after the
recording): no ``torch.cuda.synchronize`` and no ``empty_cache``, which
the ``torch.cuda.graph`` context manager would make, so another thread
(``serve``'s detect thread, or the caller's solve beside it) keeps its
queued kernels and cached blocks meanwhile.  The cache's lock guards its
programs, pools and counts; a program's own lock (``Program.lock``)
serialises the calls of threads that share it.  A capture or replay
error raises; there is no eager fallback on the card.  A stage that
reads the host inside its capture raises its own error, and its
program's key gets new pools (``GraphCache.discard``).

A mesh's program (``Program(..., mesh=)``) records one graph a stage
over all the mesh's cards, as ``jax.jit`` of a ``shard_map`` compiles
one executable: each shard's work on a branch stream of its own
(``Branches``, through ``parallel.Mesh.map``), every other card on a
stream forked from the capture stream, the copies between cards inside
the graph, and a memory pool on each card.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

WARMUP_ROUNDS = 2
# kinds that keep one program per signature, and how many per card
KEEP = {"detect": 4}


class GraphCache:
    """The captured programs, one per (kind, device) or, for the kinds of
    ``KEEP``, one per (kind, device, signature); with counts: captures,
    replays, and per capture the host milliseconds of each warm-up
    round's stages and of the graphs' recording."""

    def __init__(self):
        self._lock = threading.RLock()
        self._programs: dict = {}  # key -> program, least recent first
        self._pools: dict = {}  # key -> card -> (MemPool, stream)
        self._streams: dict = {}  # key -> (card, slot) -> branch stream
        self._retired: dict = {}  # key -> dropped graphs
        self.kinds: dict = {}  # kind -> {"captures": n, "replays": n}
        self.capture_ms: list = []  # per capture: program, warmup, record

    @property
    def captures(self) -> int:
        return sum(c["captures"] for c in self.kinds.values())

    @property
    def replays(self) -> int:
        return sum(c["replays"] for c in self.kinds.values())

    def get(self, kind: str, device, signature, make) -> "Program":
        """The kind's program on ``device`` for ``signature``, made by
        ``make()`` where the cache holds none: another signature's program
        is dropped first (into the kind's pool), or for a kind of ``KEEP``
        the least recently used one beyond the kind's bound."""
        with self._lock:
            if kind in KEEP:
                return self._get_kept(kind, str(device), signature, make)
            key = (kind, str(device))
            prog = self._programs.get(key)
            if prog is None or prog.signature != signature:
                self._programs.pop(key, None)
                if prog is not None and prog.graphs:
                    # the dropped graphs live on (their tensors are freed)
                    # until the next capture into the pool has ended: the
                    # host allocator asserts when a capture begins on a pool
                    # that no graph holds any more (torch.cuda.graph empties
                    # the host cache before each capture, which this module
                    # does not)
                    self._retired[key] = prog.graphs
                del prog
                prog = self._programs[key] = make()
                prog.key, prog.signature = key, signature
            return prog

    def _get_kept(self, kind, device, signature, make) -> "Program":
        key = (kind, device, signature)
        prog = self._programs.pop(key, None)
        if prog is None:
            held = [k for k in self._programs if k[:2] == key[:2]]
            for old in held[:max(len(held) + 1 - KEEP[kind], 0)]:
                del self._programs[old]  # its graphs, then its pools
                self._pools.pop(old, None)
                self._streams.pop(old, None)
            prog = make()
            prog.key, prog.signature = key, signature
        self._programs[key] = prog  # the most recently used last
        return prog

    def pool(self, key, device) -> tuple:
        """The (memory pool, stream) of a program's key on ``device``: on
        its card the capture stream, on another card of its mesh the
        stream that card's work runs on between its branches."""
        device = torch.device(device)
        with self._lock:
            pools = self._pools.setdefault(key, {})
            if str(device) not in pools:
                with torch.cuda.device(device):
                    pools[str(device)] = (torch.cuda.MemPool(),
                                          torch.cuda.Stream(device))
            return pools[str(device)]

    def discard(self, key) -> None:
        """Forget a program key's pools after a failed capture: its next
        capture makes new ones."""
        with self._lock:
            self._pools.pop(key, None)
            self._retired.pop(key, None)

    def branch_streams(self, key, plan) -> list:
        """One stream a shard (``branch_plan``'s (card, slot) pairs),
        held with the key's pools and reused by its later captures."""
        with self._lock:
            held = self._streams.setdefault(key, {})
            out = []
            for device, slot in plan:
                name = (str(device), slot)
                if name not in held:
                    held[name] = torch.cuda.Stream(device)
                out.append(held[name])
            return out

    def _count(self, kind: str, what: str) -> None:
        with self._lock:
            self.kinds.setdefault(kind, {"captures": 0, "replays": 0})[
                what] += 1

    def stats(self) -> dict:
        """The counts (also by kind), the programs held (each program's
        label, its pools' reserved bytes in all and per card) and the
        pools' reserved bytes (the allocator's segments of those
        pools)."""
        with self._lock:
            ids = {tuple(p.id): (key, card)
                   for key, pools in self._pools.items()
                   for card, (p, _) in pools.items()}
            per_pool = dict.fromkeys(ids.values(), 0)
            if ids:
                for s in torch.cuda.memory_snapshot():
                    where = ids.get(tuple(s.get("segment_pool_id", ())))
                    if where is not None:
                        per_pool[where] += s["total_size"]
            held = []
            for key, p in self._programs.items():
                cards = {card: n for (k, card), n in per_pool.items()
                         if k == key}
                held.append({"program": p.label or key[0], "device": key[1],
                             "pool_bytes": sum(cards.values()) if cards
                             else None, "pool_bytes_per_card": cards})
            return {"captures": self.captures, "replays": self.replays,
                    "kinds": {k: dict(c) for k, c in self.kinds.items()},
                    "capture_ms": sum(
                        sum(sum(r.values()) for r in c["warmup"])
                        + c["record"] for c in self.capture_ms),
                    "capture_split_ms": [dict(c) for c in self.capture_ms],
                    "programs": len(self._programs), "held": held,
                    "pool_bytes": sum(per_pool.values())}

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()
            self._retired.clear()
            self._pools.clear()
            self._streams.clear()
            self.kinds = {}
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


def _clone(x, device=None):
    """A copy of ``x`` (as ``_copy_into`` takes it) in memory of its own,
    on ``device`` (default: where each tensor is); the items of a list (a
    mesh's ``Sharded`` shards) each stay on their own device."""
    if isinstance(x, torch.Tensor):
        if device is None:
            return x.clone(memory_format=torch.contiguous_format)
        return x.to(device, memory_format=torch.contiguous_format, copy=True)
    if isinstance(x, list):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v, device) for v in x))
    if isinstance(x, tuple):
        return type(x)(_clone(v, device) for v in x)
    return x


def _write(t: dict, out: dict) -> None:
    """Store stage outputs: in place into tensors ``t`` already holds (a
    replayed graph writes the same memory), else as new entries."""
    for k, v in out.items():
        if t.get(k) is None:
            t[k] = v
        else:
            _copy_into(t[k], v)


def _abandon(device: torch.device, pool) -> None:
    """Undo what a capture whose ``capture_end`` raised (a stage that read
    the host invalidated it) leaves in the card's allocator: its routing
    of allocations into the pool and the pool's reference that
    ``capture_begin`` took (a graph whose capture never ended gives
    neither back).  The host allocator's routing, which no binding can
    end, stays: the pool is not captured into again
    (``GraphCache.discard``)."""
    torch._C._cuda_endAllocateToPool(device.index, pool.id)
    torch._C._cuda_releasePool(device.index, pool.id)


def branch_plan(devices) -> list:
    """Each shard's (card, stream slot), in shard order (the home shard
    first): a card's shards take its slots 0, 1, ... in their order.
    Needs no card."""
    taken: dict = {}
    plan = []
    for d in map(torch.device, devices):
        plan.append((d, taken.get(d, 0)))
        taken[d] = taken.get(d, 0) + 1
    return plan


class Branches:
    """The streams over which a mesh program's stages fork the work of
    its shards while it warms up and records: ``map`` runs shard i on its
    stream ``streams[i]`` (on its card), each forked from its card's
    current stream when the shards start and joined back to it when they
    end, so that one card's shards, and the cards, run side by side
    inside one graph."""

    def __init__(self, streams):
        self.streams = streams

    def map(self, fn, *cols) -> list:
        outer = {}
        for s in self.streams:
            outer.setdefault(s.device, torch.cuda.current_stream(s.device))
        for s in self.streams:
            s.wait_stream(outer[s.device])
        outs = []
        for s, args in zip(self.streams, zip(*cols)):
            with torch.cuda.stream(s):
                outs.append(fn(*args))
        for s in self.streams:
            outer[s.device].wait_stream(s)
        return outs


class Program:
    """A loop's stages over one dict of tensors ``t``, run eagerly or as
    CUDA graphs (``graphed``, held by ``CACHE``; see the module
    docstring).  An entry of ``t`` is a tensor or a (nested) tuple or
    list of them: the mesh's ``Sharded`` state is copied, selected and
    cloned shard by shard, each shard on its own card.

    ``counted`` names the counts the stages keep, as (object, attribute)
    pairs (a kernel wrapper's module and its launch count; the call's
    ``parallel.Mesh`` and its reductions): eagerly the stages count
    themselves; a captured stage records how much it added to each and
    each replay adds that (a capture's warm-up rounds and recording count
    nothing).  ``pointers`` names (object, attribute) pairs that a stage
    sets to a tensor it made (a kernel's last per-plane rounds): each
    replay sets them to the captured stage's tensors, which the replay
    has just written.

    ``mesh`` (a ``parallel.Mesh``) makes one graph a stage span the
    mesh's cards: while the stages warm up and record, ``mesh.branches``
    gives each shard a stream of its own (``Branches``), every other card
    of the mesh runs on a stream forked from the capture stream at each
    stage's start and joined to it at its end (so that the copies between
    cards find both cards' current streams inside the capture), and each
    card allocates from a memory pool of the program's own.  A replay
    launches on the home card's current stream, after the other cards'
    current streams (the inputs' copies), which then wait for it."""

    def __init__(self, stages: dict, graphed: bool, counted=(),
                 pointers=(), label: str = "", mesh=None):
        self.stages = stages  # in capture order
        self.graphed = graphed
        self.counted = tuple(counted)
        self.pointers = tuple(pointers)
        self.label = label
        self.mesh = mesh
        self.lock = threading.Lock()
        self.key = self.signature = None
        self.t: dict = {}
        self.graphs: dict = {}
        self.deltas: dict = {}  # per captured stage, one per counted
        self.pointed: dict = {}  # per captured stage: (obj, attr, tensor)

    def _cards(self) -> list:
        """The program's cards, its own first."""
        home = torch.device(self.key[1])
        cards = [home]
        for d in (self.mesh.devices if self.mesh is not None else ()):
            if d not in cards:
                cards.append(d)
        return cards

    def load(self, **inputs) -> None:
        """The call's inputs: copied into the program's own tensors when
        graphed (made at the first call, on the program's card or, a
        mesh's shards, each on its own, and captured then), taken as they
        are eagerly."""
        if not self.graphed:
            self.t.update(inputs)
            return
        for k, v in inputs.items():
            if k in self.t:
                _copy_into(self.t[k], v)
            else:
                self.t[k] = _clone(v, self.key[1])
        if not self.graphs:
            self._capture()

    def run(self, name: str) -> None:
        if not self.graphed:
            self.t.update(self.stages[name](self.t))
            return
        home, *others = self._cards()
        for d in others:
            torch.cuda.current_stream(home).wait_stream(
                torch.cuda.current_stream(d))
        self.graphs[name].replay()
        for d in others:
            torch.cuda.current_stream(d).wait_stream(
                torch.cuda.current_stream(home))
        with CACHE._lock:
            CACHE._count(self.key[0], "replays")
            for (obj, attr), d in zip(self.counted, self.deltas[name]):
                setattr(obj, attr, getattr(obj, attr) + d)
            for obj, attr, value in self.pointed[name]:
                setattr(obj, attr, value)

    def _counts(self) -> list:
        return [getattr(obj, attr) for obj, attr in self.counted]

    @contextlib.contextmanager
    def _streams(self, pools: dict):
        """The stages' streams: each other card's on it, the capture
        stream last (the current card then is the program's own), and the
        mesh's branches."""
        home, *others = self._cards()
        with contextlib.ExitStack() as stack:
            for d in others + [home]:
                stack.enter_context(torch.cuda.stream(pools[d][1]))
            if self.mesh is not None:
                self.mesh.branches = Branches(CACHE.branch_streams(
                    self.key, branch_plan(self.mesh.devices)))
            try:
                yield
            finally:
                if self.mesh is not None:
                    self.mesh.branches = None

    def _stage(self, fn, t: dict, pools: dict, store) -> None:
        """One stage's work: the other cards' streams forked from the
        capture stream before it and joined to it after its outputs are
        stored (``store(t, out)``)."""
        home, *others = self._cards()
        for d in others:
            pools[d][1].wait_stream(pools[home][1])
        store(t, fn(t))
        for d in others:
            pools[home][1].wait_stream(pools[d][1])

    def _capture(self) -> None:
        cards = self._cards()
        home = cards[0]
        counted = self._counts()
        pools = {d: CACHE.pool(self.key, d) for d in cards}
        pool, stream = pools[home]
        # the inputs were copied in on the cards' current streams; the
        # replays run there too, after the capture
        for d in cards:
            stream.wait_stream(torch.cuda.current_stream(d))
        warmup = []
        # the warm-up rounds allocate from the program's pools too, so the
        # capture reuses their freed blocks: a capture then needs no memory
        # beyond what the warm-ups took, outside the capture, where the
        # allocator may still free cached blocks to make room
        with self._streams(pools), contextlib.ExitStack() as routed:
            for d in cards:
                routed.enter_context(torch.cuda.use_mem_pool(pools[d][0], d))
            for _ in range(WARMUP_ROUNDS):
                scratch, ms = dict(self.t), {}
                for name, fn in self.stages.items():
                    t0 = time.perf_counter()
                    self._stage(fn, scratch, pools, dict.update)
                    ms[name] = (time.perf_counter() - t0) * 1e3
                warmup.append(ms)
                del scratch
        t0 = time.perf_counter()
        try:
            with self._streams(pools), contextlib.ExitStack() as routed:
                # the capture stream's card allocates from its pool through
                # capture_begin, the mesh's other cards from theirs
                for d in cards[1:]:
                    routed.enter_context(
                        torch.cuda.use_mem_pool(pools[d][0], d))
                for name, fn in self.stages.items():
                    self._record(name, fn, pools)
        except BaseException:
            self.graphs, self.deltas, self.pointed = {}, {}, {}
            raise
        finally:
            for (obj, attr), n in zip(self.counted, counted):
                setattr(obj, attr, n)
        record_ms = (time.perf_counter() - t0) * 1e3
        for d in cards:
            torch.cuda.current_stream(d).wait_stream(stream)
        with CACHE._lock:
            CACHE._retired.pop(self.key, None)
            CACHE._count(self.key[0], "captures")
            CACHE.capture_ms.append({"program": self.key[0],
                                     "label": self.label, "warmup": warmup,
                                     "record": record_ms})

    def _record(self, name: str, fn, pools: dict) -> None:
        """Capture one stage into its graph.  A stage that fails inside
        the capture (a host read) ends the capture and raises its own
        error."""
        g = torch.cuda.CUDAGraph()
        before = self._counts()
        pointed = [getattr(obj, attr) for obj, attr in self.pointers]
        g.capture_begin(pool=pools[torch.device(self.key[1])][0].id,
                        capture_error_mode="thread_local")
        try:
            self._stage(fn, self.t, pools, _write)
        except BaseException:
            try:
                g.capture_end()
            except RuntimeError:
                _abandon(torch.device(self.key[1]),
                         pools[torch.device(self.key[1])][0])
                CACHE.discard(self.key)
            raise
        g.capture_end()
        self.graphs[name] = g
        self.deltas[name] = [a - b for a, b in zip(self._counts(), before)]
        self.pointed[name] = [
            (obj, attr, getattr(obj, attr))
            for (obj, attr), old in zip(self.pointers, pointed)
            if getattr(obj, attr) is not old]

    def out(self, x):
        """A result that outlives the next replay: a copy when graphed."""
        return _clone(x) if self.graphed else x
