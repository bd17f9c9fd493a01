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
error raises; there is no eager fallback on the card.
"""

from __future__ import annotations

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
        self._pools: dict = {}  # key -> (MemPool, capture stream)
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
                del self._programs[old]  # its graphs, then its pool
                self._pools.pop(old, None)
            prog = make()
            prog.key, prog.signature = key, signature
        self._programs[key] = prog  # the most recently used last
        return prog

    def pool(self, key, device) -> tuple:
        """The (memory pool, capture stream) of a program's key."""
        with self._lock:
            if key not in self._pools:
                with torch.cuda.device(device):
                    self._pools[key] = (torch.cuda.MemPool(),
                                        torch.cuda.Stream(device))
            return self._pools[key]

    def _count(self, kind: str, what: str) -> None:
        with self._lock:
            self.kinds.setdefault(kind, {"captures": 0, "replays": 0})[
                what] += 1

    def stats(self) -> dict:
        """The counts (also by kind), the programs held (each program's label and its
        pool's reserved bytes, where it has its own) and the pools'
        reserved bytes (the allocator's segments of those pools)."""
        with self._lock:
            ids = {tuple(p.id): key for key, (p, _) in self._pools.items()}
            per_pool = dict.fromkeys(ids.values(), 0)
            if ids:
                for s in torch.cuda.memory_snapshot():
                    key = ids.get(tuple(s.get("segment_pool_id", ())))
                    if key is not None:
                        per_pool[key] += s["total_size"]
            return {"captures": self.captures, "replays": self.replays,
                    "kinds": {k: dict(c) for k, c in self.kinds.items()},
                    "capture_ms": sum(
                        sum(sum(r.values()) for r in c["warmup"])
                        + c["record"] for c in self.capture_ms),
                    "capture_split_ms": [dict(c) for c in self.capture_ms],
                    "programs": len(self._programs),
                    "held": [{"program": p.label or key[0],
                              "device": key[1],
                              "pool_bytes": per_pool.get(key)}
                             for key, p in self._programs.items()],
                    "pool_bytes": sum(per_pool.values())}

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()
            self._retired.clear()
            self._pools.clear()
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
    on ``device`` (default: where each tensor is)."""
    if isinstance(x, torch.Tensor):
        if device is None:
            return x.clone(memory_format=torch.contiguous_format)
        return x.to(device, memory_format=torch.contiguous_format, copy=True)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v, device) for v in x))
    if isinstance(x, (tuple, list)):
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


class Program:
    """A loop's stages over one dict of tensors ``t``, run eagerly or as
    CUDA graphs (``graphed``, held by ``CACHE``; see the module
    docstring).  An entry of ``t`` is a tensor or a (nested) tuple or
    list of them: the mesh's ``Sharded`` state is copied, selected and
    cloned shard by shard.

    ``counted`` names the counts the stages keep, as (object, attribute)
    pairs (a kernel wrapper's module and its launch count; the call's
    ``parallel.Mesh`` and its reductions): eagerly the stages count
    themselves; a captured stage records how much it added to each and
    each replay adds that (a capture's warm-up rounds and recording count
    nothing).  ``pointers`` names (object, attribute) pairs that a stage
    sets to a tensor it made (a kernel's last per-plane rounds): each
    replay sets them to the captured stage's tensors, which the replay
    has just written."""

    def __init__(self, stages: dict, graphed: bool, counted=(),
                 pointers=(), label: str = ""):
        self.stages = stages  # in capture order
        self.graphed = graphed
        self.counted = tuple(counted)
        self.pointers = tuple(pointers)
        self.label = label
        self.lock = threading.Lock()
        self.key = self.signature = None
        self.t: dict = {}
        self.graphs: dict = {}
        self.deltas: dict = {}  # per captured stage, one per counted
        self.pointed: dict = {}  # per captured stage: (obj, attr, tensor)

    def load(self, **inputs) -> None:
        """The call's inputs: copied into the program's own tensors when
        graphed (made on the program's card and captured at the first
        call), taken as they are eagerly."""
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
        self.graphs[name].replay()
        with CACHE._lock:
            CACHE._count(self.key[0], "replays")
            for (obj, attr), d in zip(self.counted, self.deltas[name]):
                setattr(obj, attr, getattr(obj, attr) + d)
            for obj, attr, value in self.pointed[name]:
                setattr(obj, attr, value)

    def _counts(self) -> list:
        return [getattr(obj, attr) for obj, attr in self.counted]

    def _capture(self) -> None:
        dev = torch.device(self.key[1])
        counted = self._counts()
        pool, stream = CACHE.pool(self.key, dev)
        # the inputs were copied in on the current stream; the replays run
        # there too, after the capture
        stream.wait_stream(torch.cuda.current_stream(dev))
        warmup = []
        # the warm-up rounds allocate from the program's pool too, so the
        # capture reuses their freed blocks: a capture then needs no memory
        # beyond what the warm-ups took, outside the capture, where the
        # allocator may still free cached blocks to make room
        with torch.cuda.stream(stream), torch.cuda.use_mem_pool(
                pool, stream.device):
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
                before = self._counts()
                pointed = [getattr(obj, attr) for obj, attr in self.pointers]
                g.capture_begin(pool=pool.id,
                                capture_error_mode="thread_local")
                try:
                    _write(self.t, fn(self.t))
                finally:
                    g.capture_end()
                self.graphs[name] = g
                self.deltas[name] = [a - b for a, b in
                                     zip(self._counts(), before)]
                self.pointed[name] = [
                    (obj, attr, getattr(obj, attr))
                    for (obj, attr), old in zip(self.pointers, pointed)
                    if getattr(obj, attr) is not old]
        record_ms = (time.perf_counter() - t0) * 1e3
        for (obj, attr), n in zip(self.counted, counted):
            setattr(obj, attr, n)
        torch.cuda.current_stream(dev).wait_stream(stream)
        with CACHE._lock:
            CACHE._retired.pop(self.key, None)
            CACHE._count(self.key[0], "captures")
            CACHE.capture_ms.append({"program": self.key[0],
                                     "label": self.label, "warmup": warmup,
                                     "record": record_ms})

    def out(self, x):
        """A result that outlives the next replay: a copy when graphed."""
        return _clone(x) if self.graphed else x
