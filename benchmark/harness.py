"""The benchmark's driver loop, driven by data.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  The
configuration is ``configs/<config>.json``; the mix is
``traffic/<traffic>.json``, whose ``"driver"`` names the module
``drivers/<driver>.py`` that sets the cell up and runs one operation; the
limits of its comparisons are ``limits/<cell>.json``; a per-layer metric
``<name>`` is read by ``metrics/<name>.py``, or by ``metrics/<base>.py``
for a name ``<base>.<split>``.  Each is found by name, so a later change
adds a configuration, a mix, a driver or a metric by adding files.

A run: set-up (inputs from the seed, the program built and every shape of
the cell warmed up), then whole operations until ``--seconds`` have passed,
then the comparison with the plain reference, then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from contextlib import nullcontext
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that may not be loaded in a run (compared whole: the
# port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ar_slam_tpu")


def cache_dirs(root: str = ROOT) -> dict:
    """Fixed build and kernel cache directories inside the checkout."""
    base = os.path.join(root, "build", "bench_cache")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "CUDA_CACHE_PATH": os.path.join(base, "cuda")}


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(manifest: dict, workload: str, root: str = ROOT) -> dict:
    """The files a cell is made of, found by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench = os.path.join(root, "benchmark")
    mix_path = os.path.join(bench, "traffic", cell["traffic"] + ".json")
    mix = load_json(mix_path)
    return {
        "cell": cell,
        "config": load_json(os.path.join(root,
                                         configs[cell["config"]]["file"])),
        "mix": mix,
        "driver": os.path.join(bench, "drivers", mix["driver"] + ".py"),
        "limits": load_json(os.path.join(bench, "limits",
                                         workload + ".json")),
    }


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    """The cell's metric entries: end-to-end ones untraced, per-layer ones
    traced."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key]
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str, root: str = ROOT):
    """The reader module of a per-layer metric."""
    base = os.path.join(root, "benchmark", "metrics")
    for stem in (name, name.split(".")[0]):
        path = os.path.join(base, stem + ".py")
        if os.path.exists(path):
            return load_module(path, "bench_metric_" + stem.replace(".", "_"))
    raise FileNotFoundError(f"no reader for metric {name!r}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(torch, chips: int, device: str) -> dict:
    """The result's ``device``: the cards' name and count, and torch's
    peak of allocated bytes on the fullest card."""
    if device == "cuda":
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": 0}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, start: float | None = None, device: str = "cuda",
         sizes: dict | None = None, mix_sizes: dict | None = None,
         fault: str | None = None, root: str = ROOT) -> int:
    """One run.  ``device``, ``sizes`` and ``mix_sizes`` (overrides of
    the configuration and the mix) and ``fault`` (a fault planted under the
    timed path) are for the benchmark's own tests; a run on the chip takes
    the defaults."""
    start = time.perf_counter() if start is None else start
    args = parse(argv)
    for k, v in cache_dirs(root).items():
        os.environ[k] = v
        os.makedirs(v, exist_ok=True)
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    files = resolve(manifest, args.workload, root)
    cell, cfg, mix = files["cell"], dict(files["config"]), dict(files["mix"])
    cfg.update(sizes or {})
    mix.update(mix_sizes or {})
    chips = int(cell["chips"])

    import torch

    if device == "cuda" and not (torch.cuda.is_available()
                                 and torch.cuda.device_count() >= chips):
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, torch.get_num_threads()))

    from benchmark.trace import Profile, Spans

    driver = load_module(files["driver"], "bench_driver_" + mix["driver"])
    spans = Spans() if args.trace else None
    ctx = SimpleNamespace(cfg=cfg, mix=mix, seed=args.seed, device=device,
                          chips=chips, spans=spans, fault=fault)
    run = driver.Cell(ctx)
    if spans is not None:
        spans.seconds.clear()  # the warm-up's calls are set-up
    cards = list(range(chips)) if device == "cuda" else []
    for c in cards:
        torch.cuda.synchronize(c)
    setup_s = time.perf_counter() - start

    records, latencies, failed = [], [], 0
    prof, profiled, traced = None, None, 0

    def close_stretch():
        stretch.__exit__(None, None, None)
        spans.recording = False
        prof.__exit__(None, None, None)

    trace_after = float(mix.get("trace_after", 0.25)) * args.seconds
    w0 = time.perf_counter()
    end = w0
    while True:
        if args.trace and prof is None and profiled is None and (
                time.perf_counter() - w0 >= trace_after):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            spans.recording = True
            stretch = spans("stretch")
            stretch.__enter__()
        t0 = time.perf_counter()
        try:
            with spans("op") if spans is not None else nullcontext():
                out = run.op()
        except Exception:  # noqa: BLE001 — a failed operation is counted
            traceback.print_exc(file=sys.stderr)
            out = None
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        rec = run.after(out) if out is not None else None
        if rec is None or rec.get("failed"):
            failed += 1
        records.append(rec)
        if prof is not None:
            traced += 1
            if traced >= int(mix.get("trace_ops", 1)):
                close_stretch()
                profiled, prof = prof, None
        end = time.perf_counter()
        if t1 - w0 >= args.seconds and (profiled is not None
                                        or not args.trace):
            break
    if prof is not None:  # the window closed inside the stretch
        close_stretch()
        profiled = prof
    window_s = end - w0
    dev_info = device_info(torch, chips, device)

    metrics = {}
    breakdown = None
    if args.trace:
        trace = Profile(profiled, cards) if profiled is not None else None
        view = SimpleNamespace(spans=spans.seconds, counters=run.counters(
            records), trace=trace, records=records, window_s=window_s,
            cfg=cfg, mix=mix)
        for m in metrics_of(manifest, args.workload, True):
            value = reader(m["name"], root).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if trace is not None:
            busy = [trace.busy_s(c) for c in cards] or [0.0]
            for c, b in zip(cards, busy):
                print(f"benchmark: card {c} busy {b} s of {trace.window_s} s",
                      file=sys.stderr)
            dev_info["busy_s"] = sum(busy) / len(busy)
            dev_info["window_s"] = trace.window_s
            breakdown = trace.breakdown()
            names = {}
            for _, _, n in trace.ranges:
                names[n] = names.get(n, 0) + 1
            print(f"benchmark: traced stretch {trace.window_s} s, ranges "
                  f"{names}, device items "
                  f"{ {c: len(v) for c, v in trace.device.items()} }, "
                  f"launches {len(trace.launches)}", file=sys.stderr)
        del trace, view, profiled
    else:
        values = run.end_to_end(records, latencies, window_s)
        values["setup_s"] = setup_s
        for m in metrics_of(manifest, args.workload, False):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    # the comparison with the plain reference, once the program's state
    # is freed
    truth = run.release()
    del run
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    try:
        numbers = driver.check(ctx, truth, records, files["limits"])
    except Exception:  # noqa: BLE001 — a comparison that fails is reported
        traceback.print_exc(file=sys.stderr)
        numbers = {}
    print(f"benchmark: window {window_s} s, {len(records)} operations; "
          f"comparison {time.perf_counter() - t_check} s", file=sys.stderr)
    ok = bool(numbers) and all(
        math.isfinite(v) and v <= lim for v, lim in numbers.values())
    correct = ok and failed == 0 and all(r is not None for r in records)

    found = forbidden_modules()
    if found:
        print(f"benchmark: modules loaded that may not be: {found}",
              file=sys.stderr)
        return 4
    result = {"correct": correct, "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
