"""``arslam-torch`` command line (port of ar_slam_tpu/cli.py).

- ``arslam-torch map [map.yaml ...] img... -o map.yaml``  ≙ ar_slam_cli:
  images only / re-solve a saved map / map + new images.
- ``arslam-torch localize map.yaml img... -o localize.yaml``  ≙ ar_loc:
  place new images against a frozen map.
- ``arslam-torch detect img...``  detection only, one JSON line per image.
- ``arslam-torch serve``  incremental mapping loop fed by a watched
  directory, stdin filenames or the load-images service (≙ the component
  pipeline + load_images service); pipelined unless ``--sequential``.
- ``arslam-torch load-images`` / ``make-map``  clients of a running serve.
- ``arslam-torch replay log.jsonl``  rebuild a map from an event log.
- ``arslam-torch annotate map.yaml``  annotated debug images.
- ``arslam-torch audit map.yaml``  per-block reprojection audit.
- ``arslam-torch scene map.yaml -o scene.png``  3-D render of the map.
- ``arslam-torch gen``  printable tag sheets (≙ ar_gen).

All that detect or solve run on the card; without one they stop with an
error unless ``--device cpu`` (or ``--platform cpu``) asks for the CPU.
``--iterative-schur`` solves with implicit-Schur CG, ``--progress`` prints
one line per LM iteration.  ``--devices N`` shards the solve's tags over N
devices (repeated CPU shards with ``--device cpu``) and, for ``detect``,
the image batch; ``--multihost coordinator:port,num_processes,process_id``
(or ``auto``) first joins a torch.distributed process group (NCCL on the
card, gloo on the CPU), over which the mesh then spans every process.
``--cpu-detector`` detects with the NumPy oracle on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time


def _is_yaml(fn: str) -> bool:
    return fn.endswith((".yaml", ".yml"))


def _maybe_print_metrics(args, engine) -> None:
    if getattr(args, "metrics", False):
        from ar_slam_tpu_torch.utils.metrics import TRACE

        print(json.dumps({"metrics": engine.metrics.summary(),
                          "trace": TRACE.summary()}), file=sys.stderr)


def _config(args):
    from ar_slam_tpu_torch.config import ArSlamConfig

    cfg = ArSlamConfig()
    if args.config:
        import yaml

        with open(args.config) as f:
            cfg = ArSlamConfig.from_dict(yaml.safe_load(f) or {})
    solver, camera, detect = {}, {}, {}
    if args.parity:
        solver.update(seed_mode="frontal", seed_anchors="single",
                      localize_unknown_tags=True)
        camera["focal_init_mode"] = "fixed"
    if args.distortion:
        camera["enable_distortion"] = True
    if args.robust_loss:
        solver["loss"] = args.robust_loss
    if args.loss_scale is not None:
        solver["loss_scale"] = args.loss_scale
    if args.iterative_schur:
        solver["linear_solver"] = "cg"
    if args.progress:
        solver["minimizer_progress_to_stdout"] = True
    if args.optimize_every is not None and args.optimize_every >= 1:
        solver["optimize_every"] = args.optimize_every
    if args.max_side is not None:
        detect["max_side"] = args.max_side
    pipeline = {}
    if args.dictionaries:
        from ar_slam_tpu_torch.detect.dictionaries import DICT_NAMES

        names = tuple(d.strip() for d in args.dictionaries.split(",")
                      if d.strip())
        for n in names:
            if n not in DICT_NAMES:
                raise SystemExit(
                    f"unknown dictionary {n!r}; choose from {DICT_NAMES}")
        detect["dictionaries"] = names
        pipeline["expected_detector_types"] = tuple(f"aruco_{n}"
                                                    for n in names)
    if getattr(args, "pub_period", None) is not None:
        pipeline["pub_period"] = args.pub_period
    if getattr(args, "event_log", None):
        pipeline["event_log_path"] = args.event_log
    if getattr(args, "embed_images", False):
        pipeline["event_log_embed_images"] = True
    if args.profile:
        pipeline["profile_trace_dir"] = args.profile
    dist = {}
    if args.devices is not None:
        dist["num_devices"] = args.devices if args.devices > 1 else 0
    return dataclasses.replace(
        cfg, dist=dataclasses.replace(cfg.dist, **dist),
        solver=dataclasses.replace(cfg.solver, **solver),
        camera=dataclasses.replace(cfg.camera, **camera),
        detect=dataclasses.replace(cfg.detect, **detect),
        pipeline=dataclasses.replace(cfg.pipeline, **pipeline))


_PLATFORMS = {"cpu": "cpu", "gpu": "cuda"}


def _device(args):
    """The command's device from --device and --platform (None: the
    card); a platform that contradicts the device is refused."""
    device = args.device or None
    platform = getattr(args, "platform", "")
    if platform:
        if platform not in _PLATFORMS:
            raise SystemExit(f"--platform {platform!r}: choose from "
                             f"{sorted(_PLATFORMS)}")
        if device and device.split(":")[0] != _PLATFORMS[platform]:
            raise SystemExit(f"--platform {platform} contradicts "
                             f"--device {device}")
        device = device or _PLATFORMS[platform]
    return device


def _engine(args, detect_mesh=None):
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine

    return ArSlamEngine(config=_config(args), device=_device(args),
                        detect_mesh=detect_mesh,
                        use_device_detector=not args.cpu_detector)


def cmd_map(args) -> int:
    engine = _engine(args)
    images = []
    for fn in args.inputs:
        if _is_yaml(fn):
            engine.load_map(fn)
        else:
            images.append(fn)
    if images:
        engine.add_images(images)
    summary = engine.solve()
    engine.print_cameras()
    engine.save_map(args.output)
    print(f"solved {summary.get('waves', 0)} captures, "
          f"rmse {summary.get('rmse', float('nan')):.4f} px -> {args.output}")
    _maybe_print_metrics(args, engine)
    return 0


def cmd_localize(args) -> int:
    engine = _engine(args)
    engine.load_map(args.map)
    images = []
    for fn in args.inputs:
        if _is_yaml(fn):
            engine.load_map(fn)
        else:
            images.append(fn)
    result = engine.localize(images)
    engine.print_cameras()
    engine.save_map(args.output)
    for uid, status in result.get("status", {}).items():
        print(f"{uid}: {status}")
    print(f"localized {result.get('localized', 0)} captures, "
          f"rmse {result.get('rmse', float('nan')):.4f} px -> {args.output}")
    _maybe_print_metrics(args, engine)
    return 0


def cmd_gen(args) -> int:
    from ar_slam_tpu_torch.detect.gen import generate_pages

    for p in generate_pages(args.out_dir, args.dictionary):
        print(p)
    return 0


def cmd_detect(args) -> int:
    mesh = None
    if args.devices and args.devices > 1:
        from ar_slam_tpu_torch.parallel.detect import image_mesh

        # under --multihost the shards span the processes
        mesh = image_mesh(args.devices, device=_device(args) or "cuda")
    engine = _engine(args, detect_mesh=mesh)
    for uid, dets, size, _path in engine.detect_images(args.inputs):
        print(json.dumps({
            "uid": uid,
            "width": size[0],
            "height": size[1],
            "detections": [{"id": tid, "corners": c.reshape(-1).tolist()}
                           for tid, c in dets],
        }))
    _maybe_print_metrics(args, engine)
    return 0


def cmd_serve(args) -> int:
    """Incremental mapping: read image paths (one per line) from stdin,
    watch a directory, or take them from the load-images service; solve
    incrementally after each batch; save the map on shutdown (≙ ArSlam
    node lifecycle ar_slam.cpp:103-111).

    Default mode is PIPELINED: decode, device detection, the merge join and
    the incremental solve overlap through double-buffered queues, ≙ the
    reference's multithreaded component container
    (ar_slam_launch.py:124-142); --sequential restores the strict
    poll→detect→solve loop.  With --artifacts FILE every solved batch
    appends one jsonl record of TF/CameraInfo/markers (≙ the per-batch
    publishes at ar_slam.cpp:133-155); --debug-images DIR writes an
    annotated PNG per newly solved capture (≙ displayDebug per solve,
    ar_slam_util.cpp:982-998, headless)."""
    engine = _engine(args)
    if args.map and os.path.exists(args.map):
        engine.load_map(args.map)
    emit = _serve_artifact_emitter(args, engine)
    pipe = None
    if not args.sequential:
        from ar_slam_tpu_torch.pipeline.stream import StreamPipeline

        pipe = StreamPipeline(engine, on_solve=emit)

    def handle(batch):
        if pipe is not None:
            pipe.submit(batch)
            return "pipelined"
        before = engine.store.next_capture_index
        engine.add_images(batch)
        s = engine.solve_incremental()
        emit(s, [c.uid for c in engine.store.captures[before:]])
        return s

    seen = set()
    server = None
    if args.listen:
        from ar_slam_tpu_torch.pipeline.service import LoadImagesServer

        server = LoadImagesServer(args.listen)
        print(f"load_images service on {args.listen}")
    try:
        if args.watch or server is not None:
            if args.watch:
                print(f"watching {args.watch} (ctrl-c to stop)")
            while True:
                batch = []
                if args.watch:
                    for fn in sorted(os.listdir(args.watch)):
                        p = os.path.join(args.watch, fn)
                        if p not in seen and fn.lower().endswith(
                                (".jpg", ".jpeg", ".png")):
                            seen.add(p)
                            batch.append(p)
                if server is not None:
                    batch.extend(server.pop_batch())
                if batch:
                    s = handle(batch)
                    print(f"+{len(batch)} images: {s}")
                if pipe is not None:
                    pipe.poll()
                if server is not None:
                    if pipe is not None and server.has_make_map():
                        pipe.drain()  # make-map answers see a settled store
                    for respond, fns in server.pop_make_map():
                        respond(_make_map_response(args, fns))
                time.sleep(args.poll)
        else:
            for line in sys.stdin:
                fn = line.strip()
                if fn:
                    print(f"{fn}: {handle([fn])}")
    except KeyboardInterrupt:
        pass
    finally:
        if pipe is not None:
            try:
                last = pipe.drain()
                if last is not None:
                    print(f"final: {last}")
            finally:
                pipe.close()
        if server is not None:
            server.close()
        if args.output:
            engine.save_map(args.output)
        engine.close()
        _maybe_print_metrics(args, engine)
    return 0


def _serve_artifact_emitter(args, engine):
    """The per-solve artifact callback: the jsonl TF/CameraInfo/marker
    stream (--artifacts) and annotated debug PNGs (--debug-images)."""
    art_path = args.artifacts
    dbg_dir = args.debug_images
    if dbg_dir:
        os.makedirs(dbg_dir, exist_ok=True)

    def emit(summary, uids):
        if art_path:
            rec = {
                "t": time.time(),
                "solved_uids": list(uids),
                "summary": {k: (float(v) if hasattr(v, "__float__") else v)
                            for k, v in (summary or {}).items()
                            if not isinstance(v, dict)},
                **engine.export_artifacts(),
            }
            with open(art_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if dbg_dir:
            from ar_slam_tpu_torch.pipeline.ingest import load_image
            from ar_slam_tpu_torch.viz.annotate import annotate_capture

            for uid in uids:
                idx = engine.store.capture_map.get(uid)
                if idx is None:
                    continue
                cap = engine.store.captures[idx]
                if not cap.img_fn or not os.path.exists(cap.img_fn):
                    continue
                out = os.path.join(dbg_dir, f"{uid}_annotated.png")
                annotate_capture(engine.store, idx, load_image(cap.img_fn),
                                 out, show_all_tags=True)

    return emit


def cmd_load_images(args) -> int:
    """Send filenames to a running ``arslam-torch serve --listen``
    instance (≙ load_images_client, ar_slam_module.py:8-20)."""
    from ar_slam_tpu_torch.pipeline.service import send_load_images

    if not args.inputs:
        print("error: no image filenames given", file=sys.stderr)
        return 1
    resp = send_load_images(args.sock, args.inputs)
    print(resp.get("message", ""))
    return 0 if resp.get("success") else 1


def _make_map_response(args, fns: list[str]) -> dict:
    """Fulfil one MakeMap request on the serve's device: build a standalone
    map from the given images and return its YAML text (≙ MakeMap.srv:
    img_fns -> yaml — declared by the reference interfaces but never
    served there)."""
    import io

    from ar_slam_tpu_torch.graph.yamlio import save_yaml

    try:
        eng = _engine(args)
        eng.add_images(fns)
        summary = eng.solve()
        buf = io.StringIO()
        save_yaml(eng.store, buf)
        return {"success": True,
                "message": f"solved {summary.get('waves', 0)} captures, "
                           f"rmse {summary.get('rmse', float('nan')):.4f} px",
                "yaml": buf.getvalue()}
    except Exception as e:  # noqa: BLE001 — report failure to the client
        logging.getLogger(__name__).exception("make_map failed")
        return {"success": False, "message": f"make_map failed: {e}"}


def cmd_make_map(args) -> int:
    """One-shot MakeMap request against a running serve instance."""
    from ar_slam_tpu_torch.pipeline.service import send_make_map

    if not args.inputs:
        print("error: no image filenames given", file=sys.stderr)
        return 1
    resp = send_make_map(args.sock, args.inputs, timeout=args.timeout)
    print(resp.get("message", ""), file=sys.stderr)
    if not resp.get("success"):
        return 1
    if args.output:
        with open(args.output, "w") as f:
            f.write(resp.get("yaml", ""))
    else:
        sys.stdout.write(resp.get("yaml", ""))
    return 0


def cmd_replay(args) -> int:
    """Rebuild a map from an event log.  Default: replay the recorded
    detections (self-contained — corners are in the log).  With
    --redetect: decode the EMBEDDED images (serve --embed-images) and run
    the detector again."""
    import numpy as np

    from ar_slam_tpu_torch.pipeline.engine import EventLog, decode_png_b64
    from ar_slam_tpu_torch.pipeline.ingest import IngestedCapture

    engine = _engine(args)
    if args.redetect:
        caps = []
        for rec in EventLog.replay(args.log):
            if rec["kind"] != "capture":
                continue
            if "image_png" not in rec:
                print(f"error: capture {rec['uid']} has no embedded image "
                      "(record with serve --embed-images)", file=sys.stderr)
                return 1
            caps.append(IngestedCapture(
                uid=rec["uid"], path=rec.get("path", ""),
                image=decode_png_b64(rec["image_png"])))
        for uid, by_dict, size, path in engine.detect_decoded(caps):
            flat = [d for dets in by_dict.values() for d in dets]
            engine.store.add_detections(uid, flat, size, path)
    else:
        for rec in EventLog.replay(args.log):
            if rec["kind"] != "detections":
                continue
            dets = [(d["id"], np.asarray(d["corners"]).reshape(4, 2))
                    for d in rec["detections"]]
            engine.store.add_detections(rec["uid"], dets,
                                        (rec["width"], rec["height"]),
                                        rec.get("path", ""))
    summary = engine.solve()
    engine.save_map(args.output)
    print(f"replayed -> rmse {summary.get('rmse', float('nan')):.4f} px "
          f"-> {args.output}")
    _maybe_print_metrics(args, engine)
    return 0


def cmd_annotate(args) -> int:
    """Write annotated debug images (≙ displayDebug, headless)."""
    from ar_slam_tpu_torch.graph.store import MapStore
    from ar_slam_tpu_torch.graph.yamlio import load_yaml
    from ar_slam_tpu_torch.pipeline.ingest import load_image
    from ar_slam_tpu_torch.viz.annotate import annotate_capture

    store = MapStore()
    load_yaml(store, args.map)
    os.makedirs(args.out_dir, exist_ok=True)
    for cap in store.captures:
        if not cap.img_fn or not os.path.exists(cap.img_fn):
            continue
        out = os.path.join(args.out_dir, f"{cap.uid}_annotated.png")
        annotate_capture(store, cap.index, load_image(cap.img_fn), out,
                         show_all_tags=args.all_tags)
        print(out)
    return 0


def cmd_audit(args) -> int:
    """Per-block reprojection audit (≙ compareProjections,
    ar_slam_util.cpp:576-589): worst blocks first."""
    from ar_slam_tpu_torch.graph.store import MapStore
    from ar_slam_tpu_torch.graph.yamlio import load_yaml
    from ar_slam_tpu_torch.utils.audit import compare_projections, format_audit

    store = MapStore()
    load_yaml(store, args.map)
    rows = compare_projections(store, device=args.device or None)
    if args.json:
        for d in rows:
            print(json.dumps(d))
    else:
        print(format_audit(rows, limit=args.limit))
    return 0


def cmd_scene(args) -> int:
    """Render the 3-D map scene (≙ the Foxglove 3D panel, headless)."""
    from ar_slam_tpu_torch.graph.store import MapStore
    from ar_slam_tpu_torch.graph.yamlio import load_yaml
    from ar_slam_tpu_torch.viz.scene import render_scene

    store = MapStore()
    load_yaml(store, args.map)
    print(render_scene(store, args.output))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="arslam-torch",
        description="AR-tag SLAM engine on PyTorch + CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", default="",
                        help="YAML/JSON file with the full ArSlamConfig "
                             "tree (CLI flags override it)")
        sp.add_argument("--device", default="",
                        help="torch device (default: cuda; without a card "
                             "the command stops unless --device cpu asks "
                             "for the CPU)")
        sp.add_argument("--metrics", action="store_true",
                        help="print the per-stage metrics summary (counts "
                             "and timings) and the tracer's spans, device "
                             "times, counters and host waits as JSON on "
                             "stderr at exit")
        sp.add_argument("--parity", action="store_true",
                        help="reference-parity mode: fixed focal init 3000 "
                             "+ frontal-only single-anchor seeding")
        sp.add_argument("--distortion", action="store_true",
                        help="calibrate radial distortion l1,l2")
        sp.add_argument("--dictionaries", default="",
                        help="comma-separated dictionaries to detect "
                             "(default 4X4_50,5X5_100; also 6X6_250)")
        sp.add_argument("--max-side", type=int, default=None,
                        help="detection working resolution: downscale "
                             "larger images before the detector (0 = off)")
        sp.add_argument("--robust-loss", default="",
                        help="robust loss: 'huber' downweights outliers")
        sp.add_argument("--loss-scale", type=float, default=None,
                        help="Huber delta in pixels of block residual norm")
        sp.add_argument("--optimize-every", type=int, default=None,
                        help="run the full optimization only every Nth "
                             "capture wave (always the last)")
        sp.add_argument("--profile", default="",
                        help="write a torch.profiler chrome trace of each "
                             "detection, localize and solve call (host, "
                             "card and the program's spans) into this "
                             "directory")
        sp.add_argument("--iterative-schur", action="store_true",
                        help="solve the reduced camera system with "
                             "implicit-Schur preconditioned CG instead of "
                             "dense Cholesky (large maps; ≙ ceres "
                             "ITERATIVE_SCHUR)")
        sp.add_argument("--progress", action="store_true",
                        help="print one line per LM iteration "
                             "(host-stepped; ≙ ceres "
                             "minimizer_progress_to_stdout)")
        sp.add_argument("--cpu-detector", action="store_true",
                        help="detect with the NumPy oracle on the host "
                             "instead of the batched device detector")
        sp.add_argument("--devices", type=int, default=None,
                        help="shard the solve's tags over N devices "
                             "(distributed BA over a 'blocks' mesh; with "
                             "--device cpu, N CPU shards) and, for detect, "
                             "the image batch; 0/1 = single device.  The "
                             "sharded solve replays CUDA graphs when this "
                             "process's shards share one card (each "
                             "--multihost process on its own card); shards "
                             "spread over several cards run eagerly")
        sp.add_argument("--multihost", default="",
                        help="join a torch.distributed process group before "
                             "any device use: 'coordinator:port,"
                             "num_processes,process_id' or 'auto' "
                             "(torchrun's environment); NCCL on the card, "
                             "gloo on the CPU; the mesh then spans every "
                             "process and --devices defaults to the world's "
                             "device count")
        sp.add_argument("--platform", default="",
                        help="'cpu' or 'gpu': the device kind (must agree "
                             "with --device)")

    sp = sub.add_parser("map", help="batch mapping (≙ ar_slam_cli)")
    sp.add_argument("inputs", nargs="+",
                    help="mix of map .yaml checkpoints and images")
    sp.add_argument("-o", "--output", default="map.yaml")
    common(sp)
    sp.set_defaults(fn=cmd_map)

    sp = sub.add_parser("localize", help="localize against a map (≙ ar_loc)")
    sp.add_argument("map", help="map.yaml to localize against")
    sp.add_argument("inputs", nargs="+", help="images (or more yaml)")
    sp.add_argument("-o", "--output", default="localize.yaml")
    common(sp)
    sp.set_defaults(fn=cmd_localize)

    sp = sub.add_parser("gen", help="generate printable tag sheets (≙ ar_gen)")
    sp.add_argument("--dictionary", default="4X4_50")
    sp.add_argument("--out-dir", default=".")
    sp.set_defaults(fn=cmd_gen)

    sp = sub.add_parser("detect", help="detect markers, print JSON")
    sp.add_argument("inputs", nargs="+")
    common(sp)  # --devices = split the image batch (data-parallel detect)
    sp.set_defaults(fn=cmd_detect)

    sp = sub.add_parser("serve", help="incremental mapping loop")
    sp.add_argument("--map", default="", help="initial map.yaml to extend")
    sp.add_argument("-o", "--output", default="map.yaml")
    sp.add_argument("--watch", default="", help="directory to watch")
    sp.add_argument("--poll", type=float, default=0.5)
    sp.add_argument("--listen", default="",
                    help="unix socket path for the load_images service "
                         "(clients: arslam-torch load-images --sock PATH "
                         "img...)")
    sp.add_argument("--sequential", action="store_true",
                    help="disable the overlapped ingest/detect/merge/solve "
                         "pipeline (strict poll-detect-solve loop)")
    sp.add_argument("--pub-period", type=float, default=None,
                    help="pace ingest to one image per PERIOD seconds "
                         "(the reference ImageLoader's pub_period; "
                         "0/omitted = unthrottled)")
    sp.add_argument("--event-log", default=None,
                    help="append captures+detections to this jsonl event "
                         "log (≙ BagRecorder; replay with arslam-torch "
                         "replay)")
    sp.add_argument("--embed-images", action="store_true",
                    help="embed capture pixels (base64 PNG) in the event "
                         "log — hermetic replay without the originals")
    sp.add_argument("--artifacts", default="",
                    help="append one jsonl record of TF/CameraInfo/markers "
                         "per solved batch (≙ the per-batch publishes, "
                         "ar_slam.cpp:133-155)")
    sp.add_argument("--debug-images", default="", dest="debug_images",
                    help="write an annotated PNG per newly solved capture "
                         "into this directory (≙ per-solve displayDebug)")
    common(sp)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("load-images",
                        help="send images to a running serve instance "
                             "(≙ load_images_client)")
    sp.add_argument("inputs", nargs="*", help="image filenames")
    sp.add_argument("--sock", default="/tmp/arslam.sock")
    sp.set_defaults(fn=cmd_load_images)

    sp = sub.add_parser("make-map",
                        help="one-shot map build via a running serve "
                             "(≙ MakeMap.srv: img_fns -> yaml)")
    sp.add_argument("inputs", nargs="*", help="image filenames")
    sp.add_argument("--sock", default="/tmp/arslam.sock")
    sp.add_argument("-o", "--output", default="",
                    help="write yaml here (default: stdout)")
    sp.add_argument("--timeout", type=float, default=600.0)
    sp.set_defaults(fn=cmd_make_map)

    sp = sub.add_parser("replay", help="rebuild a map from an event log")
    sp.add_argument("log")
    sp.add_argument("-o", "--output", default="map.yaml")
    sp.add_argument("--redetect", action="store_true",
                    help="run the detector on the log's EMBEDDED images "
                         "(from serve --embed-images) instead of replaying "
                         "recorded detections")
    common(sp)
    sp.set_defaults(fn=cmd_replay)

    sp = sub.add_parser("annotate", help="write annotated debug images")
    sp.add_argument("map")
    sp.add_argument("--out-dir", default="annotated")
    sp.add_argument("--all-tags", action="store_true")
    sp.set_defaults(fn=cmd_annotate)

    sp = sub.add_parser("audit", help="per-block reprojection audit "
                                      "(≙ compareProjections)")
    sp.add_argument("map")
    sp.add_argument("--limit", type=int, default=20,
                    help="show the N worst blocks (0 = all)")
    sp.add_argument("--json", action="store_true",
                    help="one JSON object per block instead of the table")
    sp.add_argument("--device", default="",
                    help="torch device of the projection (default: cuda)")
    sp.set_defaults(fn=cmd_audit)

    sp = sub.add_parser("scene", help="render the 3-D map scene to PNG")
    sp.add_argument("map")
    sp.add_argument("-o", "--output", default="scene.png")
    sp.set_defaults(fn=cmd_scene)
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname)s] %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    if getattr(args, "metrics", False):
        from ar_slam_tpu_torch.utils.metrics import TRACE

        TRACE.enabled = True
    _maybe_multihost(args)
    try:
        return args.fn(args)
    finally:
        if getattr(args, "multihost", ""):
            import torch.distributed as dist

            from ar_slam_tpu_torch.programs import CACHE

            # the graphs that captured collectives go before the group
            CACHE.clear()
            dist.destroy_process_group()


def _maybe_multihost(args) -> None:
    """--multihost: join the process group before any device use.

    Every process runs the identical command; the host-side graph
    bookkeeping is a pure function of the inputs, so all processes run
    the same reductions (parallel/multihost.py).  The other processes
    write their outputs into a scratch directory and mute stdout: only
    process 0 publishes results."""
    spec = getattr(args, "multihost", "")
    if not spec:
        return
    from ar_slam_tpu_torch.device import resolve_device
    from ar_slam_tpu_torch.parallel import multihost

    device = resolve_device(_device(args))
    pid, nproc = multihost.initialize(spec, device)
    if args.devices is None:
        args.devices = multihost.world_device_count(device)
    logging.getLogger("arslam").info(
        "multihost: process %d/%d, %d shards on %s", pid, nproc,
        args.devices, device.type)
    if pid != 0:
        import tempfile

        scratch = tempfile.mkdtemp(prefix="arslam-mh-")
        # per-process artifacts (the map and the profile traces) go to
        # scratch, so that N processes never clobber each other's files
        for attr in ("output", "profile"):
            if getattr(args, attr, None):
                setattr(args, attr, os.path.join(
                    scratch, os.path.basename(getattr(args, attr))))
        sys.stdout = open(os.devnull, "w")


if __name__ == "__main__":
    sys.exit(main())
