"""``arslam-torch`` command line (port of the ``map`` and ``detect``
subcommands of ar_slam_tpu/cli.py).

- ``arslam-torch map [map.yaml ...] img... -o map.yaml``  ≙ ar_slam_cli:
  images only / re-solve a saved map / map + new images.
- ``arslam-torch detect img...``  detection only, one JSON line per image.

Both run on the card when one is present (``--device`` overrides).  The
reference CLI's other subcommands are not ported yet; of its flags,
--cpu-detector, --devices, --multihost, --platform, --profile,
--iterative-schur and --progress are accepted and refused with a message.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys


def _is_yaml(fn: str) -> bool:
    return fn.endswith((".yaml", ".yml"))


def _maybe_print_metrics(args, engine) -> None:
    if getattr(args, "metrics", False):
        print(json.dumps({"metrics": engine.metrics.summary()}),
              file=sys.stderr)


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
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, **solver),
        camera=dataclasses.replace(cfg.camera, **camera),
        detect=dataclasses.replace(cfg.detect, **detect),
        pipeline=dataclasses.replace(cfg.pipeline, **pipeline))


_NOT_PORTED = ("cpu_detector", "devices", "multihost", "platform", "profile",
               "iterative_schur", "progress")


def _engine(args):
    from ar_slam_tpu_torch.pipeline.engine import ArSlamEngine

    for name in _NOT_PORTED:
        value = getattr(args, name)
        if value and not (name == "devices" and value == 1):
            raise SystemExit(f"--{name.replace('_', '-')} is not ported to "
                             "arslam-torch yet")

    return ArSlamEngine(config=_config(args), device=args.device or None)


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


def cmd_detect(args) -> int:
    engine = _engine(args)
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


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname)s] %(name)s: %(message)s")
    p = argparse.ArgumentParser(
        prog="arslam-torch",
        description="AR-tag SLAM engine on PyTorch + CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", default="",
                        help="YAML/JSON file with the full ArSlamConfig "
                             "tree (CLI flags override it)")
        sp.add_argument("--device", default="",
                        help="torch device (default: cuda when present, "
                             "else cpu)")
        sp.add_argument("--metrics", action="store_true",
                        help="print the per-stage metrics summary (counts "
                             "and timings) as JSON on stderr at exit")
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
        for flag in ("--cpu-detector", "--iterative-schur", "--progress"):
            sp.add_argument(flag, action="store_true",
                            help="not ported yet (refused)")
        for flag in ("--multihost", "--platform", "--profile"):
            sp.add_argument(flag, default="", help="not ported yet (refused)")
        sp.add_argument("--devices", type=int, default=None,
                        help="not ported yet (refused)")

    sp = sub.add_parser("map", help="batch mapping (≙ ar_slam_cli)")
    sp.add_argument("inputs", nargs="+",
                    help="mix of map .yaml checkpoints and images")
    sp.add_argument("-o", "--output", default="map.yaml")
    common(sp)
    sp.set_defaults(fn=cmd_map)

    sp = sub.add_parser("detect", help="detect markers, print JSON")
    sp.add_argument("inputs", nargs="+")
    common(sp)
    sp.set_defaults(fn=cmd_detect)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
