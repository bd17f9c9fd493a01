# Copied from ar_slam_tpu/graph/yamlio.py and kept equal to it (a CPU test
# checks that), so the port never imports the JAX package.
"""map.yaml checkpoint IO — the reference's durable-checkpoint surface.

Schema identical to ``ArSlamSolver::saveYaml`` / ``loadYaml``
(ar_slam_util.cpp:304-465; layout documented in SURVEY.md §2.4):

    blocks:                      # list, one per observation
      - capture: <capture_uid>
        aruco: <aruco_id>
        aruco_rect: [x0, y0, x1, y1, x2, y2, x3, y3]   # flow seq
    captures:
      <uid>: {inv_pose: [tx,ty,tz,rx,ry,rz], img_fn: <path>}
    arucos:
      <id>: {pose: [tx,ty,tz,rx,ry,rz]}
    camera: {params: [focal, l1, l2], width: <int>, height: <int>}

Loading is additive and re-enterable (multiple files extend one store);
a duplicate capture uid raises, matching ar_slam_util.cpp:311-315.
"""

from __future__ import annotations

import io

import numpy as np

from ar_slam_tpu_torch.graph.store import MapStore


class _FallbackToYaml(Exception):
    """The text is not in the strict machine-written subset — use PyYAML."""


def _parse_floats(parts: list[str], per_row: int) -> np.ndarray:
    """Parse a list of comma-separated float strings into (len, per_row).

    One big join + np.fromstring keeps the float parsing in C (263k
    8-float rects parse in ~0.7 s vs ~44 s through the libyaml event
    pipeline).  Size mismatches (e.g. unparseable tokens — np.fromstring
    stops early) fall back to full YAML parsing.
    """
    if not parts:
        return np.zeros((0, per_row))
    import warnings

    joined = ",".join(parts)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # fromstring text-mode deprecation
            vals = np.fromstring(joined, dtype=float, sep=",")
    except Exception:
        # np.fromstring's text mode is deprecated and may be removed; the
        # split-list constructor keeps float parsing in C (~2x slower)
        try:
            vals = np.array(joined.split(","), dtype=float)
        except ValueError:
            raise _FallbackToYaml() from None
    if vals.size != len(parts) * per_row:
        raise _FallbackToYaml()
    return vals.reshape(len(parts), per_row)


def _fast_parse(text: str):
    """Parse the exact line format ``dumps_yaml`` writes (section order
    blocks, captures, arucos, camera; 2/4-space indents; flow-seq vectors).

    Returns fully-parsed numeric data WITHOUT touching the store, so a
    mid-file surprise cannot leave a half-mutated store; any deviation
    raises _FallbackToYaml and the caller re-parses with PyYAML.
    """
    lines = text.split("\n")
    n = len(lines)
    i = 0
    if not (i < n and lines[i] == "blocks:"):
        raise _FallbackToYaml()
    i += 1
    blk_caps: list[str] = []
    blk_tags: list[str] = []
    rect_strs: list[str] = []
    while i < n and lines[i].startswith("  - capture: "):
        if not (i + 2 < n
                and lines[i + 1].startswith("    aruco: ")
                and lines[i + 2].startswith("    aruco_rect: [")
                and lines[i + 2].endswith("]")):
            raise _FallbackToYaml()
        blk_caps.append(lines[i][13:])
        blk_tags.append(lines[i + 1][11:])
        rect_strs.append(lines[i + 2][17:-1])
        i += 3
    if not (i < n and lines[i] == "captures:"):
        raise _FallbackToYaml()
    i += 1
    cap_uids: list[str] = []
    cap_pose_strs: list[str] = []
    cap_img_fns: list[str] = []
    while (i < n and lines[i].startswith("  ") and lines[i].endswith(":")
           and not lines[i].startswith("    ")):
        if not (i + 1 < n and lines[i + 1].startswith("    inv_pose: [")
                and lines[i + 1].endswith("]")):
            raise _FallbackToYaml()
        cap_uids.append(lines[i][2:-1])
        cap_pose_strs.append(lines[i + 1][15:-1])
        i += 2
        img_fn = ""
        if i < n and lines[i].startswith("    img_fn:"):
            img_fn = lines[i][11:].strip()
            i += 1
        cap_img_fns.append(img_fn)
    if not (i < n and lines[i] == "arucos:"):
        raise _FallbackToYaml()
    i += 1
    tag_ids: list[str] = []
    tag_pose_strs: list[str] = []
    while (i < n and lines[i].startswith("  ") and lines[i].endswith(":")
           and not lines[i].startswith("    ")):
        if not (i + 1 < n and lines[i + 1].startswith("    pose: [")
                and lines[i + 1].endswith("]")):
            raise _FallbackToYaml()
        tag_ids.append(lines[i][2:-1])
        tag_pose_strs.append(lines[i + 1][11:-1])
        i += 2
    camera = None
    if i < n and lines[i] == "camera:":
        i += 1
        camera = {}
        while i < n and lines[i].startswith("  "):
            ln = lines[i]
            if ln.startswith("  params: [") and ln.endswith("]"):
                camera["params"] = _parse_floats([ln[11:-1]], 3)[0]
            elif ln.startswith("  width: "):
                camera["width"] = int(ln[9:])
            elif ln.startswith("  height: "):
                camera["height"] = int(ln[10:])
            else:
                raise _FallbackToYaml()
            i += 1
    while i < n:
        if lines[i].strip():
            raise _FallbackToYaml()
        i += 1
    return {
        "cap_uids": cap_uids,
        "cap_poses": _parse_floats(cap_pose_strs, 6),
        "cap_img_fns": cap_img_fns,
        "tag_ids": tag_ids,
        "tag_poses": _parse_floats(tag_pose_strs, 6),
        "blk_caps": blk_caps,
        "blk_tags": blk_tags,
        "rects": _parse_floats(rect_strs, 8),
        "camera": camera,
    }


def load_yaml(store: MapStore, fn_or_stream) -> None:
    """Additively restore a map checkpoint into ``store``.

    Load order matches the reference loader (captures, arucos, blocks,
    camera — ar_slam_util.cpp:304-368) so index assignment is identical.

    Machine-written checkpoints (this writer's exact format) take a fast
    strict-parse path — PyYAML's event pipeline costs ~160 s on a 10k-tag /
    263k-block map vs ~5 s here; anything else (hand-edited or
    reference-written files) falls back to full YAML parsing with identical
    semantics.
    """
    if hasattr(fn_or_stream, "read"):
        text = fn_or_stream.read()
    else:
        with open(fn_or_stream) as f:
            text = f.read()

    try:
        parsed = _fast_parse(text)
    except _FallbackToYaml:
        parsed = None
    if parsed is not None:
        for uid, pose, img_fn in zip(parsed["cap_uids"], parsed["cap_poses"],
                                     parsed["cap_img_fns"]):
            cap = store.add_capture(uid, img_fn)
            cap.inv_pose = pose.copy()
        for tag_id, pose in zip(parsed["tag_ids"], parsed["tag_poses"]):
            tag = store.add_aruco(tag_id)
            tag.pose = pose.copy()
        if parsed["blk_caps"]:
            cap_map, tag_map = store.capture_map, store.aruco_map
            cap_idx = np.fromiter((cap_map[u] for u in parsed["blk_caps"]),
                                  np.int32, len(parsed["blk_caps"]))
            tag_idx = np.fromiter((tag_map[t] for t in parsed["blk_tags"]),
                                  np.int32, len(parsed["blk_tags"]))
            store.bulk_add_blocks(parsed["rects"].reshape(-1, 4, 2),
                                  cap_idx, tag_idx)
        cam = parsed["camera"]
        if cam:
            if "width" in cam and "height" in cam:
                store.camera.size = (cam["width"], cam["height"])
            params = cam.get("params")
            if params is not None:
                store.camera.params[: params.size] = params
            store.camera.focal_calibrated = True
        return

    # PyYAML only on this fallback branch: the fast path above needs no
    # third-party parser.  libyaml C loader when built (3-4x the
    # pure-Python parse); both are ~40x slower than the fast path on large
    # machine-written maps.
    import yaml

    doc = yaml.load(text, Loader=getattr(yaml, "CSafeLoader", yaml.SafeLoader))

    for uid, cap_data in (doc.get("captures") or {}).items():
        # an empty img_fn is written as 'img_fn: ' which YAML parses as
        # None — store '' (matching the fast path), not the string 'None'
        cap = store.add_capture(str(uid), str(cap_data.get("img_fn") or ""))
        cap.inv_pose = np.asarray(cap_data["inv_pose"], dtype=float).copy()

    for tag_id, ar_data in (doc.get("arucos") or {}).items():
        tag = store.add_aruco(str(tag_id))
        tag.pose = np.asarray(ar_data["pose"], dtype=float).copy()

    for block_data in doc.get("blocks") or []:
        cap_idx = store.capture_map[str(block_data["capture"])]
        tag_idx = store.aruco_map[str(block_data["aruco"])]
        rect = np.asarray(block_data["aruco_rect"], dtype=float)
        if rect.size != 8:
            raise ValueError("aruco_rect has wrong number of values")
        store.add_block(rect.reshape(4, 2), cap_idx, tag_idx)

    cam = doc.get("camera")
    if cam:
        if "width" in cam and "height" in cam:
            store.camera.size = (int(cam["width"]), int(cam["height"]))
        params = np.asarray(cam["params"], dtype=float)
        store.camera.params[: params.size] = params
        store.camera.focal_calibrated = True


def _flow(seq) -> str:
    return "[" + ", ".join(_fmt(v) for v in seq) + "]"


def _fmt(v: float) -> str:
    """Float formatting: repr-style shortest round-trip, like yaml-cpp doubles."""
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return repr(float(v))


def dumps_yaml(store: MapStore) -> str:
    """Serialize in the reference section order: blocks, captures, arucos,
    camera (ar_slam_util.cpp:371-465)."""
    out = io.StringIO()
    out.write("blocks:\n")
    for block in store.blocks:
        cap = store.captures[block.cap_idx]
        tag = store.arucos[block.tag_idx]
        out.write(f"  - capture: {cap.uid}\n")
        out.write(f"    aruco: {tag.id}\n")
        out.write(f"    aruco_rect: {_flow(block.corners.reshape(-1))}\n")
    out.write("captures:\n")
    for cap in store.captures:
        out.write(f"  {cap.uid}:\n")
        out.write(f"    inv_pose: {_flow(cap.inv_pose)}\n")
        out.write(f"    img_fn: {cap.img_fn}\n")
    out.write("arucos:\n")
    for tag in store.arucos:
        out.write(f"  {tag.id}:\n")
        out.write(f"    pose: {_flow(tag.pose)}\n")
    out.write("camera:\n")
    out.write(f"  params: {_flow(store.camera.params)}\n")
    if store.camera.size is not None:
        out.write(f"  width: {store.camera.size[0]}\n")
        out.write(f"  height: {store.camera.size[1]}\n")
    return out.getvalue()


def save_yaml(store: MapStore, fn_or_stream) -> None:
    text = dumps_yaml(store)
    if hasattr(fn_or_stream, "write"):
        fn_or_stream.write(text)
    else:
        with open(fn_or_stream, "w") as f:
            f.write(text)
