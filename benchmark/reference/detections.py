"""Detections held against the rendered truth and the plain detector.

A photo's truth is every tag whose paper lies fully inside it, with its
dictionary, id and corners as rendered.  A tag of side at least
``min_side`` px must be found with its id (chip_smoke's rule at 12 MP,
80 px).  An id that is not rendered in the photo is foreign.  Each
detection of a required tag is held to the render (its largest corner
distance) and to the plain detector (``reference/aruco.py``) on the same
photo (each corner's distance to the plain detection of that id): the
plain detector shares the program's pixel convention, which the render
does not (its corners sit ~0.4 px away), but it misplaces a corner of a few
tags by 6-11 px at 12 MP, which the render does not.
"""

from __future__ import annotations

import numpy as np


def tag_id(name: str, mid: int) -> str:
    return f"aruco_{name}_{mid}"


def compare(truth: list, found: list, center, min_side: float,
            plain: list) -> dict:
    """``truth`` [(dict, id, corners (4, 2) px, side, ...)], ``found``
    [(tag id, centered corners (4, 2))] of one photo, ``plain`` [(tag id,
    corners (4, 2) px)] of the plain detector on it.  Returns {"missed":
    required tags not found, "foreign": ids found that are not rendered,
    "render": each detection of a required tag's largest corner distance
    (px) to the render, "corners": each of its corners' distance to the
    plain detection of that id nearest it (inf where the plain detector has
    none)}."""
    got, ref = {}, {}
    for tid, crn in found:
        got.setdefault(tid, []).append(np.asarray(crn, float) + center)
    for tid, crn in plain:
        ref.setdefault(tid, []).append(np.asarray(crn, float))
    rendered = {tag_id(n, m) for n, m, *_ in truth}
    missed, render, corners = 0, [], []
    for n, m, crn, side, *_ in truth:
        if side < min_side:
            continue
        tid = tag_id(n, m)
        if tid not in got:
            missed += 1
            continue
        for c in got[tid]:
            render.append(float(np.linalg.norm(c - crn, axis=1).max()))
            gaps = [np.linalg.norm(c - r, axis=1) for r in ref.get(tid, [])]
            corners += (list(min(gaps, key=np.max)) if gaps
                        else [np.inf] * 4)
    foreign = sorted(t for t in got if t not in rendered)
    return {"missed": missed, "foreign": foreign, "render": render,
            "corners": corners}
