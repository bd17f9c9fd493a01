"""The yardstick's arithmetic: the detection stage's least times, the idle
share, the reference's Jacobians and precisions, and the inputs' seeds."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.reference import geometry as G
from benchmark.scenes import room as R
from benchmark.scenes.synthetic import synthetic_map
from benchmark.trace import gaps, union_length

torch.set_num_threads(1)


# PERF.md's kernel table, "bound" column: (role, n, h, w, ms)
BOUNDS = [("threshold", 8, 768, 1020, 0.0033),
          ("threshold", 8, 3024, 4032, 0.0510),
          ("fields", 8, 768, 1020, 0.0748),
          ("fields", 8, 3024, 4032, 1.165),
          ("components", 8, 768, 1020, 0.0070),
          ("components", 8, 3024, 4032, 0.1092),
          ("extraction", 8, 768, 1020, 0.0056),
          ("extraction", 8, 3024, 4032, 0.0874)]


@pytest.mark.parametrize("role,n,h,w,ms", BOUNDS)
def test_detect_roles_reproduce_the_kernel_table(role, n, h, w, ms):
    got = roofline.detect_roles(n, h, w)[role]
    assert round(got, 4 if ms < 1 else 3) == ms


def test_idle_counts_overlapping_streams_once():
    stream_a = [(0.0, 4.0), (6.0, 8.0)]
    stream_b = [(2.0, 5.0), (7.0, 9.0)]
    assert union_length(stream_a + stream_b) == 8.0  # [0, 5] and [6, 9]
    assert sum(e - s for s, e in stream_a + stream_b) == 11.0
    assert gaps(stream_a + stream_b, 0.0, 10.0) == [(5.0, 6.0), (9.0, 10.0)]


def test_jacobians_match_finite_differences():
    g = torch.Generator().manual_seed(3)
    b = 5
    caps = torch.randn(b, 6, generator=g, dtype=torch.float64) * 0.3
    caps[:, 2] -= 2.0
    tags = torch.randn(b, 6, generator=g, dtype=torch.float64) * 0.3
    caps[0, 3:6] = 1e-9  # the series branch
    f = torch.tensor(900.0, dtype=torch.float64)
    _, _, j_f, j_c, j_t = G.project(f, caps, tags, 0.0635, jacobians=True)

    def fd(fn, x, eps=1e-6):
        cols = []
        for i in range(x.shape[-1]):
            d = torch.zeros_like(x)
            d[:, i] = eps
            cols.append((fn(x + d) - fn(x - d)).reshape(b, 8) / (2 * eps))
        return torch.stack(cols, -1)

    jc = fd(lambda c: G.project(f, c, tags, 0.0635), caps)
    jt = fd(lambda t: G.project(f, caps, t, 0.0635), tags)
    jf = (G.project(f + 1e-3, caps, tags, 0.0635)
          - G.project(f - 1e-3, caps, tags, 0.0635)).reshape(b, 8, 1) / 2e-3
    for got, want in ((j_c, jc), (j_t, jt), (j_f, jf)):
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-5)


def test_rounded_precisions():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 3 * 2 ** -11, -3.14159265],
                     dtype=torch.float32)
    tf = G.rounded(x, "tf32")
    assert tf[0] == 1.0 and tf[1] == 1.0 + 4 * 2 ** -11
    assert torch.equal(G.rounded(x, "bf16"),
                       x.to(torch.bfloat16).to(torch.float32))
    assert G.rounded(x, "f32") is x


def test_room_inputs_repeat_for_a_seed():
    def scene(noise_seed):
        return R.room(0, 4, 320, 240, 300.0, 0.0635, noise_seed=noise_seed)
    a, b, c = scene(2 ** 31 + 11), scene(2 ** 31 + 11), scene(2 ** 31 + 12)
    assert np.array_equal(R.render(a, 1), R.render(b, 1))
    assert not np.array_equal(R.render(a, 1), R.render(c, 1))
    # the seed draws the noise; the room stays the configuration's
    assert len(R.sightings(a, 1)) > 0
    assert np.array_equal(a.inv_poses, c.inv_poses)


def test_synthetic_inputs_repeat_for_a_seed():
    kw = dict(n_tags=64, n_caps=24, focal=3000.0, image_size=(4000, 3000),
              aruco_size=0.0635, tag_spacing=0.25, height=1.8,
              noise_px=0.3, layout_seed=0, device="cpu")
    a = synthetic_map(noise_seed=2 ** 31 + 5, **kw)
    b = synthetic_map(noise_seed=2 ** 31 + 5, **kw)
    c = synthetic_map(noise_seed=2 ** 31 + 6, **kw)
    assert torch.equal(a["corners"], b["corners"])
    assert torch.equal(a["cap_idx"], c["cap_idx"])  # the layout is fixed
    assert not torch.equal(a["corners"], c["corners"])
    # tags numbered by first sighting, as the map store numbers them
    first = [int(torch.nonzero(a["tag_idx"] == t)[0]) for t in
             range(a["tag_poses"].shape[0])]
    assert first == sorted(first)
