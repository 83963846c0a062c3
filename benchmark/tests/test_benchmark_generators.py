"""The generators: deterministic by seed, and the ``ecd_std`` sizes and
rates are those of its mix file."""

import numpy as np
import torch

from benchmark.lib import scene
from benchmark.lib.spec import ROOT, Spec, read_json
from benchmark.lib.weights import draw, lpips_weights
from benchmark.reference import events
from benchmark.reference.models import param_shapes

SCENE = {"blobs": 3, "sigma_px": [4.0, 8.0], "period_s": 2.0}


def test_scene_deterministic_by_seed():
    a = scene.make_scene(SCENE, 4, 500, 25, 32, 48, "cpu", 2 ** 31 + 5, 0)
    b = scene.make_scene(SCENE, 4, 500, 25, 32, 48, "cpu", 2 ** 31 + 5, 0)
    c = scene.make_scene(SCENE, 4, 500, 25, 32, 48, "cpu", 2 ** 31 + 6, 0)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["events_xy"], c["events_xy"])
    assert a["events_ts"].dtype == np.float64
    assert a["events_xy"].dtype == np.int16
    assert a["events_p"].dtype == np.uint8
    assert np.all(np.diff(a["events_ts"]) >= 0)
    assert a["events_xy"][:, 0].max() < 48 and a["events_xy"][:, 1].max() < 32


def test_weights_deterministic_by_seed():
    cfg = read_json(ROOT / "benchmark/configs/firenet_plus.json")
    shapes = param_shapes(cfg)
    a = draw(shapes, cfg["init"], "cpu", 7)
    b = draw(shapes, cfg["init"], "cpu", 7)
    c = draw(shapes, cfg["init"], "cpu", 8)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.conv2d.weight"], c["head.conv2d.weight"])
    assert torch.all(a["pred.conv2d.bias"] == 0.5)
    bound = (5 * 3 * 3) ** -0.5
    assert a["head.conv2d.weight"].abs().max() <= bound
    la, lb = lpips_weights("cpu", 7), lpips_weights("cpu", 7)
    assert all(torch.equal(la[k], lb[k]) for k in la)


def test_ecd_std_sizes_match_the_mix():
    mix = Spec().cell("e2vid.ecd_std")[3]
    assert [s["windows"] for s in mix["sequences"]] == [128, 128, 128, 60,
                                                        128, 128, 13]
    # two sequences at the real sizes and rates, the rest share the code
    for i in (1, 6):
        s = mix["sequences"][i]
        seq = scene.make_scene(mix["scene"], s["windows"],
                               s["events_per_interval"], mix["fps"],
                               mix["height"], mix["width"], "cpu", 3, i)
        wins = events.windows(seq, {"method": "between_frames"})
        assert len(wins) == s["windows"]
        counts = [b - a for a, b, _, _ in wins]
        assert counts[0] == 0
        assert abs(np.median(counts[1:]) - s["events_per_interval"]) <= 1
        assert seq["images"].shape == (s["windows"] + 1, mix["height"],
                                       mix["width"])


def test_percentile_is_numpys_linear_rule():
    from benchmark.lib.stats import percentile

    rng = np.random.default_rng(1)
    for n in (1, 2, 7, 1000):
        xs = rng.normal(size=n).tolist()
        for q in (0, 5, 50, 95, 100):
            assert percentile(xs, q) == np.float64(np.percentile(xs, q)) \
                or abs(percentile(xs, q) - np.percentile(xs, q)) < 1e-12
