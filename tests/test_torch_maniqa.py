"""The port's MANIQA (``evreal_tpu_torch/metrics/maniqa.py``) against the
JAX package's (``evreal_tpu/metrics/maniqa.py``) on the CPU, with random
weights at the small structural widths of ``tests/test_maniqa.py:16-22``
(ViT 24 wide with 12 heads and 10 blocks, features at blocks 6-9, a 28 x 28
token grid, Swin 8 and 4 wide with 4 heads, depths [2, 2], window 4):
scores within 2e-4 (the JAX test's own bound against its torch oracle), on
crops and through the whole metric at ECD's 180 x 240 and an odd 181 x 239
(bilinear upscale, seeded crops); the upscale itself against
``jax.image.resize``; serial scoring equal to one frame at a time; and a
bad ``EVREAL_MANIQA_CROPS`` dropped with the JAX package's message."""

import numpy as np
import pytest
import torch

from evreal_tpu.metrics import maniqa as jm
from evreal_tpu_torch.harness.runner import (
    MethodRunner,
    score_batch,
    usable_metrics,
)
from evreal_tpu_torch.metrics import maniqa as tm
from evreal_tpu_torch.metrics import registry
from evreal_tpu_torch.models import build_model

torch.set_num_threads(1)

TOL = 2e-4  # tests/test_maniqa.py's bound against its torch oracle
WS = 4
SMALL = dict(vit_dim=24, vit_blocks=10, swin_dims=(8, 4), dim_mlp=16,
             depths=(2, 2), heads=4, window=WS)


@pytest.fixture(scope="module")
def weights():
    """(numpy weights with their _meta entries, port tensors, JAX
    arrays)."""
    import jax.numpy as jnp

    raw = tm.random_params(0, **SMALL)
    arrays = {k: v for k, v in raw.items() if not k.startswith("_meta")}
    return (raw, {k: torch.from_numpy(v) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()})


def test_crop_scores_match_jax(weights):
    import jax.numpy as jnp

    _, tp, jp = weights
    x = np.random.default_rng(1).normal(size=(2, 3, 224, 224)).astype(
        np.float32)
    got = tm.maniqa_scores(tp, torch.from_numpy(x), window_size=WS).numpy()
    want = np.asarray(jm.maniqa_scores(jp, jnp.asarray(x.transpose(
        0, 2, 3, 1)), window_size=WS))
    assert np.isfinite(want).all() and np.ptp(want) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    other = tm.maniqa_scores(tp, torch.from_numpy(x), window_size=WS,
                             scale=0.2).numpy()
    assert np.abs(other - got).max() > 0  # the scaled residuals matter


@pytest.mark.parametrize("hw", [(180, 240), (181, 239), (240, 250)])
def test_full_metric_matches_jax(weights, hw):
    import jax.numpy as jnp

    _, tp, jp = weights
    img = np.random.default_rng(hw[1]).uniform(size=hw).astype(np.float32)
    got = float(tm.maniqa(tp, torch.from_numpy(img), n_crops=3,
                          window_size=WS))
    want = float(jm.maniqa(jp, jnp.asarray(img), n_crops=3, window_size=WS))
    assert np.isfinite(want)
    assert abs(got - want) <= TOL, (got, want)


@pytest.mark.parametrize("hw", [(180, 240), (181, 239)])
def test_upscale_matches_jax_resize(hw):
    """F.interpolate(bilinear, align_corners=False, no antialias) against
    jax.image.resize(bilinear) on the upscale the metric makes."""
    import jax
    import jax.numpy as jnp

    img = np.random.default_rng(7).uniform(size=hw).astype(np.float32)
    s = max(tm.CROP / hw[0], tm.CROP / hw[1])
    out = (max(int(round(hw[0] * s)), tm.CROP),
           max(int(round(hw[1] * s)), tm.CROP))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(img)[None, None], size=out, mode="bilinear",
        align_corners=False, antialias=False)[0, 0].numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(img), out, "bilinear"))
    assert got.shape == want.shape == out
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture
def spec(tmp_path, monkeypatch, weights):
    raw, _, _ = weights
    path = tmp_path / "maniqa.npz"
    np.savez(path, **raw)
    monkeypatch.setenv("EVREAL_MANIQA_PARAMS", str(path))
    monkeypatch.setenv("EVREAL_MANIQA_CROPS", "2")
    (s,) = registry.resolve(["MANIQA"])
    return s


def test_serial_equals_one_at_a_time(spec, weights):
    _, tp, _ = weights
    assert spec.no_ref and spec.serial and not spec.host
    frames = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(3, 180, 240)).astype(np.float32))
    got = score_batch(spec, [frames])
    solo = torch.stack([tm.maniqa(tp, f, n_crops=2, window_size=WS)
                        for f in frames])
    assert got.shape == (3,) and torch.isfinite(got).all()
    assert torch.equal(got, solo)
    assert spec.loaded("cpu")["_meta_window"] == WS
    assert spec.loaded("cpu")["_meta_scale"] == pytest.approx(0.8)


def tiny_runner(hw):
    model = build_model("FireNet", {"num_bins": 5, "base_num_channels": 4,
                                    "kernel_size": 3})
    return MethodRunner(model, event_norm=False, post_norm="none",
                        height=hw[0], width=hw[1], num_bins=5, device="cpu")


@pytest.mark.parametrize("bad", ["twenty", "0"])
def test_bad_crops_env_drops_the_metric(spec, monkeypatch, capsys, bad):
    """Checked at the first call (validation at the frame shape), dropped
    with the message the JAX package prints, and the other metrics go on."""
    from evreal_tpu.harness.runner import validate_metric_specs
    from evreal_tpu.metrics import registry as jreg

    monkeypatch.setenv("EVREAL_MANIQA_CROPS", bad)
    mse = registry.resolve(["mse"])
    assert usable_metrics(tiny_runner((180, 240)), mse + [spec]) == mse
    got = capsys.readouterr().out
    assert "metric maniqa failed at (180, 240): EVREAL_MANIQA_CROPS" in got
    monkeypatch.setattr(jreg, "_REGISTRY", {})
    assert jm.register_if_available()
    assert validate_metric_specs({}, [jreg._REGISTRY["maniqa"]],
                                 (180, 240)) == []
    assert got == capsys.readouterr().out
