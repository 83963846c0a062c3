"""The port's ops (evreal_tpu_torch/ops) against the JAX package's:
normalize_event_tensor, CropParams, the four post-norms, and exact
percentiles — bit-exact, including NaN, infinities and signed zeros."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evreal_tpu.ops.normalize import normalize_event_tensor as j_norm
from evreal_tpu.ops.normalize import post_process_normalization as j_post
from evreal_tpu.ops.pad import CropParams as JCrop
from evreal_tpu.ops.percentile import order_stats as j_order_stats
from evreal_tpu.ops.percentile import percentiles as j_percentiles
from evreal_tpu_torch.ops.normalize import (
    normalize_event_tensor,
    post_process_normalization,
)
from evreal_tpu_torch.ops.pad import CropParams
from evreal_tpu_torch.ops.percentile import order_stats, percentiles

torch.set_num_threads(1)


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def sparse_voxel(rng, n, b=5, h=20, w=28, density=0.2):
    v = rng.normal(size=(n, b, h, w)).astype(np.float32)
    return v * (rng.uniform(size=v.shape) < density)


def test_normalize_event_tensor_matches_jax():
    rng = np.random.default_rng(0)
    vox = sparse_voxel(rng, 3)
    vox[1] = 0.0  # all zero: passes through
    vox[2][vox[2] != 0] = 0.75  # equal nonzero values: variance clamp
    got = normalize_event_tensor(torch.from_numpy(vox)).numpy()
    for i in range(3):
        want = np.asarray(j_norm(vox[i].transpose(1, 2, 0)))
        np.testing.assert_allclose(got[i], want.transpose(2, 0, 1),
                                   atol=1e-5, rtol=1e-5)
    assert np.isfinite(got).all()
    assert not got[1].any()


@pytest.mark.parametrize("h,w,enc", [(180, 240, 3), (37, 53, 3), (64, 64, 4),
                                     (31, 17, 0), (260, 346, 2)])
def test_crop_params_match_jax(h, w, enc):
    tc, jc = CropParams(w, h, enc), JCrop(w, h, enc)
    assert tc.padded_shape == jc.padded_shape
    x = np.random.default_rng(1).normal(size=(2, 3, h, w)).astype(np.float32)
    padded = tc.pad(torch.from_numpy(x)).numpy()
    want = np.asarray(jc.pad(x.transpose(0, 2, 3, 1))).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(padded, want)
    cropped = tc.crop(torch.from_numpy(padded)).numpy()
    np.testing.assert_array_equal(cropped, x)


@pytest.mark.parametrize("norm", ["none", "robust", "standard", "exprobust"])
def test_post_norms_match_jax(norm):
    """Bit-exact, except that exprobust's exp() is a different
    implementation in each library (1-ulp differences before the norm)."""
    rng = np.random.default_rng(2)
    imgs = rng.normal(0.3, 0.2, (3, 23, 31)).astype(np.float32)
    got = post_process_normalization(torch.from_numpy(imgs), norm).numpy()
    for i in range(3):
        want = np.asarray(j_post(jnp.asarray(imgs[i]), norm))
        if norm == "exprobust":
            np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(bits(got[i]), bits(want))


def test_post_norm_rejects_unknown_name():
    with pytest.raises(ValueError, match="Unrecognized"):
        post_process_normalization(torch.zeros(1, 4, 4), "bogus")


CASES = {
    "uniform": lambda rng: rng.uniform(-3, 7, 4096),
    "normal": lambda rng: rng.normal(size=999),
    "heavy ties": lambda rng: rng.integers(0, 5, 2048),
    "signed zeros": lambda rng: rng.choice([-0.0, 0.0, 1.0, -1.0], 777),
    "infinities": lambda rng: np.concatenate(
        [rng.normal(size=500), [np.inf] * 7, [-np.inf] * 9]),
    "nan": lambda rng: np.concatenate([rng.normal(size=200), [np.nan]]),
    "all inf": lambda rng: np.full(101, np.inf),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("qs", [(1, 99), (0, 100), (50,), (2.5, 37, 99.9)])
def test_percentiles_bitexact_vs_jax(name, qs):
    x = CASES[name](np.random.default_rng(3)).astype(np.float32)
    got = percentiles(torch.from_numpy(x), qs).numpy()
    want = np.asarray(j_percentiles(jnp.asarray(x), qs))
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("qs", [(1, 99), (0, 100), (2.5, 37, 99.9)])
def test_percentiles_subnormals(qs):
    """Order statistics stay bit-exact; XLA's f32 lerp flushes subnormal
    results to zero where torch keeps them, so a subnormal result counts
    as equal to zero (the rule of tests/test_percentile.py)."""
    x = np.random.default_rng(6).choice(
        np.array([1e-40, -1e-40, 3e-39, 0.0, -0.0, 1.0], np.float32), 333)
    got = percentiles(torch.from_numpy(x), qs).numpy()
    want = np.asarray(j_percentiles(jnp.asarray(x), qs))
    tiny = np.finfo(np.float32).tiny
    flush = lambda a: np.where(np.abs(a) < tiny, np.float32(0), a)  # noqa: E731
    np.testing.assert_array_equal(flush(got), flush(want))
    stats = order_stats(torch.from_numpy(x), (0, 100, 332)).numpy()
    np.testing.assert_array_equal(
        bits(stats), bits(np.asarray(j_order_stats(jnp.asarray(x),
                                                   (0, 100, 332)))))


def test_percentiles_batched_rows_are_independent():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 640)).astype(np.float32)
    x[2, 7] = np.nan
    got = percentiles(torch.from_numpy(x), (1, 99)).numpy()
    for i in range(4):
        want = np.asarray(j_percentiles(jnp.asarray(x[i]), (1, 99)))
        np.testing.assert_array_equal(bits(got[i]), bits(want))
    assert np.isnan(got[2]).all() and np.isfinite(got[[0, 1, 3]]).all()


def test_order_stats_match_sort_bitwise():
    rng = np.random.default_rng(5)
    x = rng.choice(np.array([-0.0, 0.0, -np.inf, np.inf, 1e-40, -2.5, 3.0],
                            np.float32), 1000)
    ks = (0, 1, 250, 500, 998, 999)
    got = order_stats(torch.from_numpy(x), ks).numpy()
    # the total order: -inf < ... < -0.0 < +0.0 < subnormals < ... < +inf
    want = np.asarray(j_order_stats(jnp.asarray(x), ks))
    np.testing.assert_array_equal(bits(got), bits(want))
    order = np.array([-np.inf, -2.5, -0.0, 0.0, 1e-40, 3.0, np.inf],
                     np.float32)
    n = {v: int((bits(x) == bits(np.float32(v))).sum()) for v in order}
    expect = np.repeat(order, [n[v] for v in order])
    np.testing.assert_array_equal(bits(got), bits(expect[list(ks)]))
