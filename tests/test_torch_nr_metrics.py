"""The port's host no-reference metrics (``evreal_tpu_torch/metrics/
niqe.py``, ``brisque.py`` and the registry's host wrapper) against the JAX
package's on the CPU. NIQE and BRISQUE are held bit-equal to the JAX
functions on the same frames (their alpha is an argmin over a 0.001 grid,
so any drift would move a score by a step): with synthetic pristine
statistics and a hand-built SVR, as ``tests/test_niqe.py`` and
``tests/test_brisque.py`` make them. Then the wrapper's rules: a failing
frame scores NaN with one message, ``min_side`` raises before any frame,
and NIQE's nancov rule for a partly-NaN frame (``tests/test_niqe.py:147``).
"""

import numpy as np
import pytest
import torch

from evreal_tpu.metrics import brisque as jb
from evreal_tpu.metrics import niqe as jn
from evreal_tpu_torch.metrics import brisque as tb
from evreal_tpu_torch.metrics import niqe as tn
from evreal_tpu_torch.metrics import registry

torch.set_num_threads(1)


def smooth(seed, hw):
    """A smooth natural-looking frame with a little noise."""
    from scipy.ndimage import gaussian_filter

    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float64)
    img = 0.5 + 0.3 * np.sin(xx / (8 + seed % 5)) * np.cos(yy / 11)
    img += r.normal(0, 0.01, img.shape)
    return np.clip(gaussian_filter(img, 1.0), 0, 1).astype(np.float32)


def pristine(seed=7):
    """Synthetic pristine statistics (mu 36, cov 36 x 36)."""
    feats = np.random.default_rng(seed).normal(0, 1, (80, 36))
    return feats.mean(0), np.cov(feats.T)


def svr(seed=3, n_sv=5):
    rng = np.random.default_rng(seed)
    return {"sv": rng.normal(0, 1, (n_sv, 36)),
            "sv_coef": rng.normal(0, 1, n_sv),
            "gamma": np.float64(0.05), "rho": np.float64(-0.3),
            "scale_min": np.full(36, -2.0), "scale_max": np.full(36, 2.0)}


FRAMES = {"random 192x288": lambda: np.random.default_rng(0).random(
              (192, 288)).astype(np.float32),
          "smooth 180x240": lambda: smooth(1, (180, 240)),
          "smooth 97x195": lambda: smooth(2, (97, 195))}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_niqe_bit_equal_to_jax(name):
    img = FRAMES[name]()
    mu, cov = pristine()
    np.testing.assert_array_equal(tn.niqe_features(img),
                                  jn.niqe_features(img))
    assert tn.niqe(img, mu, cov) == jn.niqe(img, mu, cov)


@pytest.mark.parametrize("name", sorted(FRAMES) + ["odd 97x131"])
def test_brisque_bit_equal_to_jax(name):
    img = (FRAMES[name]() if name in FRAMES
           else np.random.default_rng(4).random((97, 131)).astype(np.float32))
    np.testing.assert_array_equal(tb.brisque_features(img),
                                  jb.brisque_features(img))
    params = svr()
    assert tb.brisque(img, params) == jb.brisque(img, params)


def test_fits_bit_equal_to_jax():
    rng = np.random.default_rng(5)
    for vec in (rng.normal(0, 2.0, 5000), rng.laplace(0, 1.0, 5000),
                np.concatenate([-np.abs(rng.normal(0, 0.5, 3000)),
                                np.abs(rng.normal(0, 2.0, 3000))]),
                np.zeros(100)):
        assert tn.estimate_ggd(vec) == jn.estimate_ggd(vec)
        assert tn.estimate_aggd(vec) == jn.estimate_aggd(vec)


def test_partly_nan_frame_scores_from_valid_patches():
    """The nancov rule: a frame with NaN patches is scored from its
    complete feature rows (tests/test_niqe.py:147), as in the JAX
    package."""
    img = np.random.default_rng(0).uniform(0.2, 0.8, (288, 288)).astype(
        np.float32)
    img[4:92, 4:92] = np.nan
    feats = tn.niqe_features(img)
    nan_rows = np.isnan(feats).any(axis=1)
    assert nan_rows.any() and (~nan_rows).sum() >= 2
    mu, cov = np.zeros(36), np.eye(36)
    score = tn.niqe(img, mu, cov)
    assert np.isfinite(score) and score == jn.niqe(img, mu, cov)
    # fewer than two complete rows: NaN (dropped by the tracker)
    assert np.isnan(tn.niqe(np.full((96, 96), np.nan, np.float32), mu, cov))


def test_failing_frame_scores_nan_with_one_message(capsys):
    calls = []

    def score(im):
        calls.append(im.shape)
        if im[0, 0] < 0:
            raise ValueError("bad frame")
        return float(im.mean())

    fn = registry.make_host_nr_metric("demo", score)
    imgs = np.full((4, 8, 8), 0.5, np.float32)
    imgs[1, 0, 0] = imgs[3, 0, 0] = -1
    out = fn(imgs)
    assert out.dtype == np.float32 and out.shape == (4,)
    assert np.isnan(out[[1, 3]]).all() and np.isfinite(out[[0, 2]]).all()
    assert capsys.readouterr().out == \
        "demo failed on a frame (bad frame); scoring NaN\n"
    assert len(calls) == 4


def test_min_side_raises_before_any_frame():
    calls = []
    fn = registry.make_host_nr_metric("niqe", calls.append, min_side=96)
    with pytest.raises(ValueError, match="96 px"):
        fn(np.zeros((3, 64, 200), np.float32))
    with pytest.raises(ValueError, match="96 px"):
        fn(np.zeros((0, 95, 200), np.float32))
    assert calls == []


def test_registry_gates_and_scores_as_jax(tmp_path, monkeypatch):
    """Both metrics through EVREAL_NIQE_PARAMS / EVREAL_BRISQUE_PARAMS:
    host no-reference specs whose per-frame scores equal the JAX
    registry's (its pure_callback, vmapped as its runner does)."""
    import jax

    from evreal_tpu.metrics import registry as jreg

    mu, cov = pristine()
    np.savez(tmp_path / "niqe_params.npz", mu=mu, cov=cov)
    np.savez(tmp_path / "brisque_svm.npz", **svr())
    monkeypatch.setenv("EVREAL_NIQE_PARAMS", str(tmp_path / "niqe_params.npz"))
    monkeypatch.setenv("EVREAL_BRISQUE_PARAMS",
                       str(tmp_path / "brisque_svm.npz"))
    specs = registry.resolve(["niqe", "BRISQUE"])
    assert [(s.name, s.no_ref, s.host) for s in specs] == \
        [("niqe", True, True), ("brisque", True, True)]
    imgs = np.stack([smooth(8, (96, 192)),
                     np.full((96, 192), np.nan, np.float32)])
    monkeypatch.setattr(jreg, "_REGISTRY", {})
    monkeypatch.setattr(jreg, "_builtins_done", False)
    for spec, jspec in zip(specs, jreg.resolve(["niqe", "brisque"])):
        got = spec.score(imgs)
        want = np.asarray(jax.vmap(jspec.fn)(imgs))
        np.testing.assert_array_equal(got, want)
        assert np.isfinite(got[0])
