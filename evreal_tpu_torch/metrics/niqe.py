"""NIQE, the no-reference naturalness metric (``evreal_tpu/metrics/niqe.py``,
the port's own copy; Mittal et al. 2013, as in the MATLAB release and
pyiqa's port, which the reference exposes through its pyiqa factory,
utils/eval_metrics.py:100-159). Host numpy and scipy, bit-equal to the JAX
package's functions on the same frames.

  1. MSCN coefficients: (I - mu) / (sigma + 1) with a 7x7 Gaussian
     (sigma = 7/6) local mean and deviation, at two scales (the frame and
     its 2x downsample).
  2. Per 96x96 patch: a GGD fit of the MSCN coefficients (2 features) and
     AGGD fits of the four pairwise products H/V/D1/D2 (4 features each):
     18 features a scale.
  3. Patches selected by first-scale sharpness > 0.75 * its peak.
  4. Quality = sqrt((mu_p - mu_d)^T ((S_p + S_d) / 2)^-1 (mu_p - mu_d))
     against the pristine multivariate Gaussian model.

The pristine model (mu 1x36, cov 36x36) ships with the original release
and cannot be derived here: ``tools/convert_niqe.py`` writes it as
``weights/niqe_params.npz`` (or the file ``EVREAL_NIQE_PARAMS`` names).
Frames are (H, W) grayscale in [0, 1].
"""

import os
import warnings

import numpy as np
from scipy.ndimage import correlate1d
from scipy.special import gamma as _gamma

DEFAULT_PARAMS = os.path.join(os.path.dirname(__file__), os.pardir,
                              os.pardir, "weights", "niqe_params.npz")

_GAMMA_RANGE = np.arange(0.2, 10.001, 0.001)
_R_GAM = None


def params_path():
    return os.environ.get("EVREAL_NIQE_PARAMS", DEFAULT_PARAMS)


def load_params(path=None):
    data = np.load(path or params_path())
    return data["mu"].reshape(-1), data["cov"]


def _r_gam():
    global _R_GAM
    if _R_GAM is None:
        g = _GAMMA_RANGE
        _R_GAM = (_gamma(2.0 / g) ** 2) / (_gamma(1.0 / g) * _gamma(3.0 / g))
    return _R_GAM


def estimate_ggd(vec):
    """Generalized Gaussian fit -> (alpha, sigma^2) by moment matching."""
    sigma_sq = np.mean(vec ** 2)
    e = np.mean(np.abs(vec))
    rho = sigma_sq / (e ** 2 + 1e-12)
    diff = np.abs(rho - 1.0 / _r_gam())
    alpha = _GAMMA_RANGE[np.argmin(diff)]
    return alpha, sigma_sq


def estimate_aggd(vec):
    """Asymmetric GGD fit -> (alpha, mean, sigma_l^2, sigma_r^2)."""
    left = vec[vec < 0]
    right = vec[vec > 0]
    sigma_l = np.sqrt(np.mean(left ** 2)) if left.size else 0.0
    sigma_r = np.sqrt(np.mean(right ** 2)) if right.size else 0.0
    gamma_hat = sigma_l / sigma_r if sigma_r > 0 else np.inf
    e = np.mean(np.abs(vec))
    rhat = (e ** 2) / np.mean(vec ** 2) if np.mean(vec ** 2) > 0 else 0.0
    rhat_norm = (rhat * (gamma_hat ** 3 + 1) * (gamma_hat + 1)
                 / ((gamma_hat ** 2 + 1) ** 2)) if np.isfinite(gamma_hat) \
        else rhat
    g = _GAMMA_RANGE
    diff = (_r_gam() - rhat_norm) ** 2
    alpha = g[np.argmin(diff)]
    const = np.sqrt(_gamma(1.0 / alpha) / _gamma(3.0 / alpha))
    mean = (sigma_r - sigma_l) * (_gamma(2.0 / alpha) / _gamma(1.0 / alpha)) \
        * const
    return alpha, mean, sigma_l ** 2, sigma_r ** 2


def _gaussian_window(size=7, sigma=7.0 / 6.0):
    x = np.arange(size) - size // 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def mscn(img, eps=1.0):
    """Mean-subtracted contrast-normalized coefficients and the local
    deviation."""
    k = _gaussian_window()

    def f(a):
        return correlate1d(correlate1d(a, k, axis=0, mode="nearest"), k,
                           axis=1, mode="nearest")

    mu = f(img)
    sigma = np.sqrt(np.abs(f(img * img) - mu * mu))
    return (img - mu) / (sigma + eps), sigma


def patch_features(patch):
    """The 18 features of one patch: GGD of the coefficients, AGGD of the
    four directional products."""
    feats = list(estimate_ggd(patch.ravel()))
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):  # H, V, D1, D2
        shifted = np.roll(np.roll(patch, dy, axis=0), dx, axis=1)
        feats += list(estimate_aggd((patch * shifted).ravel()))
    return feats


def _downsample(img):
    """2x average pooling (the MATLAB imresize approximation)."""
    return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                   + img[0::2, 1::2] + img[1::2, 1::2])


def niqe_features(img, patch_size=96, sharpness_thresh=0.75):
    """The 36 features of each selected patch of a [0, 1] frame."""
    img = np.asarray(img, np.float64) * 255.0
    h, w = img.shape
    n_ph, n_pw = h // patch_size, w // patch_size
    img = img[: n_ph * patch_size, : n_pw * patch_size]
    if n_ph == 0 or n_pw == 0:
        raise ValueError(f"image {h}x{w} smaller than NIQE patch "
                         f"{patch_size}")
    feats_all = []
    sharpness = None
    for scale in (1, 2):
        coeff, sigma = mscn(img)
        ps = patch_size // scale
        feats_scale, sharp_scale = [], []
        for py in range(n_ph):
            for px in range(n_pw):
                cell = (slice(py * ps, (py + 1) * ps),
                        slice(px * ps, (px + 1) * ps))
                feats_scale.append(patch_features(coeff[cell]))
                if scale == 1:  # only the first scale selects patches
                    sharp_scale.append(sigma[cell].mean())
        feats_all.append(np.array(feats_scale))
        if scale == 1:
            sharpness = np.array(sharp_scale)
            img = _downsample(img)  # between the scales only
    select = sharpness > sharpness_thresh * sharpness.max()
    if not np.any(select):
        select = np.ones_like(sharpness, bool)
    return np.concatenate([f[select] for f in feats_all], axis=1)


def niqe(img, mu_pris, cov_pris):
    feats = niqe_features(img)
    # MATLAB/pyiqa pair nanmean with NANCOV (complete rows only): a frame
    # with a few NaN patches is scored from its valid patches
    valid = feats[~np.isnan(feats).any(axis=1)]
    if valid.shape[0] < 2:
        # no sample covariance below two complete rows: NaN, which the
        # tracker drops (reference semantics, utils/eval_metrics.py:51)
        return float("nan")
    with warnings.catch_warnings():
        # an all-NaN feature column makes nanmean warn on its way to the
        # NaN result the tracker drops
        warnings.simplefilter("ignore", RuntimeWarning)
        mu_d = np.nanmean(feats, axis=0)
        cov_d = np.cov(valid, rowvar=False)
    pooled = (cov_pris + cov_d) / 2.0
    d = mu_pris - mu_d
    inv = np.linalg.pinv(pooled)
    return float(np.sqrt(max(d @ inv @ d, 0.0)))


def make_spec(path):
    """The host metric over the pristine model at ``path``; frames under
    96 px a side fail validation (``min_side``)."""
    from evreal_tpu_torch.metrics.registry import (MetricSpec,
                                                   make_host_nr_metric)

    mu, cov = load_params(path)
    return MetricSpec("niqe", make_host_nr_metric(
        "niqe", lambda im: niqe(im, mu, cov), min_side=96), no_ref=True,
        host=True)
