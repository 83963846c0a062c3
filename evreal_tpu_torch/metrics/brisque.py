"""BRISQUE, a no-reference metric (``evreal_tpu/metrics/brisque.py``, the
port's own copy; the reference's Table-3 commands reach pyiqa's through
its factory, utils/eval_metrics.py:100-159). Host numpy, bit-equal to the
JAX package's functions on the same frames.

Features: 18 a scale, 2 scales: the GGD (alpha, sigma^2) of the MSCN
coefficients and the AGGD (alpha, mean, l_var, r_var) of the four
directional products over the whole frame, the second scale a 2x average
pool (the original uses MATLAB's bicubic imresize: absolute scores shift
slightly). Score: libsvm's RBF epsilon-SVR on the features scaled to
[-1, 1]. The trained SVR cannot be derived here: ``tools/convert_brisque.py``
writes it as ``weights/brisque_svm.npz`` (or the file
``EVREAL_BRISQUE_PARAMS`` names).
"""

import os

import numpy as np

from evreal_tpu_torch.metrics.niqe import _downsample, mscn, patch_features

DEFAULT_PARAMS = os.path.join(os.path.dirname(__file__), os.pardir,
                              os.pardir, "weights", "brisque_svm.npz")


def params_path():
    return os.environ.get("EVREAL_BRISQUE_PARAMS", DEFAULT_PARAMS)


def load_params(path=None):
    d = np.load(path or params_path())
    return {k: d[k] for k in d.files}


def brisque_features(img):
    """The 36 features of a [0, 1] grayscale frame."""
    img = np.asarray(img, np.float64) * 255.0
    feats = []
    for scale in (1, 2):
        coeff, _ = mscn(img)
        feats += patch_features(coeff)  # the whole frame as one patch
        if scale == 1:
            # odd sides (BS-ERGB's 625 x 970) lose their last row/column
            img = _downsample(img[: img.shape[0] // 2 * 2,
                                  : img.shape[1] // 2 * 2])
    return np.asarray(feats, np.float64)


def svr_score(feats, params):
    """libsvm RBF epsilon-SVR decision value of one feature vector."""
    lo, hi = params["scale_min"], params["scale_max"]
    x = -1.0 + 2.0 * (feats - lo) / (hi - lo)
    d = params["sv"] - x  # (n_sv, 36)
    k = np.exp(-params["gamma"] * np.sum(d * d, axis=1))
    return float(params["sv_coef"] @ k - params["rho"])


def brisque(img, params):
    return svr_score(brisque_features(img), params)


def make_spec(path):
    """The host metric over the SVR at ``path``."""
    from evreal_tpu_torch.metrics.registry import (MetricSpec,
                                                   make_host_nr_metric)

    params = load_params(path)
    return MetricSpec("brisque", make_host_nr_metric(
        "brisque", lambda im: brisque(im, params)), no_ref=True, host=True)
