"""LPIPS with the AlexNet backbone (``evreal_tpu/metrics/lpips.py``; the
reference pulls it in through pyiqa, utils/eval_metrics.py:100-159),
batched over a chunk's frames.

Scaling layer -> AlexNet convolutions (taps after each of the five ReLUs,
widths 64/192/384/256/256) -> unit normalization over channels ->
squared difference -> the learned 1x1 ``lin`` heads -> spatial mean -> sum
over taps. Frames are (N, H, W) grayscale in [0, 1], repeated to three
channels and mapped to [-1, 1] (pyiqa calls LPIPS with normalize=True).

The pretrained weights cannot be derived here: ``tools/convert_lpips.py``
writes them as ``weights/lpips_alex.npz`` (or the file that
``EVREAL_LPIPS_WEIGHTS`` names) in the JAX layout, where every 4-D array,
the ``lin`` heads included, is HWIO; ``load_weights`` turns them to OIHW.
Without the file the registry skips the metric with its message.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), os.pardir,
                               os.pardir, "weights", "lpips_alex.npz")

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# (name, stride, pad, max-pool before)
_ALEX_CFG = (
    ("features.0", 4, 2, False),   # conv1 11x11/4
    ("features.3", 1, 2, True),    # conv2 5x5
    ("features.6", 1, 1, True),    # conv3 3x3
    ("features.8", 1, 1, False),   # conv4 3x3
    ("features.10", 1, 1, False),  # conv5 3x3
)


def params_path():
    return os.environ.get("EVREAL_LPIPS_WEIGHTS", DEFAULT_WEIGHTS)


def load_weights(path=None):
    """{name: numpy array} of the ``.npz`` at ``path`` (default
    ``params_path()``), 4-D arrays turned from HWIO to OIHW."""
    data = np.load(path or params_path())
    return {k: (np.ascontiguousarray(data[k].transpose(3, 2, 0, 1))
                if data[k].ndim == 4 else data[k]) for k in data.files}


def _alex_features(w, x):
    taps = []
    for name, stride, pad, pool_before in _ALEX_CFG:
        if pool_before:
            # MaxPool2d(3, 2), floor mode: VALID reduce_window in JAX
            x = F.max_pool2d(x, 3, 2)
        x = F.relu(F.conv2d(x, w[f"{name}.weight"], w[f"{name}.bias"],
                            stride=stride, padding=pad))
        taps.append(x)
    return taps


def lpips(w, imgs, refs):
    """LPIPS distances (N,) of (N, H, W) frames against references; both
    go through AlexNet as one batch of 2N, in f32 (float64 frames, with
    float64 weights, stay float64: a reference for the f32 gradient)."""
    n = imgs.shape[0]
    x = torch.cat([imgs, refs])
    x = x.to(torch.promote_types(x.dtype, torch.float32))[:, None]
    x = x.expand(-1, 3, -1, -1) * 2.0 - 1.0
    shift = torch.tensor(_SHIFT, device=x.device, dtype=x.dtype).view(
        1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device, dtype=x.dtype).view(
        1, 3, 1, 1)
    total = 0.0
    for i, tap in enumerate(_alex_features(w, (x - shift) / scale)):
        tap = tap / (torch.sqrt((tap * tap).sum(dim=1, keepdim=True))
                     + 1e-10)
        d = tap[:n] - tap[n:]
        total = total + F.conv2d(d * d, w[f"lin.{i}.weight"]).mean(
            dim=(1, 2, 3))
    return total


def make_spec(path):
    from evreal_tpu_torch.metrics.registry import MetricSpec

    return MetricSpec("lpips", lpips, params=lambda: load_weights(path))
