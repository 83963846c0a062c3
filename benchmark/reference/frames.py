"""What follows the network: EVREAL's output normalization, the clip and
the 8-bit frame, and the scores the eval writes (EVREAL
utils/eval_metrics.py): MSE, SSIM as ``skimage.metrics.
structural_similarity(gaussian_weights=True, sigma=1.5,
use_sample_covariance=False, data_range=1.0)`` and LPIPS with the
AlexNet backbone (pyiqa's, ``normalize=True``). Every function takes a
batch of (N, H, W) frames."""

import numpy as np
import torch
import torch.nn.functional as F


def post_norm(img, norm):
    """``none``, or ``robust``: ``(img - p1) / (p99 - p1)`` per frame with
    numpy's linear percentiles, computed in float64. Returns the frames and
    each frame's stretch ``p99 - p1`` (infinite without a post-norm)."""
    if norm in (None, "none"):
        return img, torch.full((img.shape[0],), float("inf"))
    if norm != "robust":
        raise ValueError(f"post-norm {norm!r} is not referenced")
    flat = img.reshape(img.shape[0], -1).double()
    q = torch.quantile(flat, torch.tensor([0.01, 0.99], dtype=torch.float64,
                                          device=img.device), dim=1)
    lo, hi = q[0].view(-1, 1, 1), q[1].view(-1, 1, 1)
    return ((img.double() - lo) / (hi - lo)).float(), (q[1] - q[0]).cpu()


def to_u8(clipped):
    """``round(clip * 255)``, half to even."""
    return torch.round(clipped * 255).to(torch.uint8)


def mse(img, ref):
    return ((img.double() - ref.double()) ** 2).mean(dim=(-2, -1))


def _gauss(sigma=1.5, truncate=3.5):
    r = int(truncate * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum(), r


def _blur(x, k, r):
    """scipy.ndimage.gaussian_filter(mode='reflect') of each (H, W) frame:
    ``c b a | a b c`` padding by the radius, then the separable taps."""
    x = torch.cat([x[:, :r].flip(1), x, x[:, -r:].flip(1)], 1)
    x = torch.cat([x[:, :, :r].flip(2), x, x[:, :, -r:].flip(2)], 2)
    kt = torch.as_tensor(k, dtype=x.dtype, device=x.device)
    x = F.conv2d(x[:, None], kt.view(1, 1, 1, -1))
    return F.conv2d(x, kt.view(1, 1, -1, 1))[:, 0]


def ssim(img, ref):
    """Mean SSIM over the map cropped by the filter's radius, float64."""
    k, r = _gauss()
    x, y = img.double(), ref.double()
    ux, uy = _blur(x, k, r), _blur(y, k, r)
    vx = _blur(x * x, k, r) - ux * ux
    vy = _blur(y * y, k, r) - uy * uy
    vxy = _blur(x * y, k, r) - ux * uy
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    return s[:, r:-r, r:-r].mean(dim=(-2, -1))


_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_ALEX = (("features.0", 4, 2, False), ("features.3", 1, 2, True),
         ("features.6", 1, 1, True), ("features.8", 1, 1, False),
         ("features.10", 1, 1, False))


def lpips(weights, img, ref):
    """LPIPS distance per frame pair, in float32: both frames grey to three
    channels in [-1, 1], the scaling layer, AlexNet's five ReLU taps, each
    unit-normalized over channels, squared differences weighted by the
    ``lin`` heads, averaged over space and summed over taps."""
    shift = torch.tensor(_SHIFT, device=img.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=img.device).view(1, 3, 1, 1)

    def taps(x):
        x = (x.float()[:, None].expand(-1, 3, -1, -1) * 2 - 1 - shift) / scale
        out = []
        for name, stride, pad, pool in _ALEX:
            if pool:
                x = F.max_pool2d(x, 3, 2)
            x = torch.relu(F.conv2d(x, weights[name + ".weight"],
                                    weights[name + ".bias"], stride=stride,
                                    padding=pad))
            out.append(x / (x.pow(2).sum(1, keepdim=True).sqrt() + 1e-10))
        return out

    total = 0
    for i, (a, b) in enumerate(zip(taps(img), taps(ref))):
        total = total + F.conv2d((a - b) ** 2,
                                 weights[f"lin.{i}.weight"]).mean(
                                     dim=(1, 2, 3))
    return total
