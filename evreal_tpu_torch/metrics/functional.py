"""Full-reference image metrics (``evreal_tpu/metrics/functional.py``),
batched over a leading frame axis.

``ssim`` is skimage.metrics.structural_similarity with the configuration
the reference pins (utils/eval_metrics.py:96): ``gaussian_weights=True,
sigma=1.5, use_sample_covariance=False, data_range=1.0`` — an 11-tap
discrete Gaussian (truncate=3.5), symmetric ('reflect' in scipy) padding,
and the mean over the pad-cropped SSIM map. ``mse`` is
skimage.metrics.mean_squared_error.
"""

import numpy as np
import torch
import torch.nn.functional as F


def mse(img, ref):
    """(N, H, W) images and references -> (N,) mean squared errors."""
    d = img.to(torch.float32) - ref.to(torch.float32)
    return (d * d).mean(dim=(-2, -1))


def gaussian_kernel(sigma=1.5, truncate=3.5):
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32), radius


def _symmetric_index(n, radius, device):
    """Source indices of numpy's 'symmetric' padding (edge repeated:
    ``c b a | a b c ... | c b a``) by ``radius`` on each side."""
    i = torch.arange(-radius, n + radius, device=device)
    i = torch.where(i < 0, -i - 1, i)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _filter2d(x, k, radius):
    """Separable Gaussian filter of (N, H, W) with symmetric padding,
    'valid' output (N, H, W)."""
    n, h, w = x.shape
    xp = x[:, _symmetric_index(h, radius, x.device)]
    xp = xp[:, :, _symmetric_index(w, radius, x.device)]
    kt = torch.from_numpy(k).to(x.device)
    xp = F.conv2d(xp[:, None], kt.view(1, 1, 1, -1))  # rows
    xp = F.conv2d(xp, kt.view(1, 1, -1, 1))  # columns
    return xp[:, 0]


def ssim(img, ref, data_range=1.0, sigma=1.5, truncate=3.5, k1=0.01, k2=0.03):
    """SSIM of (N, H, W) images against references -> (N,)."""
    k, radius = gaussian_kernel(sigma, truncate)
    if min(img.shape[-2:]) <= 2 * radius:
        # skimage raises here ('win_size exceeds image extent')
        raise ValueError(
            f"ssim: image extent {tuple(img.shape[-2:])} too small for the "
            f"{2 * radius + 1}-px window (needs > {2 * radius} per side)")
    x = img.to(torch.float32)
    y = ref.to(torch.float32)
    ux, uy = _filter2d(x, k, radius), _filter2d(y, k, radius)
    uxx = _filter2d(x * x, k, radius)
    uyy = _filter2d(y * y, k, radius)
    uxy = _filter2d(x * y, k, radius)
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    if radius:
        s = s[:, radius:-radius, radius:-radius]
    return s.mean(dim=(-2, -1))

