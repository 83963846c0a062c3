"""Histogram equalization of frames and references before scoring
(``evreal_tpu/harness/histeq.py``; reference utils/eval_metrics.py:326-350),
without OpenCV:

  * ``global`` — ``skimage.exposure.equalize_hist`` (256-bin CDF
    interpolation), numpy, the JAX package's math;
  * ``clahe`` — ``cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))``
    written out by OpenCV's rule (``clahe_u8``, torch, any device):
    bit-equal to cv2;
  * ``local`` — ``skimage.filters.rank.equalize`` over ``disk(55)``: the
    native sliding-histogram routine (``native/histeq.cpp``), bit-equal to
    the plain numpy ``rank_equalize_plain``.

Images are float (H, W) (or (H, W, 3) for ``global``) in [0, 1]; the result
is f32, as in the JAX package.
"""

import numpy as np
import torch

from evreal_tpu_torch import native

CLAHE_CLIP = 2.0
CLAHE_TILES = (8, 8)  # rows, columns
LOCAL_RADIUS = 55


def img_as_ubyte(img):
    return np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)


def equalize_global(img):
    """``skimage.exposure.equalize_hist(img, nbins=256)`` as f32."""
    flat = img.ravel()
    hist, bin_edges = np.histogram(flat, bins=256)
    bin_centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    cdf = np.cumsum(hist).astype(np.float64)
    cdf /= cdf[-1]
    out = np.interp(flat, bin_centers, cdf).reshape(img.shape)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# CLAHE (OpenCV's CLAHE_Impl::apply on uint8)
# ---------------------------------------------------------------------------

def reflect101(n_out, n):
    """Source indices of ``n_out`` positions over a side of ``n`` padded at
    its end by OpenCV's BORDER_REFLECT_101 (any pad, tiny sides too)."""
    idx = np.arange(n_out)
    if n == 1:
        return np.zeros(n_out, np.int64)
    while ((idx < 0) | (idx >= n)).any():
        idx = np.where(idx >= n, 2 * n - 2 - idx, idx)
        idx = np.abs(idx)
    return idx


def _interp_axis(size, tile, tiles):
    """(t1, t2, w1, w2) of CLAHE's f32 interpolation along one axis."""
    inv = np.float32(1.0) / np.float32(tile)
    f = (np.arange(size, dtype=np.float32) * inv - np.float32(0.5))
    f = f.astype(np.float32)
    t1 = np.floor(f).astype(np.int64)
    w2 = (f - t1.astype(np.float32)).astype(np.float32)
    w1 = (np.float32(1.0) - w2).astype(np.float32)
    return (np.maximum(t1, 0), np.minimum(t1 + 1, tiles - 1), w1, w2)


def clahe_u8(img, clip_limit=CLAHE_CLIP, tiles=CLAHE_TILES):
    """``cv2.createCLAHE(clip_limit, tiles[::-1]).apply(img)`` of a uint8
    (H, W) tensor, on its device, bit-exact. Rule: when either side is not
    a multiple of its tile count, BOTH sides are padded by ``tiles -
    side % tiles`` (reflect-101), so an exact side gains a whole tile; per
    tile a 256-bin histogram clipped at ``max(int(clip * area / 256), 1)``,
    the excess spread evenly and its residue at steps of
    ``max(256 // residue, 1)``; LUT ``round(f32(cumsum) * f32(255 /
    area))``; f32 bilinear interpolation between the four nearest tiles'
    LUTs over the unpadded image, tile indices clamped at the edges."""
    if img.dtype != torch.uint8 or img.dim() != 2:
        raise ValueError(f"clahe_u8: want a (H, W) uint8 tensor, got "
                         f"{tuple(img.shape)} {img.dtype}")
    dev = img.device
    h, w = img.shape
    ty, tx = tiles
    ext = img
    if h % ty or w % tx:
        rows = torch.from_numpy(reflect101(h + ty - h % ty, h)).to(dev)
        cols = torch.from_numpy(reflect101(w + tx - w % tx, w)).to(dev)
        ext = img[rows][:, cols]
    th, tw = ext.shape[0] // ty, ext.shape[1] // tx
    area = th * tw
    cells = ext.reshape(ty, th, tx, tw).permute(0, 2, 1, 3)
    cells = cells.reshape(ty * tx, area).long()
    hist = torch.zeros((ty * tx, 256), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, cells, torch.ones_like(cells))

    limit = max(int(clip_limit * area / 256), 1)
    excess = (hist - limit).clamp(min=0).sum(1, keepdim=True)
    hist = hist.clamp(max=limit) + excess // 256
    residual = excess % 256
    step = (256 // residual.clamp(min=1)).clamp(min=1)
    k = torch.arange(256, device=dev)
    hist = hist + ((k % step == 0) & (k // step < residual)).long()
    scale = torch.tensor(np.float32(255) / np.float32(area), device=dev)
    lut = torch.round(hist.cumsum(1).float() * scale).clamp(0, 255)
    lut = lut.view(ty, tx, 256)

    y1, y2, ya1, ya = (torch.from_numpy(a).to(dev)
                       for a in _interp_axis(h, th, ty))
    x1, x2, xa1, xa = (torch.from_numpy(a).to(dev)
                       for a in _interp_axis(w, tw, tx))
    v = img.long()

    def at(ry, cx):
        return lut[ry[:, None], cx[None, :], v]

    xa1, xa, ya1, ya = xa1[None, :], xa[None, :], ya1[:, None], ya[:, None]
    top = at(y1, x1) * xa1 + at(y1, x2) * xa
    bottom = at(y2, x1) * xa1 + at(y2, x2) * xa
    res = top * ya1 + bottom * ya
    return torch.round(res).clamp(0, 255).to(torch.uint8)


def equalize_clahe(img):
    """CLAHE (clip 2.0, 8 x 8 tiles) of a float image in [0, 1], on the
    host; f32 result."""
    u8 = torch.from_numpy(np.ascontiguousarray(img_as_ubyte(img)))
    return (clahe_u8(u8).numpy() / 255.0).astype(np.float32)


# ---------------------------------------------------------------------------
# local rank equalization
# ---------------------------------------------------------------------------

def disk(radius):
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return x * x + y * y <= radius * radius


def rank_equalize_plain(u8, radius):
    """The plain version of ``native.rank_equalize``: per pixel,
    ``floor(rank * 255 / pop)`` with rank the count of in-image disk
    neighbours <= the centre and pop the in-image disk size (brute force
    over the footprint; for tests at small radii)."""
    h, w = u8.shape
    v = u8.astype(np.int64)
    rank = np.zeros((h, w), np.int64)
    pop = np.zeros((h, w), np.int64)
    for dy, dx in np.argwhere(disk(radius)) - radius:
        ys, ye = max(0, -dy), min(h, h - dy)
        xs, xe = max(0, -dx), min(w, w - dx)
        if ys >= ye or xs >= xe:
            continue
        center = v[ys:ye, xs:xe]
        other = v[ys + dy:ye + dy, xs + dx:xe + dx]
        rank[ys:ye, xs:xe] += other <= center
        pop[ys:ye, xs:xe] += 1
    return (rank * 255 // pop).astype(np.uint8)


def equalize_local(img, radius=LOCAL_RADIUS):
    """``skimage.filters.rank.equalize(img_as_ubyte(img), disk(radius))``
    as f32 in [0, 1], by the native routine (raises when it cannot be
    built)."""
    out = native.rank_equalize(img_as_ubyte(img), radius)
    return (out / 255.0).astype(np.float32)


def histogram_equalization(img, mode):
    if mode == "none" or mode is None:
        return img
    if mode == "global":
        return equalize_global(img)  # shape-agnostic, like equalize_hist
    if img.ndim == 3 and mode in ("clahe", "local"):
        # the reference's clahe.apply / rank.equalize reject 3 channels
        raise ValueError(f"histeq '{mode}' supports grayscale images only")
    if mode == "clahe":
        return equalize_clahe(img)
    if mode == "local":
        return equalize_local(img)
    raise ValueError(f"Unrecognized histogram equalization argument: {mode}")
