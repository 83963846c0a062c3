"""Color reconstruction merge without OpenCV (``evreal_tpu/utils/color.py``;
reference utils/color_utils.py:5-88), as torch functions on uint8 tensors
that run on the device of their input and take a leading batch of frames.

The JAX package merges with OpenCV's uint8 routines; the card's machine has
no OpenCV, so each routine is written out here by OpenCV's own integer
rules:

  * ``resize_linear_u8`` — ``cv2.resize(..., INTER_LINEAR)`` on uint8: per
    axis ``f = f32((d + 0.5) * src / dst - 0.5)``, taps ``floor(f)`` and
    ``floor(f) + 1`` clamped to the image, 11-bit weights
    ``round(f32(1 - f) * 2048)``, ``round(f * 2048)``; the horizontal pass
    sets a tap left of or at the last column to weight (2048, 0), the
    vertical pass keeps the raw weights and only clamps the row index;
    rows combine as ``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16)
    + 2 >> 2``. Bit-equal to cv2;
  * ``add_weighted_half`` — ``cv2.addWeighted(a, 0.5, b, 0.5, 0)``: round
    half to even of ``(a + b) / 2``. Bit-equal;
  * ``bgr_to_lab_u8`` — ``COLOR_BGR2LAB`` on uint8: an sRGB table
    ``round(2040 * gamma(i / 255))`` in f32, coefficients
    ``round(4096 * M / white)``, a 3072-entry cube-root table at 2^15 (f32),
    and OpenCV's descales. Bit-equal over all 2^24 colours;
  * ``lab_to_bgr_u8`` — ``COLOR_LAB2BGR`` on uint8 by OpenCV's integer
    inverse (L -> (y, f(y)) table, a / b steps at 2^14, a cube table, 14-bit
    coefficients, a 4096-entry inverse-gamma table). OpenCV's exact rule
    was not recovered: this one is within 2 grey levels of cv2 over all
    2^24 inputs, off on 4.25% of them and by 2 on 122
    (``tests/test_torch_color.py``). Integer arithmetic only, so it is
    bit-equal across devices.

All index and weight tables are computed once on the host with numpy and
cached per device.
"""

import functools

import numpy as np
import torch

_F32 = np.float32
_D65 = (0.950456, 1.0, 1.088754)
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535],
                     [-0.969256, 1.875991, 0.041556],
                     [0.055648, -0.204043, 1.057311]])
_LAB_BASE = 1 << 14            # the inverse's fixed-point base
_AB_MIN, _AB_MAX = -8160, 26880  # f(y) +- a / b steps stay inside


# ---------------------------------------------------------------------------
# resize, shift, addWeighted
# ---------------------------------------------------------------------------

def _linear_taps(src, dst, clamp_edges):
    """(i0, i1, w0, w1) of one axis of cv2's uint8 INTER_LINEAR resize,
    weights at 2^11."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(_F32)).astype(_F32)
    if clamp_edges:  # the horizontal pass (cv2 resize: xmin / xmax)
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0
        s = np.clip(s, 0, src - 1)
    w0 = np.round((_F32(1) - f) * _F32(2048)).astype(np.int64)
    w1 = np.round(f * _F32(2048)).astype(np.int64)
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1)


@functools.lru_cache(maxsize=64)
def _resize_plan(src_hw, dst_hw, device):
    h = _linear_taps(src_hw[1], dst_hw[1], True)
    v = _linear_taps(src_hw[0], dst_hw[0], False)
    return tuple(torch.from_numpy(a).to(device) for a in h + v)


def resize_linear_u8(img, size):
    """``cv2.resize(img, (W, H), interpolation=INTER_LINEAR)`` of uint8
    ``img`` (..., h, w) to ``size`` = (H, W), bit-exact."""
    hi0, hi1, hw0, hw1, vi0, vi1, vw0, vw1 = _resize_plan(
        tuple(img.shape[-2:]), tuple(size), img.device)
    x = img.to(torch.int32)
    rows = x[..., hi0] * hw0.to(torch.int32) + x[..., hi1] * hw1.to(
        torch.int32)
    r0 = rows[..., vi0, :] >> 4
    r1 = rows[..., vi1, :] >> 4
    b0 = vw0.to(torch.int32).view(-1, 1)
    b1 = vw1.to(torch.int32).view(-1, 1)
    out = (((b0 * r0) >> 16) + ((b1 * r1) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


def shift_image(x, dx, dy):
    """``x`` (..., H, W) moved by ``dx`` columns and ``dy`` rows, the
    vacated edge repeating the nearest moved row / column
    (``evreal_tpu/utils/color.py:shift_image``)."""
    h, w = x.shape[-2:]
    dev = x.device
    rows = (torch.arange(h, device=dev) - dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=dev) - dx).clamp(0, w - 1)
    return x[..., rows, :][..., cols]


def add_weighted_half(a, b):
    """``cv2.addWeighted(a, 0.5, b, 0.5, 0, dtype=CV_8U)``: (a + b) / 2
    rounded half to even."""
    s = a.to(torch.int32) + b.to(torch.int32)
    return ((s + ((s >> 1) & 1)) >> 1).to(torch.uint8)


# ---------------------------------------------------------------------------
# LAB
# ---------------------------------------------------------------------------

def _f32_pow(x, e):
    """f32 of the f64 power of f32 ``x``: the correctly rounded f32 result
    for every table entry used here, whatever the platform's powf."""
    return np.power(x.astype(np.float64), e).astype(_F32)


@functools.lru_cache(maxsize=1)
def _lab_tables_np():
    x = (np.arange(256, dtype=_F32) / _F32(255)).astype(_F32)
    gamma = np.where(x <= _F32(0.04045), (x / _F32(12.92)).astype(_F32),
                     _f32_pow(((x + _F32(0.055)) / _F32(1.055)).astype(_F32),
                              2.4))
    gamma = np.round(_F32(2040) * gamma.astype(_F32)).astype(np.int64)

    c = (np.arange(3072, dtype=_F32) / _F32(2040)).astype(_F32)
    lin = (c * _F32(841 / 108) + _F32(16 / 116)).astype(_F32)
    cube = np.cbrt(c.astype(np.float64)).astype(_F32)
    cbrt = np.round(np.where(c < _F32(216 / 24389), lin, cube)
                    * _F32(1 << 15)).astype(np.int64)
    # OpenCV's f32 cube root is not correctly rounded: these two entries
    # land one lower there (found against cv2 over all 2^24 colours)
    cbrt[[324, 2079]] -= 1
    # rows X, Y, Z; columns over the B, G, R inputs
    to_xyz = np.round(4096 * _RGB2XYZ / np.array(_D65)[:, None])
    to_xyz = to_xyz.astype(np.int64)[:, ::-1].copy()

    # inverse: L -> (y, f(y)) at 2^14
    y_tab, fy_tab = np.zeros(256, np.int64), np.zeros(256, np.int64)
    base = _LAB_BASE
    for i in range(256):
        if i <= 20:
            y_tab[i] = np.round(_F32(i * base * 20 * 9)
                                / _F32(17 * 29 * 29 * 29))
            fy_tab[i] = np.round(_F32(base) * (_F32(16) / _F32(116)
                                               + _F32(i * 5)
                                               / _F32(3 * 17 * 29)))
        else:
            fy = _F32(_F32(i * 100 * base) / _F32(255 * 116)) \
                + _F32(_F32(16 * base) / _F32(116))
            fy_tab[i] = np.round(fy)
            y_tab[i] = np.round(_F32(_F32(fy * fy) * fy)
                                / _F32(base * base))
    v = np.arange(_AB_MIN, _AB_MAX)
    ab = np.empty(v.shape, np.int64)
    lo = v <= 3390  # f <= 6 / 29: the linear segment
    ab[lo] = (np.trunc(v[lo] * 108 / 841).astype(np.int64)
              - base * 16 // 116 * 108 // 841)
    vf = (v[~lo].astype(_F32) / _F32(base)).astype(_F32)
    ab[~lo] = np.round(((vf * vf).astype(_F32) * vf).astype(_F32)
                       * _F32(base)).astype(np.int64)
    to_bgr = np.round(4096 * _XYZ2RGB[::-1] * np.array(_D65)[None, :])
    g = (np.arange(4096, dtype=_F32) / _F32(4096)).astype(_F32)
    inv = np.where(g <= _F32(0.0031308), (_F32(12.92) * g).astype(_F32),
                   (_F32(1.055) * _f32_pow(g, 1 / 2.4)).astype(_F32)
                   - _F32(0.055))
    inv_gamma = np.round(_F32(255) * inv.astype(_F32)).astype(np.int64)
    return {"gamma": gamma, "cbrt": cbrt, "to_xyz": to_xyz, "y": y_tab,
            "fy": fy_tab, "ab": ab, "to_bgr": to_bgr.astype(np.int64),
            "inv_gamma": inv_gamma}


@functools.lru_cache(maxsize=8)
def _lab_tables(device):
    return {k: torch.from_numpy(v).to(device)
            for k, v in _lab_tables_np().items()}


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def bgr_to_lab_u8(bgr):
    """``cv2.cvtColor(bgr, COLOR_BGR2LAB)`` of uint8 ``bgr`` (..., 3),
    bit-exact."""
    t = _lab_tables(bgr.device)
    lin = t["gamma"][bgr.long()]  # (..., 3) over B, G, R
    c = t["to_xyz"]
    fx, fy, fz = (t["cbrt"][_descale((lin * c[k]).sum(-1), 12)]
                  for k in range(3))
    shift = 15
    lum = _descale(296 * fy - 1336934, shift)
    a = _descale(500 * (fx - fy) + (128 << shift), shift)
    b = _descale(200 * (fy - fz) + (128 << shift), shift)
    return torch.stack([lum, a, b], -1).clamp(0, 255).to(torch.uint8)


def lab_to_bgr_u8(lab):
    """``cv2.cvtColor(lab, COLOR_LAB2BGR)`` of uint8 ``lab`` (..., 3) by
    OpenCV's integer inverse as far as it was recovered: within 2 grey
    levels of cv2 (module docstring)."""
    t = _lab_tables(lab.device)
    lum, a, b = (lab[..., k].long() for k in range(3))
    base = _LAB_BASE
    fy = t["fy"][lum]
    x = t["ab"][fy + a * base // 500 - 128 * base // 500 - _AB_MIN]
    # OpenCV's b step carries a +1 (it halves the mismatches against cv2)
    z = t["ab"][fy - (b * base // 200 - 128 * base // 200 + 1) - _AB_MIN]
    xyz = torch.stack([x, t["y"][lum], z], -1)
    lin = _descale((xyz.unsqueeze(-2) * t["to_bgr"]).sum(-1), 14)
    return t["inv_gamma"][lin.clamp(0, 4095)].to(torch.uint8)


# ---------------------------------------------------------------------------
# the merge (evreal_tpu/utils/color.py:24-51)
# ---------------------------------------------------------------------------

def upsample_color_image(gray, bgr):
    """Full-resolution BGR of the chroma ``bgr`` (T, h, w, 3) with its LAB
    lightness replaced by ``gray`` (T, H, W). At an odd sensor side the
    chroma is one row / column short and is stretched to (H, W) first."""
    hw = tuple(gray.shape[-2:])
    if tuple(bgr.shape[-3:-1]) != hw:
        bgr = resize_linear_u8(bgr.movedim(-1, -3), hw).movedim(-3, -1)
    lab = bgr_to_lab_u8(bgr)
    lab = torch.cat([gray.unsqueeze(-1), lab[..., 1:]], -1)
    return lab_to_bgr_u8(lab)


def merge_channels_into_color_image(channels, gray):
    """``channels`` (T, 4, h, w) uint8 half-resolution reconstructions in
    the order R, G, B, W and ``gray`` (T, H, W) uint8 -> full-resolution
    BGR (T, H, W, 3) uint8."""
    h, w = channels.shape[-2:]
    up = resize_linear_u8(channels, (2 * h, 2 * w))
    red, green, blue, white = up.unbind(-3)
    blue = shift_image(blue, 1, 1)
    green = shift_image(green, 1, 0)
    white = shift_image(white, 0, 1)
    bgr = torch.stack([blue, add_weighted_half(green, white), red], -1)
    return upsample_color_image(gray, bgr)
