"""Event -> voxel-grid binning with temporal bilinear interpolation.

Semantics of ``evreal_tpu/ops/voxelize.py`` (reference EVREAL
utils/event_utils.py:27-59):

  * timestamps are normalized to ``[0, num_bins - 1]`` over the window:
    ``t_norm = (ts - ts[0]) / dt * (num_bins - 1)``;
  * each event adds ``p * (1 - frac)`` to bin ``floor(t_norm)`` and
    ``p * frac`` to the next bin at pixel ``(y, x)``, coordinates truncated
    toward zero;
  * degenerate windows (``dt < 1e-9``) spread events evenly:
    ``t_norm = slot * (num_bins - 1) / max(count - 1, 1)``;
  * on the uint16 (``compact``) wire the timestamps are already
    window-normalized fractions: ``t_norm = ts * f32((B - 1) / 65535)``.

Events sit in fixed-capacity ``(T, E)`` buffers with a per-window
``count``; slots past ``count`` and out-of-bounds coordinates deposit
nothing, and an unsorted timestamp with ``t_norm <= -1`` deposits nothing
either (the ``lo + 1 >= 0`` guard).

Two precisions, K2's (``evreal_tpu/kernels/voxelize_pallas.py``):
``"highest"`` (the default) deposits the f32 weights; ``"default"`` rounds
each weight to bf16 (round to nearest even) before the f32 accumulation,
the bf16 serving mode's choice (``harness/runner.py:voxel_precision_choice``).

``voxelize_windows`` is the entry the runner calls, on a wire buffer dict
(``{xs, ys, ts, ps, count}`` or the packed ``{ev, count}``). On CPU
tensors it runs the plain PyTorch version here (``index_add_``, f32
operations in the JAX package's order); on CUDA tensors it launches the
hand-written kernels ``kernels/csrc/voxelize.cu``, which read every wire
(compact4 included) themselves, or raises. The kernels sum in int64 fixed
point at 2^32 (``to_fixed``, ``from_fixed``); the plain version with
``accum_dtype=torch.int64`` does the same and equals them bit for bit.
"""

import torch

from evreal_tpu_torch.data.packing import U16_TS_SCALE, compact4_layout
from evreal_tpu_torch.kernels import voxelize_cuda

_F32 = torch.float32
FIXED_SCALE = 2.0 ** 32  # the kernels' fixed point (csrc/voxelize.cu)


def decode_compact4(ev, sensor_size):
    """Unpack the packed-u32 wire into ``(xs, ys, ts, ps)``: xs, ys int32,
    ts uint16 on the ``compact`` scale, ps float32 ±1. The out-of-range
    sentinel ``h*w`` decodes to ``y >= h`` and is dropped by the bounds
    guard. The timestamp fraction widens to 16 bits by bit replication
    ``(q << (16 - n)) | (q >> (2n - 16))``, as the JAX package does."""
    h, w = sensor_size
    idx_bits, ts_bits = compact4_layout((h, w))
    e = ev.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    idx = e & ((1 << idx_bits) - 1)
    xs = (idx % w).to(torch.int32)
    ys = (idx // w).to(torch.int32)
    q = (e >> idx_bits) & ((1 << ts_bits) - 1)
    ts = ((q << (16 - ts_bits)) | (q >> (2 * ts_bits - 16))).to(torch.uint16)
    ps = torch.where((e >> 31) != 0, 1.0, -1.0).to(_F32)
    return xs, ys, ts, ps


def t_norm(ts, count, num_bins):
    """Normalized temporal coordinate per event, ``(T, E)`` f32."""
    if ts.dtype == torch.uint16:  # compact wire: pre-normalized fraction
        scale = torch.tensor((num_bins - 1) / U16_TS_SCALE, dtype=_F32)
        return ts.to(_F32) * scale.to(ts.device)
    ts = ts.to(_F32)
    e = ts.shape[1]
    n = count.to(torch.int64)
    ts0 = ts[:, :1]
    # last valid timestamp; a zero count yields all-zero weights anyway
    tsk = ts.gather(1, (n - 1).clamp(0, e - 1)[:, None])
    dt = tsk - ts0
    span = float(num_bins - 1)
    t_reg = (ts - ts0) / dt.clamp(min=1e-38) * span
    slot = torch.arange(e, dtype=_F32, device=ts.device)[None]
    denom = (n - 1).clamp(min=1).to(_F32)[:, None]
    t_deg = slot * span / denom
    return torch.where(dt < 1e-9, t_deg, t_reg)


def deposit_weights(tn, p, bf16_factors=False):
    """An event's two deposits from its ``t_norm`` and f32 polarity:
    ``(lo, w_lo, w_hi)`` with ``lo = floor(tn)`` (int64), ``w_lo =
    p * (1 - frac)`` for bin ``lo`` and ``w_hi = p * frac`` for bin
    ``lo + 1``; ``bf16_factors`` rounds each weight to bf16 (round to
    nearest even) and back to f32."""
    lo = torch.floor(tn).to(torch.int32).to(torch.int64)
    frac = tn - lo.to(_F32)
    w_lo = p * (1.0 - frac)
    w_hi = p * frac
    if bf16_factors:
        w_lo = w_lo.to(torch.bfloat16).to(_F32)
        w_hi = w_hi.to(torch.bfloat16).to(_F32)
    return lo, w_lo, w_hi


def to_fixed(w):
    """f32 deposits -> int64 fixed point at 2^32: the scale is exact in f32,
    then one rounding to nearest even (``__float2ll_rn``)."""
    return torch.round(w * FIXED_SCALE).to(torch.int64)


def from_fixed(acc):
    """int64 fixed-point sums -> f32 with one rounding: int64 -> float64 is
    exact below 2^53, the 2^-32 scale is exact."""
    return (acc.to(torch.float64) * (1.0 / FIXED_SCALE)).to(_F32)


def event_deposits(xs, ys, ts, ps, count, num_bins, hw, bf16_factors=False):
    """Per-event prep: the flat output indices of the two deposits of each
    event and their weights, for the valid ones only. Returns
    ``(index, weight)`` over ``(T * num_bins * H * W,)``, lo deposits
    first, then hi deposits, each in event order. ``bf16_factors`` rounds
    each weight to bf16 (round to nearest even) and back to f32."""
    h, w = hw
    t, e = xs.shape
    dev = xs.device
    xi = xs.to(torch.int32).to(torch.int64)  # trunc toward zero
    yi = ys.to(torch.int32).to(torch.int64)
    slot = torch.arange(e, device=dev)[None]
    valid = slot < count.to(torch.int64)[:, None]
    inb = valid & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)

    lo, w_lo, w_hi = deposit_weights(t_norm(ts, count, num_bins),
                                     ps.to(_F32), bf16_factors)
    ok_lo = inb & (lo >= 0) & (lo < num_bins)
    ok_hi = inb & (lo + 1 >= 0) & (lo + 1 < num_bins)

    plane = h * w
    base = torch.arange(t, device=dev)[:, None] * num_bins
    pix = yi * w + xi
    idx_lo = (base + lo) * plane + pix
    idx_hi = (base + lo + 1) * plane + pix
    return (torch.cat([idx_lo[ok_lo], idx_hi[ok_hi]]),
            torch.cat([w_lo[ok_lo], w_hi[ok_hi]]))


def voxelize_windows_plain(xs, ys, ts, ps, count, num_bins, hw,
                           accum_dtype=_F32, bf16_factors=False):
    """Plain PyTorch voxelizer: ``(T, E)`` buffers -> ``(T, B, H, W)`` f32.
    ``accum_dtype=torch.float64`` sums the (f32) deposits in float64 before
    the final cast, which makes the result independent of the summation
    order to f32 rounding (CUDA ``index_add_`` itself uses atomics).
    ``accum_dtype=torch.int64`` is the kernels' arithmetic: each deposit
    rounded to fixed point (``to_fixed``), an exact order-free sum, one
    rounding to f32 (``from_fixed``); a cell of k deposits lies within
    k * 2^-33 of the exact sum before that rounding.
    ``bf16_factors`` is the "default" precision (``event_deposits``)."""
    h, w = hw
    t, e = xs.shape
    out = torch.zeros(t * num_bins * h * w, dtype=accum_dtype,
                      device=xs.device)
    if e:  # zero capacity: nothing to read (ts[:, 0] does not exist)
        idx, wgt = event_deposits(xs, ys, ts, ps, count, num_bins, hw,
                                  bf16_factors)
        out.index_add_(0, idx, to_fixed(wgt) if accum_dtype == torch.int64
                       else wgt.to(accum_dtype))
    out = from_fixed(out) if accum_dtype == torch.int64 else out.to(_F32)
    return out.view(t, num_bins, h, w)


def voxelize_buffers_plain(bufs, num_bins, hw, accum_dtype=_F32,
                           bf16_factors=False):
    """``voxelize_windows_plain`` of a wire buffer dict; the compact4 wire
    is decoded first (``decode_compact4``)."""
    if "ev" in bufs:
        xs, ys, ts, ps = decode_compact4(bufs["ev"], hw)
    else:
        xs, ys, ts, ps = bufs["xs"], bufs["ys"], bufs["ts"], bufs["ps"]
    return voxelize_windows_plain(xs, ys, ts, ps, bufs["count"], num_bins,
                                  hw, accum_dtype, bf16_factors)


def voxelize_scatter(xs, ys, ts, ps, count, num_bins, sensor_size):
    """One window: ``(E,)`` inputs -> ``(B, H, W)`` f32 (plain version)."""
    count = torch.as_tensor(count, dtype=torch.int32).reshape(1)
    return voxelize_windows_plain(xs[None], ys[None], ts[None], ps[None],
                                  count.to(xs.device), num_bins,
                                  sensor_size)[0]


def voxelize_windows(bufs, num_bins, hw, precision=None):
    """Voxelize a chunk of T windows in one call: a wire buffer dict of
    ``(T, E)`` event buffers (``{xs, ys, ts, ps, count}`` or the packed
    ``{ev, count}``, ``count`` a ``(T,)`` int32) -> ``(T, num_bins, H, W)``
    f32. ``precision``: ``None``/"highest" or "default" (bf16 factors);
    anything else raises. CPU tensors take the plain version; CUDA tensors
    launch the kernels (per call a count, a scatter and an accumulate
    kernel, compact4 decoded in the first two)."""
    bf16 = voxelize_cuda.check_precision(precision)
    dev = bufs["ev" if "ev" in bufs else "xs"].device
    if dev.type == "cpu":
        return voxelize_buffers_plain(bufs, num_bins, hw, bf16_factors=bf16)
    if dev.type != "cuda":
        raise ValueError(f"voxelize_windows: unsupported device {dev}")
    if "ev" in bufs:
        return voxelize_cuda.voxelize_compact4(
            bufs["ev"], bufs["count"], num_bins, hw, compact4_layout(hw),
            precision)
    return voxelize_cuda.voxelize(
        *(bufs[k] for k in ("xs", "ys", "ts", "ps", "count")), num_bins, hw,
        precision)


# the precisions K2 takes (voxelize_pallas_windows.supported_precisions)
voxelize_windows.supported_precisions = voxelize_cuda.PRECISIONS
