"""Pack variable-length event windows into fixed-capacity ``(T, E)`` buffers.

The port's own copy of ``evreal_tpu/data/packing.py``. ``pack_windows``
packs with the native C++ packer (``native/packer.cpp``) when the events
are the memmap layout it reads (f64 timestamps, int16 ``(N, 2)``
coordinates, uint8 polarity, each C-contiguous) and the buffers its wire
writes; other inputs, and every input under ``EVREAL_NATIVE=0``, take the
numpy loop, which gives bit-identical buffers and is the plain version
the tests hold the native packer to.

Windows have wildly varying event counts, so the events of a chunk of T
windows are packed into ``(T, E)`` arrays with a per-window ``count``;
capacities are bucketed to powers of two. Three wire formats
(``wire_dtypes``):

* ``f32`` — int16 coordinates (float32 for fractional on-disk coordinates),
  float32 zero-based timestamps, int8 ±1 polarity;
* ``compact`` — uint16 window-normalized timestamp fractions
  ``q = rint((ts - ts0) / dt * 65535)`` and uint8 coordinates when the
  sensor fits (out-of-range values park at the 255 sentinel);
* ``compact4`` — one uint32 per event: linear pixel index, timestamp
  fraction and polarity bit (``compact4_layout``), decoded by the CUDA
  voxelizer on the card and by ``ops.voxelize.decode_compact4`` on the CPU.

``wire_format()`` reads the active wire from ``EVREAL_WIRE``.

Timestamps are zero-based per window and cast to float32 *after* the
shift, preserving the reference's precision behavior.
"""

import os

import numpy as np

from evreal_tpu_torch import native

_MIN_CAPACITY = 2048
U16_TS_SCALE = 65535.0
WIRES = ("f32", "compact", "compact4")


def wire_format():
    """Active wire format: ``EVREAL_WIRE`` in {f32, compact, compact4},
    default f32."""
    wire = os.environ.get("EVREAL_WIRE", "f32")
    if wire not in WIRES:
        raise ValueError(
            f"EVREAL_WIRE must be 'f32', 'compact' or 'compact4': {wire!r}")
    return wire


def compact4_layout(resolution):
    """(idx_bits, ts_bits) of the packed-u32 wire for this sensor, or None
    when it doesn't fit: the linear index needs ``ceil(log2(h*w + 1))``
    bits (``h*w`` is the out-of-range sentinel), polarity takes bit 31,
    the timestamp fraction the rest, capped at 16 and floored at 12."""
    if resolution is None:
        return None
    h, w = int(resolution[0]), int(resolution[1])
    if h <= 0 or w <= 0:
        return None
    idx_bits = max(int(h * w).bit_length(), 1)
    ts_bits = min(31 - idx_bits, 16)
    if ts_bits < 12:
        return None
    return idx_bits, ts_bits


def wire_dtypes(wire, int_coords, resolution=None):
    """Buffer dtypes for a wire format: {xs, ys, ts, ps, count}, or
    {ev, count} for an eligible ``compact4`` sensor. ``int_coords``: whether
    the on-disk coordinates are integral; ``resolution``: (h, w)."""
    if wire == "compact4":
        if int_coords and compact4_layout(resolution) is not None:
            return {"ev": np.uint32, "count": np.int32}
        wire = "compact"  # per-sensor fallback, like u8 coords
    xy = np.int16 if int_coords else np.float32
    ts = np.float32
    if wire == "compact":
        ts = np.uint16
        if int_coords and resolution is not None:
            h, w = resolution
            if h <= 255 and w <= 255:
                xy = np.uint8
    return {"xs": xy, "ys": xy, "ts": ts, "ps": np.int8, "count": np.int32}


def alloc_buffers(shape_prefix, capacity, dtypes, alloc=np.zeros):
    """Event-buffer dict for any wire: per-event arrays shaped
    ``shape_prefix + (capacity,)``, plus ``count`` shaped ``shape_prefix``."""
    out = {k: alloc(shape_prefix + (capacity,), d)
           for k, d in dtypes.items() if k != "count"}
    out["count"] = alloc(shape_prefix, dtypes["count"])
    return out


def polarity_bit(ps):
    """Positive-polarity bit per event: LSB for unsigned on-disk polarity
    ({0,1} or {0,255}), sign for signed or float (already ±1) input."""
    ps = np.asarray(ps)
    if np.issubdtype(ps.dtype, np.unsignedinteger):
        return (ps & 1).astype(np.uint32)
    return (ps > 0).astype(np.uint32)


def quantize_ts(ts, qmax):
    """Window-normalized timestamp quantization shared by the narrow wires:
    one f64 division into the scale, then per-event multiply + rint + clip,
    with the degenerate-window (dt < 1e-9) linspace quantized here.
    Returns f64 values in [0, qmax]."""
    ts = np.asarray(ts, np.float64)
    n = ts.shape[0]
    if n == 0:
        return np.zeros((0,), np.float64)
    dt_w = float(ts[-1] - ts[0])
    if dt_w < 1e-9:
        return np.rint(np.arange(n) * (qmax / max(n - 1, 1)))
    return np.clip(np.rint((ts - ts[0]) * (qmax / dt_w)), 0.0, qmax)


def encode_compact4(xs, ys, ts, ps, resolution):
    """Encode one window's events as packed uint32 (module docstring)."""
    idx_bits, ts_bits = compact4_layout(resolution)
    h, w = int(resolution[0]), int(resolution[1])
    xs = np.asarray(xs).astype(np.int64)
    ys = np.asarray(ys).astype(np.int64)
    inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    idx = np.where(inb, ys * w + xs, h * w).astype(np.uint32)
    qmax = float((1 << ts_bits) - 1)
    q = quantize_ts(ts, qmax).astype(np.uint32)
    pbit = polarity_bit(ps)
    return idx | (q << np.uint32(idx_bits)) | (pbit << np.uint32(31))


def pack_row(out, row, xs, ys, ts, ps, resolution=None):
    """Write one window's events and count into row ``row`` of ``out`` on
    the wire its dtypes name (``wire_dtypes``); slots past the count are
    left as they are. ``ts`` are absolute (zero-based here, in their own
    dtype); ``ps`` on-disk {0,1} or ±1 (``polarity_bit``); ``resolution``
    (h, w) is needed by the compact4 wire."""
    n = len(xs)
    out["count"][row] = n
    if n == 0:
        return
    if "ev" in out:  # packed-u32 wire
        out["ev"][row, :n] = encode_compact4(xs, ys, ts, ps, resolution)
        return
    if out["xs"].dtype == np.uint8:
        # out-of-range coordinates park at the 255 sentinel; the
        # voxelizer's bounds guard drops them
        out["xs"][row, :n] = np.where((xs >= 0) & (xs < 256), xs, 255) \
            .astype(np.uint8)
        out["ys"][row, :n] = np.where((ys >= 0) & (ys < 256), ys, 255) \
            .astype(np.uint8)
    else:
        out["xs"][row, :n] = xs
        out["ys"][row, :n] = ys
    ts = np.asarray(ts)
    if out["ts"].dtype == np.uint16:
        out["ts"][row, :n] = quantize_ts(ts, U16_TS_SCALE).astype(np.uint16)
    else:
        out["ts"][row, :n] = (ts - ts[0]).astype(np.float32)
    out["ps"][row, :n] = polarity_bit(ps).astype(np.int8) * 2 - 1


def bucket_capacity(max_count, minimum=_MIN_CAPACITY):
    cap = minimum
    while cap < max_count:
        cap *= 2
    return cap


def outlier_buffers(shape_prefix, chunk_max, dtypes):
    """One-off zeroed buffers for a chunk whose max event count exceeds the
    pool capacity chosen by ``plan_capacity``. Returns
    ``(capacity, buffers)``."""
    cap_c = bucket_capacity(chunk_max)
    return cap_c, alloc_buffers(shape_prefix, cap_c, dtypes)


def plan_capacity(counts, tail_frac=0.01, min_ratio=4, minimum=_MIN_CAPACITY):
    """Pool capacity robust to heavy-tailed window sizes: up to
    ``ceil(tail_frac * n)`` windows may exceed the pool bucket (their chunk
    escalates to its own buffers), but only when that saves at least
    ``min_ratio`` x capacity."""
    counts = np.sort(np.asarray(list(counts), np.int64))
    n = counts.size
    if n == 0:
        return minimum
    cap_all = bucket_capacity(int(counts[-1]), minimum)
    k = min(max(1, int(np.ceil(n * tail_frac))), n - 1)
    if k <= 0:
        return cap_all
    base = bucket_capacity(int(counts[n - 1 - k]), minimum)
    return base if cap_all >= base * min_ratio else cap_all


def _native_eligible(seq):
    """Whether the native packer reads ``seq``'s events: f64 ``t``, int16
    ``(N, 2)`` ``xy`` and uint8 ``p``, each C-contiguous."""
    try:
        return (seq.t.dtype == np.float64 and seq.t.ndim == 1
                and seq.t.flags["C_CONTIGUOUS"]
                and seq.xy.dtype == np.int16 and seq.xy.ndim == 2
                and seq.xy.shape[1] == 2 and seq.xy.flags["C_CONTIGUOUS"]
                and seq.p.dtype == np.uint8 and seq.p.ndim == 1
                and seq.p.flags["C_CONTIGUOUS"])
    except AttributeError:
        return False


def _native_writes(out, resolution):
    """Whether the native packer writes ``out``: the dtypes of one wire,
    every buffer C-contiguous, and a compact4 layout for the sensor when
    the wire is compact4."""
    if "ev" in out:
        want = {"ev": np.uint32}
        if compact4_layout(resolution) is None:
            return False
    else:
        xy = np.uint8 if out["xs"].dtype == np.uint8 else np.int16
        want = {"xs": xy, "ys": xy, "ps": np.int8,
                "ts": (np.uint16 if out["ts"].dtype == np.uint16
                       else np.float32)}
    want["count"] = np.int32
    return set(out) == set(want) and all(
        out[k].dtype == d and out[k].flags["C_CONTIGUOUS"]
        for k, d in want.items())


def pack_windows(seq, indices, capacity=None, out=None, metas=None,
                 out_zeroed=True, wire="f32"):
    """Pack the given window indices of a Sequence.

    Returns ``(buffers, metas)``: buffers is a dict of numpy arrays with
    dtypes per ``wire_dtypes(wire, ...)`` — {xs, ys, ts, ps: (T, E);
    count: (T,)} or {ev: (T, E); count} — and metas the ``seq.window``
    dicts. Pass ``out`` to pack in place (the wire is then read from its
    dtypes) and ``out_zeroed=False`` when those buffers are reused, so row
    tails get cleared of stale events (the native packer always clears
    them). The native packer runs when ``native.enabled()``, the events
    are eligible and it writes ``out``'s dtypes (module docstring); else
    the numpy loop."""
    if metas is None:
        metas = [seq.window(i) for i in indices]
    max_count = max((m["event_count"] for m in metas), default=0)
    if capacity is None:
        capacity = bucket_capacity(max_count)
    if capacity < max_count:
        raise ValueError(f"capacity {capacity} < window size {max_count}")

    t = len(indices)
    int_coords = np.issubdtype(seq.xy.dtype, np.integer)
    resolution = getattr(seq, "sensor_resolution", None)

    native_ok = native.enabled() and _native_eligible(seq)
    if out is None:
        # the native packer writes every slot, so its buffers start empty
        out = alloc_buffers((t,), capacity,
                            wire_dtypes(wire, int_coords, resolution),
                            alloc=np.empty if native_ok else np.zeros)
        zeroed = not native_ok
    else:
        # every buffer's shape, not just one: the native packer writes
        # rows at stride `capacity` with no bounds of its own
        for k in out:
            want = (t,) if k == "count" else (t, capacity)
            if out[k].shape != want:
                raise ValueError(f"buffer {k}: shape {out[k].shape}, "
                                 f"want {want}")
        zeroed = bool(out_zeroed)

    if native_ok and _native_writes(out, resolution):
        idx0 = np.asarray([m["idx0"] for m in metas], np.int64)
        idx1 = np.asarray([m["idx1"] for m in metas], np.int64)
        if "ev" in out:
            native.pack_compact4(seq.t, seq.xy, seq.p, idx0, idx1,
                                 capacity, resolution, out)
        elif out["ts"].dtype == np.uint16:
            native.pack_compact(seq.t, seq.xy, seq.p, idx0, idx1, capacity,
                                out["xs"].dtype == np.uint8, out)
        else:
            native.pack_i16(seq.t, seq.xy, seq.p, idx0, idx1, capacity, out)
        return out, metas

    for row, meta in enumerate(metas):
        n = meta["event_count"]
        if not zeroed:
            for k in out:
                if k != "count":
                    out[k][row, n:] = 0
        i0, i1 = meta["idx0"], meta["idx1"]
        xy = seq.xy[i0:i1]
        pack_row(out, row, xy[:, 0], xy[:, 1], seq.t[i0:i1],
                 np.asarray(seq.p[i0:i1]), resolution)
    return out, metas
