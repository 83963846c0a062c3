"""The program's own spans and counters inside ``evaluate``
(``evreal_tpu_torch/harness/timers.py``), read for the per-layer metrics.

Spans: the ``evreal.*`` host events of the traced slice
(``run.Layers.window.host``: ``torch.profiler``'s ``user_annotation`` and
``cpu_op`` events), summed by exact name as the union of their intervals cut to the
slice, so overlapping or nested spans of one metric count once. Counters:
``ctx.timings.counts``, the program's ``TimingLog`` counts over the
window's untraced passes. Every reading is None where there is nothing to
read: no device trace (``ctx.window`` None, as in the CPU rehearsal), a
span or counter the program does not emit (an older program), or a zero
denominator. The names are copied here, so that the program may change
and the yardstick not."""

from benchmark.lib.trace import union_us

BUNDLE = "evreal.bundle"
PACK = "evreal.pack"
UPLOAD = "evreal.upload"
FETCH = "evreal.fetch"
PNG_WAIT = "evreal.png.wait"
PNG_DRAIN = "evreal.png.drain"


def span_s(ctx, *names):
    """Seconds of the union of the traced slice's host events named one
    of ``names``; None without a device trace or when one of ``names``
    does not occur in it."""
    if ctx.window is None:
        return None
    w = ctx.window
    found = [(n, max(a, w.lo), min(b, w.hi)) for n, a, b in w.host
             if n in names]
    if {n for n, _, _ in found} != set(names):
        return None
    return union_us([(a, b) for _, a, b in found if b > a]) / 1e6


def ms_per_window(ctx, *names):
    """``span_s`` in ms per real window of the traced pass (the
    benchmark's own count, ``ctx.windows``)."""
    s = span_s(ctx, *names)
    if s is None or not ctx.windows:
        return None
    return 1000.0 * s / ctx.windows


def counts(ctx):
    """The program's counters of the window's passes, or None (no device
    trace, or a program that keeps none)."""
    if ctx.window is None:
        return None
    return getattr(getattr(ctx, "timings", None), "counts", None)


def bundle_s(ctx):
    """Seconds the traced pass spent building the method's bundle: the
    ``.pth`` read, the model built and its weights loaded and cast."""
    return span_s(ctx, BUNDLE)


def feed_ms_per_frame(ctx):
    """ms per window the host spent packing chunks and uploading them
    (pinning and the non-blocking copy)."""
    return ms_per_window(ctx, PACK, UPLOAD)


def fetch_wait_ms_per_frame(ctx):
    """ms per window the host sat blocked on the chunks' device-to-host
    copies, i.e. on the device."""
    return ms_per_window(ctx, FETCH)


def writer_wait_ms_per_frame(ctx):
    """ms per window the loop waited on the PNG writers: frames queued to
    a full writer, and each sequence's writer joined at its end."""
    return ms_per_window(ctx, PNG_WAIT, PNG_DRAIN)


def png_busy_ms_per_frame(ctx):
    """The writer threads' ms per PNG (encode and write), over the
    window's passes."""
    c = counts(ctx)
    if not c or not c.get("png.frames"):
        return None
    return 1000.0 * c["png.busy_s"] / c["png.frames"]


def lockstep_useful(ctx):
    """Share of the lane-windows a lockstep group stepped that were real
    windows, in %, over the window's passes."""
    c = counts(ctx)
    if not c or not c.get("lane_windows.computed"):
        return None
    return 100.0 * c["lane_windows.real"] / c["lane_windows.computed"]
