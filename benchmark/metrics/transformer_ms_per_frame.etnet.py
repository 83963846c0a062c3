"""Device ms a real window of the traced pass spent on the work launched
under the program's ``evreal.etnet.transformer`` span (tokens and the six
transformer streams; ``lib/devspans.py``), over the benchmark's own count
of real windows. None where the trace holds no such span
(``kinds/eval_spans.py``), or off the card."""

SPAN = "evreal.etnet.transformer"


def read(ctx):
    us = (getattr(ctx, "span_device_us", None) or {}).get(SPAN)
    if getattr(ctx, "window", None) is None or not us or not ctx.windows:
        return None
    return us / 1000.0 / ctx.windows
