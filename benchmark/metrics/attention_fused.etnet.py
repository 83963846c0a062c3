"""Share of the program's attention calls over the window's passes that
launched the fused kernel (counters ``attention.kernel_calls`` over
``attention.calls``), in %. None without a device trace or without the
counters (an older program)."""

from benchmark.lib.spans import counts


def read(ctx):
    c = counts(ctx)
    if not c or not c.get("attention.calls"):
        return None
    return 100.0 * c["attention.kernel_calls"] / c["attention.calls"]
