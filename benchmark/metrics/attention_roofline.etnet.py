"""The attention kernels' share of their roofline over the traced pass,
in %: the least time of the pass's attention products (``lib/
attention.py``: the configuration's shapes at the cell's frame size, times
the real windows of the pass, each call max(operations / FP32 peak, bytes
/ HBM bandwidth)) over the summed device time of the kernels named
``attention_*``. None without a device trace, the cell's shapes
(``kinds/eval_spans.py``) or such kernels."""

from benchmark.lib.attention import least_seconds

KERNELS = r"attention_"


def read(ctx):
    window, peaks = getattr(ctx, "window", None), getattr(ctx, "peaks", None)
    config = getattr(ctx, "config", None)
    if window is None or peaks is None or config is None:
        return None
    kernel_s = window.kernel_us(KERNELS) / 1e6
    if kernel_s <= 0:
        return None
    least = least_seconds(config, ctx.height, ctx.width, ctx.windows,
                          peaks["flops"]["float32"],
                          peaks["hbm_bytes_per_s"])
    return 100.0 * least / kernel_s
