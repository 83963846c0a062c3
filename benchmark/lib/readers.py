"""The per-layer readings, each of the traced slice (``run.Layers``).
A metric's file under ``benchmark/metrics/`` binds one of them as its
``read``; one quantity read in cells that report different end-to-end
metrics is one metric a kind of cell (``mfu.eval``, ``mfu.sweep``). A
reading that finds nothing to read returns None."""

VOXELIZER = r"voxelize_"


def idle_share(ctx):
    """Share of the slice's wall in which no kernel, copy or memset ran
    on the card (``torch.profiler``'s device events), in %."""
    if ctx.window is None:
        return None
    return 100.0 * (1.0 - ctx.window.busy_us / ctx.window.window_us)


def mfu(ctx):
    """The model step's share of the chip's peak over the slice's wall,
    in %: the benchmark's own FLOPs a window (the reference network's
    convolutions at the configuration's shapes, ``lib/peaks.py``) times
    the real windows of the slice (not the empty windows of ended lanes),
    over the slice's wall and the peak of the configuration's
    arithmetic."""
    if ctx.window is None or ctx.peak_flops is None:
        return None
    flops = ctx.flops_per_window * ctx.windows
    return 100.0 * flops / (ctx.window.window_us / 1e6) / ctx.peak_flops


def voxelizer_roofline(ctx):
    """The voxelizer kernels' share of their roofline over the slice, in
    %: the least time the slice's voxel grids need (4 bytes an event
    actually in the windows, the densest wire the program has, plus the
    f32 grids written once, over the card's HBM bandwidth), over the
    summed device time of the kernels named ``voxelize_*``. The counts
    come from the benchmark's own inputs, whatever wire or path the
    program takes."""
    if ctx.window is None or ctx.peaks is None:
        return None
    kernel_s = ctx.window.kernel_us(VOXELIZER) / 1e6
    if kernel_s <= 0:
        return None
    least_s = (4 * ctx.events + ctx.grid_bytes) / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / kernel_s


def loop_ms_per_frame(ctx):
    """Steady ms per window of the eval loop, from the program's own
    ``TimingLog`` (``harness/timers.py:DeviceTimer``: each group's chunk
    loop after its first chunk, the writers' drain left out) over every
    pass of the traced run's window."""
    return ctx.timings.ms_per_frame(ctx.method)
