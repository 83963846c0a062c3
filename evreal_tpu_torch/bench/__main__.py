"""The port's measurement entry point (the counterpart of ``bench.py`` and
the JAX tools ``tools/bench_methods.py``, ``tools/bench_serve_latency.py``,
``tools/bench_batch_scaling.py`` and ``tools/profile_chunk.py``):

    python -m evreal_tpu_torch.bench <mode> [--device cuda|cpu] [--seed N]
        [--lanes N] [--chunk-t N] [--height H] [--width W] [--windows N]
        [--repeats N] [--events N] [mode options]

Modes: ``flagship`` (the headline), ``methods``, ``serve``, ``scaling``,
``profile`` and ``probes`` (each module's docstring says what it runs).
It runs on the card unless ``--device cpu`` is given, and raises when
``cuda`` is asked for and there is none. The first line is the card's name
and power limit as nvidia-smi prints them; the last line is one JSON
object: ``mode``, ``device`` (``platform``, ``name``, ``count``,
``power_limit_w``), ``seed``, the mode's metrics and ``units``. A
``--device cpu`` run writes no device metric (no MFU, busy share, peak
memory or probe). A failed correctness or launch check exits with code 1
before the last line.

``--windows`` is the windows a lane runs in each timed run (``serve``:
the pushes timed; ``profile``: the windows traced); ``--lanes`` in
``serve`` measures an N-lane ``push_group`` in place of a stream.
"""

import argparse
import json
import sys

from evreal_tpu_torch.bench import (batch_scaling, common, flagship, methods,
                                    probes, profile_chunk, serve_latency)
from evreal_tpu_torch.utils import resolve_device

MODES = {"flagship": flagship, "methods": methods, "serve": serve_latency,
         "scaling": batch_scaling, "profile": profile_chunk,
         "probes": probes}
DIMS = ("lanes", "chunk_t", "height", "width", "windows", "repeats",
        "events", "warmup")
DTYPES = ("float32", "bfloat16")


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m evreal_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=sorted(MODES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    for dim in DIMS:
        ap.add_argument("--" + dim.replace("_", "-"), type=int)
    ap.add_argument("-m", "--methods", nargs="+",
                    help="methods and serve: the methods to run")
    ap.add_argument("--batches", nargs="+", type=int,
                    help="scaling: lane counts (default 8 16 32 64)")
    ap.add_argument("--dtypes", nargs="+", choices=DTYPES,
                    default=list(DTYPES), help="scaling: dtypes")
    ap.add_argument("--dtype", choices=DTYPES, default="float32",
                    help="serve and profile: the serving dtype")
    ap.add_argument("--wire", choices=("f32", "compact", "compact4"),
                    default="f32", help="serve: the wire")
    ap.add_argument("--trace", help="profile: where the Chrome trace goes")
    ap.add_argument("--trace-only", metavar="FILE",
                    help="profile: report on this Chrome trace of "
                    "--windows // --chunk-t chunks; runs nothing")
    ap.add_argument("--top", type=int, default=20,
                    help="profile: kernels listed")
    return ap.parse_args(argv)


def dims_of(args, defaults):
    """The mode's sizes: each argument given, else the mode's default."""
    return {k: getattr(args, k) if getattr(args, k) is not None else v
            for k, v in defaults.items()}


def measure(args, device):
    """(metrics, units) of ``args.mode`` on ``device``."""
    mod = MODES[args.mode]
    dims = dims_of(args, getattr(mod, "DEFAULTS", {}))
    if args.mode == "methods":
        return mod.run(dims, device, args.seed, args.methods)
    if args.mode == "serve":
        return mod.run(dims, device, args.seed, args.methods,
                       args.lanes or 0, args.dtype, args.wire)
    if args.mode == "scaling":
        return mod.run(dims, device, args.seed, args.batches, args.dtypes)
    if args.mode == "profile":
        return mod.run(dims, device, args.seed, args.dtype, args.trace,
                       args.top)
    return mod.run(dims, device, args.seed)


def trace_only(args):
    """The profile report of an exported trace: the last line's device is
    the trace's (no power limit: the trace does not record it)."""
    dims = dims_of(args, profile_chunk.DEFAULTS)
    chunks = max(1, dims["windows"] // dims["chunk_t"])
    m = profile_chunk.analyze(args.trace_only, chunks, args.top)
    platform = "gpu" if "device_busy_ms" in m else "cpu"
    return {"mode": "profile", "device": {"platform": platform,
                                          "name": m["trace_device"],
                                          "count": 1 if platform == "gpu"
                                          else 0, "power_limit_w": None},
            "seed": None, **m,
            "units": {k: v for k, v in profile_chunk.UNITS.items()
                      if k in common.keys_in(m)}}


def main(argv=None):
    args = parse(argv)
    if args.mode == "profile" and args.trace_only:
        print(f"trace: {args.trace_only}", flush=True)
        print(json.dumps(trace_only(args)), flush=True)
        return 0
    device = resolve_device(args.device)
    print(common.card_line(device), flush=True)
    metrics, units = measure(args, device)
    if args.mode == "flagship" and device.type == "cuda":
        # the card's state beside the headline (bench.py stamps its probes)
        metrics["probes"] = probes.run_probes(device)
        units = {**units, **probes.UNITS}
    print(json.dumps(common.result(args.mode, device, args.seed, metrics,
                                   units)), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except common.BenchError as exc:
        print(f"bench: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
