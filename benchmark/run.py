"""One run of one cell of ``BENCHMARK.json``:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A fresh process sets up (inputs and weights from ``--seed``, one warm
pass or a few warm pushes), measures for ``--seconds`` seconds, checks
what the timed path produced against the plain reference
(``benchmark/reference/``), and prints one JSON object as the last line
of its standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines
of standard error).

It needs the card the cell asks for and exits non-zero, printing no
result, without it. ``--rehearse`` runs the same code on the CPU at the
mix's tiny rehearsal size and reports no device metric (README.md).
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "evreal_tpu")


def process_age():
    """Seconds since this process started (Linux ``/proc``), 0 elsewhere."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


START = _T0 - process_age()


def note(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level names of loaded modules that the run must not hold,
    compared whole (``evreal_tpu_torch`` is not ``evreal_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def program_env(config):
    """The environment the program runs in: every ``EVREAL_*`` switch
    cleared, then the configuration's own; the kernel and build caches
    at fixed paths inside the checkout."""
    for key in [k for k in os.environ if k.startswith("EVREAL_")]:
        del os.environ[key]
    os.environ.update(config.get("env", {}))
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))


class Run:
    """What a kind's run is handed: the cell, the device, the working
    directory, and the set-up's clock."""

    def __init__(self, spec, cell, config, mix, args, device, workdir):
        self.spec, self.cell, self.config, self.mix = spec, cell, config, mix
        self.seed, self.rehearse = args.seed, args.rehearse
        self.device, self.workdir = device, workdir
        self.marks = []

    def write_config(self, group, name, obj):
        """``config/<group>/<name>.json`` in the working directory, which
        the program searches before the repository's."""
        path = os.path.join(self.workdir, "config", group, name + ".json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(obj, f)

    def mark(self, label):
        """Close a stage of set-up: its seconds go to standard error."""
        self.sync()
        now = time.perf_counter()
        last = self.marks[-1][1] if self.marks else START
        self.marks.append((label, now))
        note(f"setup {label}: {now - last:.3f} s")

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def note(self, msg):
        note(msg)


@contextlib.contextmanager
def profiled(device, path):
    """``torch.profiler`` over the block (host, and the card's kernels
    where there is one), the block in the ``bench.window`` span; the
    Chrome trace goes to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.lib.trace import WINDOW_SPAN

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            yield
        if device.type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


class Layers:
    """What the per-layer readers (``benchmark/metrics/<name>.py``) read:
    ``window`` (``lib.trace.Window`` of the traced slice, None without
    device events), ``peaks`` (``lib.peaks``' row of the card, None off
    it), ``peak_flops``, ``flops_per_window``, and the kind's counts of
    the traced slice (``windows``, ``events``, ``grid_bytes``, ...)."""

    def __init__(self, window, peaks, config, flops_per_window, counts):
        self.window, self.peaks = window, peaks
        self.peak_flops = (peaks["flops"][config["peak"]]
                           if peaks is not None else None)
        self.flops_per_window = flops_per_window
        self.__dict__.update(counts)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU at the mix's tiny size (no device "
                        "metric)")
    return p.parse_args(argv)


def main(argv=None, spec=None):
    """One run; ``spec`` (a ``lib.spec.Spec``) defaults to this checkout's
    ``BENCHMARK.json``."""
    args = parse(argv)
    sys.path.insert(0, ROOT)
    from benchmark.lib.spec import Spec, kind_module

    spec = spec or Spec()
    cell, _, config, mix = spec.cell(args.workload)
    program_env(config)
    import torch

    if args.rehearse:
        device = torch.device("cpu")
        torch.set_num_threads(min(4, os.cpu_count() or 1))
    else:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            note(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                 f"this machine has "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda")
        torch.zeros(1, device=device)  # the CUDA context, in set-up
        torch.cuda.reset_peak_memory_stats()
    tmp = os.environ.get("TMPDIR") or tempfile.gettempdir()
    workdir = tempfile.mkdtemp(prefix=f"bench-{args.workload}-", dir=tmp)
    cwd = os.getcwd()
    try:
        return measure(args, spec, cell, config, mix, device, workdir,
                       kind_module(mix["kind"]))
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)


def measure(args, spec, cell, config, mix, device, workdir, kind):
    import torch

    from benchmark.lib import check, peaks, trace

    run = Run(spec, cell, config, mix, args, device, workdir)
    note(f"cell {cell['name']} seed {args.seed} on "
         f"{torch.cuda.get_device_name() if device.type == 'cuda' else 'cpu'}")
    if device.type == "cuda":
        note("card: " + card_state())
    run.mark("imports and device")
    k = kind.Run(run)
    k.setup()
    t_setup = time.perf_counter()
    path = os.path.join(workdir, "trace.json")
    e2e = k.window(args.seconds, (lambda: profiled(device, path))
                   if args.trace else None)
    # a kind whose window starts with untimed warm traffic says when its
    # timed work began
    e2e["setup_s"] = getattr(k, "timed_from", t_setup) - START
    layers, breakdown = None, None
    if args.trace:
        dev_events, host, _ = trace.read_trace(path)
        os.remove(path)
        span = trace.span(host, trace.WINDOW_SPAN)
        window = trace.Window(dev_events, host, *span)
        if not window.device:
            window = None
        name = torch.cuda.get_device_name() if device.type == "cuda" else ""
        layers = Layers(window, peaks.peaks(name), config,
                        peaks.flops_per_window(config, k.h, k.w),
                        k.layer_counts())
        breakdown = window.breakdown() if window is not None else None
    bad = forbidden_modules()
    if bad:
        note(f"the run loaded {', '.join(bad)}: refused")
        return 3
    dev_block = device_block(device, cell)
    if layers is not None and layers.window is not None:
        dev_block.update(busy_s=layers.window.busy_us / 1e6,
                         window_s=layers.window.window_us / 1e6)
    k.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = k.check()
    correct, rows = check.judge(values,
                                check.limits(spec.root, cell["name"]))
    note(f"check: {time.perf_counter() - t_check:.3f} s; readings "
         + json.dumps(values))
    note(f"disk: {disk_bytes(workdir)} bytes in the working directory")
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(cell["name"], section):
        value = (spec.reader(m["name"])(layers) if args.trace
                 else e2e[m["name"]])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": k.attempted(),
           "failed": k.failed, "metrics": metrics, "device": dev_block}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    for n, v, lim in rows:
        note(f"check {n}: {v!r} (limit {lim!r})")
    print(json.dumps(out), flush=True)
    return 0


def disk_bytes(top):
    """Bytes of the files under ``top``: what the run wrote and kept."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(top) for f in files)


def card_state():
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def device_block(device, cell):
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
            "count": cell["chips"],
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(cell["chips"]))}


if __name__ == "__main__":
    sys.exit(main())
