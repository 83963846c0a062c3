"""The device time spent on the work a program's span launched, read from
the raw ``torch.profiler`` Chrome trace (``lib/trace.py`` keeps neither
the device-side annotations nor the correlation ids it needs).

For a span name: the union of the device-side annotations of that name
(``gpu_user_annotation`` events, which ``torch.profiler`` writes for a
``record_function`` range) where the trace has them; else the summed
device time of the kernels, copies and memsets whose correlation id is
that of a launch (a ``cuda_runtime`` or ``cuda_driver`` event) made on
the span's thread inside one of the span's host events."""

import bisect
import json

from benchmark.lib.trace import DEVICE_CATS, HOST_CATS, union_us

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def device_us_under(path, names):
    """{name: device us} of each of ``names`` that the trace at ``path``
    holds as a span with device work under it; {} without a trace."""
    try:
        with open(path, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
    except (OSError, ValueError):
        return {}
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    launches = {}  # (pid, tid) -> sorted [(ts, correlation)]
    device = {}    # correlation -> device us
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        if e.get("cat") in LAUNCH_CATS:
            launches.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), corr))
        elif e.get("cat") in DEVICE_CATS:
            device[corr] = device.get(corr, 0.0) + float(e["dur"])
    for v in launches.values():
        v.sort()
    out = {}
    for name in names:
        notes = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("cat") == "gpu_user_annotation"
                 and e.get("name") == name]
        if notes:
            out[name] = union_us(notes)
            continue
        total, found = 0.0, False
        for e in events:
            if e.get("cat") not in HOST_CATS or e.get("name") != name:
                continue
            found = True
            lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            seq = launches.get((e.get("pid"), e.get("tid")), [])
            i = bisect.bisect_left(seq, (lo, -1))
            while i < len(seq) and seq[i][0] <= hi:
                total += device.get(seq[i][1], 0.0)
                i += 1
        if found and total > 0:
            out[name] = total
    return out
