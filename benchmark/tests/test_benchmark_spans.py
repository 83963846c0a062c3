"""The readers of the program's spans and counters (``lib/spans.py``): on
a synthetic Chrome trace built as ``test_benchmark_trace.py`` builds one
(the spans as annotations or as ``cpu_op`` events),
and on ``TimingLog``-shaped counters; the traced CPU rehearsal reports
the new metrics as absent, not as errors."""

import json
from collections import Counter
from types import SimpleNamespace

import pytest

from benchmark.lib import spans, trace
from benchmark.lib.spec import Spec

NEW = {"e2vid.ecd_std": ["bundle_s.eval", "feed_ms_per_frame.eval",
                         "fetch_wait_ms_per_frame.eval",
                         "writer_wait_ms_per_frame.eval",
                         "png_busy_ms_per_frame.eval",
                         "lockstep_useful.eval"],
       "e2vid.ecd_k15k": ["lockstep_useful.sweep"]}


def write_trace(path, host, cat="user_annotation"):
    dev = [("cudnn::fprop_conv_kernel", 100, 300),
           ("voxelize_scatter_kernel", 320, 330)]
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a}
              for n, a, b in dev]
    events += [{"ph": "X", "cat": cat, "name": n, "ts": a,
                "dur": b - a} for n, a, b in host]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events}, f)


def ctx_of(tmp_path, host, windows=10, lo=0, hi=1000, counts=None,
           cat="user_annotation"):
    path = tmp_path / "t.json"
    write_trace(path, host + [(trace.WINDOW_SPAN, lo, hi)], cat)
    dev, host_ev, _ = trace.read_trace(path)
    return SimpleNamespace(window=trace.Window(dev, host_ev, lo, hi),
                           windows=windows,
                           timings=SimpleNamespace(counts=counts))


@pytest.mark.parametrize("cat", ["user_annotation", "cpu_op"])
def test_union_over_overlapping_spans(tmp_path, cat):
    ctx = ctx_of(tmp_path, [
        ("evreal.pack", 0, 100), ("evreal.upload", 50, 150),
        ("evreal.pack", 400, 500), ("evreal.fetch", 500, 800),
        ("evreal.png.drain", 900, 1200), ("evreal.png.wait", 880, 890),
        ("evreal.bundle", -100, 40), ("aten::pin_memory", 60, 70)],
        cat=cat)
    assert spans.feed_ms_per_frame(ctx) == pytest.approx(250 / 1e3 / 10)
    assert spans.fetch_wait_ms_per_frame(ctx) == pytest.approx(0.03)
    # spans cut to the traced slice
    assert spans.writer_wait_ms_per_frame(ctx) == pytest.approx(0.011)
    assert spans.bundle_s(ctx) == pytest.approx(40e-6)


def test_nested_spans_of_one_metric_count_once(tmp_path):
    ctx = ctx_of(tmp_path, [("evreal.png.wait", 10, 20),
                            ("evreal.png.wait", 15, 18),
                            ("evreal.png.drain", 12, 30)], windows=1)
    assert spans.writer_wait_ms_per_frame(ctx) == pytest.approx(0.02)


@pytest.mark.parametrize("reader", ["bundle_s", "feed_ms_per_frame",
                                    "fetch_wait_ms_per_frame",
                                    "writer_wait_ms_per_frame"])
def test_span_readers_none_without_their_spans(tmp_path, reader):
    read = getattr(spans, reader)
    # an older program: no evreal.* span at all
    assert read(ctx_of(tmp_path, [("aten::detach", 0, 100)])) is None
    # one name of a union missing
    partial = ctx_of(tmp_path, [("evreal.pack", 0, 10),
                                ("evreal.png.wait", 0, 10)])
    if reader in ("feed_ms_per_frame", "writer_wait_ms_per_frame"):
        assert read(partial) is None
    # no device trace
    assert read(SimpleNamespace(window=None, windows=10)) is None


def test_counter_readers(tmp_path):
    counts = Counter({"lane_windows.real": 713, "lane_windows.computed": 896,
                      "png.frames": 1426, "png.bytes": 9_000_000,
                      "png.busy_s": 2.852})
    ctx = ctx_of(tmp_path, [], counts=counts)
    assert spans.lockstep_useful(ctx) == pytest.approx(100 * 713 / 896)
    assert spans.png_busy_ms_per_frame(ctx) == pytest.approx(2.0)


@pytest.mark.parametrize("counts", [
    None, Counter(), Counter({"lane_windows.real": 5}),
    Counter({"png.bytes": 5})])
def test_counter_readers_none_without_counts(tmp_path, counts):
    ctx = ctx_of(tmp_path, [], counts=counts)
    assert spans.lockstep_useful(ctx) is None
    assert spans.png_busy_ms_per_frame(ctx) is None


def test_counter_readers_none_off_the_card(tmp_path):
    """No device trace: nothing is reported, whatever the counts hold; and
    a ``TimingLog`` without ``counts`` (an older program) is no error."""
    ctx = SimpleNamespace(window=None, windows=10, timings=SimpleNamespace(
        counts=Counter({"lane_windows.real": 1, "lane_windows.computed": 2,
                        "png.frames": 1, "png.busy_s": 0.1})))
    assert spans.lockstep_useful(ctx) is None
    old = ctx_of(tmp_path, [])
    old.timings = SimpleNamespace(samples={})
    assert spans.lockstep_useful(old) is None
    assert spans.png_busy_ms_per_frame(old) is None


@pytest.mark.parametrize("metric", sorted(sum(NEW.values(), [])))
def test_metric_files_bind_the_readers(metric):
    spec = Spec()
    entry = next(m for m in spec.bench["per_layer"] if m["name"] == metric)
    base = metric.rsplit(".", 1)[0]
    assert spec.reader(metric) is getattr(spans, base)
    assert entry["workloads"] == [c for c, ms in NEW.items() if metric in ms]


@pytest.mark.parametrize("workload", sorted(NEW))
def test_traced_rehearsal_reports_them_absent(rehearse, workload):
    out, rc = rehearse(workload, seconds=0.0, trace=1)
    assert rc == 0 and out["correct"]
    assert not set(NEW[workload]) & set(out["metrics"])
