"""The eval loop's spans and counters (``evreal_tpu_torch/harness/
timers.py``: ``span``, ``SPANS``, ``TimingLog.counts``) on the CPU: a
three-lane lockstep ``evaluate`` of a narrow FireNet+ under
``torch.profiler`` exports every span (once a chunk where a chunk has
one, once a call for the datasets and the bundle), nested only as
``evreal.png.wait`` in ``evreal.record``, all on the loop's thread;
without a profiler ``span`` is one shared no-op and makes no profiler
event; the lane-window counts match the windows written and
the running lanes' windows chunk by chunk (the group narrows as its
lanes end), the PNG counts the files on disk; the single-sequence path
counts every stepped window as real."""

import json
import os

import pytest
import torch

from evreal_tpu_torch.data import Sequence
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.harness.timers import (
    BUNDLE,
    FETCH,
    OPEN,
    PACK,
    PNG_WAIT,
    RECORD,
    SPANS,
    STEP,
    UPLOAD,
    TimingLog,
)
from evreal_tpu_torch.utils import spans
from evreal_tpu_torch.utils.spans import span

from .test_torch_eval import make_sequence, write_inputs

torch.set_num_threads(1)

CHUNK_T = 8
METHOD = "FireNet+"
# three lanes of unequal length: the shorter two drop out of the group
DURATIONS = {"seq0": 1.7, "seq1": 0.9, "seq2": 1.25}


def lane_dirs(root):
    return {name: root / "outputs" / "std" / "SYN" / name / METHOD
            for name in DURATIONS}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One ``evaluate`` of a three-lane group under ``torch.profiler``:
    {"root", "events" (the trace's ``evreal.*`` events), "timings",
    "n_chunks", "main_tid"}."""
    root = tmp_path_factory.mktemp("tracing")
    write_inputs(root)
    for i, name in enumerate(sorted(DURATIONS)[1:]):
        make_sequence(str(root / "data" / "SYN" / name), height=40,
                      width=56, duration_s=DURATIONS[name], fps=20,
                      events_per_frame=600, seed=6 + i)
    (root / "config" / "dataset" / "SYN.json").write_text(json.dumps(
        {"root_path": "data/SYN",
         "sequences": {name: {} for name in sorted(DURATIONS)}}))
    timings = TimingLog()
    path = root / "trace.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setattr(trunner, "DEFAULT_CHUNK_T", CHUNK_T)
        mp.setenv("EVREAL_LPIPS_WEIGHTS", str(root / "lpips_alex.npz"))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            trunner.evaluate([METHOD], ["std"], ["SYN"],
                             ["mse", "ssim", "lpips"], device="cpu",
                             timings=timings)
        prof.export_chrome_trace(str(path))
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    events = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
               e.get("tid"))
              for e in trace["traceEvents"]
              if e.get("ph") == "X" and e["name"].startswith("evreal.")]
    longest = max(len(Sequence(str(root / "data" / "SYN" / n)))
                  for n in DURATIONS)
    return {"root": root, "events": events, "timings": timings,
            "n_chunks": -(-longest // CHUNK_T),
            "main_tid": next(t for n, *_, t in events if n == BUNDLE)}


@pytest.mark.parametrize("name", SPANS)
def test_every_span_is_in_the_trace(traced, name):
    assert any(n == name for n, *_ in traced["events"]), name


@pytest.mark.parametrize("name", [OPEN, BUNDLE, PACK, UPLOAD, STEP, FETCH])
def test_spans_once_a_chunk(traced, name):
    got = sum(1 for n, *_ in traced["events"] if n == name)
    want = 1 if name in (OPEN, BUNDLE) else traced["n_chunks"]
    assert traced["n_chunks"] > 2
    assert got == want, (name, got, want)


@pytest.mark.parametrize("name", SPANS)
def test_spans_nest_as_specified(traced, name):
    """Each span's enclosing ``evreal.*`` spans, on the loop's thread:
    ``evreal.png.wait`` sits in ``evreal.record``, nothing else nests."""
    events = traced["events"]
    assert {t for *_, t in events} == {traced["main_tid"]}
    want = {RECORD} if name == PNG_WAIT else set()
    for n, a, b, _ in events:
        if n != name:
            continue
        around = {m for m, c, d, _ in events
                  if (m, c, d) != (n, a, b) and c <= a and b <= d}
        assert around == want, (name, around)


def refuse(*_):
    raise AssertionError("a profiler event made with no profiler")


@pytest.mark.parametrize("name", SPANS)
def test_span_off_the_profiler_is_the_shared_no_op(monkeypatch, name):
    monkeypatch.setattr(spans, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    got = span(name)
    assert got is span(SPANS[0])
    with got:
        pass


def narrowed_counts(rows, chunk_t):
    """(lane-windows computed, lanes narrowed) of a lockstep group whose
    lanes run ``rows`` windows: chunk k runs the lanes with windows left
    in it, each for the chunk's ``valid_t``; the lanes that end before
    the group's last chunk are dropped."""
    n_chunks = -(-max(rows) // chunk_t)
    computed = 0
    for k in range(n_chunks):
        live = [r - k * chunk_t for r in rows if r > k * chunk_t]
        computed += len(live) * min(chunk_t, max(live))
    return computed, sum(1 for r in rows if -(-r // chunk_t) < n_chunks)


def test_lane_windows_of_the_group(traced):
    """``real``: the windows written (one timestamp row each);
    ``computed``: the sum over chunks of the running lanes times the
    chunk's ``valid_t``; ``lockstep.narrowed``: the lanes that end before
    the group's last chunk."""
    rows = {name: len((d / "timestamps.txt").read_text().splitlines())
            for name, d in lane_dirs(traced["root"]).items()}
    counts = traced["timings"].counts
    assert len(set(rows.values())) == len(DURATIONS)
    computed, narrowed = narrowed_counts(list(rows.values()), CHUNK_T)
    assert narrowed == len(rows) - 1
    assert counts["lane_windows.real"] == sum(rows.values())
    assert counts["lane_windows.computed"] == computed
    assert counts["lane_windows.computed"] < len(rows) * max(rows.values())
    assert counts["lockstep.narrowed"] == narrowed


@pytest.mark.parametrize("counter", ["png.frames", "png.bytes"])
def test_png_counts_match_the_disk(traced, counter):
    files = [f for d in lane_dirs(traced["root"]).values()
             for f in d.glob("frame_*.png")]
    want = (len(files) if counter == "png.frames"
            else sum(os.path.getsize(f) for f in files))
    counts = traced["timings"].counts
    assert files and counts[counter] == want
    assert 0 < counts["png.busy_s"]


def test_summary_reports_the_counts(traced):
    lines = traced["timings"].summary()
    assert any(line.startswith("lockstep: ")
               and line.endswith(", 2 lanes narrowed") for line in lines), \
        lines
    assert any(line.startswith("png writers: ") for line in lines), lines


def test_single_path_counts_every_window_real(traced, tmp_path,
                                              monkeypatch):
    """One sequence through ``eval_method_on_sequence``, no profiler (a
    profiler event would raise): real equals computed equals the windows
    written."""
    monkeypatch.setattr(spans, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(trunner, "DEFAULT_CHUNK_T", CHUNK_T)
    monkeypatch.chdir(traced["root"])
    cfg = trunner.get_method_config(METHOD)
    bundle = trunner.MethodBundle(METHOD, cfg, "cpu")
    seq_dir = traced["root"] / "data" / "SYN" / "seq1"
    sequence = {"name": "one", "dataset": Sequence(
        str(seq_dir), num_bins=5, voxel_method={"method": "between_frames"}),
        "start_time_s": 0.0, "end_time_s": 10.0}
    log = TimingLog()
    monkeypatch.chdir(tmp_path)
    trunner.eval_method_on_sequence("SYN", {"name": "std", "ts_tol_ms": 1.0},
                                    METHOD, bundle, cfg, sequence, ["mse"],
                                    log)
    out = tmp_path / "outputs" / "std" / "SYN" / "one" / METHOD
    written = len((out / "timestamps.txt").read_text().splitlines())
    assert written > CHUNK_T
    assert log.counts["lane_windows.real"] == written
    assert log.counts["lane_windows.computed"] == written
    assert log.counts["png.frames"] == len(list(out.glob("frame_*.png")))
