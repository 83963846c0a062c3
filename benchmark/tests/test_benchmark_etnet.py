"""The ET-Net cell (``etnet.bsergb_std``): its per-layer readers on a
synthetic trace and synthetic counts (each None where it has nothing to
read), the device time under a span by correlation id and by device-side
annotation (``lib/devspans.py``), the FLOPs a window against a count by
hand, the attention's least time (``lib/attention.py``), the cell's CPU
rehearsal, and a fault in the attention (one block of keys dropped) that
comes out not correct."""

import json
import math
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from benchmark.lib import attention, devspans, trace
from benchmark.lib.peaks import PEAKS, flops_per_window
from benchmark.lib.spec import Spec

CELL = "etnet.bsergb_std"
NEW = ["mfu.etnet", "idle_share.etnet", "attention_roofline.etnet",
       "transformer_ms_per_frame.etnet", "attention_fused.etnet"]
SPAN = "evreal.etnet.transformer"
H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def config():
    return Spec().cell(CELL)[2]


def raw_trace(path, annotate=False):
    """A loop thread (tid 1) that launches kernels 1-3 inside the
    transformer span and kernel 4 after it; a writer thread (tid 2) that
    launches kernel 5 inside an overlapping span of the same name on
    another thread is not the loop's. ``annotate`` adds the device-side
    annotation of the span."""
    ev = [{"ph": "X", "cat": "cpu_op", "name": SPAN, "ts": 100, "dur": 100,
           "pid": 1, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN,
           "ts": 0, "dur": 2000, "pid": 1, "tid": 1}]
    for corr, ts, tid in ((1, 110, 1), (2, 150, 1), (3, 190, 1),
                          (4, 210, 1), (5, 150, 2)):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": ts, "dur": 5, "pid": 1,
                   "tid": tid, "args": {"correlation": corr}})
    names = {1: "attention_fwd_kernel", 2: "attention_fwd_kernel",
             3: "vectorized_layer_norm_kernel", 4: "cudnn::fprop",
             5: "elementwise_kernel"}
    start = 300
    for corr, name in names.items():
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": start,
                   "dur": 100 * corr, "pid": 0, "tid": 7,
                   "args": {"correlation": corr}})
        start += 100 * corr + 10
    if annotate:
        ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": SPAN,
                   "ts": 300, "dur": 640, "pid": 0, "tid": 7})
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": ev}, f)


def ctx_of(path, **counts):
    dev, host, _ = trace.read_trace(path)
    window = trace.Window(dev, host, 0, 2000)
    base = dict(windows=2, config=config(), height=625, width=970,
                span_device_us=devspans.device_us_under(path, (SPAN,)),
                timings=SimpleNamespace(counts=Counter(counts)))
    return SimpleNamespace(window=window, peaks=H100, **base)


def test_device_time_under_a_span_by_correlation(tmp_path):
    raw_trace(tmp_path / "t.json")
    got = devspans.device_us_under(tmp_path / "t.json",
                                   (SPAN, "evreal.etnet.decode"))
    assert got == {SPAN: 100 + 200 + 300}


def test_device_time_under_a_span_by_annotation(tmp_path):
    raw_trace(tmp_path / "t.json", annotate=True)
    assert devspans.device_us_under(tmp_path / "t.json", (SPAN,)) == \
        {SPAN: 640}


def test_no_trace_reads_nothing(tmp_path):
    assert devspans.device_us_under(tmp_path / "missing.json", (SPAN,)) == {}


def test_readers_on_a_synthetic_trace(tmp_path):
    raw_trace(tmp_path / "t.json")
    ctx = ctx_of(tmp_path / "t.json", **{"attention.calls": 42,
                                         "attention.kernel_calls": 42})
    spec = Spec()
    least = attention.least_seconds(config(), 625, 970, 2, 67e12, 3.35e12)
    assert spec.reader("attention_roofline.etnet")(ctx) == pytest.approx(
        100.0 * least / 300e-6)
    assert spec.reader("transformer_ms_per_frame.etnet")(ctx) == \
        pytest.approx(0.6 / 2)
    assert spec.reader("attention_fused.etnet")(ctx) == 100.0


@pytest.mark.parametrize("metric", ["attention_roofline.etnet",
                                    "transformer_ms_per_frame.etnet",
                                    "attention_fused.etnet"])
def test_readers_none_where_nothing_is_there(tmp_path, metric):
    read = Spec().reader(metric)
    # off the card: no device trace, whatever the rest holds
    raw_trace(tmp_path / "t.json")
    ctx = ctx_of(tmp_path / "t.json", **{"attention.calls": 4})
    ctx.window = None
    assert read(ctx) is None
    # an older program: no span, no attention kernel, no counters; and
    # the plain eval kind, which hands no shapes
    with open(tmp_path / "old.json", "w", encoding="utf-8") as f:
        json.dump({"traceEvents": [
            {"ph": "X", "cat": "kernel", "name": "cudnn::fprop", "ts": 10,
             "dur": 5, "args": {"correlation": 9}}]}, f)
    old = ctx_of(tmp_path / "old.json")
    assert read(old) is None
    plain = SimpleNamespace(window=old.window, peaks=H100, windows=2,
                            timings=SimpleNamespace(samples={}))
    assert read(plain) is None


def test_metric_entries():
    spec = Spec()
    for name in NEW:
        entry = next(m for m in spec.bench["per_layer"] if m["name"] == name)
        assert entry["workloads"] == [CELL] and entry["moves"] == "eval_fps"
        assert callable(spec.reader(name))
    e2e = next(m for m in spec.bench["end_to_end"] if m["name"] == "eval_fps")
    assert CELL in e2e["workloads"]


def test_attention_calls_of_a_window():
    calls = attention.calls(config(), 625, 970)
    assert calls == [(8, 9638, 9638, 32)] * 21
    assert sum(attention.flops(*c) for c in calls) == \
        21 * 4 * 9638 ** 2 * 256
    # compute-bound: the operations' time is some 120x the bytes'
    c = calls[0]
    assert attention.flops(c[0], *c[1:]) / 67e12 > 100 * \
        attention.bytes_moved(*c) / 3.35e12


def test_flops_a_window_hold_the_attention_by_hand():
    """``flops_per_window`` at 970 x 625 (padded 976 x 632): the hand count
    of the 21 attentions' QKᵀ and PV, plus the convolutions and the
    projections and FFNs, each counted by hand."""
    cfg = config()
    got = flops_per_window(cfg, 625, 970)
    L, d, ffn = 79 * 122, 256, cfg["kwargs"]["dim_feedforward"]
    attention_flops = 21 * 4 * L * L * d
    # per attention q, k, v and out projections; per layer an FFN
    linear = 2 * L * d * (21 * 4 * d + 15 * 2 * ffn)

    def conv(cin, cout, k, h, w):
        return 2 * cin * cout * k * k * h * w

    hp, wp = 632, 976
    convs = conv(5, 32, 5, hp, wp)
    ins = (32, 64, 128)
    for i, c in enumerate((64, 128, 256)):
        h, w = hp >> (i + 1), wp >> (i + 1)
        convs += conv(ins[i], c, 5, h, w) + conv(2 * c, 4 * c, 3, h, w)
        convs += conv(c, ins[i], 5, h * 2, w * 2)  # its upsample decoder
    convs += conv(128, 256, 2, hp // 8, wp // 8)   # split1
    convs += conv(64, 256, 4, hp // 8, wp // 8)    # split2
    convs += conv(32, 1, 1, hp, wp)                # pred
    assert got == attention_flops + linear + convs
    assert attention_flops / got == pytest.approx(0.719, abs=1e-3)
    assert math.isclose(got / 1e12, 2.7775, rel_tol=1e-4)


def test_rehearsal_is_correct(rehearse):
    out, rc = rehearse(CELL, seed=2 ** 31 + 11, seconds=0.5)
    assert rc == 0 and out["correct"] is True, out["checks"]
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["missing"] == 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"eval_fps", "setup_s"}


def test_traced_rehearsal_reports_no_device_metric(rehearse):
    out, rc = rehearse(CELL, seed=3, seconds=0.0, trace=1)
    assert rc == 0 and out["correct"]
    assert not set(NEW) & set(out["metrics"])


def drop_key_block(monkeypatch, block=16):
    """Attention that leaves out the first ``block`` keys of every call."""
    from evreal_tpu_torch.kernels import attention_cuda

    orig = attention_cuda.attention_plain

    def dropped(q, k, v):
        return orig(q, k[:, :, block:], v[:, :, block:])

    monkeypatch.setattr(attention_cuda, "attention_plain", dropped)


def test_dropped_key_block_is_not_correct(rehearse, monkeypatch):
    drop_key_block(monkeypatch)
    out, rc = rehearse(CELL, seed=5, seconds=0.0)
    assert rc == 0
    assert out["correct"] is False, out["checks"]


def test_stale_state_is_not_correct(rehearse, monkeypatch):
    from evreal_tpu_torch.models.etnet import EITR

    orig = EITR.forward

    def forward(self, voxel, state):
        out, _ = orig(self, voxel, state)
        return out, state

    monkeypatch.setattr(EITR, "forward", forward)
    out, rc = rehearse(CELL, seed=5, seconds=0.0)
    assert rc == 0
    assert out["correct"] is False, out["checks"]


@pytest.mark.cuda
def test_cell_on_the_card(card, rehearse):
    out, rc = rehearse(CELL, seed=7, seconds=0.0, trace=1, on_card=True)
    assert rc == 0 and out["correct"] is True, out["checks"]
    assert set(NEW) <= set(out["metrics"])
    for name in ("mfu.etnet", "attention_roofline.etnet"):
        assert 0 < out["metrics"][name]["value"] < 100
    assert out["metrics"]["attention_fused.etnet"]["value"] == 100.0
    assert torch.cuda.max_memory_allocated() < 40e9
