"""ET-Net through the port's ``evaluate`` on the CPU.

A three-lane lockstep group of the benchmark's ``etnet.bsergb_std`` cell
at its rehearsal size (``benchmark/run.py --rehearse``, the mix cut to its
first three sequences) comes out ``correct`` against the plain reference,
traced, with no device metric. A three-lane group of unequal lengths
under ``torch.profiler`` exports ET-Net's spans (``models/etnet.py:
SPANS``) once a model step, inside ``evreal.step``, and counts its
attention calls: 21 a step (3 scales x (3 encoder self-attentions + 2 x 2
decoder ones)), none fused on the CPU, and N x 8 x L x L products each,
summed over the running lanes of every step; ``summary()`` says so."""

import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import scene  # noqa: E402
from benchmark.lib.spec import Spec, read_json  # noqa: E402
from benchmark.lib.weights import draw, save_pth  # noqa: E402
from benchmark.reference.models import param_shapes  # noqa: E402
from evreal_tpu_torch.harness import runner as trunner  # noqa: E402
from evreal_tpu_torch.harness.timers import (  # noqa: E402
    ATTENTION_COUNTS,
    STEP,
    TimingLog,
)
from evreal_tpu_torch.models.etnet import SPANS as MODEL_SPANS  # noqa: E402

torch.set_num_threads(1)

CELL = "etnet.bsergb_std"
CALLS_A_STEP = 21
HEADS = 8


@pytest.fixture(scope="module")
def three_lane_spec(tmp_path_factory):
    """A root whose benchmark holds ``etnet.bsergb_std3``: the cell's
    configuration under its mix cut to three sequences."""
    root = tmp_path_factory.mktemp("bench3")
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    mix = read_json(root / "benchmark/traffic" / f"{cell['traffic']}.json")
    mix["sequences"] = mix["sequences"][:3]
    (root / "benchmark/traffic/bsergb_std3.json").write_text(json.dumps(mix))
    shutil.copy(root / "benchmark/limits" / f"{CELL}.json",
                root / "benchmark/limits" / f"{CELL}3.json")
    bench["workloads"].append(dict(cell, name=CELL + "3",
                                   traffic="bsergb_std3"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(CELL + "3")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Spec(root)


def test_three_lane_rehearsal_is_correct(three_lane_spec, tmp_path,
                                         monkeypatch, capsys):
    from benchmark import run

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.chdir(ROOT)
    # the test process holds JAX (tests/conftest.py); the run is refused
    # only for what it loads itself
    held, loaded = set(run.forbidden_modules()), run.forbidden_modules
    monkeypatch.setattr(run, "forbidden_modules",
                        lambda: sorted(set(loaded()) - held))
    rc = run.main(["--workload", CELL + "3", "--seed", str(2 ** 31 + 7),
                   "--seconds", "0", "--trace", "1", "--rehearse"],
                  three_lane_spec)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["correct"] is True, out["checks"]
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["missing"] == 0 and out["failed"] == 0
    assert checks["px_share"] < 0.01
    for metric in ("mse", "ssim", "lpips"):
        assert checks.get(f"{metric}_gap", 0) < 1e-4
    assert out["attempted"] == 2 * sum(
        max(2, round(s["windows"] * 0.5)) for s in
        three_lane_spec.cell(CELL + "3")[3]["sequences"])
    # traced on the CPU: no device trace, so of the cell's per-layer
    # metrics only the eval loop's own timing, which needs none
    assert set(out["metrics"]) == {"loop_ms_per_frame.etnet"}
    assert out["metrics"]["loop_ms_per_frame.etnet"]["value"] > 0
    assert out["device"]["platform"] == "cpu"


WINDOWS = {"lane0": 9, "lane1": 6, "lane2": 3}
CHUNK_T = 4
HW = (32, 48)  # L = 4 x 6 tokens a scale


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One ``evaluate`` of ET-Net (the cell's configuration at a narrow
    head and FFN) over three lanes of 9, 6 and 3 windows, chunks of 4,
    under ``torch.profiler``: {"events", "timings", "rows"}."""
    root = tmp_path_factory.mktemp("etnet_eval")
    config = read_json(os.path.join(ROOT, "benchmark/configs/etnet.json"))
    config["kwargs"] = dict(config["kwargs"], base_num_channels=8,
                            dim_feedforward=32)
    seqs = {}
    for i, (name, n) in enumerate(WINDOWS.items()):
        seq = scene.make_scene({"blobs": 2, "sigma_px": [3.0, 6.0],
                                "period_s": 2.0}, n, 400, 20, *HW, "cpu",
                               11, i)
        scene.write_sequence(str(root / "data" / "ESYN" / name), seq)
        seqs[name] = {"start_time_s": 0.0, "end_time_s": n / 20}
    pth = root / "model.pth"
    save_pth(pth, config, draw(param_shapes(config), config["init"], "cpu",
                               11))
    for group, name, obj in (
            ("method", "ET-Net", dict(config["method_config"],
                                      model_path=str(pth))),
            ("dataset", "ESYN", {"root_path": str(root / "data" / "ESYN"),
                                 "sequences": seqs})):
        (root / "config" / group).mkdir(parents=True, exist_ok=True)
        (root / "config" / group / f"{name}.json").write_text(
            json.dumps(obj))
    timings = TimingLog()
    path = root / "trace.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setattr(trunner, "DEFAULT_CHUNK_T", CHUNK_T)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            trunner.evaluate(["ET-Net"], ["std"], ["ESYN"], ["mse"],
                             device="cpu", timings=timings)
        prof.export_chrome_trace(str(path))
    with open(path, encoding="utf-8") as f:
        events = [(e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                  for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"
                  and str(e.get("name", "")).startswith("evreal.")]
    rows = {name: len((root / "outputs" / "std" / "ESYN" / name / "ET-Net"
                       / "timestamps.txt").read_text().splitlines())
            for name in WINDOWS}
    return {"events": events, "timings": timings, "rows": rows}


def steps(rows):
    """(model steps, lane-windows stepped) of a lockstep group narrowed at
    chunk boundaries: chunk k steps ``valid_t`` windows of its running
    lanes."""
    n_steps = lane_windows = 0
    for k in range(-(-max(rows) // CHUNK_T)):
        live = [r - k * CHUNK_T for r in rows if r > k * CHUNK_T]
        valid_t = min(CHUNK_T, max(live))
        n_steps += valid_t
        lane_windows += len(live) * valid_t
    return n_steps, lane_windows


@pytest.mark.parametrize("name", MODEL_SPANS)
def test_model_spans_once_a_step_inside_the_step(traced, name):
    n_steps, _ = steps(list(traced["rows"].values()))
    mine = [(a, b) for n, a, b in traced["events"] if n == name]
    assert len(mine) == n_steps, (name, len(mine), n_steps)
    outer = [(a, b) for n, a, b in traced["events"] if n == STEP]
    assert all(any(c <= a and b <= d for c, d in outer) for a, b in mine)


def test_attention_counts(traced):
    rows = list(traced["rows"].values())
    assert sorted(rows) == sorted(WINDOWS.values())
    n_steps, lane_windows = steps(rows)
    tokens = (HW[0] // 8) * (HW[1] // 8)
    counts = traced["timings"].counts
    assert counts["lane_windows.computed"] == lane_windows
    assert [counts[n] for n in ATTENTION_COUNTS] == [
        CALLS_A_STEP * n_steps, 0,
        CALLS_A_STEP * HEADS * tokens * tokens * lane_windows]
    calls, _, products = (counts[n] for n in ATTENTION_COUNTS)
    assert f"attention: {calls} calls, 0 fused (0.0%), {products} " \
        "products" in traced["timings"].summary()


def test_other_methods_count_no_attention(tmp_path):
    """A model without attention adds the three counters as zeros, and
    ``summary()`` prints no attention line."""
    log = TimingLog()
    with trunner.count_step(log):
        pass
    assert [log.counts[n] for n in ATTENTION_COUNTS] == [0, 0, 0]
    assert not any(line.startswith("attention") for line in log.summary())
