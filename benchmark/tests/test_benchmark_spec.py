"""A cell, configuration, traffic mix or per-layer metric added as new
files and new entries is found by name, with no edit to an existing
file; and ``BENCHMARK.json`` keeps to its contract's shape."""

import json
import shutil

from benchmark.lib.spec import ROOT, Spec


def test_new_files_are_found_without_edits(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    cfg = json.loads((ROOT / "benchmark/configs/e2vid.json").read_text())
    (tmp_path / "benchmark/configs/e2vid_small.json").write_text(
        json.dumps(dict(cfg, name="e2vid_small")))
    mix = json.loads((ROOT / "benchmark/traffic/ecd_std.json").read_text())
    (tmp_path / "benchmark/traffic/one_seq.json").write_text(
        json.dumps(dict(mix, sequences=mix["sequences"][:1])))
    (tmp_path / "benchmark/metrics/windows.eval.py").write_text(
        "def read(ctx):\n    return ctx.windows\n")
    (tmp_path / "benchmark/limits/e2vid_small.one_seq.json").write_text(
        json.dumps({"limits": {"missing": 0}}))
    bench["configs"].append({"name": "e2vid_small", "source": "x",
                             "file": "benchmark/configs/e2vid_small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "e2vid_small.one_seq",
                               "config": "e2vid_small",
                               "traffic": "one_seq", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "windows.eval", "unit": "1",
                               "better": "higher", "source": "program_counter",
                               "layer": "eval loop", "moves": "eval_fps"})
    bench["end_to_end"][0]["workloads"].append("e2vid_small.one_seq")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec(tmp_path)
    cell, entry, config, found = spec.cell("e2vid_small.one_seq")
    assert config["name"] == "e2vid_small"
    assert len(found["sequences"]) == 1
    names = [m["name"] for m in spec.metrics("e2vid_small.one_seq",
                                             "per_layer")]
    assert "windows.eval" in names
    assert "eval_fps" in [m["name"] for m in
                          spec.metrics("e2vid_small.one_seq", "end_to_end")]

    class Ctx:
        windows = 7

    assert spec.reader("windows.eval")(Ctx()) == 7
    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} was edited"


def test_every_metric_and_cell_has_its_files():
    spec = Spec()
    bench = spec.bench
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        _, _, _, mix = spec.cell(w["name"])
        assert (ROOT / "benchmark/limits" / f"{w['name']}.json").exists()
        reported = {m["name"] for m in spec.metrics(w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        if mix["kind"] == "eval":
            assert mix["rate_metric"] in reported
        layers = spec.metrics(w["name"], "per_layer")
        assert layers
        for m in layers:
            assert m["moves"] in reported
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))
