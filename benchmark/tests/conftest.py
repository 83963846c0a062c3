"""The benchmark's own tests (``python -m pytest benchmark/tests``): on the
CPU at the mixes' tiny rehearsal sizes; the ``cuda`` ones run on the card
and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")


@pytest.fixture
def spec_for(tmp_path_factory):
    """``spec_for(workload)``: the ``Spec`` that runs ``workload`` — this
    checkout's, or for a cell that ``BENCHMARK.json`` does not hold
    (``extra_cells.json``: ``firenet_plus.ecd_std`` and ``e2vid.stream4``,
    PERF.md §7), a root whose ``BENCHMARK.json`` adds those cells and
    their configurations beside this ``benchmark/``."""
    import json

    from benchmark.lib.spec import Spec

    def make(workload):
        spec = Spec()
        if workload in {w["name"] for w in spec.bench["workloads"]}:
            return spec
        root = tmp_path_factory.mktemp("extra_root")
        bench = dict(spec.bench)
        with open(os.path.join(os.path.dirname(__file__),
                               "extra_cells.json"), encoding="utf-8") as f:
            extra = json.load(f)
        for key in ("configs", "workloads"):
            bench[key] = bench[key] + extra[key]
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
        (root / "benchmark").symlink_to(os.path.join(ROOT, "benchmark"))
        return Spec(root)

    return make


@pytest.fixture
def rehearse(tmp_path, monkeypatch, capsys, spec_for):
    """Run a cell with ``--rehearse`` (or, ``on_card``, at its own size on
    the card) in this process; returns its result line as a dict (or None
    when it printed none) and its exit code."""
    from benchmark import run

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.chdir(ROOT)

    def go(workload, seed=11, seconds=0.0, trace=0, on_card=False):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)]
                      + ([] if on_card else ["--rehearse"]),
                      spec_for(workload))
        lines = capsys.readouterr().out.strip().splitlines()
        import json

        return (json.loads(lines[-1]) if lines else None), rc

    return go
