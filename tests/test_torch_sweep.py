"""The port's robustness sweep (``python -m evreal_tpu_torch.sweep``) on the
CPU: its synthetic sequences byte-equal to
``tools/make_synthetic_sequence.py``'s; its score rows on the t, k and kr
conditions within 2e-5 of the JAX package's ``evaluate`` on the same data
and the same ``.pth`` file (FireNet+ at its published width), with the
same frame indices; ``evreal_tpu_torch.analysis.read_scores`` equal to
``analysis/robustness.read_scores`` on that tree; exit code 1, with every
condition run, when a condition fails."""

import contextlib
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from analysis import robustness
from evreal_tpu_torch import analysis, sweep
from evreal_tpu_torch.analysis import read_scores
from evreal_tpu_torch.bench.models import write_method_checkpoints
from evreal_tpu_torch.data.synthetic import make_sequence

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_synthetic_sequence import make_sequence as tool_sequence  # noqa: E402

torch.set_num_threads(1)

TINY = {"height": 32, "width": 48, "duration": 0.4, "events_per_frame": 3000}
# the sweep's runs, a family each (--conditions stay inside one family)
RUNS = (("t", ("t10ms", "t40ms")), ("k", ("k5k",)), ("kr", ("kr0.5",)))
CONDITIONS = [c for _, conds in RUNS for c in conds]
METHOD = "FireNet+"
# FireNet+ takes seed 1 + 3: its random output lies inside (0, 1); at
# seed 3 it is below 0 on every pixel, so its clipped frames, and scores,
# would not depend on the events
SEED = 1
TOL_JAX = 2e-5


def run_sweep(argv):
    """(exit code, summary) of ``sweep.main``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = sweep.main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def cpu_argv(root, family, conditions):
    return ["--device", "cpu", "--root", str(root), "--methods", METHOD,
            "--family", family, "--conditions", *conditions]


def provision(root):
    sweep.provision_dataset(str(root), **TINY)
    write_method_checkpoints(torch, str(root), [METHOD], seed=SEED)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("hw", [(32, 48), (40, 56)])
def test_synthetic_sequence_byte_equal_to_the_tool(tmp_path, seed, hw):
    kw = {"height": hw[0], "width": hw[1], "duration_s": 0.4, "fps": 25,
          "events_per_frame": 500, "seed": seed}
    make_sequence(str(tmp_path / "port"), **kw)
    tool_sequence(str(tmp_path / "tool"), **kw)
    names = sorted(os.listdir(tmp_path / "tool"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert "metadata.json" in names and len(names) == 7
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "tool" / name).read_bytes()), name


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The JAX package's ``evaluate`` and the port's sweep over the same
    sequences and ``.pth``: ({"jax": outputs, "torch": outputs}, [sweep
    summaries])."""
    import evreal_tpu.utils
    from evreal_tpu.harness import runner as jax_runner
    from evreal_tpu.harness import staging

    root = tmp_path_factory.mktemp("sweep")
    provision(root)
    cache = tmp_path_factory.mktemp("converted")
    cwd = os.getcwd()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(evreal_tpu.utils, "enable_compile_cache",
                       lambda: None)
            mp.setattr(staging, "_compute_seen", False)
            mp.setattr(staging, "_staged_bytes", 0)
            mp.setattr(jax_runner, "_converted_cache_path",
                       lambda name, pth: str(cache / f"{name}.npz"))
            os.chdir(root)
            with contextlib.redirect_stdout(io.StringIO()):
                jax_runner.evaluate([METHOD], CONDITIONS, [sweep.DATASET],
                                    ["mse", "ssim"])
    finally:
        os.chdir(cwd)
    (root / "outputs").rename(root / "outputs_jax")
    summaries = []
    for family, conditions in RUNS:
        rc, summary = run_sweep(cpu_argv(root, family, conditions))
        assert rc == 0 and summary["ok"], summary
        summaries.append(summary)
    return {"jax": root / "outputs_jax", "torch": root / "outputs"}, summaries


@pytest.mark.parametrize("condition", CONDITIONS)
def test_rows_agree_with_jax_evaluate(trees, condition):
    out, _ = trees
    for seq in ("seq0", "seq1"):
        for metric in ("mse", "ssim"):
            rows = [np.loadtxt(out[k] / condition / sweep.DATASET / seq
                               / METHOD / f"{metric}.txt", ndmin=2)
                    for k in ("jax", "torch")]
            assert rows[0].shape == rows[1].shape and len(rows[0]) >= 1
            np.testing.assert_array_equal(rows[1][:, 0], rows[0][:, 0])
            np.testing.assert_allclose(rows[1][:, 1], rows[0][:, 1],
                                       rtol=0, atol=TOL_JAX)


def test_summary_and_read_scores_match_the_analysis_module(trees):
    out, summaries = trees
    for (family, conditions), summary in zip(RUNS, summaries):
        assert [r["condition"] for r in summary["conditions"]] == \
            list(conditions)
        for r in summary["conditions"]:
            assert r["returncode"] == 0 and not r["contained_exception"]
            # the CPU path launches no kernel
            assert r["voxelize_launches"] == {"highest": 0, "default": 0}
        assert set(summary["means"][METHOD]) == set(conditions)
    for pattern in ("t*ms", "k*k", "kr*", "*"):
        for metric in ("mse", "ssim"):
            for datasets in (None, [sweep.DATASET], ["ECD"]):
                got = read_scores(str(out["torch"]), pattern, metric,
                                  datasets=datasets)
                want = robustness.read_scores(str(out["torch"]), pattern,
                                              metric, datasets=datasets)
                assert got.keys() == want.keys()
                for model, conds in want.items():
                    assert got[model].keys() == conds.keys()
                    for c, v in conds.items():
                        assert got[model][c] == pytest.approx(v, rel=1e-12)
    assert read_scores(str(out["torch"]), "*", "mse",
                       skip_models=(METHOD,)) == {}
    # the frames depend on the events: a window length changes the scores
    means = summaries[0]["means"][METHOD]
    assert means["t10ms"] != means["t40ms"]
    models = sweep.ALL_METHODS[::-1] + ["other"]
    assert analysis.order_models(models) == robustness.order_models(models)
    for c in sweep.T_CONDITIONS + sweep.K_CONDITIONS + sweep.KR_CONDITIONS:
        assert analysis.extract_numeric_value(c) == \
            robustness.extract_numeric_value(c)


@pytest.mark.parametrize("fault", ["missing_pth", "bad_eval_config"])
def test_a_failing_condition_exits_1_and_the_rest_run(tmp_path, fault):
    provision(tmp_path)
    if fault == "missing_pth":
        # evaluate contains the load error and exits 0: every condition
        # fails on the line it prints
        cfg = tmp_path / "config" / "method" / f"{METHOD}.json"
        cfg.parent.mkdir(parents=True)
        cfg.write_text(json.dumps({"model_name": METHOD,
                                   "model_path": "pretrained/none/model.pth",
                                   "event_tensor_normalization": False,
                                   "post_process_norm": "none"}))
    else:
        # t10ms alone names a window method that does not exist
        cfg = tmp_path / "config" / "eval" / "t10ms.json"
        cfg.parent.mkdir(parents=True)
        cfg.write_text(json.dumps({"dataset_kwargs": {
            "num_bins": 5, "voxel_method": {"method": "nosuch"}}}))
    rc, summary = run_sweep(cpu_argv(tmp_path, "t", ["t10ms", "t40ms"]))
    assert rc == 1 and summary["ok"] is False
    runs = {r["condition"]: r for r in summary["conditions"]}
    assert list(runs) == ["t10ms", "t40ms"]
    assert not runs["t10ms"]["ok"]
    if fault == "missing_pth":
        assert all(r["returncode"] == 0 and r["contained_exception"]
                   and not r["ok"] for r in runs.values())
    else:
        assert runs["t10ms"]["returncode"] not in (0, None)
        assert runs["t40ms"]["ok"] and (
            tmp_path / "outputs" / "t40ms" / sweep.DATASET / "seq1" / METHOD
            / "mse.txt").stat().st_size > 0
