"""Both command lines on the CPU over one small synthetic sequence: the JAX
package's (``eval.py``, evreal_tpu.cli) and the port's
(``python -m evreal_tpu_torch``), with the same random-init narrow E2VID
and FireNet+ weights saved as ``.npz`` + sidecar and ``-qm mse ssim
lpips`` with one random LPIPS ``.npz`` (``EVREAL_LPIPS_WEIGHTS``). Score
rows agree within 2e-5, PNG frames within 1 grey level, and timestamps,
event rates, frame sets and ``done.json``'s metrics byte for byte. Without
the LPIPS file the port prints the JAX package's skip line and writes the
same mse/ssim rows."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evreal_tpu_torch.cli import main as torch_main
from evreal_tpu_torch.convert.params import flatten, save_params
from evreal_tpu_torch.harness.runner import evaluate
from evreal_tpu_torch.models.init import init_e2vid, init_firenet

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

from .test_torch_lpips import jax_layout_weights  # noqa: E402

torch.set_num_threads(1)

METHODS = {
    "E2VID": ({"class": "E2VIDRecurrent",
               "kwargs": {"num_bins": 5, "base_num_channels": 8,
                          "kernel_size": 3, "num_encoders": 2,
                          "recurrent_block_type": "convlstm",
                          "num_residual_blocks": 1, "skip_type": "sum",
                          "norm": None, "use_upsample_conv": True,
                          "final_activation": "sigmoid"}},
              lambda: init_e2vid(seed=0, base_num_channels=8, kernel_size=3,
                                 num_encoders=2, num_residual_blocks=1),
              {"event_tensor_normalization": True,
               "post_process_norm": "robust"}),
    "FireNet+": ({"class": "FireNet", "num_encoders": 0,
                  "kwargs": {"num_bins": 5, "base_num_channels": 8,
                             "kernel_size": 3}},
                 lambda: init_firenet(seed=1, base_num_channels=8),
                 {"event_tensor_normalization": False,
                  "post_process_norm": "none"}),
}
ARGS = ["-m", "E2VID", "FireNet+", "-c", "std", "-d", "SYN", "-qm", "mse",
        "ssim", "lpips"]
METRICS = ("mse", "ssim", "lpips")


def write_inputs(root):
    make_sequence(str(root / "data" / "SYN" / "seq0"), height=40, width=56,
                  duration_s=1.7, fps=20, events_per_frame=600, seed=5)
    for group in ("method", "dataset"):
        (root / "config" / group).mkdir(parents=True)
    for name, (meta, make, flags) in METHODS.items():
        path = root / "pretrained" / name / "model.npz"
        path.parent.mkdir(parents=True)
        save_params(path, flatten(make()), {**meta, "model_name": name})
        cfg = {"model_name": name, "model_path": str(path.relative_to(root)),
               **flags}
        (root / "config" / "method" / f"{name}.json").write_text(
            json.dumps(cfg))
    (root / "config" / "dataset" / "SYN.json").write_text(json.dumps(
        {"root_path": "data/SYN", "sequences": {"seq0": {}}}))
    np.savez(root / "lpips_alex.npz", **jax_layout_weights(11))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Output trees of both command lines: {"jax": dir, "torch": dir}."""
    import evreal_tpu.utils
    from evreal_tpu.cli import eval_main
    from evreal_tpu.harness import staging
    from evreal_tpu.metrics import registry as jreg

    root = tmp_path_factory.mktemp("eval")
    write_inputs(root)
    cwd = os.getcwd()
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            # no persistent compile cache outside the test's directory
            mp.setattr(evreal_tpu.utils, "enable_compile_cache",
                       lambda: None)
            # the JAX harness's process-wide staging state: start fresh,
            # and restore it for the tests that run after this module
            mp.setattr(staging, "_compute_seen", False)
            mp.setattr(staging, "_staged_bytes", 0)
            # the JAX registry reads the LPIPS file once per process
            mp.setattr(jreg, "_REGISTRY", {})
            mp.setattr(jreg, "_builtins_done", False)
            mp.setenv("EVREAL_LPIPS_WEIGHTS", str(root / "lpips_alex.npz"))
            for name, run in (("jax", lambda: eval_main(ARGS)),
                              ("torch", lambda: torch_main(
                                  ARGS + ["--device", "cpu"]))):
                os.chdir(root)
                run()
                out[name] = root / f"outputs_{name}"
                (root / "outputs").rename(out[name])
    finally:
        os.chdir(cwd)
    out["root"] = root
    return out


def seq_dir(base, method):
    return base / "std" / "SYN" / "seq0" / method


@pytest.mark.parametrize("method", sorted(METHODS))
def test_score_rows_agree(runs, method):
    for metric in METRICS:
        rows = [np.loadtxt(seq_dir(runs[k], method) / f"{metric}.txt")
                for k in ("jax", "torch")]
        assert rows[0].shape == rows[1].shape and len(rows[0]) >= 30
        np.testing.assert_array_equal(rows[0][:, 0], rows[1][:, 0])
        np.testing.assert_allclose(rows[1][:, 1], rows[0][:, 1], atol=2e-5)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_tree_and_text_files_match(runs, method):
    a, b = seq_dir(runs["jax"], method), seq_dir(runs["torch"], method)
    assert sorted(p.name for p in a.iterdir()) == \
        sorted(p.name for p in b.iterdir())
    for name in ("timestamps.txt", "event_rate.txt"):
        assert (a / name).read_bytes() == (b / name).read_bytes()
    ja, jb = (json.loads((d / "done.json").read_text()) for d in (a, b))
    assert ja["num_evaluated"] == jb["num_evaluated"]
    assert ja["settings"] == jb["settings"]
    assert ja["metrics"] == jb["metrics"] == list(METRICS)
    assert ja["mean_scores"].keys() == jb["mean_scores"].keys()


@pytest.mark.parametrize("method", sorted(METHODS))
def test_frames_agree(runs, method):
    cv2 = pytest.importorskip("cv2")
    frames = sorted(seq_dir(runs["jax"], method).glob("frame_*.png"))
    assert len(frames) >= 30
    for p in frames:
        want = cv2.imread(str(p), cv2.IMREAD_UNCHANGED).astype(int)
        got = cv2.imread(str(seq_dir(runs["torch"], method) / p.name),
                         cv2.IMREAD_UNCHANGED).astype(int)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1


def test_entry_points_refuse_to_run_on_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate(["E2VID"], ["std"], ["SYN"], ["mse"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_main(["-m", "E2VID", "-c", "std", "-d", "SYN"])


def test_unported_metric_fails_fast(runs, monkeypatch, capsys):
    """Without the LPIPS file the default ``-qm`` list (mse ssim lpips)
    skips lpips with the JAX package's line and the run goes on: the same
    mse/ssim rows as with it, and no lpips.txt."""
    monkeypatch.chdir(runs["root"])
    monkeypatch.setenv("EVREAL_LPIPS_WEIGHTS",
                       str(runs["root"] / "absent.npz"))
    torch_main(ARGS[:ARGS.index("-qm")] + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "lpips weights unavailable (see tools/convert_lpips.py); " \
        "skipping lpips" in out
    assert "Exception" not in out
    for method in METHODS:
        base = seq_dir(runs["root"] / "outputs", method)
        for metric in ("mse", "ssim"):
            assert (base / f"{metric}.txt").read_bytes() == (seq_dir(
                runs["torch"], method) / f"{metric}.txt").read_bytes()
        assert not (base / "lpips.txt").exists()
        assert json.loads((base / "done.json").read_text())["metrics"] == \
            ["mse", "ssim"]
