"""``EVREAL_RESUME`` in the port: the five cases of ``tests/test_resume.py``.
Finished (config, dataset, sequence, method) outputs, marked by the
``done.json`` record ``finalize`` writes, are skipped on rerun and their
recorded scores reused; a fresh run without the switch invalidates the
record first; changed settings or a changed eval window run again. A
skipped sequence builds no runner (so it launches nothing)."""

import json
import sys
from pathlib import Path

import pytest
import torch

from evreal_tpu_torch.convert.params import flatten, save_params
from evreal_tpu_torch.data import Sequence
from evreal_tpu_torch.harness.batched import eval_method_on_sequence_group
from evreal_tpu_torch.harness.runner import (
    MethodBundle,
    eval_method_on_sequence,
)
from evreal_tpu_torch.metrics.tracker import EvalMetricsTracker
from evreal_tpu_torch.models.init import init_firenet

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

torch.set_num_threads(1)

EVAL_CONFIG = {"name": "std", "save_images": True, "histeq": "none",
               "eval_infer_all": False, "ts_tol_ms": 1.0,
               "create_video": False}
META = {"class": "FireNet", "num_encoders": 0,
        "kwargs": {"num_bins": 5, "base_num_channels": 8, "kernel_size": 3}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(sequence dirs, method config)."""
    root = tmp_path_factory.mktemp("resume")
    dirs = []
    for i in range(2):
        d = root / f"seq{i}"
        make_sequence(str(d), height=48, width=64, duration_s=0.8, fps=20,
                      events_per_frame=800, seed=60 + i)
        dirs.append(str(d))
    path = root / "FireNet+.npz"
    save_params(path, flatten(init_firenet(seed=1, base_num_channels=8)),
                {**META, "model_name": "FireNet+"})
    return dirs, {"model_name": "FireNet+", "model_path": str(path),
                  "event_tensor_normalization": False,
                  "post_process_norm": "none"}


def _sequences(seq_dirs):
    return [{"name": f"seq{i}",
             "dataset": Sequence(d, num_bins=5,
                                 voxel_method={"method": "between_frames"}),
             "start_time_s": 0.1, "end_time_s": 10.0}
            for i, d in enumerate(seq_dirs)]


def _bundle(cfg):
    return MethodBundle("FireNet+", cfg, "cpu")


def test_single_sequence_resume(setup, tmp_path, monkeypatch, capsys):
    seq_dirs, cfg = setup
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("EVREAL_RESUME", raising=False)
    seq = _sequences(seq_dirs)[0]
    args = ("SYNS", EVAL_CONFIG, "FireNet+", _bundle(cfg), cfg, seq,
            ["mse", "ssim"])

    first = eval_method_on_sequence(*args)
    out_dir = tmp_path / "outputs/std/SYNS/seq0/FireNet+"
    done = json.loads((out_dir / "done.json").read_text())
    assert done["num_evaluated"] == first[0] > 0
    ts_before = (out_dir / "timestamps.txt").read_text()

    monkeypatch.setenv("EVREAL_RESUME", "1")
    capsys.readouterr()
    fresh = _bundle(cfg)
    second = eval_method_on_sequence("SYNS", EVAL_CONFIG, "FireNet+", fresh,
                                     cfg, seq, ["mse", "ssim"])
    assert "Skipping finished" in capsys.readouterr().out
    assert second[0] == first[0]
    assert second[1] == pytest.approx(first[1])
    # untouched, and nothing was built: the run really was skipped
    assert (out_dir / "timestamps.txt").read_text() == ts_before
    assert fresh._runners == {}

    # a narrower metric request is covered by the record, reported narrowly
    assert eval_method_on_sequence(
        "SYNS", EVAL_CONFIG, "FireNet+", fresh, cfg, seq, ["mse"]) == \
        (first[0], {"mse": first[1]["mse"]})

    # a record that does not cover a requested metric forces a real run
    monkeypatch.delenv("EVREAL_RESUME")
    eval_method_on_sequence("SYNS", EVAL_CONFIG, "FireNet+", fresh, cfg, seq,
                            ["mse"])
    monkeypatch.setenv("EVREAL_RESUME", "1")
    capsys.readouterr()
    third = eval_method_on_sequence(*args)
    assert "Skipping finished" not in capsys.readouterr().out
    assert third[0] == first[0]
    assert third[1] == pytest.approx(first[1])


def test_fresh_run_invalidates_record(setup, tmp_path, monkeypatch):
    seq_dirs, cfg = setup
    monkeypatch.chdir(tmp_path)
    seq = _sequences(seq_dirs)[0]
    args = ("SYNS", EVAL_CONFIG, "FireNet+", _bundle(cfg), cfg, seq,
            ["mse"])
    monkeypatch.delenv("EVREAL_RESUME", raising=False)
    eval_method_on_sequence(*args)
    out_dir = tmp_path / "outputs/std/SYNS/seq0/FireNet+"
    first = (out_dir / "done.json").read_text()
    # a rerun without EVREAL_RESUME removes the record at its start (an
    # interrupted rerun leaves none) and writes it again at its end
    present = []
    real_update = EvalMetricsTracker.update

    def spy(self, *a, **k):
        present.append((out_dir / "done.json").exists())
        return real_update(self, *a, **k)

    monkeypatch.setattr(EvalMetricsTracker, "update", spy)
    eval_method_on_sequence(*args)
    assert present and not any(present)
    assert (out_dir / "done.json").read_text() == first


def test_group_partial_resume(setup, tmp_path, monkeypatch, capsys):
    seq_dirs, cfg = setup
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("EVREAL_RESUME", raising=False)
    bundle = _bundle(cfg)
    full = eval_method_on_sequence_group(
        "SYNS", EVAL_CONFIG, "FireNet+", bundle, cfg, _sequences(seq_dirs),
        ["mse", "ssim"])
    # invalidate seq1's record: only seq0 should be skipped on resume
    done1 = tmp_path / "outputs/std/SYNS/seq1/FireNet+/done.json"
    done1.unlink()

    monkeypatch.setenv("EVREAL_RESUME", "1")
    capsys.readouterr()
    again = eval_method_on_sequence_group(
        "SYNS", EVAL_CONFIG, "FireNet+", bundle, cfg, _sequences(seq_dirs),
        ["mse", "ssim"])
    out = capsys.readouterr().out
    skipped = [line for line in out.splitlines() if "Skipping finished" in line]
    assert len(skipped) == 1 and "seq0" in skipped[0]
    # the rest ran as a group of one lane
    assert ("batched", 1, 48, 64) in bundle._runners
    assert len(again) == 2
    for (n0, s0), (n1, s1) in zip(full, again):
        assert n0 == n1
        for k in s0:
            assert s0[k] == pytest.approx(s1[k], abs=1e-6)
    assert done1.exists()  # seq1 re-ran and re-recorded

    # all finished -> whole group skipped
    capsys.readouterr()
    third = eval_method_on_sequence_group(
        "SYNS", EVAL_CONFIG, "FireNet+", bundle, cfg, _sequences(seq_dirs),
        ["mse", "ssim"])
    assert capsys.readouterr().out.count("Skipping finished") == 2
    assert [n for n, _ in third] == [n for n, _ in full]


def test_changed_settings_invalidate_resume(setup, tmp_path, monkeypatch,
                                            capsys):
    """A rerun with different output-affecting settings (save_images newly
    on) runs again: its PNGs were never produced."""
    seq_dirs, cfg = setup
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("EVREAL_RESUME", raising=False)
    bundle = _bundle(cfg)
    seq = _sequences(seq_dirs)[0]
    cfg_off = dict(EVAL_CONFIG, save_images=False)
    eval_method_on_sequence("SYNS", cfg_off, "FireNet+", bundle, cfg, seq,
                            ["mse"])
    out_dir = tmp_path / "outputs/std/SYNS/seq0/FireNet+"
    assert not list(out_dir.glob("frame_*.png"))
    monkeypatch.setenv("EVREAL_RESUME", "1")
    cfg_on = dict(EVAL_CONFIG, save_images=True)
    capsys.readouterr()
    eval_method_on_sequence("SYNS", cfg_on, "FireNet+", bundle, cfg, seq,
                            ["mse"])
    assert "Skipping finished" not in capsys.readouterr().out
    assert list(out_dir.glob("frame_*.png"))  # images really were produced
    # now the record matches the new settings: a rerun does skip
    capsys.readouterr()
    eval_method_on_sequence("SYNS", cfg_on, "FireNet+", bundle, cfg, seq,
                            ["mse"])
    assert "Skipping finished" in capsys.readouterr().out


def test_changed_eval_window_invalidates_resume(setup, tmp_path,
                                                monkeypatch, capsys):
    """The quantitative-eval time window lives on the sequence, and
    editing it runs again rather than reusing stale scores."""
    seq_dirs, cfg = setup
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("EVREAL_RESUME", raising=False)
    bundle = _bundle(cfg)
    seq = _sequences(seq_dirs)[0]
    n_full, _ = eval_method_on_sequence("SYNW", EVAL_CONFIG, "FireNet+",
                                        bundle, cfg, seq, ["mse"])
    monkeypatch.setenv("EVREAL_RESUME", "1")
    cut = dict(seq, start_time_s=seq["start_time_s"] + 0.1)
    capsys.readouterr()
    n_cut, _ = eval_method_on_sequence("SYNW", EVAL_CONFIG, "FireNet+",
                                       bundle, cfg, cut, ["mse"])
    assert "Skipping finished" not in capsys.readouterr().out
    assert n_cut < n_full
    # same window again: now it does skip, reusing the cut-window record
    capsys.readouterr()
    n_again, _ = eval_method_on_sequence("SYNW", EVAL_CONFIG, "FireNet+",
                                         bundle, cfg, cut, ["mse"])
    assert "Skipping finished" in capsys.readouterr().out
    assert n_again == n_cut
