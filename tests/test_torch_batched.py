"""The port's lockstep batched runner (evreal_tpu_torch/harness/batched.py)
on the CPU: against the port's own single-sequence path (byte-equal score
rows), against the JAX package's ``eval_method_on_sequence_group`` on the
same inputs (scores within 2e-5, PNGs within 1 grey level), with mixed
reference-frame availability, and the grouping switches EVREAL_BATCHED,
EVREAL_BATCH_N and EVREAL_CHUNK_T. Narrow random-init FireNet / E2VID
weights, saved with ``save_params``; synthetic sequences of different
lengths."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evreal_tpu_torch.convert.params import flatten, save_params
from evreal_tpu_torch.data import Sequence
from evreal_tpu_torch.harness import batched as tbatched
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.harness.outputs import decode_png_gray8
from evreal_tpu_torch.models.init import init_e2vid, init_firenet

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

torch.set_num_threads(1)

EVAL_CONFIG = {"name": "std", "save_images": True, "histeq": "none",
               "eval_infer_all": False, "ts_tol_ms": 1.0,
               "create_video": False}
METHODS = {
    "FireNet+": ({"class": "FireNet", "num_encoders": 0,
                  "kwargs": {"num_bins": 5, "base_num_channels": 8,
                             "kernel_size": 3}},
                 lambda: init_firenet(seed=1, base_num_channels=8),
                 {"event_tensor_normalization": False,
                  "post_process_norm": "none"}),
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
}
CHUNK_T = 8  # several chunks, a ragged last one, lanes ending apart


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two sequences of different lengths, the methods' weights and
    configs: {"seq_dirs", "method_configs"}."""
    root = tmp_path_factory.mktemp("batched")
    seq_dirs = []
    for i, (dur, epf) in enumerate([(0.9, 900), (1.3, 700)]):
        d = root / "data" / f"seq{i}"
        make_sequence(str(d), height=48, width=64, duration_s=dur, fps=20,
                      events_per_frame=epf, seed=30 + i)
        seq_dirs.append(str(d))
    configs = {}
    for name, (meta, make, flags) in METHODS.items():
        path = root / "weights" / f"{name}.npz"
        path.parent.mkdir(exist_ok=True)
        save_params(path, flatten(make()), {**meta, "model_name": name})
        configs[name] = {"model_name": name, "model_path": str(path),
                         **flags}
    return {"seq_dirs": seq_dirs, "method_configs": configs}


def sequences(cls, seq_dirs):
    return [{"name": f"seq{i}",
             "dataset": cls(d, num_bins=5,
                            voxel_method={"method": "between_frames"}),
             "start_time_s": 0.1, "end_time_s": 10.0}
            for i, d in enumerate(seq_dirs)]


def rows(base, method, i, metric="mse"):
    return (base / "outputs/std/SYNS" / f"seq{i}" / method /
            f"{metric}.txt").read_text()


@pytest.fixture
def chunk_t(monkeypatch):
    monkeypatch.setattr(trunner, "DEFAULT_CHUNK_T", CHUNK_T)
    return CHUNK_T


@pytest.mark.parametrize("method", sorted(METHODS))
def test_batched_matches_single(inputs, tmp_path, monkeypatch, chunk_t,
                                method):
    cfg = inputs["method_configs"][method]
    bundle = trunner.MethodBundle(method, cfg, "cpu")
    out = {}
    for mode in ("single", "batched"):
        d = tmp_path / mode
        d.mkdir()
        monkeypatch.chdir(d)
        seqs = sequences(Sequence, inputs["seq_dirs"])
        if mode == "single":
            out[mode] = [trunner.eval_method_on_sequence(
                "SYNS", EVAL_CONFIG, method, bundle, cfg, s, ["mse", "ssim"])
                for s in seqs]
        else:
            out[mode] = tbatched.eval_method_on_sequence_group(
                "SYNS", EVAL_CONFIG, method, bundle, cfg, seqs,
                ["mse", "ssim"])
    assert bundle.batched_runner_for((48, 64), cfg, 5, 2).chunk_t == chunk_t
    lengths = [len(Sequence(d)) for d in inputs["seq_dirs"]]
    assert lengths[0] != lengths[1] and max(lengths) > 2 * chunk_t
    for i, ((n0, s0), (n1, s1)) in enumerate(zip(out["single"],
                                                 out["batched"])):
        assert n0 == n1 > 0, i
        assert s0.keys() == s1.keys() == {"mse", "ssim"}
        for k in s0:
            assert abs(s0[k] - s1[k]) < 1e-5, (i, k, s0[k], s1[k])
        for metric in ("mse", "ssim", "timestamps", "event_rate"):
            assert rows(tmp_path / "single", method, i, metric) == \
                rows(tmp_path / "batched", method, i, metric), (i, metric)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_batched_matches_jax_group(inputs, tmp_path, monkeypatch, chunk_t,
                                   method):
    cv2 = pytest.importorskip("cv2")
    from evreal_tpu.data import Sequence as JSequence
    from evreal_tpu.harness import batched as jbatched
    from evreal_tpu.harness import runner as jrunner
    from evreal_tpu.harness import staging

    cfg = inputs["method_configs"][method]
    monkeypatch.setattr(jrunner, "DEFAULT_CHUNK_T", chunk_t)
    monkeypatch.setattr(jbatched, "_EVAL_MESH", None)  # one device
    monkeypatch.setattr(staging, "_compute_seen", False)
    monkeypatch.setattr(staging, "_staged_bytes", 0)
    res = {}
    for name, run in (
            ("jax", lambda: jbatched.eval_method_on_sequence_group(
                "SYNS", EVAL_CONFIG, method, jrunner.MethodBundle(method, cfg),
                cfg, sequences(JSequence, inputs["seq_dirs"]),
                ["mse", "ssim"])),
            ("torch", lambda: tbatched.eval_method_on_sequence_group(
                "SYNS", EVAL_CONFIG, method,
                trunner.MethodBundle(method, cfg, "cpu"), cfg,
                sequences(Sequence, inputs["seq_dirs"]), ["mse", "ssim"]))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        res[name] = run()
    for i, ((nj, sj), (nt, st)) in enumerate(zip(res["jax"], res["torch"])):
        assert nj == nt > 0
        for k in sj:
            assert abs(sj[k] - st[k]) <= 2e-5, (i, k)
        for metric in ("mse", "ssim"):
            a = np.loadtxt(tmp_path / "jax/outputs/std/SYNS" / f"seq{i}" /
                           method / f"{metric}.txt")
            b = np.loadtxt(tmp_path / "torch/outputs/std/SYNS" / f"seq{i}" /
                           method / f"{metric}.txt")
            np.testing.assert_array_equal(a[:, 0], b[:, 0])
            np.testing.assert_allclose(b[:, 1], a[:, 1], atol=2e-5)
        jdir, tdir = (tmp_path / k / "outputs/std/SYNS" / f"seq{i}" / method
                      for k in ("jax", "torch"))
        frames = sorted(jdir.glob("frame_*.png"))
        assert len(frames) >= nj
        assert [p.name for p in frames] == \
            sorted(p.name for p in tdir.glob("frame_*.png"))
        for p in frames:
            want = cv2.imread(str(p), cv2.IMREAD_UNCHANGED).astype(int)
            got = decode_png_gray8((tdir / p.name).read_bytes())
            assert np.abs(got.astype(int) - want).max() <= 1


def test_batched_group_with_mixed_gt_availability(inputs, tmp_path,
                                                  monkeypatch):
    """A group of a sequence with reference frames and an events-only one:
    the first scores MSE/SSIM, the second only writes frames (its windows
    still count as evaluated, as in the JAX package)."""
    d = tmp_path / "nogt_seq"
    d.mkdir()
    rng = np.random.default_rng(12)
    n = 4000
    np.save(d / "events_ts.npy", np.sort(rng.uniform(0, 1.0, n)))
    np.save(d / "events_xy.npy", np.stack(
        [rng.integers(0, 64, n), rng.integers(0, 48, n)], 1).astype(np.int16))
    np.save(d / "events_p.npy", rng.integers(0, 2, n).astype(np.uint8))
    (d / "metadata.json").write_text(json.dumps(
        {"sensor_resolution": [48, 64]}))
    vm = {"method": "t_seconds", "t": 0.05, "sliding_window_t": 0}
    gt_seq = Sequence(inputs["seq_dirs"][0], num_bins=5, voxel_method=vm)
    ev_seq = Sequence(str(d), num_bins=5, voxel_method=dict(vm))
    group = [{"name": "with_gt", "dataset": gt_seq,
              "start_time_s": 0.0, "end_time_s": 10.0},
             {"name": "no_gt", "dataset": ev_seq,
              "start_time_s": 0.0, "end_time_s": 10.0}]
    monkeypatch.chdir(tmp_path)
    cfg = inputs["method_configs"]["FireNet+"]
    (n_gt, s_gt), (n_ev, s_ev) = tbatched.eval_method_on_sequence_group(
        "MIX", dict(EVAL_CONFIG, ts_tol_ms=1e9), "FireNet+",
        trunner.MethodBundle("FireNet+", cfg, "cpu"), cfg, group,
        ["mse", "ssim"])
    assert n_gt > 0 and set(s_gt) == {"mse", "ssim"}
    assert n_ev == len(ev_seq) and s_ev == {}
    base = tmp_path / "outputs/std/MIX"
    assert len(list((base / "no_gt/FireNet+").glob("frame_*.png"))) == n_ev
    mse_rows = base / "no_gt/FireNet+/mse.txt"
    assert not mse_rows.exists() or mse_rows.read_text() == ""


def test_batch_n_and_batched_switch_group_sequences(monkeypatch):
    """EVREAL_BATCH_N caps same-resolution groups; EVREAL_BATCHED=0 and
    color configs take one sequence at a time."""
    assert trunner.split_groups([[1, 2, 3, 4, 5], [6]], 2) == \
        [[1, 2], [3, 4], [5], [6]]
    assert trunner.split_groups([[1, 2, 3], [6]], 0) == [[1, 2, 3], [6]]

    class Res:
        def __init__(self, hw):
            self.sensor_resolution = hw

    seqs = [{"name": n, "dataset": Res(hw)} for n, hw in
            (("a", (48, 64)), ("b", (48, 64)), ("c", (32, 40)),
             ("d", (48, 64)))]

    def names(groups):
        return [[s["name"] for s in g] for g in groups]

    monkeypatch.delenv("EVREAL_BATCHED", raising=False)
    monkeypatch.setattr(trunner, "DEFAULT_BATCH_N", 0)
    assert names(trunner.sequence_groups(EVAL_CONFIG, seqs)) == \
        [["a", "b", "d"], ["c"]]
    monkeypatch.setattr(trunner, "DEFAULT_BATCH_N", 2)
    assert names(trunner.sequence_groups(EVAL_CONFIG, seqs)) == \
        [["a", "b"], ["d"], ["c"]]
    assert names(trunner.sequence_groups(dict(EVAL_CONFIG, color=True),
                                         seqs)) == [["a"], ["b"], ["c"], ["d"]]
    monkeypatch.setenv("EVREAL_BATCHED", "0")
    assert names(trunner.sequence_groups(EVAL_CONFIG, seqs)) == \
        [["a"], ["b"], ["c"], ["d"]]


PROBE = """
import json
from evreal_tpu_torch.harness import runner
print(json.dumps([runner.DEFAULT_CHUNK_T, runner.DEFAULT_BATCH_N]))
"""


@pytest.mark.parametrize("env,want", [
    ({}, [32, 0]),
    ({"EVREAL_CHUNK_T": "7", "EVREAL_BATCH_N": "3"}, [7, 3]),
    ({"EVREAL_CHUNK_T": "seven"}, "ValueError"),
    ({"EVREAL_BATCH_N": "2.5"}, "ValueError")])
def test_chunk_t_and_batch_n_parse_at_import(env, want):
    """Both are parsed when the runner is imported, with int(), as in the
    JAX package (evreal_tpu/harness/runner.py:46-50)."""
    full = {k: v for k, v in os.environ.items()
            if k not in ("EVREAL_CHUNK_T", "EVREAL_BATCH_N")}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          env={**full, **env}, capture_output=True,
                          text=True, timeout=120, check=False)
    if want == "ValueError":
        assert proc.returncode != 0 and "ValueError" in proc.stderr
    else:
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1]) == want


def test_unported_settings_raise(inputs, tmp_path, monkeypatch, capsys):
    """A metric waiting for its weights file no longer raises in a group:
    as in the JAX package it is skipped with its line and the group runs
    (hist-eq too), and EVREAL_RESUME then skips the finished lanes."""
    cfg = inputs["method_configs"]["FireNet+"]
    bundle = trunner.MethodBundle("FireNet+", cfg, "cpu")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EVREAL_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    heq = dict(EVAL_CONFIG, histeq="global")
    args = ("SYNS", heq, "FireNet+", bundle, cfg)
    res = tbatched.eval_method_on_sequence_group(
        *args, sequences(Sequence, inputs["seq_dirs"]), ["mse", "lpips"])
    out = capsys.readouterr().out
    assert "lpips weights unavailable (see tools/convert_lpips.py); " \
        "skipping lpips" in out
    assert [set(s) for _, s in res] == [{"mse"}, {"mse"}]
    assert all(n > 0 for n, _ in res)
    for i in range(2):
        assert rows(tmp_path, "FireNet+", i).count("\n") == res[i][0]
    monkeypatch.setenv("EVREAL_RESUME", "1")
    again = tbatched.eval_method_on_sequence_group(
        *args, sequences(Sequence, inputs["seq_dirs"]), ["mse", "lpips"])
    assert capsys.readouterr().out.count("Skipping finished") == 2
    assert again == res


def test_lockstep_lpips_matches_jax_group(inputs, tmp_path, monkeypatch,
                                          chunk_t):
    """``-qm mse ssim lpips`` in lockstep with one random LPIPS ``.npz``:
    the port's group against the JAX package's, lpips rows within 2e-5."""
    from evreal_tpu.data import Sequence as JSequence
    from evreal_tpu.harness import batched as jbatched
    from evreal_tpu.harness import runner as jrunner
    from evreal_tpu.harness import staging
    from evreal_tpu.metrics import registry as jreg

    from .test_torch_lpips import jax_layout_weights

    np.savez(tmp_path / "lpips_alex.npz", **jax_layout_weights(12))
    monkeypatch.setenv("EVREAL_LPIPS_WEIGHTS", str(tmp_path / "lpips_alex.npz"))
    monkeypatch.setattr(jreg, "_REGISTRY", {})
    monkeypatch.setattr(jreg, "_builtins_done", False)
    monkeypatch.setattr(jrunner, "DEFAULT_CHUNK_T", chunk_t)
    monkeypatch.setattr(jbatched, "_EVAL_MESH", None)
    monkeypatch.setattr(staging, "_compute_seen", False)
    monkeypatch.setattr(staging, "_staged_bytes", 0)
    cfg = inputs["method_configs"]["FireNet+"]
    metrics = ["mse", "ssim", "lpips"]
    res = {}
    for name, run in (
            ("jax", lambda: jbatched.eval_method_on_sequence_group(
                "SYNS", EVAL_CONFIG, "FireNet+",
                jrunner.MethodBundle("FireNet+", cfg), cfg,
                sequences(JSequence, inputs["seq_dirs"]), metrics)),
            ("torch", lambda: tbatched.eval_method_on_sequence_group(
                "SYNS", EVAL_CONFIG, "FireNet+",
                trunner.MethodBundle("FireNet+", cfg, "cpu"), cfg,
                sequences(Sequence, inputs["seq_dirs"]), metrics))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        res[name] = run()
    for i, ((nj, sj), (nt, st)) in enumerate(zip(res["jax"], res["torch"])):
        assert nj == nt > 0 and sj.keys() == st.keys() == set(metrics)
        for metric in metrics:
            a, b = (np.loadtxt(tmp_path / k / "outputs/std/SYNS" / f"seq{i}" /
                               "FireNet+" / f"{metric}.txt")
                    for k in ("jax", "torch"))
            np.testing.assert_array_equal(a[:, 0], b[:, 0])
            np.testing.assert_allclose(b[:, 1], a[:, 1], atol=2e-5)
        assert abs(sj["lpips"] - st["lpips"]) <= 2e-5
