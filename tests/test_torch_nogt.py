"""No-reference scoring and the cases of ``tests/test_nogt_e2e.py`` in the
port, against the JAX package on the CPU (that file's ``FakeBundle`` needs
a reference tree that is not here; these use random-init FireNet weights
saved as ``.npz``, read by both packages' ``MethodBundle``):

- an events-only sequence (t_seconds windows) with a registered
  no-reference metric, single and in a lockstep group mixed with a
  sequence that has reference frames: the metric's rows within 2e-5 of
  the JAX package's and ``done.json`` key for key (means within 2e-5);
  ``EVREAL_RESUME`` then skips both; and under hist-eq, the metric on the
  equalized frames, single and lockstep;
- ``std_all`` (``eval_infer_all``: every window saved, scoring gated);
- windows with no events (``event_rate`` 0, frames still saved);
- seeded ``keep_ratio``: two runs byte-identical, and the JAX package's
  windows;
- a ``serial`` metric against the batched one, single and lockstep;
- a metric that raises while scoring: dropped with the JAX package's
  message for the rest of the sequence, the others go on, and
  ``done.json`` leaves it out.

Both registries are global to the process: the metrics a test registers
are removed after it."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evreal_tpu_torch.convert.params import flatten, save_params
from evreal_tpu_torch.data import Sequence
from evreal_tpu_torch.harness import batched as tbatched
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.metrics import registry
from evreal_tpu_torch.models.init import init_firenet

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

torch.set_num_threads(1)

TOL = 2e-5
META = {"class": "FireNet", "num_encoders": 0,
        "kwargs": {"num_bins": 5, "base_num_channels": 8, "kernel_size": 3}}
T_SECONDS = {"method": "t_seconds", "t": 0.04, "sliding_window_t": 0}


def events_only(d, hw, seed, n=8000):
    """A sequence without reference frames (the TPAMI20_HDR case)."""
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    np.save(d / "events_ts.npy", np.sort(rng.uniform(0, 1.0, n)))
    np.save(d / "events_xy.npy", np.stack(
        [rng.integers(0, hw[1], n), rng.integers(0, hw[0], n)],
        1).astype(np.int16))
    np.save(d / "events_p.npy", rng.integers(0, 2, n).astype(np.uint8))
    (d / "metadata.json").write_text(json.dumps(
        {"sensor_resolution": list(hw)}))
    return str(d)


def with_gap(d, seed=4):
    """Events only in [0, 0.2] and [0.8, 1.0] and frames at 0.05..0.95:
    several between-frame windows hold no event."""
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    n = 3000
    ts = np.sort(np.concatenate([rng.uniform(0, 0.2, n // 2),
                                 rng.uniform(0.8, 1.0, n // 2)]))
    np.save(d / "events_ts.npy", ts)
    np.save(d / "events_xy.npy", np.stack(
        [rng.integers(0, 32, n), rng.integers(0, 24, n)], 1).astype(np.int16))
    np.save(d / "events_p.npy", rng.integers(0, 2, n).astype(np.uint8))
    frame_ts = np.linspace(0.05, 0.95, 10)
    np.save(d / "images.npy",
            rng.integers(0, 255, (10, 24, 32, 3)).astype(np.uint8))
    np.save(d / "images_ts.npy", frame_ts.reshape(-1, 1))
    np.save(d / "image_event_indices.npy", np.searchsorted(
        ts, frame_ts, "right").reshape(-1, 1) - 1)
    (d / "metadata.json").write_text(json.dumps(
        {"sensor_resolution": [24, 32]}))
    return str(d)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("nogt")
    out = {"hdr": events_only(root / "hdr0", (48, 64), 5),
           "hdr1": events_only(root / "hdr1", (48, 64), 6),
           "gap": with_gap(root / "gap")}
    for name, hw, dur, seed in (("gt", (48, 64), 1.0, 2),
                                ("small", (32, 48), 1.0, 3),
                                ("kr", (32, 48), 0.8, 6)):
        out[name] = str(root / name)
        make_sequence(out[name], height=hw[0], width=hw[1], duration_s=dur,
                      fps=20, events_per_frame=500, seed=seed)
    path = root / "FireNet+.npz"
    save_params(path, flatten(init_firenet(seed=1, base_num_channels=8)),
                {**META, "model_name": "FireNet+"})
    out["cfg"] = {"model_name": "FireNet+", "model_path": str(path),
                  "event_tensor_normalization": False,
                  "post_process_norm": "none"}
    return out


def eval_config(name="t40ms", **changes):
    return {"name": name, "save_images": True, "histeq": "none",
            "eval_infer_all": False, "ts_tol_ms": 1.0,
            "create_video": False, **changes}


def sequence(cls, path, name, voxel_method=None, start=None, end=None,
             **kwargs):
    seq = cls(path, num_bins=5,
              voxel_method=voxel_method or {"method": "between_frames"},
              **kwargs)
    t0, t1 = seq.get_min_max_t()
    return {"name": name, "dataset": seq,
            "start_time_s": t0 if start is None else start,
            "end_time_s": t1 if end is None else end}


@pytest.fixture
def packages(data, monkeypatch):
    """Both packages' (Sequence, single runner, group runner, bundle
    maker) and the no-reference metric ``meanval`` registered in both."""
    from evreal_tpu.data import Sequence as JSequence
    from evreal_tpu.harness import batched as jbatched
    from evreal_tpu.harness import runner as jrunner
    from evreal_tpu.harness import staging
    from evreal_tpu.metrics import registry as jreg

    monkeypatch.setattr(jbatched, "_EVAL_MESH", None)
    monkeypatch.setattr(staging, "_compute_seen", False)
    monkeypatch.setattr(staging, "_staged_bytes", 0)
    monkeypatch.setattr(jreg, "_REGISTRY", {})
    monkeypatch.setattr(jreg, "_builtins_done", False)
    jreg._ensure_builtins()
    jreg.register("meanval", lambda img: img.mean(), no_ref=True)
    registry.register("meanval", lambda imgs: imgs.mean(dim=(1, 2)),
                      no_ref=True)
    cfg = data["cfg"]
    yield {"jax": (JSequence, jrunner.eval_method_on_sequence,
                   jbatched.eval_method_on_sequence_group,
                   lambda: jrunner.MethodBundle("FireNet+", cfg)),
           "torch": (Sequence, trunner.eval_method_on_sequence,
                     tbatched.eval_method_on_sequence_group,
                     lambda: trunner.MethodBundle("FireNet+", cfg, "cpu"))}
    registry._REGISTRY.pop("meanval", None)


def run_both(tmp_path, monkeypatch, packages, fn):
    """``fn(Sequence, single, group, bundle)`` in each package's directory
    under ``tmp_path``: {package: result}."""
    res = {}
    for name, parts in packages.items():
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        res[name] = fn(*parts)
    return res


def out_dir(base, config, dataset, seq):
    return base / "outputs" / config / dataset / seq / "FireNet+"


def assert_rows_close(a, b, metric):
    ra, rb = (np.loadtxt(d / f"{metric}.txt", ndmin=2) for d in (a, b))
    assert ra.shape == rb.shape and len(ra) > 0, metric
    np.testing.assert_array_equal(ra[:, 0], rb[:, 0])
    np.testing.assert_allclose(rb[:, 1], ra[:, 1], rtol=0, atol=TOL)


def assert_done_equal(a, b):
    ja, jb = (json.loads((d / "done.json").read_text()) for d in (a, b))
    assert ja.keys() == jb.keys()
    for key in ja:
        if key == "mean_scores":
            assert ja[key].keys() == jb[key].keys()
            for m in ja[key]:
                assert abs(ja[key][m] - jb[key][m]) <= TOL, m
        else:
            assert ja[key] == jb[key], key
    return jb


def test_nogt_noref_metric_single(data, tmp_path, monkeypatch, packages,
                                  capsys):
    cfg = data["cfg"]
    res = run_both(tmp_path, monkeypatch, packages,
                   lambda S, single, group, bundle: single(
                       "HDR", eval_config(), "FireNet+", bundle(), cfg,
                       sequence(S, data["hdr"], "hdr0", T_SECONDS),
                       ["mse", "ssim", "meanval"]))
    (nj, sj), (nt, st) = res["jax"], res["torch"]
    n_windows = len(Sequence(data["hdr"], num_bins=5, voxel_method=T_SECONDS))
    # the reference-frame metrics drop out; the no-reference one scores
    assert nj == nt == n_windows and sj.keys() == st.keys() == {"meanval"}
    a, b = (out_dir(tmp_path / k, "t40ms", "HDR", "hdr0")
            for k in ("jax", "torch"))
    assert_rows_close(a, b, "meanval")
    assert not (b / "mse.txt").exists()
    assert sorted(p.name for p in a.iterdir()) == \
        sorted(p.name for p in b.iterdir())
    done = assert_done_equal(a, b)
    assert done["metrics"] == ["meanval"]
    # EVREAL_RESUME: the record covers the sequence's no-reference metrics
    monkeypatch.setenv("EVREAL_RESUME", "1")
    capsys.readouterr()
    again = trunner.eval_method_on_sequence(
        "HDR", eval_config(), "FireNet+",
        trunner.MethodBundle("FireNet+", cfg, "cpu"), cfg,
        sequence(Sequence, data["hdr"], "hdr0", T_SECONDS),
        ["mse", "ssim", "meanval"])
    assert "Skipping finished" in capsys.readouterr().out
    assert again[0] == nt and again[1]["meanval"] == pytest.approx(
        st["meanval"], abs=1e-12)


@pytest.mark.parametrize("lockstep", [False, True])
def test_nogt_noref_metric_on_equalized_frames(data, tmp_path, monkeypatch,
                                               packages, lockstep):
    """A hist-eq config scores the no-reference metric on the equalized
    frames of a sequence without reference frames, as the JAX package
    does (single, and a group of two such sequences)."""
    cfg = data["cfg"]
    ec = eval_config(histeq="global")
    names = ("hdr0", "hdr1") if lockstep else ("hdr0",)

    def go(S, single, group, bundle):
        seqs = [sequence(S, data[n.replace("hdr0", "hdr")], n, T_SECONDS)
                for n in names]
        if lockstep:
            return group("HDR", ec, "FireNet+", bundle(), cfg, seqs,
                         ["ssim", "meanval"])
        return [single("HDR", ec, "FireNet+", bundle(), cfg, seqs[0],
                       ["ssim", "meanval"])]

    res = run_both(tmp_path, monkeypatch, packages, go)
    for name, (nj, sj), (nt, st) in zip(names, res["jax"], res["torch"]):
        assert nj == nt > 0 and sj.keys() == st.keys() == {"meanval"}
        a, b = (out_dir(tmp_path / k, "t40ms", "HDR", name)
                for k in ("jax", "torch"))
        assert_rows_close(a, b, "meanval")
        assert len(list(Path(str(b) + "_processed").glob("*.png"))) == nt
        assert_done_equal(a, b)


def test_nogt_noref_metric_mixed_lockstep_group(data, tmp_path, monkeypatch,
                                                packages, capsys):
    """A group of a sequence with reference frames and two without: MSE
    on the first, the no-reference metric on all three."""
    cfg = data["cfg"]
    ec = eval_config(ts_tol_ms=1e9)
    res = run_both(tmp_path, monkeypatch, packages,
                   lambda S, single, group, bundle: group(
                       "MIX", ec, "FireNet+", bundle(), cfg,
                       [sequence(S, data["gt"], "gt", T_SECONDS),
                        sequence(S, data["hdr"], "hdr0", T_SECONDS),
                        sequence(S, data["hdr1"], "hdr1", T_SECONDS)],
                       ["mse", "meanval"]))
    assert len(res["torch"]) == 3
    for (nj, sj), (nt, st) in zip(res["jax"], res["torch"]):
        assert nj == nt > 0 and sj.keys() == st.keys()
    assert res["torch"][0][1].keys() == {"mse", "meanval"}
    assert res["torch"][1][1].keys() == {"meanval"}
    for name in ("gt", "hdr0", "hdr1"):
        a, b = (out_dir(tmp_path / k, "t40ms", "MIX", name)
                for k in ("jax", "torch"))
        assert_rows_close(a, b, "meanval")
        if name == "gt":
            assert_rows_close(a, b, "mse")
        else:
            assert not (b / "mse.txt").exists()
        assert_done_equal(a, b)
    monkeypatch.setenv("EVREAL_RESUME", "1")
    capsys.readouterr()
    again = tbatched.eval_method_on_sequence_group(
        "MIX", ec, "FireNet+", trunner.MethodBundle("FireNet+", cfg, "cpu"),
        cfg, [sequence(Sequence, data[k], n, T_SECONDS)
              for k, n in (("gt", "gt"), ("hdr", "hdr0"),
                           ("hdr1", "hdr1"))], ["mse", "meanval"])
    assert capsys.readouterr().out.count("Skipping finished") == 3
    assert [n for n, _ in again] == [n for n, _ in res["torch"]]


def test_eval_infer_all_reconstructs_everything(data, tmp_path, monkeypatch,
                                                packages):
    """std_all (reference config/eval/std_all.json:12): every window is
    reconstructed and saved, scoring still gates on the eval window."""
    cfg = data["cfg"]
    ec = eval_config("std_all", eval_infer_all=True)
    res = run_both(tmp_path, monkeypatch, packages,
                   lambda S, single, group, bundle: single(
                       "SYN", ec, "FireNet+", bundle(), cfg,
                       sequence(S, data["small"], "seq0", start=0.3,
                                end=0.6), ["mse"]))
    n_windows = len(Sequence(data["small"], num_bins=5))
    (nj, _), (nt, _) = res["jax"], res["torch"]
    assert nj == nt and 0 < nt < n_windows
    a, b = (out_dir(tmp_path / k, "std_all", "SYN", "seq0")
            for k in ("jax", "torch"))
    assert len(list(b.glob("frame_*.png"))) == n_windows
    assert (np.loadtxt(b / "mse.txt", ndmin=2).shape[0]) == nt
    assert_rows_close(a, b, "mse")
    assert (a / "timestamps.txt").read_bytes() == \
        (b / "timestamps.txt").read_bytes()


def test_zero_event_windows_through_pipeline(data, tmp_path, monkeypatch,
                                             packages):
    """Windows with no events (reference dataset.py:59-75): an empty voxel
    grid, event_rate 0 and the frame saved, as in the JAX package."""
    cfg = data["cfg"]
    metas = Sequence(data["gap"], num_bins=5).windows()
    zero = [i for i, m in enumerate(metas) if m["event_count"] == 0]
    assert zero, "the fixture needs a gap"
    ec = eval_config("std", ts_tol_ms=1e9)
    res = run_both(tmp_path, monkeypatch, packages,
                   lambda S, single, group, bundle: single(
                       "SYN", ec, "FireNet+", bundle(), cfg,
                       sequence(S, data["gap"], "gap"), ["mse"]))
    assert res["jax"][0] == res["torch"][0] == len(metas)
    a, b = (out_dir(tmp_path / k, "std", "SYN", "gap")
            for k in ("jax", "torch"))
    assert len(list(b.glob("frame_*.png"))) == len(metas)
    assert (a / "event_rate.txt").read_bytes() == \
        (b / "event_rate.txt").read_bytes()
    rates = np.loadtxt(b / "event_rate.txt", ndmin=2)[:, 1]
    assert all(rates[i] == 0.0 for i in zero)
    assert_rows_close(a, b, "mse")


def test_eval_is_deterministic(data, tmp_path, monkeypatch, packages):
    """Seeded keep_ratio (the reference's choice is unseeded): two runs of
    the port are byte-identical, and they keep the JAX package's
    windows."""
    cfg = data["cfg"]
    ec = eval_config("std", save_images=False)
    texts = []
    for run in ("a", "b"):
        d = tmp_path / run
        d.mkdir()
        monkeypatch.chdir(d)
        trunner.eval_method_on_sequence(
            "SYN", ec, "FireNet+",
            trunner.MethodBundle("FireNet+", cfg, "cpu"), cfg,
            sequence(Sequence, data["kr"], "seq0", keep_ratio=0.8, seed=0),
            ["mse", "ssim"])
        base = out_dir(d, "std", "SYN", "seq0")
        texts.append({f.name: f.read_text() for f in sorted(base.iterdir())
                      if f.suffix == ".txt"})
    assert texts[0] == texts[1]
    assert set(texts[0]) == {"timestamps.txt", "mse.txt", "ssim.txt",
                             "event_rate.txt"}
    JSequence = packages["jax"][0]
    jseq = JSequence(data["kr"], num_bins=5, keep_ratio=0.8, seed=0,
                     voxel_method={"method": "between_frames"})
    tseq = Sequence(data["kr"], num_bins=5, keep_ratio=0.8, seed=0)
    assert len(tseq) < len(Sequence(data["kr"], num_bins=5))
    assert [m["frame_index"] for m in tseq.windows()] == \
        [m["frame_index"] for m in jseq.windows()]


def test_serial_metric_matches_batched(data, tmp_path, monkeypatch):
    """``serial=True`` (a frame at a time, for memory-heavy metrics such as
    MANIQA) scores as the batched call does, single and lockstep."""
    fn = lambda imgs: (imgs * imgs).mean(dim=(1, 2)) + imgs[:, 0, 0]  # noqa: E731
    registry.register("m_v", fn, no_ref=True)
    registry.register("m_s", fn, no_ref=True, serial=True)
    try:
        cfg = data["cfg"]
        ec = eval_config("t40ms", save_images=False)
        monkeypatch.chdir(tmp_path)
        bundle = trunner.MethodBundle("FireNet+", cfg, "cpu")
        _, single = trunner.eval_method_on_sequence(
            "HDR", ec, "FireNet+", bundle, cfg,
            sequence(Sequence, data["hdr"], "hdr0", T_SECONDS),
            ["m_v", "m_s"])
        assert single["m_s"] == pytest.approx(single["m_v"], abs=1e-6)
        base = out_dir(tmp_path, "t40ms", "HDR", "hdr0")
        assert (base / "m_s.txt").read_text() == \
            (base / "m_v.txt").read_text()
        [(_, lock), _] = tbatched.eval_method_on_sequence_group(
            "HDR", ec, "FireNet+", bundle, cfg,
            [sequence(Sequence, data[k], k, T_SECONDS)
             for k in ("hdr", "hdr1")], ["m_v", "m_s"])
        assert lock["m_s"] == pytest.approx(lock["m_v"], abs=1e-6)
        assert lock["m_s"] == pytest.approx(single["m_s"], abs=1e-5)
    finally:
        registry._REGISTRY.pop("m_v", None)
        registry._REGISTRY.pop("m_s", None)


def test_runtime_failure_drops_the_metric(data, tmp_path, monkeypatch,
                                          capsys):
    """A metric that raises at its third chunk is dropped for the rest of
    the sequence with the JAX package's message; MSE goes on; done.json
    leaves the dropped metric out and its mean reports -1."""
    calls = []

    def boom(imgs, refs):
        calls.append(len(imgs))
        if len(calls) == 3:
            raise RuntimeError("device fault\nout of luck")
        return (imgs - refs).abs().mean(dim=(1, 2))

    registry.register("boom", boom)
    monkeypatch.setattr(trunner, "DEFAULT_CHUNK_T", 4)
    try:
        cfg = data["cfg"]
        monkeypatch.chdir(tmp_path)
        n, scores = trunner.eval_method_on_sequence(
            "SYN", eval_config("std", ts_tol_ms=1e9), "FireNet+",
            trunner.MethodBundle("FireNet+", cfg, "cpu"), cfg,
            sequence(Sequence, data["small"], "seq0"), ["mse", "boom"])
    finally:
        registry._REGISTRY.pop("boom", None)
    out = capsys.readouterr().out
    assert out.count("Metric boom failed at runtime; dropping it for the "
                     "rest of this sequence (out of luck)") == 1
    assert calls == [0, 4, 4]  # the validation probe, two chunks, the fault
    base = out_dir(tmp_path, "std", "SYN", "seq0")
    assert np.loadtxt(base / "mse.txt", ndmin=2).shape[0] == n > 8
    assert np.loadtxt(base / "boom.txt", ndmin=2).shape[0] == 4
    assert scores["boom"] == -1 and scores["mse"] > 0
    done = json.loads((base / "done.json").read_text())
    assert done["metrics"] == ["mse"] and "boom" not in done["mean_scores"]


@pytest.mark.parametrize("lockstep", [False, True])
def test_all_unknown_metrics_write_the_jax_tree(data, tmp_path, monkeypatch,
                                                packages, lockstep):
    """A ``-qm`` list of which no name resolves: the JAX tracker falls back
    to ``mse ssim lpips`` for its file list and leaves those files empty;
    the port writes the same tree (file names, empty metric files,
    timestamps, ``done.json``) and returns the same counts and means."""
    cfg = data["cfg"]
    names = ("small", "kr") if lockstep else ("small",)

    def go(S, single, group, bundle):
        seqs = [sequence(S, data[n], n) for n in names]
        if lockstep:
            return group("SYN", eval_config("std"), "FireNet+", bundle(),
                         cfg, seqs, ["nosuch", "Psnr"])
        return [single("SYN", eval_config("std"), "FireNet+", bundle(), cfg,
                       seqs[0], ["nosuch", "Psnr"])]

    res = run_both(tmp_path, monkeypatch, packages, go)
    assert res["torch"] == res["jax"]
    for (n, means), name in zip(res["torch"], names):
        assert n > 0 and means == {"mse": -1, "ssim": -1, "lpips": -1}
        a, b = (out_dir(tmp_path / k, "std", "SYN", name)
                for k in ("jax", "torch"))
        assert sorted(p.name for p in a.iterdir()) == \
            sorted(p.name for p in b.iterdir())
        for metric in ("mse", "ssim", "lpips"):
            assert (b / f"{metric}.txt").read_bytes() == b""
        for f in ("timestamps.txt", "event_rate.txt"):
            assert (a / f).read_bytes() == (b / f).read_bytes()
        assert assert_done_equal(a, b)["metrics"] == []
