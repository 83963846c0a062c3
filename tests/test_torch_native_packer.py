"""The port's native event packer (``evreal_tpu_torch/native/packer.cpp``
through ``data/packing.py:pack_windows``) against the JAX package's native
packer and its numpy path, and the port's own numpy path
(``EVREAL_NATIVE=0``): bit-equal buffers on every wire (compact with uint8
and int16 coordinates, out-of-range coordinates at the sentinels),
zero-event and full-capacity rows, degenerate timestamps, reused buffers
with stale tails, and the inputs that take the numpy path (fractional
coordinates, a compact4 sensor with no layout, a non-contiguous buffer).
Then the capacity and bounds errors, a failing compiler, and ``evaluate``
on the CPU, single and lockstep: the native and ``EVREAL_NATIVE=0`` trees
byte-equal, the score rows within 2e-5 of the JAX package's run."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evreal_tpu import native as jnative
from evreal_tpu.data import Sequence as JSequence
from evreal_tpu.data import pack_windows as jpack
from evreal_tpu_torch import native
from evreal_tpu_torch.data import Sequence as TSequence
from evreal_tpu_torch.data import pack_windows as tpack
from evreal_tpu_torch.data.packing import alloc_buffers, wire_dtypes

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

torch.set_num_threads(1)

CAPACITY = 1024
K = 700  # k_events windows
# sensors: uint8 coordinates on the compact wire; int16 there; no compact4
# layout (h * w needs 25 index bits, leaving 6 for the timestamp)
SENSORS = {"small": (48, 64), "large": (300, 400), "huge": (4000, 5000)}
WAYS = ("torch_native", "torch_numpy", "jax_native", "jax_numpy")


def write_events(path, hw, n=6000, seed=7, xy_dtype=np.int16):
    """Sorted f64 timestamps with a block of equal ones (a degenerate
    window), coordinates partly off the sensor (negative and past both
    edges, past 255 too), uint8 polarity {0, 1}."""
    rng = np.random.default_rng(seed)
    h, w = hw
    ts = np.sort(rng.uniform(0, 1.0, n))
    ts[2000:2400] = ts[2000]
    if np.issubdtype(xy_dtype, np.integer):
        xs = rng.integers(-4, w + 300, n)
        ys = rng.integers(-3, h + 270, n)
    else:
        xs = rng.uniform(-2, w + 2, n)
        ys = rng.uniform(-2, h + 2, n)
    path.mkdir(parents=True, exist_ok=True)
    np.save(path / "events_ts.npy", ts)
    np.save(path / "events_xy.npy", np.stack([xs, ys], 1).astype(xy_dtype))
    np.save(path / "events_p.npy", rng.integers(0, 2, n).astype(np.uint8))
    (path / "metadata.json").write_text(
        json.dumps({"sensor_resolution": list(hw)}))
    return str(path)


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    """{name: (JAX Sequence, port Sequence)} of k_events windows; "frac"
    has fractional f32 coordinates."""
    root = tmp_path_factory.mktemp("packer")
    if jnative.load() is None:  # built here, before any EVREAL_NATIVE=0
        pytest.skip("the JAX package's native packer did not build")
    dirs = {name: write_events(root / name, hw)
            for name, hw in SENSORS.items()}
    dirs["frac"] = write_events(root / "frac", SENSORS["small"],
                                xy_dtype=np.float32)
    vm = {"method": "k_events", "k": K, "sliding_window_w": 0}
    return {name: (JSequence(d, voxel_method=vm),
                   TSequence(d, voxel_method=vm))
            for name, d in dirs.items()}


def custom_metas(n_events):
    """Windows by bounds: empty rows (also at the first and last event),
    a full-capacity row, the degenerate block and a one-event row."""
    bounds = [(0, 0), (100, 100 + CAPACITY), (2050, 2350), (5, 6),
              (3000, 3000), (n_events - 300, n_events), (n_events, n_events)]
    return [{"idx0": a, "idx1": b, "event_count": b - a} for a, b in bounds]


def four_ways(monkeypatch, seqs, name, call):
    """{way: buffers} of ``call(pack_windows, seq)`` for the port and the
    JAX package, each on its native and its numpy path; the port's native
    pack calls of each way are counted into ``calls``."""
    jseq, tseq = seqs[name]
    out, calls = {}, {}
    for way in WAYS:
        with monkeypatch.context() as mp:
            if way == "torch_numpy":
                mp.setenv("EVREAL_NATIVE", "0")
            if way == "jax_numpy":
                mp.setattr(jnative, "_lib", None)
            native.reset_pack_calls()
            port = way.startswith("torch")
            out[way] = call(tpack if port else jpack, tseq if port else jseq)
            calls[way] = sum(native.pack_calls.values())
    return out, calls


def assert_equal(results):
    want = results["jax_numpy"]
    for way, got in results.items():
        assert sorted(got) == sorted(want), way
        for key in want:
            assert got[key].dtype == want[key].dtype, (way, key)
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{way} {key}")


CASES = [("small", "f32"), ("small", "compact"), ("small", "compact4"),
         ("large", "f32"), ("large", "compact"), ("large", "compact4"),
         ("huge", "compact4")]


@pytest.mark.parametrize("name,wire", CASES)
def test_every_wire_bit_equal(seqs, monkeypatch, name, wire):
    """Every k_events window of the sequence, fresh buffers."""
    def call(pack, seq):
        return pack(seq, list(range(len(seq))), capacity=CAPACITY,
                    wire=wire)[0]

    results, calls = four_ways(monkeypatch, seqs, name, call)
    assert_equal(results)
    assert calls["torch_native"] == 1 and calls["torch_numpy"] == 0
    if name == "small" and wire == "compact":
        assert results["torch_native"]["xs"].dtype == np.uint8
        assert (results["torch_native"]["xs"] == 255).any()
    if name == "huge":  # no layout: the compact wire, int16 coordinates
        assert "ev" not in results["torch_native"]


@pytest.mark.parametrize("name,wire", CASES)
def test_edge_rows_into_stale_buffers(seqs, monkeypatch, name, wire):
    """Zero-event, full-capacity, degenerate and one-event rows packed
    into reused buffers full of stale values (``out_zeroed=False``) and
    into fresh ones."""
    tseq = seqs[name][1]
    metas = custom_metas(len(tseq.t))
    dtypes = wire_dtypes(wire, True, SENSORS[name])
    stale = {k: np.random.default_rng(3).integers(
        1, 100, (len(metas), CAPACITY)).astype(d)
        for k, d in dtypes.items() if k != "count"}
    stale["count"] = np.full(len(metas), 77, np.int32)

    def reused(pack, seq):
        out = {k: v.copy() for k, v in stale.items()}
        return pack(seq, range(len(metas)), capacity=CAPACITY, out=out,
                    metas=metas, out_zeroed=False)[0]

    def fresh(pack, seq):
        return pack(seq, range(len(metas)), capacity=CAPACITY, metas=metas,
                    wire=wire)[0]

    for call in (reused, fresh):
        results, calls = four_ways(monkeypatch, seqs, name, call)
        assert_equal(results)
        assert calls["torch_native"] == 1 and calls["torch_numpy"] == 0
        got = results["torch_native"]
        assert list(got["count"]) == [m["event_count"] for m in metas]
        row = next(iter(k for k in got if k != "count"))
        assert not got[row][0].any() and not got[row][-1].any()


def test_pooled_lockstep_views(seqs, monkeypatch):
    """Views of an (N, T, E) compact4 pool, a lane at a time, as the
    lockstep runner packs them, over stale chunks."""
    tseq = seqs["large"][1]
    n, t = 3, 4
    dtypes = wire_dtypes("compact4", True, SENSORS["large"])

    def call(pack, seq):
        pool = alloc_buffers((n, t), CAPACITY, dtypes)
        for k in range(2):
            for j in range(n):
                idxs = list(range((j + k * n) % 5, (j + k * n) % 5 + t - j))
                pack(seq, idxs, capacity=CAPACITY,
                     out={key: v[j, :len(idxs)] for key, v in pool.items()},
                     out_zeroed=False)
        return pool

    assert len(tseq) >= 8
    results, calls = four_ways(monkeypatch, seqs, "large", call)
    assert_equal(results)
    assert calls["torch_native"] == 2 * n and calls["torch_numpy"] == 0


def test_fractional_coordinates_take_numpy(seqs, monkeypatch):
    def call(pack, seq):
        return pack(seq, list(range(len(seq))), capacity=CAPACITY,
                    wire="compact")[0]

    results, calls = four_ways(monkeypatch, seqs, "frac", call)
    assert_equal(results)
    assert results["torch_native"]["xs"].dtype == np.float32
    assert calls == dict.fromkeys(WAYS, 0)


def test_non_contiguous_buffer_takes_numpy(seqs, monkeypatch):
    dtypes = wire_dtypes("f32", True, SENSORS["small"])
    t = 5

    def call(pack, seq):
        wide = alloc_buffers((t,), 2 * CAPACITY, dtypes)
        out = {k: v[:, :CAPACITY] if k != "count" else v
               for k, v in wide.items()}
        pack(seq, list(range(t)), capacity=CAPACITY, out=out)
        return out

    results, calls = four_ways(monkeypatch, seqs, "small", call)
    assert_equal(results)
    assert calls == dict.fromkeys(WAYS, 0)


def test_compact4_without_layout_takes_numpy(seqs, monkeypatch):
    """Explicit compact4 buffers at a sensor with no layout: the numpy
    path in both packages, which cannot encode an event (TypeError) and
    leaves empty windows as zeros."""
    tseq = seqs["huge"][1]
    assert tuple(tseq.sensor_resolution) == SENSORS["huge"]
    empty = [{"idx0": 9, "idx1": 9, "event_count": 0}] * 3

    def call(pack, seq, metas):
        out = {"ev": np.full((len(metas), CAPACITY), 5, np.uint32),
               "count": np.zeros(len(metas), np.int32)}
        try:
            pack(seq, range(len(metas)), capacity=CAPACITY, out=out,
                 metas=metas, out_zeroed=False)
        except TypeError:
            return {"raised": np.array([1])}
        return out

    for metas, raised in ((empty, False), (custom_metas(10)[3:4], True)):
        results, calls = four_ways(
            monkeypatch, seqs, "huge",
            lambda pack, seq, metas=metas: call(pack, seq, metas))
        assert_equal(results)
        assert ("raised" in results["torch_native"]) == raised
        assert calls == dict.fromkeys(WAYS, 0)


def test_evreal_native_0_counts_nothing(seqs, monkeypatch):
    tseq = seqs["small"][1]
    native.reset_pack_calls()
    monkeypatch.setenv("EVREAL_NATIVE", "0")
    off = tpack(tseq, [0, 1, 2], wire="compact4")[0]
    assert native.pack_calls == dict.fromkeys(native.WIRES, 0)
    monkeypatch.setenv("EVREAL_NATIVE", "1")
    on = tpack(tseq, [0, 1, 2], wire="compact4")[0]
    assert native.pack_calls == {"f32": 0, "compact": 0, "compact4": 1}
    for k in off:
        np.testing.assert_array_equal(on[k], off[k])


@pytest.mark.parametrize("wire", ["f32", "compact", "compact4"])
def test_capacity_and_bounds_errors_match_jax(seqs, wire):
    """A window past the capacity, or past the events, raises the JAX
    package's ValueError from the native routine, and counts nothing."""
    jseq, tseq = seqs["large"]
    hw = SENSORS["large"]
    dtypes = wire_dtypes(wire, True, hw)
    n = len(tseq.t)
    for idx0, idx1, cap in ((0, 600, 512), (n - 10, n + 1, CAPACITY),
                            (-1, 5, CAPACITY)):
        errors = []
        for mod, seq in ((native, tseq), (jnative, jseq)):
            out = alloc_buffers((1,), cap, dtypes)
            args = (seq.t, seq.xy, seq.p, np.array([idx0]), np.array([idx1]),
                    cap)
            native.reset_pack_calls()
            with pytest.raises(ValueError) as err:
                if wire == "f32":
                    mod.pack_i16(*args, out)
                elif wire == "compact":
                    mod.pack_compact(*args, False, out)
                else:
                    mod.pack_compact4(*args, hw, out)
            errors.append(str(err.value))
            assert sum(native.pack_calls.values()) == 0
        assert errors[0] == errors[1]
        assert errors[0].endswith(": window exceeds capacity or bounds")
    # through pack_windows: a window past the events
    metas = [{"idx0": n - 10, "idx1": n + 5, "event_count": 15}]
    with pytest.raises(ValueError, match="exceeds capacity or bounds"):
        tpack(tseq, [0], capacity=CAPACITY, metas=metas, wire=wire)


def test_wrappers_refuse_buffers_they_cannot_write(seqs):
    tseq = seqs["small"][1]
    out = alloc_buffers((2,), 64, wire_dtypes("f32", True, (48, 64)))
    args = (tseq.t, tseq.xy, tseq.p, np.array([0, 5]), np.array([5, 9]), 64)
    bad = dict(out, ts=out["ts"].astype(np.float64))
    with pytest.raises(ValueError, match=r"out\['ts'\]"):
        native.pack_i16(*args, bad)
    with pytest.raises(ValueError, match=r"out\['ts'\].*\(2, 128\)"):
        native.pack_i16(*args[:5], 128, out)
    with pytest.raises(ValueError, match="no compact4 layout"):
        native.pack_compact4(*args, SENSORS["huge"], out)
    with pytest.raises(ValueError, match="^p: want"):
        native.pack_i16(tseq.t, tseq.xy, tseq.p.astype(np.int8),
                        *args[3:], out)


def test_failing_compiler_raises_naming_it(seqs, monkeypatch, tmp_path):
    """No silent fallback: a build whose compiler fails raises, naming
    the compiler and EVREAL_NATIVE=0."""
    false = tmp_path / "broken-cxx"
    false.write_text("#!/bin/sh\necho broken compiler >&2\nexit 3\n")
    false.chmod(0o755)
    monkeypatch.setenv("CXX", str(false))
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError) as err:
        tpack(seqs["small"][1], [0, 1])
    msg = str(err.value)
    assert str(false) in msg and "exit 3" in msg
    assert "EVREAL_NATIVE=0" in msg and "broken compiler" in msg
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setenv("EVREAL_NATIVE", "0")  # the numpy path needs none
    assert tpack(seqs["small"][1], [0, 1])[0]["count"][0] == K


def test_build_is_cached_by_sources_and_flags(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    first = native.build()
    assert not first["cached"] and Path(first["path"]).exists()
    assert native.build() == {"path": first["path"], "seconds": 0.0,
                              "cached": True}
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g0",))
    assert native.library_path() != Path(first["path"])
    assert not list(tmp_path.glob("*.tmp"))


# ---------------------------------------------------------------------------
# evaluate on the CPU: native against EVREAL_NATIVE=0 and the JAX package
# ---------------------------------------------------------------------------

META = {"class": "E2VIDRecurrent",
        "kwargs": {"num_bins": 5, "base_num_channels": 8, "kernel_size": 3,
                   "num_encoders": 2, "recurrent_block_type": "convlstm",
                   "num_residual_blocks": 1, "skip_type": "sum",
                   "norm": None, "use_upsample_conv": True,
                   "final_activation": "sigmoid"}}
ARGS = ["-m", "E2VID", "-c", "std", "-d", "SYN", "-qm", "mse", "ssim"]
MODES = {"single": "0", "lockstep": "1"}


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """{(mode, way): output dir} for way in jax, native, numpy; and the
    port's native pack calls per (mode, way)."""
    import evreal_tpu.utils
    from evreal_tpu.cli import eval_main
    from evreal_tpu.harness import staging

    from evreal_tpu_torch.cli import main as torch_main
    from evreal_tpu_torch.convert.params import flatten, save_params
    from evreal_tpu_torch.models.init import init_e2vid

    root = tmp_path_factory.mktemp("native_eval")
    for i, (dur, epf) in enumerate([(1.2, 600), (0.9, 500)]):
        d = root / "data" / "SYN" / f"seq{i}"
        make_sequence(str(d), height=40, width=56, duration_s=dur, fps=20,
                      events_per_frame=epf, seed=5 + i)
        # uint8 polarity, as the converters write it: the native layout
        p = np.load(d / "events_p.npy")
        np.save(d / "events_p.npy", p.astype(np.uint8))
    for group in ("method", "dataset"):
        (root / "config" / group).mkdir(parents=True)
    path = root / "pretrained" / "E2VID" / "model.npz"
    path.parent.mkdir(parents=True)
    save_params(path, flatten(init_e2vid(
        seed=0, base_num_channels=8, kernel_size=3, num_encoders=2,
        num_residual_blocks=1)), {**META, "model_name": "E2VID"})
    (root / "config" / "method" / "E2VID.json").write_text(json.dumps(
        {"model_name": "E2VID", "model_path": str(path.relative_to(root)),
         "event_tensor_normalization": True,
         "post_process_norm": "robust"}))
    (root / "config" / "dataset" / "SYN.json").write_text(json.dumps(
        {"root_path": "data/SYN", "sequences": {"seq0": {}, "seq1": {}}}))

    cwd = os.getcwd()
    out, calls = {}, {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(evreal_tpu.utils, "enable_compile_cache",
                       lambda: None)
            mp.setattr(staging, "_compute_seen", False)
            mp.setattr(staging, "_staged_bytes", 0)
            os.chdir(root)
            for mode, batched in MODES.items():
                mp.setenv("EVREAL_BATCHED", batched)
                for way in ("jax", "native", "numpy"):
                    mp.setenv("EVREAL_NATIVE", "0" if way == "numpy" else "1")
                    native.reset_pack_calls()
                    if way == "jax":
                        eval_main(ARGS)
                    else:
                        torch_main(ARGS + ["--device", "cpu"])
                    calls[mode, way] = dict(native.pack_calls)
                    out[mode, way] = root / f"out_{mode}_{way}"
                    (root / "outputs").rename(out[mode, way])
    finally:
        os.chdir(cwd)
    return out, calls


def tree(base):
    return {str(p.relative_to(base)): p.read_bytes()
            for p in sorted(base.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("mode", list(MODES))
def test_evaluate_native_tree_byte_equal_to_numpy(eval_runs, mode):
    out, calls = eval_runs
    native_tree = tree(out[mode, "native"])
    assert native_tree == tree(out[mode, "numpy"])
    assert sum(p.endswith(".png") for p in native_tree) >= 40
    assert calls[mode, "native"]["f32"] > 0
    assert calls[mode, "numpy"] == dict.fromkeys(native.WIRES, 0)


@pytest.mark.parametrize("mode", list(MODES))
def test_evaluate_native_rows_match_jax(eval_runs, mode):
    out, _ = eval_runs
    for seq in ("seq0", "seq1"):
        for metric in ("mse", "ssim"):
            rows = [np.loadtxt(out[mode, way] / "std" / "SYN" / seq / "E2VID"
                               / f"{metric}.txt") for way in ("jax", "native")]
            assert rows[0].shape == rows[1].shape and len(rows[0]) >= 15
            np.testing.assert_array_equal(rows[0][:, 0], rows[1][:, 0])
            np.testing.assert_allclose(rows[1][:, 1], rows[0][:, 1],
                                       atol=2e-5)
