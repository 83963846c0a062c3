"""The port's own copies of the data layer (evreal_tpu_torch/data) against
the JAX package's: the same window table from a memmap sequence, and
bit-identical packed buffers on every wire format."""

import sys
from pathlib import Path

import numpy as np
import pytest

from evreal_tpu.data import Sequence as JSequence
from evreal_tpu.data import packing as jpack
from evreal_tpu_torch.data import Sequence
from evreal_tpu_torch.data import packing as tpack

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402


@pytest.fixture(scope="module")
def seq_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data") / "seq0"
    make_sequence(str(d), height=24, width=40, duration_s=0.8, fps=20,
                  events_per_frame=500, seed=11)
    return str(d)


@pytest.mark.parametrize("voxel_method", [
    {"method": "between_frames"},
    {"method": "k_events", "k": 700, "sliding_window_w": 100},
    {"method": "t_seconds", "t": 0.03, "sliding_window_t": 0.0}])
def test_window_tables_match(seq_dir, voxel_method):
    t = Sequence(seq_dir, num_bins=5, voxel_method=voxel_method)
    j = JSequence(seq_dir, num_bins=5, voxel_method=voxel_method)
    assert t.sensor_resolution == j.sensor_resolution
    assert t.windows() == j.windows()


@pytest.mark.parametrize("wire", ["f32", "compact", "compact4"])
def test_packed_buffers_bit_identical(seq_dir, wire):
    t = Sequence(seq_dir, num_bins=5)
    j = JSequence(seq_dir, num_bins=5)
    idx = list(range(len(t)))
    cap = tpack.plan_capacity(m["event_count"] for m in t.windows())
    assert cap == jpack.plan_capacity(m["event_count"] for m in j.windows())
    got, _ = tpack.pack_windows(t, idx, capacity=cap, wire=wire)
    want, _ = jpack.pack_windows(j, idx, capacity=cap, wire=wire)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    # reused pool buffers (stale tails cleared) give the same bytes
    pool = tpack.alloc_buffers((len(idx),), cap,
                               tpack.wire_dtypes(wire, True, (24, 40)))
    for v in pool.values():
        v[...] = 7
    again, _ = tpack.pack_windows(t, idx, capacity=cap, out=pool,
                                  out_zeroed=False)
    for k in got:
        np.testing.assert_array_equal(again[k], want[k])


def test_capacity_helpers_match():
    counts = [100] * 300 + [50_000]
    assert tpack.plan_capacity(counts) == jpack.plan_capacity(counts)
    assert tpack.bucket_capacity(5000) == jpack.bucket_capacity(5000)
    for res in [(180, 240), (260, 346), (720, 1280), (4000, 4000)]:
        assert tpack.compact4_layout(res) == jpack.compact4_layout(res)
        for coords in (True, False):
            for w in ("f32", "compact", "compact4"):
                assert tpack.wire_dtypes(w, coords, res) == \
                    jpack.wire_dtypes(w, coords, res)


@pytest.mark.parametrize("env", [None, "f32", "compact", "compact4", "zstd",
                                 "F32", ""])
def test_wire_format_parses_like_jax(env, monkeypatch):
    """``EVREAL_WIRE`` in {f32, compact, compact4}, default f32, anything
    else a ValueError (tests/test_wire_compact.py:43-52)."""
    if env is None:
        monkeypatch.delenv("EVREAL_WIRE", raising=False)
    else:
        monkeypatch.setenv("EVREAL_WIRE", env)
    try:
        want = jpack.wire_format()
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tpack.wire_format()
        assert str(got.value) == str(exc)
        return
    assert tpack.wire_format() == want == (env or "f32")


@pytest.fixture(scope="module")
def big_sensor_dir(tmp_path_factory):
    """An events-only sequence on a sensor too large for compact4's index
    (3000 x 3000: 24 index bits leave 7 timestamp bits < 12)."""
    d = tmp_path_factory.mktemp("big") / "seq"
    d.mkdir()
    rng = np.random.default_rng(4)
    n = 5000
    np.save(d / "events_ts.npy", np.sort(rng.uniform(0, 1.0, n)))
    np.save(d / "events_xy.npy", np.stack(
        [rng.integers(-5, 3005, n), rng.integers(-5, 3005, n)],
        1).astype(np.int16))
    np.save(d / "events_p.npy", rng.integers(0, 2, n).astype(np.uint8))
    (d / "metadata.json").write_text('{"sensor_resolution": [3000, 3000]}')
    return str(d)


@pytest.mark.parametrize("wire", ["compact", "compact4"])
def test_compact4_falls_back_to_compact_per_sensor(big_sensor_dir, wire):
    vm = {"method": "k_events", "k": 700, "sliding_window_w": 0}
    t = Sequence(big_sensor_dir, voxel_method=vm)
    j = JSequence(big_sensor_dir, voxel_method=vm)
    assert tpack.compact4_layout(t.sensor_resolution) is None
    idx = list(range(len(t)))
    got, _ = tpack.pack_windows(t, idx, wire=wire)
    want, _ = jpack.pack_windows(j, idx, wire=wire)
    assert sorted(got) == sorted(want) == ["count", "ps", "ts", "xs", "ys"]
    assert got["ts"].dtype == np.uint16 and got["xs"].dtype == np.int16
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
