"""The port's serving engine (evreal_tpu_torch/serve.py) against the JAX
package's (evreal_tpu/serve.py; tests/test_serve.py is the template), both
on the CPU at 32 x 48 with flagship-width E2VID (FireNet+ where a case says
so), weights made by ``evreal_tpu.models.build_flagship_e2vid(seed=0)``
and carried over with ``from_jax_tree``:

- the engine against the JAX engine (5 windows, atol 1e-4, the models'
  bound of tests/test_torch_models.py) and against the port's chunked
  offline runner (atol 1e-6), on each wire;
- ``_pack_window`` byte-equal to the JAX packer on every wire;
- polarity conventions, stream isolation, ``reset`` and ``stats``; u8
  frames; a zero-event window; a group with an idle lane (5e-4 against
  solo streams, the JAX package's bound);
- the socket transport, within the package and across packages (a client
  of each against a server of the other), and the server's refusals;
- ``bounded_fetch``; 4 threads on 2 streams and 2 groups; ``from_method``
  on random ``.pth`` files; bf16 within the port's bf16 bounds of its own
  f32 run; the card requirement of the engine and the CLI.

Every socket has a timeout and every server thread is joined with one."""

import json
import os
import subprocess
import sys
import threading
from contextlib import contextmanager, suppress
from pathlib import Path

import numpy as np
import pytest
import torch

from evreal_tpu import serve as jserve
from evreal_tpu.models import build_flagship_e2vid
from evreal_tpu.models import build_model as j_build_model
from evreal_tpu.models.init import init_firenet
from evreal_tpu_torch import serve as tserve
from evreal_tpu_torch.convert.checkpoint import save_method_checkpoint
from evreal_tpu_torch.convert.params import from_jax_tree
from evreal_tpu_torch.harness.runner import MethodRunner
from evreal_tpu_torch.models import build_model, flagship_e2vid_kwargs
from evreal_tpu_torch.utils import bounded_fetch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
H, W, NBINS = 32, 48, 5
ATOL_JAX = 1e-4       # tests/test_torch_models.py
ATOL_OFFLINE = 1e-6   # tests/test_serve.py:85
ATOL_GROUP = 5e-4     # tests/test_serve.py:191-195
BF16_MEAN, BF16_MAX = 0.02, 0.2  # tests/test_torch_bf16.py
TIMEOUT = 60.0        # seconds, every socket and every join
FIRENET = {"num_bins": 5, "base_num_channels": 16, "kernel_size": 3}
FLAGS = {"E2VID": dict(event_norm=True, post_norm="robust"),
         "FireNet+": dict(event_norm=False, post_norm="none")}


@pytest.fixture(autouse=True)
def _f32_wire(monkeypatch):
    """The f32 wire and the f32 serving dtype unless a case sets others."""
    monkeypatch.setenv("EVREAL_WIRE", "f32")
    monkeypatch.delenv("EVREAL_DTYPE", raising=False)
    monkeypatch.delenv("EVREAL_VOXEL_PRECISION", raising=False)


@pytest.fixture(scope="module")
def nets():
    """{method: (JAX model, JAX params, port model)}, the same weights."""
    jm, jp = build_flagship_e2vid(seed=0)
    tm = build_model("E2VIDRecurrent", flagship_e2vid_kwargs())
    tm.load_state_dict(from_jax_tree(jp), strict=True)
    fp = init_firenet(seed=1, **FIRENET)
    fm = build_model("FireNet", FIRENET)
    fm.load_state_dict(from_jax_tree(fp), strict=True)
    return {"E2VID": (jm, jp, tm.eval()),
            "FireNet+": (j_build_model("FireNet", FIRENET), fp, fm.eval())}


def engines(nets, method="E2VID"):
    """(JAX engine, port engine on the CPU) of ``method``."""
    jm, jp, tm = nets[method]
    return (jserve.ReconEngine(jm, jp, **FLAGS[method]),
            tserve.ReconEngine(tm, device="cpu", **FLAGS[method]))


def _windows(seed, n_windows, events_per=700):
    rng = np.random.default_rng(seed)
    wins = []
    t0 = 0.0
    for _ in range(n_windows):
        n = int(events_per * rng.uniform(0.5, 1.5))
        ts = np.sort(rng.uniform(t0, t0 + 0.03, n))
        wins.append((rng.integers(0, W, n).astype(np.int16),
                     rng.integers(0, H, n).astype(np.int16),
                     ts, rng.integers(0, 2, n).astype(np.uint8)))
        t0 += 0.03
    return wins


def _push_all(engine, sid, wins, **kw):
    return [engine.push(sid, *w, **kw) for w in wins]


# ---------------------------------------------------------------------------
# the engine against the JAX engine and the offline runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", sorted(FLAGS))
def test_engine_matches_jax_engine_and_offline_runner(nets, method):
    wins = _windows(0, 5)
    jeng, teng = engines(nets, method)
    want = _push_all(jeng, jeng.open_stream(H, W), wins)
    got = _push_all(teng, teng.open_stream(H, W), wins)
    for g, w in zip(got, want):
        assert g.shape == (H, W) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL_JAX)

    runner = MethodRunner(nets[method][2], height=H, width=W,
                          num_bins=NBINS, device="cpu", chunk_t=len(wins),
                          **FLAGS[method])
    cap = 2048
    bufs = {"xs": np.zeros((len(wins), cap), np.int16),
            "ys": np.zeros((len(wins), cap), np.int16),
            "ts": np.zeros((len(wins), cap), np.float32),
            "ps": np.zeros((len(wins), cap), np.int8),
            "count": np.zeros((len(wins),), np.int32)}
    for i, (xs, ys, ts, ps) in enumerate(wins):
        n = len(xs)
        bufs["count"][i] = n
        bufs["xs"][i, :n] = xs
        bufs["ys"][i, :n] = ys
        bufs["ts"][i, :n] = (ts - ts[0]).astype(np.float32)
        bufs["ps"][i, :n] = ps.astype(np.int8) * 2 - 1
    _, _, clipped = runner.run(runner.init_state(), runner.upload(bufs),
                               len(wins))
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, clipped[i].numpy(), rtol=0,
                                   atol=ATOL_OFFLINE)


@pytest.mark.parametrize("wire", ["compact", "compact4"])
def test_engine_on_narrow_wires_matches_jax(nets, monkeypatch, wire):
    """A narrow wire, read once when the stream opens: the same buffer
    dtypes as the JAX engine's and frames at the models' bound."""
    jeng, teng = engines(nets)
    monkeypatch.setenv("EVREAL_WIRE", wire)
    jsid, sid = jeng.open_stream(H, W), teng.open_stream(H, W)
    monkeypatch.setenv("EVREAL_WIRE", "f32")  # fixed at open time
    assert teng._streams[sid].dtypes == jeng._streams[jsid].dtypes
    wins = _windows(6, 4)
    want = _push_all(jeng, jsid, wins)
    got = _push_all(teng, sid, wins)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL_JAX)


# ---------------------------------------------------------------------------
# the packer
# ---------------------------------------------------------------------------

def _events(seed, n, hw, lo=0, float_coords=False):
    rng = np.random.default_rng(seed)
    h, w = hw
    if float_coords:
        xs = rng.uniform(lo, w - lo, n).astype(np.float32)
        ys = rng.uniform(lo, h - lo, n).astype(np.float32)
    else:
        xs = rng.integers(lo, w - lo, n).astype(np.int16)
        ys = rng.integers(lo, h - lo, n).astype(np.int16)
    ts = np.sort(rng.uniform(10.0, 10.5, n))
    return xs, ys, ts


POLARITIES = {"u8_01": lambda b: b.astype(np.uint8),
              "u8_0255": lambda b: (b * 255).astype(np.uint8),
              "i8_pm1": lambda b: (b * 2 - 1).astype(np.int8)}
PACK_CASES = {
    # name: (wire, float_coords, resolution, coordinate offset)
    "f32": ("f32", False, (48, 64), 0),
    "f32 float_coords": ("f32", True, (48, 64), 0),
    "compact u8 coords": ("compact", False, (48, 64), 0),
    "compact out-of-range coords": ("compact", False, (48, 64), -40),
    "compact int16 coords": ("compact", False, (260, 346), 0),
    "compact float_coords": ("compact", True, (48, 64), 0),
    "compact4": ("compact4", False, (48, 64), 0),
    "compact4 out-of-range coords": ("compact4", False, (48, 64), -5),
    "compact4 float_coords (compact)": ("compact4", True, (48, 64), 0),
}


def assert_same_buffers(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("polarity", sorted(POLARITIES))
@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_window_matches_jax(case, polarity):
    from evreal_tpu.data.packing import wire_dtypes as j_wire_dtypes
    from evreal_tpu_torch.data.packing import wire_dtypes

    wire, fc, hw, lo = PACK_CASES[case]
    n = 300
    xs, ys, ts = _events(4, n, hw, lo, fc)
    ps = POLARITIES[polarity](np.random.default_rng(5).integers(0, 2, n))
    dtypes = wire_dtypes(wire, not fc, hw)
    assert dtypes == j_wire_dtypes(wire, not fc, hw)
    kw = dict(float_coords=fc, dtypes=dtypes, resolution=hw)
    got = tserve._pack_window(xs, ys, ts, ps, **kw)
    assert_same_buffers(got, jserve._pack_window(xs, ys, ts, ps, **kw))
    assert got["count"][0] == n
    # in place into a lane's view of a pooled (2, 1, E) allocation whose
    # tail holds a previous push's events
    from evreal_tpu_torch.data.packing import alloc_buffers

    pools = [alloc_buffers((2, 1), 1024, dtypes) for _ in range(2)]
    for pool, pack in zip(pools, (tserve._pack_window, jserve._pack_window)):
        for v in pool.values():
            v.view(np.uint8)[...] = 7
        pack(xs, ys, ts, ps, capacity=1024, **kw,
             out={k: v[1] for k, v in pool.items()})
    assert_same_buffers(*pools)
    assert pools[0]["count"][1, 0] == n


def test_pack_window_capacity_error_and_empty_window():
    xs, ys, ts = _events(0, 40, (H, W))
    ps = np.ones(40, np.int8)
    for pack in (tserve._pack_window, jserve._pack_window):
        with pytest.raises(ValueError,
                           match="window of 40 events exceeds capacity 32"):
            pack(xs, ys, ts, ps, capacity=32)
    for fc in (False, True):
        empty = tserve._empty_window(fc)
        want = jserve._empty_window(fc)
        assert [a.dtype for a in empty] == [a.dtype for a in want]
        assert_same_buffers(tserve._pack_window(*empty, float_coords=fc),
                            jserve._pack_window(*want, float_coords=fc))


def test_pack_window_sizes_capacity_by_bucket():
    xs, ys, ts = _events(1, 5000, (H, W))
    ps = np.zeros(5000, np.uint8)
    got = tserve._pack_window(xs, ys, ts, ps)
    assert got["xs"].shape == (1, 8192)
    assert_same_buffers(got, jserve._pack_window(xs, ys, ts, ps))


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def test_polarity_conventions_equivalent(nets):
    """{0,1}, {0,255} and ±1 polarity reconstruct identically."""
    wins = _windows(1, 2)
    _, engine = engines(nets)
    frames = []
    for conv in POLARITIES.values():
        sid = engine.open_stream(H, W)
        frames.append([engine.push(sid, xs, ys, ts, conv(ps.astype(int)))
                       for xs, ys, ts, ps in wins])
    for other in frames[1:]:
        for a, b in zip(frames[0], other):
            assert np.array_equal(a, b)


def test_multi_stream_isolation_reset_and_stats(nets):
    """Interleaved streams equal independent runs; ``reset`` returns a
    stream to a fresh stream's output; ``stats`` equals the JAX engine's
    after the same operations."""
    wins_a, wins_b = _windows(2, 3), _windows(3, 3)
    jeng, engine = engines(nets)
    for eng in (jeng, engine):
        sa, sb = eng.open_stream(H, W), eng.open_stream(H, W)
        inter = [(eng.push(sa, *wa), eng.push(sb, *wb))
                 for wa, wb in zip(wins_a, wins_b)]
        if eng is jeng:
            continue
        _, solo = engines(nets)
        solo_a = _push_all(solo, solo.open_stream(H, W), wins_a)
        for (x, _), y in zip(inter, solo_a):
            assert np.array_equal(x, y)
        engine.reset(sb)
        replay = _push_all(engine, sb, wins_b)
        fresh = _push_all(engine, engine.open_stream(H, W), wins_b)
        for x, y in zip(replay, fresh):
            assert np.array_equal(x, y)
        for x, y in zip(replay, (b for _, b in inter)):
            assert np.array_equal(x, y)
    jeng.reset(2)
    _push_all(jeng, 2, wins_b)
    _push_all(jeng, jeng.open_stream(H, W), wins_b)
    st = engine.stats()
    assert st == jeng.stats()
    assert st == {"streams": 3, "groups": [], "resolutions": [(H, W)],
                  "frames": 12}
    engine.close(1)
    assert engine.stats()["streams"] == 2
    assert engine.stats()["frames"] == 12  # never goes down
    with pytest.raises(KeyError, match="unknown stream id 1"):
        engine.push(1, *wins_a[0])
    with pytest.raises(KeyError, match="unknown stream id 99"):
        engine.reset(99)


def test_u8_frames(nets):
    (wnd,) = _windows(4, 1)
    jeng, engine = engines(nets)
    sid = engine.open_stream(H, W)
    f32 = engine.push(sid, *wnd)
    engine.reset(sid)
    u8 = engine.push(sid, *wnd, u8=True)
    assert u8.dtype == np.uint8 and u8.shape == (H, W)
    assert np.array_equal(u8, np.round(np.clip(f32, 0, 1) * 255)
                          .astype(np.uint8))
    want = jeng.push(jeng.open_stream(H, W), *wnd, u8=True)
    assert np.abs(u8.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("method", sorted(FLAGS))
def test_zero_event_window(nets, method):
    """An empty window runs (a zero voxel grid) and advances the state,
    as in the JAX engine: a window after it agrees too."""
    jeng, engine = engines(nets, method)
    (wnd,) = _windows(7, 1)
    got, want = ([eng.push(sid, *w)
                  for w in (tserve._empty_window(), wnd)]
                 for eng, sid in ((engine, engine.open_stream(H, W)),
                                  (jeng, jeng.open_stream(H, W))))
    assert got[0].shape == (H, W) and np.isfinite(got[0]).all()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL_JAX)


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

def _lane_windows(lanes, t, idle=(1, 2)):
    """Tick ``t`` of the lanes' windows; lane 2 idles at tick 1."""
    return [None if (t, j) == idle else lanes[j][t]
            for j in range(len(lanes))]


def test_group_matches_single_streams_and_jax(nets):
    """Each lane of a lockstep group reconstructs as a solo stream fed the
    same windows (an idle lane as one fed an empty window), and the group
    agrees with the JAX engine's group."""
    lanes = [_windows(10, 3), _windows(11, 3), _windows(12, 3)]
    jeng, engine = engines(nets)
    gid, jgid = engine.open_group(3, H, W), jeng.open_group(3, H, W)
    got, want = [], []
    for t in range(3):
        wins = _lane_windows(lanes, t)
        got.append(engine.push_group(gid, wins))
        want.append(jeng.push_group(jgid, wins))
        assert got[-1].shape == (3, H, W) and got[-1].dtype == np.float32
        np.testing.assert_allclose(got[-1], want[-1], rtol=0, atol=ATOL_JAX)
    for j in range(3):
        sid = engine.open_stream(H, W)
        for t in range(3):
            w = _lane_windows(lanes, t)[j]
            if w is None:
                w = tserve._empty_window()
            solo = engine.push(sid, *w)
            np.testing.assert_allclose(got[t][j], solo, rtol=0,
                                       atol=ATOL_GROUP)
    u8 = engine.push_group(gid, _lane_windows(lanes, 0), u8=True)
    assert u8.dtype == np.uint8 and u8.shape == (3, H, W)
    # 8 lane windows served (the idle lane is not one), 9 solo, 3 u8
    assert engine.stats()["frames"] == 8 + 9 + 3
    engine.reset_group(gid)
    again = engine.push_group(gid, _lane_windows(lanes, 0))
    assert np.array_equal(again, got[0])
    with pytest.raises(ValueError, match="has 3 lanes, got 2"):
        engine.push_group(gid, lanes[:2])
    assert engine.stats()["groups"] == [3]
    engine.close_group(gid)
    assert engine.stats()["groups"] == []
    with pytest.raises(KeyError, match="unknown group id"):
        engine.push_group(gid, _lane_windows(lanes, 0))


# ---------------------------------------------------------------------------
# the socket transport
# ---------------------------------------------------------------------------

@contextmanager
def serving(package, engine, path):
    """``package``'s ReconServer over ``engine`` on ``path``, served from
    a thread that is joined with a timeout."""
    server = package.ReconServer(engine, path)
    thread = threading.Thread(target=server.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()
        thread.join(TIMEOUT)
        assert not thread.is_alive()


def connect(package, path):
    client = package.ReconClient(path)
    client._sock.settimeout(TIMEOUT)
    return client


def test_socket_roundtrip(nets, tmp_path):
    """tests/test_serve.py:204-283 against the port's server and client."""
    _, engine = engines(nets)
    _, ref_engine = engines(nets)
    path = str(tmp_path / "serve.sock")
    with serving(tserve, engine, path):
        wins = _windows(5, 2)
        client = connect(tserve, path)
        sid = client.open_stream(H, W)
        got = [client.push(sid, *w) for w in wins]
        want = _push_all(ref_engine, ref_engine.open_stream(H, W), wins)
        for g, w_ in zip(got, want):
            assert np.array_equal(g, w_)

        st = client.stats()
        assert st["streams"] == 1 and st["frames"] == 2

        # a bad sid reports, and the connection survives
        with pytest.raises(RuntimeError, match="unknown stream id 999"):
            client.push(999, *wins[0])
        client.reset(sid)
        client.close_stream(sid)
        assert client.stats()["streams"] == 0

        # groups over the wire: 2 lanes, lane 1 idle, equal in-process
        gid = client.open_group(2, H, W)
        frames = client.push_group(gid, [wins[0], None])
        g2 = ref_engine.open_group(2, H, W)
        assert np.array_equal(frames, ref_engine.push_group(
            g2, [wins[0], None]))
        u8 = client.push_group(gid, [wins[1], wins[0]], u8=True)
        assert u8.dtype == np.uint8 and np.array_equal(
            u8, ref_engine.push_group(g2, [wins[1], wins[0]], u8=True))
        client.reset_group(gid)
        client.close_group(gid)

        # idle lanes travel as the presence mask: the served-frame count
        # matches the in-process engine's
        assert client.stats()["frames"] == ref_engine.stats()["frames"]

        # writable frames; no framing keys in stats; a monotonic counter
        got[0] *= 0.5
        assert "meta" not in st and "ok" not in st
        assert client.stats()["frames"] >= 2

        # a second server on a live socket refuses, it does not hijack
        with pytest.raises(OSError, match="already listening"):
            tserve.ReconServer(ref_engine, path)
        client.close()

        # an unknown op gets an error response and the connection
        # survives; a non-JSON line drops that connection only
        c2 = connect(tserve, path)
        with pytest.raises(RuntimeError, match="unknown op"):
            c2._call({"op": "bogus"})
        assert c2.stats()["streams"] == 0
        c2._f.write(b"not json\n")
        c2._f.flush()
        with pytest.raises((ConnectionError, OSError)):
            c2.stats()
        with suppress(OSError):  # the request left unsent by the drop
            c2.close()
        c3 = connect(tserve, path)
        assert c3.stats()["streams"] == 0
        c3.close()


def _json_stats(stats):
    """In-process stats as they arrive over JSON (tuples become lists)."""
    return json.loads(json.dumps(stats))


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("torch", "jax"), ("jax", "torch")])
def test_cross_package_protocol(nets, tmp_path, server_pkg, client_pkg):
    """A client of either package against a server of the other: frames
    equal to the server package's in-process engine, stats equal."""
    pkgs = {"jax": jserve, "torch": tserve}
    idx = {"jax": 0, "torch": 1}[server_pkg]
    engine, ref = engines(nets)[idx], engines(nets)[idx]
    wins = _windows(9, 3)
    path = str(tmp_path / "x.sock")
    with serving(pkgs[server_pkg], engine, path):
        client = connect(pkgs[client_pkg], path)
        sid, rid = client.open_stream(H, W), ref.open_stream(H, W)
        for i, w in enumerate(wins):
            u8 = i == 2
            got, want = client.push(sid, *w, u8=u8), ref.push(rid, *w, u8=u8)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        gid, rgid = client.open_group(3, H, W), ref.open_group(3, H, W)
        lanes = [wins[0], None, wins[2]]
        assert np.array_equal(client.push_group(gid, lanes),
                              ref.push_group(rgid, lanes))
        assert client.stats() == _json_stats(ref.stats())
        client.close_stream(sid)
        ref.close(rid)
        client.close_group(gid)
        ref.close_group(rgid)
        assert client.stats() == _json_stats(ref.stats())
        with pytest.raises(RuntimeError, match="unknown op"):
            client._call({"op": "bogus"})
        client.close()


@pytest.mark.parametrize("kind", ["file", "live", "stale"])
def test_server_path_rules(nets, tmp_path, kind):
    """A regular file is refused and kept; a live socket is refused; a
    stale socket (nobody listening) is unlinked and served on."""
    import socket

    _, engine = engines(nets)
    path = tmp_path / "p.sock"
    if kind == "file":
        path.write_text("precious")
        with pytest.raises(OSError, match="not a socket"):
            tserve.ReconServer(engine, str(path))
        assert path.read_text() == "precious"
    elif kind == "live":
        with serving(tserve, engine, str(path)):
            with pytest.raises(OSError, match="already listening"):
                tserve.ReconServer(engine, str(path))
    else:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.bind(str(path))
        s.close()
        assert path.exists()
        with serving(tserve, engine, str(path)):
            client = connect(tserve, str(path))
            assert client.stats()["streams"] == 0
            client.close()


# ---------------------------------------------------------------------------
# bounded fetch, threads, from_method, bf16, the card requirement, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,max_bytes", [
    ((3, 4), 1 << 20),                          # small: one copy
    ((8, 64, 64), 64 * 64 * 4 * 2 + 1),         # leading-axis slices
    ((2, 3, 128, 128), 128 * 128 * 4 * 2 + 1),  # recursive
])
def test_bounded_fetch_slices_and_recurses(shape, max_bytes):
    import jax.numpy as jnp

    from evreal_tpu.utils import bounded_fetch as j_bounded_fetch

    host = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    tensor = torch.from_numpy(host.copy())
    got = bounded_fetch(tensor, max_bytes)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert np.array_equal(got, host)
    assert np.array_equal(got, j_bounded_fetch(jnp.asarray(host), max_bytes))
    got[(0,) * got.ndim] = 42.0  # writable, and not the tensor's memory
    assert float(tensor.reshape(-1)[0]) == host.reshape(-1)[0]


def test_threads_on_streams_and_groups(nets):
    """4 threads push at once to 2 streams and 2 groups (each group's
    pooled buffers repacked on every push); each result equals its serial
    run bit for bit."""
    jobs = [("stream", [_windows(20, 4)]), ("stream", [_windows(21, 4)]),
            ("group", [_windows(22, 4), _windows(23, 4)]),
            ("group", [_windows(24, 4), _windows(25, 4), _windows(26, 4)])]

    def open_all(engine):
        return [engine.open_stream(H, W) if kind == "stream"
                else engine.open_group(len(lanes), H, W)
                for kind, lanes in jobs]

    def run(engine, ident, job):
        kind, lanes = job
        out = []
        for t in range(4):
            if kind == "stream":
                out.append(engine.push(ident, *lanes[0][t], u8=t == 3))
            else:
                wins = [None if (t == 1 and j == 0) else lane[t]
                        for j, lane in enumerate(lanes)]
                out.append(engine.push_group(ident, wins, u8=t == 3))
        return out

    _, serial = engines(nets)
    want = [run(serial, i, job) for i, job in zip(open_all(serial), jobs)]

    _, engine = engines(nets)
    ids = open_all(engine)
    got, errors = [None] * len(jobs), []
    barrier = threading.Barrier(len(jobs))

    def worker(k):
        try:
            barrier.wait(TIMEOUT)
            got[k] = run(engine, ids[k], jobs[k])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,), daemon=True)
               for k in range(len(jobs))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert engine.stats() == serial.stats()


def _random_pth(root, method, seed):
    """A random-weight reference ``.pth`` of ``method``; returns (path,
    model)."""
    torch.manual_seed(seed)
    if method == "E2VID":  # its schema records no final activation
        model = build_model("E2VIDRecurrent", flagship_e2vid_kwargs())
        kwargs = {k: v for k, v in flagship_e2vid_kwargs().items()
                  if k != "final_activation"}
    else:
        kwargs = FIRENET
        model = build_model("FireNet", kwargs)
    path = root / "pretrained" / method / "model.pth"
    path.parent.mkdir(parents=True)
    save_method_checkpoint(path, method, model, kwargs)
    return path, model.eval()


@pytest.mark.parametrize("method", sorted(FLAGS))
def test_from_method_on_reference_pth(tmp_path, method):
    """``from_method`` loads a reference ``.pth`` as ``evaluate`` does and
    takes the method config's normalization flags: frames equal to an
    engine built directly on the same weights."""
    path, model = _random_pth(tmp_path, method, seed=3)
    engine = tserve.ReconEngine.from_method(
        method, {"model_path": str(path)}, device="cpu")
    assert (engine.event_norm, engine.post_norm) == tuple(
        FLAGS[method].values())
    direct = tserve.ReconEngine(model, device="cpu", **FLAGS[method])
    wins = _windows(13, 3)
    for eng in (engine, direct):
        eng.sid = eng.open_stream(H, W)
    for w in wins:
        assert np.array_equal(engine.push(engine.sid, *w),
                              direct.push(direct.sid, *w))


def test_bf16_engine_within_bounds_of_f32(nets, monkeypatch):
    """EVREAL_DTYPE=bfloat16: a stream and a group within the port's bf16
    bounds of the f32 engine's frames (post-norm 'none': the raw sigmoid
    output), every runner sharing one bf16 copy of the model."""
    tm = nets["E2VID"][2]
    wins = [_windows(30, 4), _windows(31, 4)]
    kw = dict(device="cpu", event_norm=True, post_norm="none")
    out = {}
    for dtype in ("float32", "bfloat16"):
        monkeypatch.setenv("EVREAL_DTYPE", dtype)
        engine = tserve.ReconEngine(tm, **kw)
        sid, gid = engine.open_stream(H, W), engine.open_group(2, H, W)
        out[dtype] = np.concatenate(
            [np.stack(_push_all(engine, sid, wins[0]))]
            + [engine.push_group(gid, [wins[0][t], wins[1][t]])
               for t in range(4)])
        models = {id(r.model) for r in engine._runners.values()}
        assert len(models) == 1
    bf16 = engine._models[torch.bfloat16]
    assert next(iter(models)) == id(bf16) and bf16 is not tm
    assert next(bf16.parameters()).dtype == torch.bfloat16
    assert next(tm.parameters()).dtype == torch.float32
    d = np.abs(out["bfloat16"] - out["float32"])
    assert 0 < d.max() < BF16_MAX and d.mean() < BF16_MEAN


def test_bf16_zero_event_window_equals_offline_runner(nets, monkeypatch):
    """In bf16 an empty first window gives a flat raw frame, which the
    robust post-norm divides by zero: the engine returns what the offline
    runner returns for the same window (NaN where it does)."""
    monkeypatch.setenv("EVREAL_DTYPE", "bfloat16")
    tm = nets["E2VID"][2]
    engine = tserve.ReconEngine(tm, device="cpu", **FLAGS["E2VID"])
    got = engine.push(engine.open_stream(H, W), *tserve._empty_window())
    runner = MethodRunner(tm, height=H, width=W, num_bins=NBINS,
                          device="cpu", chunk_t=1, **FLAGS["E2VID"])
    bufs = tserve._pack_window(*tserve._empty_window(),
                               dtypes=engine._streams[1].dtypes)
    _, _, clipped = runner.run(runner.init_state(), runner.upload(bufs), 1)
    np.testing.assert_array_equal(got, clipped[0].numpy())


def test_engine_and_cli_need_a_card_unless_asked_for_the_cpu(
        nets, tmp_path, monkeypatch):
    tm = nets["E2VID"][2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.ReconEngine(tm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.ReconEngine.from_method("E2VID")
    sock = tmp_path / "s.sock"
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main(["-m", "E2VID", "--socket", str(sock)])
    assert not sock.exists()
    assert tserve.ReconEngine(tm, device="cpu").device.type == "cpu"


def test_cli_serves_on_the_cpu(tmp_path):
    """``python -m evreal_tpu_torch.serve -m FireNet+ --device cpu`` with a
    method config in the working directory naming a random ``.pth``: the
    "serving" line, then frames over the socket equal to an in-process
    engine's."""
    path, model = _random_pth(tmp_path, "FireNet+", seed=4)
    cfg_dir = tmp_path / "config" / "method"
    cfg_dir.mkdir(parents=True)
    cfg = json.loads((ROOT / "config" / "method" / "FireNet+.json")
                     .read_text())
    (cfg_dir / "FireNet+.json").write_text(json.dumps(
        dict(cfg, model_path=str(path))))
    sock = tmp_path / "cli.sock"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "evreal_tpu_torch.serve", "-m", "FireNet+",
         "--socket", str(sock), "--device", "cpu"], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = []
        reader = threading.Thread(
            target=lambda: line.append(proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(TIMEOUT)
        assert line == [f"serving FireNet+ on {sock}\n"], line
        client = connect(tserve, str(sock))
        engine = tserve.ReconEngine(model, device="cpu", **FLAGS["FireNet+"])
        sid, rid = client.open_stream(H, W), engine.open_stream(H, W)
        for w in _windows(14, 2):
            np.testing.assert_allclose(client.push(sid, *w),
                                       engine.push(rid, *w), rtol=0,
                                       atol=ATOL_OFFLINE)
        client.close()
    finally:
        proc.kill()
        proc.communicate(timeout=TIMEOUT)
