"""Resident reconstruction serving engine (``evreal_tpu/serve.py``).

The offline CLI pays model load and per-run set-up for every evaluation;
this module keeps one method resident and turns incoming event windows
into reconstructed frames for any number of concurrent camera streams:

* One ``ReconEngine`` per method, on one device (CUDA unless the caller
  asks for another; it raises without a card). Per sensor resolution it
  builds a ``MethodRunner`` with ``chunk_t=1`` (one window per dispatch:
  the latency configuration), and per ``("group", n, h, w)`` a lockstep
  ``BatchedRunner``, or, when the engine runs on ``cuda``, more than one
  card is visible and ``n`` divides over them, a ``ShardedRunner`` with a
  block of the lanes on each card of the eval mesh
  (``harness/batched.py:eval_mesh_for``; ``EVREAL_MESH=0`` turns it off). All runners on a device share one
  replica of the engine's model per serving dtype (``EVREAL_DTYPE``).
* Each stream owns only its recurrent state, which stays on the device
  between windows: per push the host uploads one packed window and
  downloads one frame (``u8=True``: quantized on the device, 4x fewer
  bytes).
* Windowing stays the client's concern; the engine consumes one window of
  events per ``push``. Capacities are bucketed to powers of two
  (``data/packing.py``); polarity may be the on-disk {0,1} or ±1. The
  wire (``EVREAL_WIRE``) and ``float_coords`` are fixed when a stream or
  group is opened.

A Unix-socket transport speaks the JAX package's protocol byte for byte (a
newline-terminated JSON header with per-array ``{dtype, shape}``, then the
arrays' raw C-order bytes), so a client of either package talks to a
server of the other; ``python -m evreal_tpu_torch.serve`` runs one.

Threads: the engine lock covers every dispatch (the runners flip the
process-global TF32 flags, ``utils.matmul_precision_ctx``, and the
voxelizer's launch counters are shared); frames are fetched outside it.
"""

import argparse
import json
import os
import socket
import socketserver
import stat
import tempfile
import threading

import numpy as np
import torch

from evreal_tpu_torch.data.packing import (
    alloc_buffers,
    bucket_capacity,
    pack_row,
    wire_dtypes,
    wire_format,
)
from evreal_tpu_torch.harness.batched import (
    BatchedRunner,
    ShardedRunner,
    eval_mesh_for,
    part_states,
    run_parts,
    upload_parts,
)
from evreal_tpu_torch.harness.config import get_method_config
from evreal_tpu_torch.harness.runner import (
    MethodBundle,
    MethodRunner,
    compute_dtype,
    quantize_u8,
)
from evreal_tpu_torch.parallel.mesh import (
    canonical_device,
    dp_devices,
    replica_on,
)
from evreal_tpu_torch.utils import bounded_fetch, resolve_device


def _empty_window(float_coords=False):
    dt = np.float32 if float_coords else np.int16
    return (np.array([], dt), np.array([], dt),
            np.array([], np.float64), np.array([], np.int8))


def _pack_window(xs, ys, ts, ps, capacity=None, float_coords=False,
                 dtypes=None, resolution=None, out=None):
    """One event window -> the runner's ``(T=1, E)`` packed host buffers,
    byte for byte the JAX package's.

    ``out``: views to fill in place (a group passes per-lane views of one
    pooled ``(N, 1, E)`` allocation). Slots past the written ``count`` may
    hold a previous push's events: the voxelizers are count-masked.
    ``ts`` may be absolute (zero-based here in float64, then narrowed);
    ``ps`` may be the on-disk {0,1} or ±1 (``polarity_bit``: the LSB for
    unsigned input, the sign otherwise). ``dtypes`` are the stream's, fixed
    when it was opened (``wire_dtypes``); ``resolution`` (h, w) is needed
    by the compact4 wire. A window over ``capacity`` raises."""
    n = len(xs)
    cap = capacity or bucket_capacity(n)
    if cap < n:
        raise ValueError(f"window of {n} events exceeds capacity {cap}")
    if dtypes is None:
        dtypes = wire_dtypes("f32", not float_coords)
    if out is None:
        out = alloc_buffers((1,), cap, dtypes)
    # the offline packer's row encoding: one wire format in the port
    pack_row(out, 0, np.asarray(xs), np.asarray(ys),
             np.asarray(ts, np.float64), np.asarray(ps), resolution)
    return out


class _Stream:
    __slots__ = ("runner", "state", "frames", "float_coords", "dtypes")

    def __init__(self, runner, float_coords, dtypes):
        self.runner = runner
        self.state = runner.init_state()
        self.frames = 0
        self.float_coords = float_coords
        self.dtypes = dtypes


class _Group:
    __slots__ = ("runner", "state", "n", "frames", "float_coords", "dtypes",
                 "buf_pool", "lock")

    def __init__(self, runner, n, float_coords, dtypes):
        self.runner = runner
        self.state = part_states(runner)  # one per shard
        self.n = n
        self.frames = 0
        self.float_coords = float_coords
        self.dtypes = dtypes
        # per capacity bucket, one reused (N, 1, E) host buffer set; held
        # under ``lock`` from its packing to the frames' fetch
        self.buf_pool = {}
        self.lock = threading.Lock()


class ReconEngine:
    """Resident single-method serving engine on one device (its groups
    on every card of the eval mesh where that applies); thread-safe.

    ``model`` is the port's module with its weights loaded; it is never
    moved: each device runs it where it already lies there in the serving
    dtype, else a replica made once (``parallel.mesh.replica_on``).
    ``device``: ``cuda`` unless the caller asks for another
    (``utils.resolve_device``: raises without a card). The
    engine dispatches one window per ``push`` (a group: one window per
    lane per ``push_group``), so its runners run at ``chunk_t=1``."""

    def __init__(self, model, *, event_norm=False, post_norm="none",
                 num_bins=None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.event_norm = event_norm
        self.post_norm = post_norm
        self.num_bins = num_bins if num_bins is not None else model.num_bins
        self._models = {}    # (device, serving dtype) -> model replica
        self._runners = {}   # (h, w) -> MethodRunner; group keys -> Batched
        self._streams = {}   # sid -> _Stream
        self._groups = {}    # gid -> _Group
        self._next_sid = 1
        self._total_frames = 0
        self._lock = threading.Lock()

    @classmethod
    def from_method(cls, method_name, method_config=None, device=None):
        """Build from a method name as the eval CLI does: resolves
        ``config/method/<name>.json`` (``method_config`` updates it), loads
        its reference ``.pth`` or converted ``.npz`` (``MethodBundle``) and
        honors its input and output normalization flags."""
        device = resolve_device(device)
        cfg = dict(get_method_config(method_name))
        if method_config:
            cfg.update(method_config)
        bundle = MethodBundle(method_name, cfg, device)
        return cls(bundle.model,
                   event_norm=cfg.get("event_tensor_normalization", False),
                   post_norm=cfg.get("post_process_norm", "none"),
                   device=device)

    def _runner_args(self, height, width, device=None):
        """A runner's arguments on ``device`` (the engine's by default):
        the engine's model in the serving dtype read now (one replica per
        device and dtype, shared by every runner there)."""
        device = self.device if device is None else device
        key = (canonical_device(device), compute_dtype())
        model = self._models.get(key)
        if model is None:
            model = self._models[key] = replica_on(self.model, *key).eval()
        return dict(event_norm=self.event_norm, post_norm=self.post_norm,
                    height=int(height), width=int(width),
                    num_bins=self.num_bins, device=device,
                    chunk_t=1), model

    def _runner(self, h, w):
        key = (int(h), int(w))
        r = self._runners.get(key)
        if r is None:
            kwargs, model = self._runner_args(h, w)
            r = self._runners[key] = MethodRunner(model, **kwargs)
        return r

    def open_stream(self, height, width, float_coords=False):
        """Register a camera stream at a sensor resolution; returns its id.
        ``float_coords``: the stream carries fractional (sub-pixel)
        coordinates. It and the wire (``EVREAL_WIRE``, read here once) are
        fixed for the stream's life."""
        with self._lock, torch.no_grad():
            runner = self._runner(height, width)
            dtypes = wire_dtypes(wire_format(), not float_coords,
                                 (int(height), int(width)))
            sid = self._next_sid
            self._next_sid += 1
            self._streams[sid] = _Stream(runner, bool(float_coords), dtypes)
            return sid

    def _get(self, sid):
        try:
            return self._streams[sid]
        except KeyError:
            raise KeyError(f"unknown stream id {sid}") from None

    def push(self, sid, xs, ys, ts, ps, *, u8=False):
        """Feed one event window; returns the reconstructed frame (H, W)
        float32 in [0, 1] (uint8 with ``u8=True``, quantized on the device
        by ``quantize_u8``).

        The engine lock covers packing, upload, dispatch and the state
        swap, which keeps a stream's pushes in order; the frame's fetch
        happens outside it, so other streams dispatch meanwhile. The packed
        buffers are this call's own."""
        with self._lock, torch.no_grad():
            st = self._get(sid)
            bufs = _pack_window(xs, ys, ts, ps,
                                float_coords=st.float_coords,
                                dtypes=st.dtypes,
                                resolution=(st.runner.h, st.runner.w))
            state, _, clipped = st.runner.run(st.state,
                                              st.runner.upload(bufs), 1)
            st.state = state
            st.frames += 1
            self._total_frames += 1
            out = quantize_u8(clipped[0]) if u8 else clipped[0]
        return bounded_fetch(out)

    def reset(self, sid):
        """Zero the stream's recurrent state (a new sequence: the
        reference's ``model.reset_states()``)."""
        with self._lock, torch.no_grad():
            st = self._get(sid)
            st.state = st.runner.init_state()
            st.frames = 0

    # -- lockstep groups -------------------------------------------------
    # n streams that share a frame clock advance together through one
    # BatchedRunner dispatch (the offline lockstep axis, harness/batched.py).
    # Every push_group advances all lanes; a lane without new events takes
    # an empty window (a zero voxel grid, the offline empty-window rule).

    def open_group(self, n, height, width, float_coords=False):
        """Register ``n`` lockstep streams; returns the group's id. An
        engine on ``cuda`` on a host with more than one card shards the
        lanes over the eval mesh (``dp``), one contiguous block a card,
        when ``n`` divides over it; otherwise, on the CPU, or under
        ``EVREAL_MESH=0``, they run on the engine's device
        (``evreal_tpu/serve.py:286-303``)."""
        with self._lock, torch.no_grad():
            mesh = eval_mesh_for(self.device)
            devices = dp_devices(mesh) if mesh is not None else []
            if int(n) % max(len(devices), 1):
                devices = []  # lanes not dp-divisible: run unsharded
            key = ("group", int(n), int(height), int(width),
                   tuple(str(d) for d in devices))
            runner = self._runners.get(key)
            if runner is None:
                def batched(lanes, device=None):
                    kwargs, model = self._runner_args(height, width, device)
                    return BatchedRunner(model, n=lanes, **kwargs)

                runner = self._runners[key] = (
                    ShardedRunner([batched(int(n) // len(devices), d)
                                   for d in devices])
                    if devices else batched(int(n)))
            dtypes = wire_dtypes(wire_format(), not float_coords,
                                 (int(height), int(width)))
            gid = self._next_sid
            self._next_sid += 1
            self._groups[gid] = _Group(runner, int(n), bool(float_coords),
                                       dtypes)
            return gid

    def _group(self, gid):
        with self._lock:
            g = self._groups.get(gid)
        if g is None:
            raise KeyError(f"unknown group id {gid}")
        return g

    def push_group(self, gid, windows, *, u8=False):
        """Feed one window per lane (n ``(xs, ys, ts, ps)`` tuples, None
        for an idle lane: an empty window, not counted as a served frame);
        returns the n frames as an (n, H, W) array.

        The group's pooled host buffers are repacked in place by every
        push, so the group's own lock is held from the packing through the
        dispatch to the frames' fetch: the next push of this group starts
        only when this one's frames are on the host. The engine lock is
        held for the dispatch alone; other streams and groups pack and
        fetch meanwhile."""
        g = self._group(gid)
        with g.lock:
            if len(windows) != g.n:
                raise ValueError(
                    f"group {gid} has {g.n} lanes, got {len(windows)}")
            empty = _empty_window(g.float_coords)
            wins = [w if w is not None else empty for w in windows]
            cap = bucket_capacity(max((len(w[0]) for w in wins), default=0))
            bufs = g.buf_pool.get(cap)
            if bufs is None:
                bufs = g.buf_pool[cap] = alloc_buffers((g.n, 1), cap,
                                                       g.dtypes)
            for j, w in enumerate(wins):
                _pack_window(*w, capacity=cap, float_coords=g.float_coords,
                             dtypes=g.dtypes,
                             resolution=(g.runner.h, g.runner.w),
                             out={k: v[j] for k, v in bufs.items()})
            served = sum(1 for w in windows if w is not None)
            with self._lock, torch.no_grad():
                outs = [c[:, 0] for c in run_parts(
                    g.runner, g.state, upload_parts(g.runner, bufs), 1)]
                g.frames += served
                self._total_frames += served
                if u8:
                    outs = [quantize_u8(o) for o in outs]
            # each shard's lanes from its card, in lane order
            frames = [bounded_fetch(o) for o in outs]
            return frames[0] if len(frames) == 1 else np.concatenate(frames)

    def reset_group(self, gid):
        g = self._group(gid)
        with g.lock, self._lock, torch.no_grad():
            g.state = part_states(g.runner)
            g.frames = 0

    def close_group(self, gid):
        with self._lock:
            self._groups.pop(gid, None)

    def close(self, sid):
        with self._lock:
            self._streams.pop(sid, None)

    def stats(self):
        with self._lock:
            return {"streams": len(self._streams),
                    "groups": sorted(g.n for g in self._groups.values()),
                    "resolutions": sorted(k for k in self._runners
                                          if k[0] != "group"),
                    # engine-lifetime frames served: closing a stream does
                    # not lower it, and idle group lanes do not count
                    "frames": self._total_frames}


# ---------------------------------------------------------------------------
# socket transport: one newline-terminated JSON header per message with
# per-array {dtype, shape} metadata, then the arrays' raw C-order bytes
# ---------------------------------------------------------------------------

def _send(fobj, header, arrays=()):
    arrays = [np.ascontiguousarray(a) for a in arrays]
    header = dict(header)
    header["meta"] = [{"dtype": a.dtype.str, "shape": list(a.shape)}
                      for a in arrays]
    fobj.write((json.dumps(header) + "\n").encode())
    for a in arrays:
        fobj.write(a.tobytes())
    fobj.flush()


def _read_exact(fobj, n):
    chunks = []
    while n:
        b = fobj.read(n)
        if not b:
            raise EOFError("connection closed mid-payload")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _recv(fobj):
    line = fobj.readline()
    if not line:
        return None, []
    header = json.loads(line.decode())
    arrays = []
    for m in header.get("meta", []):
        dt = np.dtype(m["dtype"])
        shape = tuple(m["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        buf = _read_exact(fobj, count * dt.itemsize)
        # a bytearray, so the client's frames are writable like the
        # in-process API's
        arrays.append(np.frombuffer(bytearray(buf), dt).reshape(shape))
    return header, arrays


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        engine = self.server.engine
        while True:
            try:
                header, arrays = _recv(self.rfile)
            except (ValueError, OSError, EOFError):
                break  # a broken frame: drop this connection only
            if header is None:
                break
            try:
                self._reply(engine, header, arrays)
            except BrokenPipeError:
                break
            except Exception as e:  # noqa: BLE001 — a bad request must not
                # kill the server: report it and keep the connection
                try:
                    _send(self.wfile, {"ok": False,
                                       "error": f"{type(e).__name__}: {e}"})
                except OSError:
                    break

    def _reply(self, engine, header, arrays):
        op = header["op"]
        u8 = bool(header.get("u8", False))
        float_coords = bool(header.get("float_coords", False))
        if op == "open":
            sid = engine.open_stream(header["height"], header["width"],
                                     float_coords=float_coords)
            _send(self.wfile, {"ok": True, "sid": sid})
        elif op == "push":
            xs, ys, ts, ps = arrays
            frame = engine.push(header["sid"], xs, ys, ts, ps, u8=u8)
            _send(self.wfile, {"ok": True}, [frame])
        elif op == "reset":
            engine.reset(header["sid"])
            _send(self.wfile, {"ok": True})
        elif op == "close":
            engine.close(header["sid"])
            _send(self.wfile, {"ok": True})
        elif op == "open_group":
            gid = engine.open_group(header["n"], header["height"],
                                    header["width"],
                                    float_coords=float_coords)
            _send(self.wfile, {"ok": True, "gid": gid})
        elif op == "push_group":
            # the presence mask: an idle lane reaches the engine as None,
            # so it is not a served frame; no mask means every lane is real
            n = int(header["n"])
            mask = header.get("mask")
            wins = [tuple(arrays[4 * i:4 * i + 4])
                    if (mask is None or mask[i]) else None
                    for i in range(n)]
            frames = engine.push_group(header["gid"], wins, u8=u8)
            _send(self.wfile, {"ok": True}, [frames])
        elif op == "reset_group":
            engine.reset_group(header["gid"])
            _send(self.wfile, {"ok": True})
        elif op == "close_group":
            engine.close_group(header["gid"])
            _send(self.wfile, {"ok": True})
        elif op == "stats":
            _send(self.wfile, {"ok": True, **engine.stats()})
        else:
            _send(self.wfile, {"ok": False, "error": f"unknown op {op!r}"})


class ReconServer(socketserver.ThreadingUnixStreamServer):
    """Unix-socket server over a ReconEngine, one thread per client."""

    daemon_threads = True

    def __init__(self, engine, path):
        if os.path.exists(path):
            # unlink only a stale socket: never a user's file, never a
            # socket a live server listens on
            if not stat.S_ISSOCK(os.stat(path).st_mode):
                raise OSError(f"{path}: exists and is not a socket")
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.connect(path)
            except OSError:
                os.unlink(path)  # nobody listening: stale
            else:
                raise OSError(f"{path}: a server is already listening")
            finally:
                probe.close()
        super().__init__(path, _Handler)
        self.engine = engine


class ReconClient:
    """Blocking client of ReconServer's protocol."""

    def __init__(self, path):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(path)
        self._f = self._sock.makefile("rwb")

    def _call(self, header, arrays=()):
        _send(self._f, header, arrays)
        resp, payload = _recv(self._f)
        if resp is None:
            raise ConnectionError("server closed the connection")
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "server error"))
        return resp, payload

    def open_stream(self, height, width, float_coords=False):
        resp, _ = self._call({"op": "open", "height": int(height),
                              "width": int(width),
                              "float_coords": bool(float_coords)})
        return resp["sid"]

    def push(self, sid, xs, ys, ts, ps, u8=False):
        _, payload = self._call(
            {"op": "push", "sid": sid, "u8": bool(u8)},
            [np.asarray(xs), np.asarray(ys),
             np.asarray(ts, np.float64), np.asarray(ps)])
        return payload[0]

    def reset(self, sid):
        self._call({"op": "reset", "sid": sid})

    def close_stream(self, sid):
        self._call({"op": "close", "sid": sid})

    def open_group(self, n, height, width, float_coords=False):
        resp, _ = self._call({"op": "open_group", "n": int(n),
                              "height": int(height), "width": int(width),
                              "float_coords": bool(float_coords)})
        return resp["gid"]

    def push_group(self, gid, windows, u8=False):
        """``windows``: n ``(xs, ys, ts, ps)`` tuples (None: an idle lane);
        returns the (n, H, W) frames. Idle lanes travel as the presence
        mask, so the server counts served frames as the engine does."""
        arrays, mask = [], []
        for w in windows:
            mask.append(w is not None)
            if w is None:
                w = _empty_window()
            arrays += [np.asarray(w[0]), np.asarray(w[1]),
                       np.asarray(w[2], np.float64), np.asarray(w[3])]
        _, payload = self._call(
            {"op": "push_group", "gid": gid, "n": len(windows),
             "u8": bool(u8), "mask": mask}, arrays)
        return payload[0]

    def reset_group(self, gid):
        self._call({"op": "reset_group", "gid": gid})

    def close_group(self, gid):
        self._call({"op": "close_group", "gid": gid})

    def stats(self):
        resp, _ = self._call({"op": "stats"})
        return {k: v for k, v in resp.items() if k not in ("ok", "meta")}

    def close(self):
        try:
            self._f.close()
        finally:
            self._sock.close()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="evreal_tpu_torch reconstruction server")
    parser.add_argument("-m", "--method", required=True,
                        help="method name (config/method/<name>.json)")
    parser.add_argument("--socket",
                        default=os.path.join(tempfile.gettempdir(),
                                             "evreal_serve.sock"),
                        help="unix socket path")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs the "
                             "plain CPU path)")
    args = parser.parse_args(argv)

    engine = ReconEngine.from_method(args.method, device=args.device)
    server = ReconServer(engine, args.socket)
    print(f"serving {args.method} on {args.socket}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
