"""The ``stream`` kind: live cameras pushing event windows into one
resident ``evreal_tpu_torch.serve.ReconEngine``, open loop.

Set-up draws each stream's cycle of windows from the seed
(``lib/scene.py``: its event rate times the push period a window), the
method's ``.pth`` and config, builds the engine the way ``serve.py``
does (``ReconEngine.from_method``), and warms it with a few pushes of
each stream's windows one after another. The window's client threads
first push ``warm_s`` seconds of the traffic on streams of their own
(set-up, untimed), then go on, on the same schedule, with the window's
pushes on fresh streams. The window opens one fresh
stream a camera; each camera's client thread pushes its windows on a
fixed period, the cameras' phases evenly spaced over it in an order drawn
from the seed, whether or not the last
push has returned, and takes the frame back as u8 (``push(..., u8=True)``,
what a viewer shows). A push is timed from when it was due until its
frame is on the host; one that raises counts as missing (an infinite
latency). Every push due in ``--seconds`` is made, late or not.

A traced run profiles a slice of ``traced_s`` seconds in the middle of
the window, in the main thread's ``bench.window`` span. The check
replays every stream's pushes through the plain reference and compares
every returned frame."""

import math
import os
import threading
import time

import numpy as np
import torch

from benchmark.lib import scene
from benchmark.lib.check import Tally
from benchmark.lib.stats import percentile
from benchmark.lib.weights import draw, save_pth
from benchmark.reference import events as ref_events
from benchmark.reference import frames as ref_frames
from benchmark.reference.models import param_shapes
from benchmark.reference.pipeline import Recon

WARM_PUSHES = 4   # of each stream's windows, one after another

class Run:
    def __init__(self, run):
        self.r = run
        self.mix, self.config = run.mix, run.config
        mix = self.mix
        if run.rehearse:
            r = mix["rehearsal"]
            self.h, self.w = r["height"], r["width"]
            self.rates = [s["events_per_s"] * r["event_scale"]
                          for s in mix["streams"]]
            self.push_hz = mix["push_rate_hz"] * r["rate_scale"]
        else:
            self.h, self.w = mix["height"], mix["width"]
            self.rates = [s["events_per_s"] for s in mix["streams"]]
            self.push_hz = mix["push_rate_hz"]
        self.n = len(self.rates)
        self.period = self.n / self.push_hz            # a stream's period
        self.per_window = [max(1, round(r * self.period))
                           for r in self.rates]
        self.cycle = max(1, math.ceil(mix["cycle_s"] / self.period))
        self.failed = 0
        self.traced = None

    # -- set-up ---------------------------------------------------------

    def setup(self, engine=None):
        """Inputs, the engine (``engine``: one built already), and
        ``WARM_PUSHES`` pushes of every stream's windows one after another
        on a stream of their own (the first pushes build and load what the
        engine needs); the open-loop warm traffic runs in ``window``."""
        self.inputs()
        os.chdir(self.r.workdir)
        from evreal_tpu_torch.serve import ReconEngine

        self.engine = engine or ReconEngine.from_method(
            self.config["method"], device=self.r.device)
        self.r.mark("data, weights and engine")
        warm = self.engine.open_stream(self.h, self.w)
        for j in range(self.n):
            for k in range(WARM_PUSHES):
                self.engine.push(warm, *self.win(j, k), u8=True)
        self.r.mark("warm pushes")

    def inputs(self):
        """Each stream's cycle of windows, the phases, the weights."""
        r, mix = self.r, self.mix
        self.streams = []
        for j, per in enumerate(self.per_window):
            seq = scene.make_scene(mix["scene"], self.cycle, per,
                                   1.0 / self.period, self.h, self.w,
                                   r.device, r.seed, j)
            self.streams.append(seq)
        # the same arrivals for every seed: the streams' phases evenly
        # spaced over a period, the seed choosing which stream takes which
        gen = np.random.default_rng(scene.sub_seed(r.seed, 1 << 22))
        self.phase = (gen.permutation(self.n) + 0.5) * self.period / self.n
        self.state_dict = draw(param_shapes(self.config),
                               self.config["init"], r.device, r.seed)
        pth = os.path.join(r.workdir, "model.pth")
        save_pth(pth, self.config, self.state_dict)
        r.write_config("method", self.config["method"],
                       dict(self.config["method_config"], model_path=pth))

    def win(self, j, k):
        """Push ``k`` of stream ``j``: (xs, ys, ts, ps) host arrays."""
        seq, per = self.streams[j], self.per_window[j]
        a = (k % self.cycle) * per
        xy = seq["events_xy"][a:a + per]
        return (xy[:, 0], xy[:, 1], seq["events_ts"][a:a + per],
                seq["events_p"][a:a + per])

    # -- the window -----------------------------------------------------

    def window(self, seconds, traced=None):
        """``warm_s`` seconds of the traffic on warm streams, then, on the
        same client threads, the window's pushes on fresh streams; with
        ``traced``, its middle ``traced_s`` seconds under it."""
        from torch.profiler import record_function

        self.count = max(1, int(seconds / self.period))
        lead = int(self.mix["warm_s"] / self.period)   # warm pushes
        warm = [self.engine.open_stream(self.h, self.w)
                for _ in range(self.n)]
        self.sids = [self.engine.open_stream(self.h, self.w)
                     for _ in range(self.n)]
        self.frames = [[None] * self.count for _ in range(self.n)]
        self.latency = [[math.inf] * self.count for _ in range(self.n)]
        self.late = [[0.0] * self.count for _ in range(self.n)]
        self.marks = [[(0.0, 0.0)] * self.count for _ in range(self.n)]
        errors = []
        span = record_function if traced else None
        start0 = time.perf_counter() + 0.05
        t0 = self.t0 = self.timed_from = start0 + lead * self.period

        def client(j):
            for i in range(-lead, self.count):
                due = t0 + self.phase[j] + i * self.period
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                start = time.perf_counter()
                k = i % self.count if i < 0 else i
                sid = warm[j] if i < 0 else self.sids[j]
                try:
                    if span is not None and i >= 0:
                        with span("bench.push"):
                            frame = self.engine.push(sid, *self.win(j, k),
                                                     u8=True)
                    else:
                        frame = self.engine.push(sid, *self.win(j, k),
                                                 u8=True)
                except Exception as e:  # noqa: BLE001 — counted, reported
                    errors.append(repr(e))
                    continue
                if i < 0:
                    continue
                end = time.perf_counter()
                self.frames[j][k] = np.asarray(frame)
                self.latency[j][k] = end - due
                self.late[j][k] = start - due
                self.marks[j][k] = (start, end)

        threads = [threading.Thread(target=client, args=(j,), daemon=True)
                   for j in range(self.n)]
        for t in threads:
            t.start()
        if traced is not None:
            mid = t0 + seconds / 2 - self.mix["traced_s"] / 2
            time.sleep(max(0.0, mid - time.perf_counter()))
            with traced():
                a = time.perf_counter()
                time.sleep(self.mix["traced_s"])
                b = time.perf_counter()
            self.traced = (a, b)
        for t in threads:
            t.join(timeout=seconds + self.mix["warm_s"] + 300)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a client thread did not finish its pushes")
        self.failed = len(errors)
        if errors:
            self.r.note(f"{len(errors)} pushes failed, first: {errors[0]}")
        lat_ms = [x * 1e3 for row in self.latency for x in row]
        late_ms = [x * 1e3 for row in self.late for x in row]
        j, k = divmod(int(np.argmax(late_ms)), self.count)
        self.r.note(f"window: {self.n} streams x {self.count} pushes every "
                    f"{self.period * 1e3:.3f} ms after {lead} warm ones; "
                    f"generator late p50 {percentile(late_ms, 50):.3f} ms, "
                    f"p95 {percentile(late_ms, 95):.3f} ms, max "
                    f"{max(late_ms):.3f} ms (stream {j}, push {k})")
        return {"push_ms_p50": percentile(lat_ms, 50),
                "push_ms_p95": percentile(lat_ms, 95)}

    def attempted(self):
        return self.n * self.count

    def layer_counts(self):
        """The pushes that ran wholly inside the profiled slice."""
        a, b = self.traced
        pushes = [(j, k) for j in range(self.n) for k in range(self.count)
                  if a <= self.marks[j][k][0] and self.marks[j][k][1] <= b
                  and self.frames[j][k] is not None]
        bins = self.config["kwargs"]["num_bins"]
        return {"windows": len(pushes),
                "events": sum(self.per_window[j] for j, _ in pushes),
                "grid_bytes": len(pushes) * bins * self.h * self.w * 4}

    def free(self):
        self.engine = None

    # -- the check ------------------------------------------------------

    def reference_frames(self, mode):
        """For each push index k, the (streams, H, W) uint8 frames of the
        reference over the same windows, the streams in lockstep, and the
        streams whose frame is well-conditioned (``pipeline.STRETCH_MIN``)."""
        dev = self.r.device
        bins = self.config["kwargs"]["num_bins"]
        recon = Recon(self.config, self.state_dict, self.h, self.w, self.n,
                      dev, mode)
        evs = [ref_events.device_events(s, dev) for s in self.streams]
        for k in range(self.count):
            vox = []
            for j, (t_ev, p_ev, pix) in enumerate(evs):
                a = (k % self.cycle) * self.per_window[j]
                b = a + self.per_window[j]
                vox.append(ref_events.voxel_grid(t_ev[a:b], p_ev[a:b],
                                                 pix[a:b], bins, self.h,
                                                 self.w))
            clipped, sound = recon.step(torch.stack(vox))
            yield (ref_frames.to_u8(clipped).cpu().numpy(),
                   [j for j in range(self.n) if sound[j]])

    def check(self, mode="float32"):
        tally = Tally()
        for k, (ref, sound) in enumerate(self.reference_frames(mode)):
            got = [self.frames[j][k] for j in range(self.n)]
            have = [j for j in range(self.n) if got[j] is not None
                    and got[j].shape == ref[j].shape
                    and got[j].dtype == np.uint8]
            tally.missing += self.n - len(have)
            tally.ill += self.n - len(sound)
            held = [j for j in have if j in sound]
            if held:
                tally.frames(np.stack([got[j] for j in held]), ref[held],
                             [(j, k) for j in held])
        return tally.values()

    def control(self, mode, seconds):
        """The reference in ``mode`` in the program's place, against the
        reference in float32, over as many pushes as a run of ``seconds``
        makes."""
        self.count = max(1, int(seconds / self.period))
        tally = Tally()
        for k, ((ref, sound), (got, _)) in enumerate(zip(
                self.reference_frames("float32"),
                self.reference_frames(mode))):
            tally.ill += self.n - len(sound)
            if sound:
                tally.frames(got[sound], ref[sound], [(j, k) for j in sound])
        return tally.values()
