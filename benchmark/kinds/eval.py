"""The ``eval`` kind: EVREAL's ``evaluate`` as a user runs it, pass after
pass.

Set-up writes the mix's sequences (``lib/scene.py``) as a dataset in the
npy-memmap layout, the cell's ``config/{method,dataset,eval}`` files, the
method's ``.pth`` and LPIPS's ``.npz`` into the run's working directory,
then runs one whole pass, which builds and warms every shape the passes
use. The window runs ``evreal_tpu_torch.harness.runner.evaluate`` back to
back until ``--seconds`` have passed; each pass's ``outputs/`` is moved
aside when it ends. The rate, under the name the mix's ``rate_metric``
gives (``eval_fps``, ``sweep_fps``), is the windows of those passes,
counted from the mix's own windows, over the seconds from the first
pass's start to the last pass's end. A traced run adds one pass under the profiler.

The check replays every sequence through the plain reference and
compares, on one pass drawn from the seed and on the last, every frame
the eval wrote and every score row; every pass must have finished every
sequence."""

import contextlib
import json
import os
import random
import time

import numpy as np
import torch

from benchmark.lib import scene
from benchmark.lib.check import Tally, decode_png_gray8, read_rows
from benchmark.lib.weights import (draw, lpips_weights, save_lpips,
                                   save_pth)
from benchmark.reference import events as ref_events
from benchmark.reference import frames as ref_frames
from benchmark.reference.models import param_shapes
from benchmark.reference.pipeline import Recon, precision


def cpu_seconds():
    """CPU seconds of this process, all its threads, so far."""
    t = os.times()
    return t.user + t.system


def sizes(mix, rehearse):
    """(height, width, [(name, windows, events a window)], voxel method)
    of the mix, cut to the rehearsal's tiny size with ``rehearse``."""
    vm = dict(mix["eval_config"]["dataset_kwargs"]["voxel_method"])
    if not rehearse:
        return (mix["height"], mix["width"],
                [(s["name"], s["windows"], s["events_per_interval"])
                 for s in mix["sequences"]], vm)
    r = mix["rehearsal"]
    if "k" in r:
        vm["k"] = r["k"]
    return (r["height"], r["width"],
            [(s["name"], max(2, round(s["windows"] * r["window_scale"])),
              max(16, round(s["events_per_interval"] * r["event_scale"])))
             for s in mix["sequences"]], vm)


class Run:
    def __init__(self, run):
        self.r = run
        self.mix, self.config = run.mix, run.config
        self.h, self.w, self.seq_sizes, self.voxel_method = sizes(
            self.mix, run.rehearse)
        self.eval_config = dict(self.mix["eval_config"])
        self.eval_config["dataset_kwargs"] = dict(
            self.eval_config["dataset_kwargs"],
            voxel_method=self.voxel_method)
        self.passes = []          # (start, end) host seconds
        self.cpu = []             # this process's CPU seconds a pass
        self.timings = None
        self.trace_pass = None

    # -- set-up ---------------------------------------------------------

    def setup(self):
        self.inputs()
        os.chdir(self.r.workdir)
        from evreal_tpu_torch.harness.runner import evaluate
        from evreal_tpu_torch.harness.timers import TimingLog

        self.evaluate, self.TimingLog = evaluate, TimingLog
        self.r.mark("data, weights and files")
        self.run_pass("warm")
        self.check_not_constant("warm")
        self.r.mark("warm pass")

    def inputs(self):
        """The sequences, weights and config files, from the seed."""
        r, mix = self.r, self.mix
        dev = r.device
        data_dir = os.path.join(r.workdir, "data", mix["dataset"])
        self.seqs, seq_cfg, self.data_bytes = {}, {}, 0
        for i, (name, windows, per) in enumerate(self.seq_sizes):
            seq = scene.make_scene(mix["scene"], windows, per, mix["fps"],
                                   self.h, self.w, dev, r.seed, i)
            self.data_bytes += scene.write_sequence(
                os.path.join(data_dir, name), seq)
            self.seqs[name] = seq
            seq_cfg[name] = {"start_time_s": 0.0,
                             "end_time_s": windows / mix["fps"]}
        self.windows = {n: ref_events.windows(s, self.voxel_method)
                        for n, s in self.seqs.items()}
        self.per_pass = sum(len(w) for w in self.windows.values())
        r.write_config("dataset", mix["dataset"],
                       {"root_path": data_dir, "sequences": seq_cfg})
        r.write_config("eval", mix["eval_name"], self.eval_config)
        self.state_dict = draw(param_shapes(self.config),
                               self.config["init"], dev, r.seed)
        pth = os.path.join(r.workdir, "model.pth")
        save_pth(pth, self.config, self.state_dict)
        r.write_config("method", self.config["method"],
                       dict(self.config["method_config"], model_path=pth))
        self.lpips = lpips_weights(dev, r.seed)
        lpips_path = os.path.join(r.workdir, "lpips_alex.npz")
        save_lpips(lpips_path, self.lpips)
        os.environ["EVREAL_LPIPS_WEIGHTS"] = lpips_path

    def run_pass(self, label, timings=None):
        """One ``evaluate`` call; its ``outputs/`` becomes
        ``passes/<label>``."""
        with open("evaluate.log", "a", encoding="utf-8") as log, \
                contextlib.redirect_stdout(log):
            self.evaluate(method_names=[self.config["method"]],
                          eval_config_names=[self.mix["eval_name"]],
                          dataset_names=[self.mix["dataset"]],
                          metrics=self.mix["metrics"], device=self.r.device,
                          timings=timings)
        os.makedirs("passes", exist_ok=True)
        os.rename("outputs", os.path.join("passes", str(label)))

    def out_dir(self, label, name):
        return os.path.join("passes", str(label), self.mix["eval_name"],
                            self.mix["dataset"], name, self.config["method"])

    def check_not_constant(self, label):
        """A pass whose frames (or, without frames, scores) are all one
        value measures nothing: stop the run."""
        values = set()
        for name, wins in self.windows.items():
            d = self.out_dir(label, name)
            if self.eval_config["save_images"]:
                for i in range(0, len(wins), max(1, len(wins) // 4)):
                    path = os.path.join(d, f"frame_{i:010d}.png")
                    if os.path.exists(path):
                        with open(path, "rb") as f:
                            values.update(np.unique(decode_png_gray8(
                                f.read())).tolist())
            else:
                rows = read_rows(os.path.join(d, "mse.txt")) or {}
                values.update(rows.values())
        if len(values) < 2:
            raise RuntimeError(f"the {label} pass's frames are constant "
                               f"({sorted(values)}): nothing to measure")

    # -- the window -----------------------------------------------------

    def window(self, seconds, traced=None):
        """Passes back to back until ``seconds`` have passed; then, with
        ``traced`` (a context manager factory), one more under it."""
        self.timings = self.TimingLog()
        first = time.perf_counter()
        while True:
            t0, c0 = time.perf_counter(), cpu_seconds()
            self.run_pass(len(self.passes), self.timings)
            self.passes.append((t0, time.perf_counter()))
            self.cpu.append(cpu_seconds() - c0)
            if self.passes[-1][1] - first >= seconds:
                break
        wall = self.passes[-1][1] - first
        if traced is not None:
            with traced():
                self.run_pass("traced")
            self.trace_pass = "traced"
        self.r.note(f"window: {len(self.passes)} passes of {self.per_pass} "
                    f"windows in {wall:.3f} s; pass s "
                    + " ".join(f"{b - a:.3f}" for a, b in self.passes))
        # the same work every pass: a pass that takes more CPU seconds
        # ran on a slower host
        self.r.note("cpu s a pass " + " ".join(f"{c:.2f}" for c in self.cpu))
        return {self.mix["rate_metric"]:
                len(self.passes) * self.per_pass / wall}

    def attempted(self):
        return (len(self.passes) + bool(self.trace_pass)) * self.per_pass

    def layer_counts(self):
        """What the per-layer readers need of the traced pass: its real
        windows, their events, the bytes of their grids."""
        bins = self.eval_config["dataset_kwargs"]["num_bins"]
        wins = [w for ws in self.windows.values() for w in ws]
        return {"windows": len(wins),
                "events": sum(b - a for a, b, _, _ in wins),
                "grid_bytes": len(wins) * bins * self.h * self.w * 4,
                "timings": self.timings, "method": self.config["method"]}

    def free(self):
        self.evaluate = None

    # -- the check ------------------------------------------------------

    def check(self, mode="float32"):
        """The compared numbers (``lib/check.py``) of the passes drawn for
        the check against the reference in ``mode``."""
        tally = Tally()
        labels = [str(i) for i in range(len(self.passes))]
        if self.trace_pass:
            labels.append(self.trace_pass)
        expected = {n: self.expected_rows(n) for n in self.windows}
        self.failed = 0
        for label in labels:  # every pass finished every sequence
            for name, rows in expected.items():
                done = os.path.join(self.out_dir(label, name), "done.json")
                try:
                    with open(done, encoding="utf-8") as f:
                        ok = json.load(f)["num_evaluated"] == len(rows)
                except (OSError, ValueError, KeyError):
                    ok = False
                if not ok:
                    self.failed += len(self.windows[name])
        tally.missing += self.failed
        rng = random.Random(self.r.seed)
        compared = sorted({rng.choice(labels[:len(self.passes)]),
                           labels[-1]})
        self.replay(tally, compared, expected, mode)
        return tally.values()

    def expected_rows(self, name):
        """Indices of the windows the tracker scores: inside the sequence's
        cut and within ``ts_tol_ms`` of their reference frame."""
        frame_ts = self.seqs[name]["images_ts"].reshape(-1)
        end = dict((n, w) for n, w, _ in self.seq_sizes)[name] / self.mix[
            "fps"]
        tol = self.eval_config["ts_tol_ms"]
        return [i for i, (_, _, ts, f) in enumerate(self.windows[name])
                if 0.0 <= ts <= end and abs(frame_ts[f] - ts) * 1000 <= tol]

    def reference_steps(self, mode):
        """The reference over every sequence, the lanes in lockstep: for
        each window index t, (t, live lanes, their well-conditioned ones
        (``pipeline.STRETCH_MIN``), (lanes, H, W) uint8 frames, {lane:
        {metric: score}} of the well-conditioned lanes whose window t is
        scored)."""
        dev = self.r.device
        names = list(self.windows)
        bins = self.eval_config["dataset_kwargs"]["num_bins"]
        recon = Recon(self.config, self.state_dict, self.h, self.w,
                      len(names), dev, mode)
        evs = [ref_events.device_events(self.seqs[n], dev) for n in names]
        refs = {n: torch.as_tensor(self.seqs[n]["images"], device=dev)
                for n in names}
        want = {n: set(self.expected_rows(n)) for n in names}
        zero = torch.zeros((bins, self.h, self.w), device=dev)
        for t in range(max(len(w) for w in self.windows.values())):
            vox = []
            for (t_ev, p_ev, pix), n in zip(evs, names):
                if t < len(self.windows[n]):
                    a, b, _, _ = self.windows[n][t]
                    vox.append(ref_events.voxel_grid(
                        t_ev[a:b], p_ev[a:b], pix[a:b], bins, self.h,
                        self.w))
                else:
                    vox.append(zero)
            clipped, sound = recon.step(torch.stack(vox))
            live = [j for j, n in enumerate(names)
                    if t < len(self.windows[n])]
            scored = [j for j in live if t in want[names[j]] and sound[j]]
            scores = {}
            if scored:
                frames_ref = torch.stack([
                    refs[names[j]][self.windows[names[j]][t][3]]
                    for j in scored]).float() / 255.0
                img = clipped[scored]
                with precision(mode, dev):
                    got = {"mse": ref_frames.mse(img, frames_ref),
                           "ssim": ref_frames.ssim(img, frames_ref),
                           "lpips": ref_frames.lpips(self.lpips, img,
                                                     frames_ref)}
                got = {m: got[m].tolist() for m in self.mix["metrics"]}
                scores = {j: {m: got[m][i] for m in got}
                          for i, j in enumerate(scored)}
            yield (t, live, [j for j in live if sound[j]],
                   ref_frames.to_u8(clipped).cpu().numpy(), scores)

    def replay(self, tally, labels, expected, mode):
        """Compare each window's frame and scores in the passes ``labels``
        with the reference's."""
        names = list(self.windows)
        rows = {(label, n, m): read_rows(os.path.join(
                    self.out_dir(label, n), m + ".txt"))
                for label in labels for n in names
                for m in self.mix["metrics"]}
        for (label, n, m), got in rows.items():
            if got is None:
                tally.missing += len(expected[n])
            elif set(got) != set(expected[n]):
                tally.missing += len(set(got) ^ set(expected[n]))
        for t, live, sound, u8, scores in self.reference_steps(mode):
            tally.ill += (len(live) - len(sound)) * len(labels)
            for label in labels:
                if self.eval_config["save_images"]:
                    got, lanes = self.read_frames(label, names, live, t)
                    tally.missing += len(live) - len(got)
                    held = [i for i, j in enumerate(lanes) if j in sound]
                    if held:
                        tally.frames(np.stack([got[i] for i in held]),
                                     u8[[lanes[i] for i in held]],
                                     [(label, names[lanes[i]], t)
                                      for i in held])
                for j, by_metric in scores.items():
                    for m, v in by_metric.items():
                        got = rows[(label, names[j], m)]
                        if got is not None and t in got:
                            tally.score(m, got[t], v, (label, names[j], t))

    def control(self, mode, seconds):
        """The compared numbers of the reference in ``mode`` put in the
        program's place: its frames and its scores, written as the eval
        writes them (5 decimals), against the reference in float32."""
        tally = Tally()
        names_of = list(self.windows)
        for (t, live, sound, u8, scores), (*_, u8_c, scores_c) in zip(
                self.reference_steps("float32"), self.reference_steps(mode)):
            tally.ill += len(live) - len(sound)
            if self.eval_config["save_images"] and sound:
                tally.frames(u8_c[sound], u8[sound],
                             [(names_of[j], t) for j in sound])
            for j, by_metric in scores.items():
                for m, v in by_metric.items():
                    tally.score(m, round(scores_c[j][m], 5), v,
                                (names_of[j], t))
        return tally.values()

    def read_frames(self, label, names, live, t):
        """The written frames of window ``t`` of the ``live`` lanes that
        have one: (frames, their lane indices)."""
        got, lanes = [], []
        for j in live:
            path = os.path.join(self.out_dir(label, names[j]),
                                f"frame_{t:010d}.png")
            try:
                with open(path, "rb") as f:
                    got.append(decode_png_gray8(f.read()))
                lanes.append(j)
            except (OSError, ValueError):
                continue
        return got, lanes
