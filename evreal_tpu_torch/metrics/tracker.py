"""Score tracking and per-sequence outputs (``evreal_tpu/metrics/tracker.py``;
reference utils/eval_metrics.py:162-350 and eval.py:249-276).

``EvalMetricsTracker`` writes the reference's output tree — timestamps,
per-metric score rows, PNG frames, hist-eq'd copies under
``<dir>_processed`` — gates quantitative evaluation on the eval time window
and the image/reference timestamp tolerance (not when every metric is a
no-reference one; a sequence without reference frames keeps only those),
drops non-finite scores, and reports the ``-1`` no-result sentinel for a
metric with no scores or dropped at runtime (kept out of dataset means by
the caller). In color mode it saves frames and records
no scores (the metric files stay empty). Frames go to a background
``AsyncImageWriter``, started at the first saved frame. It writes the JAX
package's ``done.json`` completion record, which ``EVREAL_RESUME`` reads
back (``load_completed``), only once every frame is written, and makes
the folder's videos.
"""

import json
import math
import os
import shutil

from evreal_tpu_torch.harness.outputs import AsyncImageWriter, truncate
from evreal_tpu_torch.harness.video import create_vid_from_recon_folder


def resume_enabled():
    """``EVREAL_RESUME=1``: finished (config, dataset, sequence, method)
    output dirs, marked by the ``done.json`` that ``finalize`` writes, are
    skipped and their recorded scores reused."""
    return os.environ.get("EVREAL_RESUME", "0").lower() in ("1", "true",
                                                            "yes")


def resume_settings(eval_config):
    """The output-affecting eval-config subset recorded in ``done.json``: a
    rerun whose settings differ (say, save_images newly on) runs again."""
    return {"save_images": eval_config.get("save_images", True),
            "histeq": eval_config.get("histeq", "none"),
            "create_video": eval_config.get("create_video", False),
            "eval_infer_all": eval_config.get("eval_infer_all", False),
            "color": eval_config.get("color", False),
            "ts_tol_ms": eval_config.get("ts_tol_ms", float("inf"))}


def sequence_settings(settings, sequence):
    """``settings`` plus the sequence's quantitative-eval time window,
    which is as score-affecting as ts_tol_ms."""
    return {**settings,
            "start_time_s": sequence.get("start_time_s"),
            "end_time_s": sequence.get("end_time_s")}


def load_completed(output_dir, expected_metrics, settings=None):
    """(num_evaluated, mean_scores) of a finished run in ``output_dir``
    that covers ``expected_metrics`` under the same ``settings``, else
    None."""
    try:
        with open(os.path.join(output_dir, "done.json"),
                  encoding="utf-8") as f:
            data = json.load(f)
        if not set(expected_metrics) <= set(data["metrics"]):
            return None
        if settings is not None and data.get("settings") != settings:
            return None
        return int(data["num_evaluated"]), {
            m: float(data["mean_scores"][m]) for m in expected_metrics}
    except (OSError, ValueError, KeyError, TypeError):
        return None


class MetricTracker:
    """Count-weighted running means per key (reference eval.py:249-276)."""

    def __init__(self):
        self.data = {}

    def update(self, key, value, count=1):
        if count == 0:
            return
        d = self.data.setdefault(key, {"total": 0.0, "count": 0,
                                       "average": 0.0})
        d["total"] += value * count
        d["count"] += count
        d["average"] = d["total"] / d["count"]

    def get_average(self, key):
        return self.data.get(key, {"average": 0.0})["average"]

    def get_count(self, key):
        return self.data.get(key, {"count": 0})["count"]

    def keys(self):
        return self.data.keys()


class EvalMetricsTracker:
    def __init__(self, output_dir, metric_names, save_images=True,
                 quan_eval_start_time=0, quan_eval_end_time=float("inf"),
                 quan_eval_ts_tol_ms=float("inf"),
                 has_reference_frames=False, run_settings=None,
                 hist_eq="none", color=False, no_ref_metric_names=()):
        self.output_dir = output_dir
        self.save_images = save_images
        self.save_processed_images = save_images and hist_eq != "none"
        self.processed_output_dir = output_dir + "_processed"
        self.color = color
        self.start_time = quan_eval_start_time
        self.end_time = quan_eval_end_time
        self.ts_tol_ms = quan_eval_ts_tol_ms
        # no resolved name (an all-unknown -qm): the JAX tracker's file
        # list, mse ssim lpips, whose files stay empty
        self.metric_names = list(metric_names or ["mse", "ssim", "lpips"])
        if not has_reference_frames:  # only no-reference metrics can score
            self.metric_names = [m for m in self.metric_names
                                 if m in no_ref_metric_names]
        # no-reference metrics alone: no reference frame, no timestamp gate
        self.only_no_ref = all(m in no_ref_metric_names
                               for m in self.metric_names)
        self.run_settings = run_settings
        self.scores = {m: [] for m in self.metric_names}
        self.quan_eval_indices = []
        self._files = {}
        self._custom = set()
        self._image_writer = None
        # the frame writer's totals once ``finalize`` has joined it
        # (``AsyncImageWriter.totals``); none when no frame was saved
        self.writer_totals = {}
        os.makedirs(output_dir, exist_ok=True)
        if self.save_processed_images:
            os.makedirs(self.processed_output_dir, exist_ok=True)
        try:  # a fresh run invalidates any earlier completion record
            os.remove(self._path("done.json"))
        except FileNotFoundError:
            pass
        truncate(self._path("timestamps.txt"))
        for m in self.metric_names:
            truncate(self._path(m + ".txt"))

    def _path(self, name):
        return os.path.join(self.output_dir, name)

    def _append(self, name, line):
        f = self._files.get(name)
        if f is None:
            f = open(self._path(name), "a", buffering=1, encoding="utf-8")
            self._files[name] = f
        f.write(line)

    def update(self, idx, img_u8, img_ts, ref_ts=None, scores=None,
               processed_img=None):
        """Record one frame: ``img_u8`` the quantized frame (or None when
        images are not saved), ``scores`` {metric: value} for it,
        ``processed_img`` its hist-eq'd copy (f32 in [0, 1]) when the
        config equalizes."""
        if ref_ts is None:
            ref_ts = img_ts
        self._append("timestamps.txt", "{} {:.15f}\n".format(idx, img_ts))
        if img_u8 is not None and self.save_images:
            self._writer().submit(self.output_dir, img_u8, idx)
        if processed_img is not None and self.save_processed_images:
            self._writer().submit(self.processed_output_dir, processed_img,
                                  idx)
        inside_cut = self.start_time <= img_ts <= self.end_time
        tol_ok = (self.only_no_ref
                  or abs(ref_ts - img_ts) * 1000 <= self.ts_tol_ms)
        if inside_cut and tol_ok and not self.color and scores is not None:
            self.quan_eval_indices.append(idx)
            for name in self.metric_names:
                if name not in scores:
                    continue
                s = float(scores[name])
                if math.isfinite(s):
                    self.scores[name].append(s)
                    self._append(name + ".txt", "{} {:.5f}\n".format(idx, s))

    def save_custom_metric(self, idx, metric_name, metric_value):
        name = metric_name + ".txt"
        if metric_name not in self._custom:  # first row truncates the file
            truncate(self._path(name))
            self._custom.add(metric_name)
        self._append(name, "{} {:.5f}\n".format(idx, metric_value))

    def _writer(self):
        if self._image_writer is None:
            self._image_writer = AsyncImageWriter()
        return self._image_writer

    def _close_files(self):
        for f in self._files.values():
            f.close()
        self._files = {}

    def finalize(self, dropped=()):
        """Write the queued frames, close the text files and write the
        ``done.json`` record. A failed frame write raises here, after the
        text files are closed and before the record, so an
        ``EVREAL_RESUME`` rerun runs the sequence again.
        ``dropped``: metrics the runner dropped at runtime. They stay out
        of the record (an ``EVREAL_RESUME`` rerun scores them again) and
        their means report -1, as does a metric with no score despite
        evaluated frames (dropped by validation)."""
        writer, self._image_writer = self._image_writer, None
        try:
            if writer is not None:
                writer.close()
        finally:
            if writer is not None:
                self.writer_totals = writer.totals()
            self._close_files()
        self._dropped = set(dropped)
        complete = [m for m in self.metric_names if m not in self._dropped
                    and (self.scores[m] or not self.quan_eval_indices)]
        mean_scores = {k: v for k, v in self.get_mean_scores().items()
                       if k in complete}
        with open(self._path("done.json"), "w", encoding="utf-8") as f:
            json.dump({"num_evaluated": self.get_num_quan_evaluations(),
                       "mean_scores": mean_scores, "metrics": complete,
                       "settings": self.run_settings}, f)

    def abandon(self):
        """After an error in the eval loop: stop the frame writer without
        writing its queued frames, close the text files, write no
        ``done.json``."""
        writer, self._image_writer = self._image_writer, None
        try:
            if writer is not None:
                writer.abandon()
        finally:
            self._close_files()

    def get_num_quan_evaluations(self):
        return len(self.quan_eval_indices)

    def get_mean_scores(self):
        dropped = getattr(self, "_dropped", ())
        return {name: (sum(v) / len(v) if v and name not in dropped else -1)
                for name, v in self.scores.items()}

    def create_video(self):
        if self.save_images:
            create_vid_from_recon_folder(self.output_dir)
        else:
            print("Can not create video when save_images is False")

    def create_processed_video(self):
        if self.save_processed_images:
            shutil.copy2(self._path("timestamps.txt"),
                         self.processed_output_dir)
            create_vid_from_recon_folder(self.processed_output_dir)
        else:
            print("Can not create processed video when "
                  "save_processed_images is False")
