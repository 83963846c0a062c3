"""Evaluation loop of the single-sequence grayscale path
(``evreal_tpu/harness/runner.py:551-627`` and ``:787-1076``; reference
eval.py:189-455).

Per chunk of ``chunk_t`` windows:

    packed (T, E) event buffers -> device -> ONE voxelize_windows launch
    -> per window: input norm, pad, model step -> crop -> post-norm ->
    clip -> u8 quantization and batched MSE/SSIM on the device

then the quantized frames and scores come back to the host, where the
tracker writes the output tree. Chunk k's results are copied back
asynchronously and written while chunk k + 1 runs on the device.

Out of scope so far (ROADMAP.md, Queue 1): color, hist-eq, resume,
staging, the lockstep batched runner, bf16 serving, the compact wires.
"""

import glob
import os
import traceback
from collections import OrderedDict

import numpy as np
import torch

from evreal_tpu_torch.convert.params import from_jax_tree, load_params
from evreal_tpu_torch.data import Sequence, pack_windows, plan_capacity
from evreal_tpu_torch.data.packing import (
    alloc_buffers,
    outlier_buffers,
    wire_dtypes,
)
from evreal_tpu_torch.harness.config import (
    get_dataset_configs,
    get_eval_configs,
    get_method_config,
    REPO_ROOT,
)
from evreal_tpu_torch.harness.tables import (
    color_error,
    color_progress,
    print_scores,
)
from evreal_tpu_torch.harness.timers import DeviceTimer, TimingLog
from evreal_tpu_torch.metrics import functional as metric_fns
from evreal_tpu_torch.metrics.tracker import EvalMetricsTracker, MetricTracker
from evreal_tpu_torch.models import build_from_meta
from evreal_tpu_torch.ops.normalize import (
    normalize_event_tensor,
    post_process_normalization,
)
from evreal_tpu_torch.ops.pad import CropParams
from evreal_tpu_torch.ops.voxelize import voxelize_windows
from evreal_tpu_torch.utils import f32_parity, resolve_device

DEFAULT_CHUNK_T = 32
PIPELINE_DEPTH = 2  # chunks in flight before the host drains the oldest
DEFAULT_METRICS = ["mse", "ssim"]

# uint8 reference frames -> f32 by a table of host-computed (IEEE) x / 255,
# the values Sequence.frame produces: a device divide by 255 may become a
# reciprocal multiply, 1 ulp off for some values
_U8_LUT = np.arange(256, dtype=np.float32) / np.float32(255.0)


class MethodRunner:
    """Chunked eval pipeline for one (model, sensor resolution) on one
    device."""

    def __init__(self, model, *, event_norm, post_norm, height, width,
                 num_bins, device, chunk_t=DEFAULT_CHUNK_T):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.event_norm = event_norm
        self.post_norm = post_norm
        self.h, self.w = height, width
        self.num_bins = num_bins
        self.chunk_t = chunk_t
        self.crop = CropParams(width, height, model.num_encoders)
        self.u8_lut = torch.from_numpy(_U8_LUT).to(self.device)

    def init_state(self):
        ph, pw = self.crop.padded_shape
        return self.model.init_state(1, ph, pw, device=self.device)

    def upload(self, arrays):
        """Numpy arrays -> device tensors (pinned, non-blocking on CUDA;
        the pinned staging copy frees the numpy buffers for reuse)."""
        out = {}
        for k, v in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def voxelize(self, bufs):
        """Device event buffers -> (T, num_bins, H, W) voxel grids."""
        return voxelize_windows(bufs["xs"], bufs["ys"], bufs["ts"],
                                bufs["ps"], bufs["count"], self.num_bins,
                                (self.h, self.w))

    @torch.no_grad()
    def reconstruct(self, state, vox):
        """Run the model over the windows of ``vox`` (n, B, H, W) in order.
        Returns (state, images (n, H, W) cropped, before post-norm)."""
        with f32_parity():
            if self.event_norm:
                vox = normalize_event_tensor(vox)
            vox = self.crop.pad(vox)
            imgs = []
            for i in range(vox.shape[0]):
                out, state = self.model(vox[i:i + 1], state)
                imgs.append(out["image"])
            return state, self.crop.crop(torch.cat(imgs))[:, 0]

    @torch.no_grad()
    def run(self, state, bufs, valid_t):
        """One chunk: voxelize all of ``bufs`` in one launch, reconstruct
        its first ``valid_t`` windows. Returns (state, images, clipped)."""
        vox = self.voxelize(bufs)
        state, imgs = self.reconstruct(state, vox[:valid_t])
        imgs = post_process_normalization(imgs, self.post_norm)
        return state, imgs, imgs.clamp(0.0, 1.0)

    @staticmethod
    def quantize_u8(clipped):
        """``round(clip(img) * 255)`` as uint8 (round half to even, like
        the JAX package's device quantization)."""
        return torch.round(clipped * 255).to(torch.uint8)

    @torch.no_grad()
    def metric_scores(self, specs, clipped, refs):
        """{name: (T,) scores} of ``clipped`` against ``refs`` (T, H, W)."""
        if refs.dtype == torch.uint8:
            refs = self.u8_lut[refs.to(torch.int64)]
        with f32_parity():
            return {name: fn(clipped, refs) for name, fn in specs}


# ---------------------------------------------------------------------------
# model loading
# ---------------------------------------------------------------------------

def load_method_params(method_config):
    """A method's converted ``.npz`` (JAX layout) and its sidecar ->
    (nested numpy tree, meta). A relative ``model_path`` resolves against
    the working directory, then the repository root; ``.pth`` paths map to
    the ``.npz`` beside them. Converting a torch ``.pth`` is not ported:
    the JAX package's converter (``evreal_tpu.convert``) writes the
    ``.npz``."""
    path = method_config["model_path"]
    if not os.path.isabs(path) and not os.path.exists(path):
        candidate = os.path.join(REPO_ROOT, path)
        if os.path.exists(os.path.splitext(candidate)[0] + ".npz"):
            path = candidate
    path = os.path.splitext(path)[0] + ".npz"
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} does not exist; the port reads converted checkpoints "
            f"(.npz + .npz.json) only")
    return load_params(path)


class MethodBundle:
    """A method's model with its weights, and its runners per sensor
    resolution."""

    def __init__(self, method_name, method_config, device):
        self.method_name = method_name
        self.device = torch.device(device)
        tree, meta = load_method_params(method_config)
        self.model = build_from_meta(meta)
        self.model.load_state_dict(from_jax_tree(tree), strict=True)
        self.model.to(self.device).eval()
        self._runners = {}

    def runner_for(self, sensor_resolution, method_config, num_bins):
        key = tuple(sensor_resolution)
        if key not in self._runners:
            h, w = sensor_resolution
            self._runners[key] = MethodRunner(
                self.model,
                event_norm=method_config.get("event_tensor_normalization",
                                             False),
                post_norm=method_config.get("post_process_norm", "none"),
                height=h, width=w, num_bins=num_bins, device=self.device)
        return self._runners[key]


# ---------------------------------------------------------------------------
# sequence / dataset assembly (reference eval.py:38-106)
# ---------------------------------------------------------------------------

def get_sequences(dataset_config, dataset_kwargs, seed=0):
    dataset_root = dataset_config["root_path"]
    has_subfolders = dataset_config.get("has_subfolders", False)
    dataset_kwargs = dict(dataset_kwargs)
    dataset_kwargs.update(dataset_config.get("dataset_kwargs", {}))
    if dataset_config.get("get_all_sequences", False):
        pattern = os.path.join(dataset_root, "*", "*") if has_subfolders \
            else os.path.join(dataset_root, "*")
        seq_cfg = OrderedDict()
        for path in sorted(glob.glob(pattern)):
            if not os.path.isdir(path):
                continue
            name = (os.path.basename(os.path.dirname(path)) + "_" +
                    os.path.basename(path)) if has_subfolders \
                else os.path.basename(path)
            seq_cfg[name] = {"sequence_path": path}
    else:
        seq_cfg = dataset_config.get("sequences", {})

    sequences = []
    for name, seq in seq_cfg.items():
        seq = dict(seq)
        seq_path = seq.get("sequence_path", os.path.join(dataset_root, name))
        seq["name"] = name
        seq["dataset"] = Sequence(seq_path, seed=seed, **dataset_kwargs)
        min_t, max_t = seq["dataset"].get_min_max_t()
        seq.setdefault("start_time_s", min_t)
        seq.setdefault("end_time_s", max_t)
        sequences.append(seq)
    return sequences


def get_datasets(dataset_configs, dataset_kwargs):
    return [{"name": c["name"],
             "sequences": get_sequences(c, dataset_kwargs)}
            for c in dataset_configs]


# ---------------------------------------------------------------------------
# per-sequence eval (reference eval.py:189-246)
# ---------------------------------------------------------------------------

def sequence_output_dir(eval_config, dataset_name, seq_name, method_name):
    """outputs/<eval_cfg>/<dataset>/<sequence>/<method> (reference
    eval.py:168)."""
    return os.path.join("outputs", eval_config["name"], dataset_name,
                        seq_name, method_name)


def gate_windows(metas, start, end, eval_infer_all):
    """Window indices to process (reference eval.py:212-216: skip while
    voxel_ts < start - 10 s, stop past end; eval_infer_all disables the
    cut)."""
    proc = []
    for i, m in enumerate(metas):
        ts = m["voxel_timestamp"]
        if not eval_infer_all:
            if ts < start - 10:
                continue
            if ts > end:
                break
        proc.append(i)
    return proc


def run_settings(eval_config, sequence):
    """The output-affecting settings recorded in done.json."""
    return {"save_images": eval_config.get("save_images", True),
            "histeq": eval_config.get("histeq", "none"),
            "create_video": eval_config.get("create_video", False),
            "eval_infer_all": eval_config.get("eval_infer_all", False),
            "color": eval_config.get("color", False),
            "ts_tol_ms": eval_config.get("ts_tol_ms", float("inf")),
            "start_time_s": sequence.get("start_time_s"),
            "end_time_s": sequence.get("end_time_s")}


def _usable_metrics(specs, hw, device):
    """Drop, with a message, metrics that cannot score this image shape
    (SSIM below its 11-px window): the reference's per-metric
    containment."""
    probe = torch.zeros((1,) + tuple(hw), device=device)
    out = []
    for name, fn in specs:
        try:
            fn(probe, probe)
        except ValueError as exc:
            print(color_error(f"metric {name} failed at {tuple(hw)}: {exc}; "
                              f"skipping"))
            continue
        out.append((name, fn))
    return out


def _to_host(tensors):
    """Start device->host copies of a dict of tensors; returns the host
    dict and an event to wait on (None on the CPU)."""
    if not tensors or next(iter(tensors.values())).device.type != "cuda":
        return tensors, None
    host = {}
    for k, v in tensors.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def eval_method_on_sequence(dataset_name, eval_config, method_name, bundle,
                            method_config, sequence, metrics, timings=None):
    if (eval_config.get("color", False) or eval_config.get("create_video")
            or eval_config.get("histeq", "none") != "none"):
        raise NotImplementedError("color, hist-eq and video eval configs "
                                  "are not ported yet (ROADMAP.md, Queue 1)")
    seq = sequence["dataset"]
    output_dir = sequence_output_dir(eval_config, dataset_name,
                                     sequence["name"], method_name)
    runner = bundle.runner_for(seq.sensor_resolution, method_config,
                               seq.num_bins)
    device = runner.device
    specs = _usable_metrics(metric_fns.resolve(metrics),
                            seq.sensor_resolution, device)
    tracker = EvalMetricsTracker(
        output_dir, metrics,
        save_images=eval_config.get("save_images", True),
        quan_eval_start_time=sequence["start_time_s"],
        quan_eval_end_time=sequence["end_time_s"],
        quan_eval_ts_tol_ms=eval_config["ts_tol_ms"],
        has_reference_frames=seq.has_images,
        run_settings=run_settings(eval_config, sequence))

    metas_all = seq.windows()
    proc = gate_windows(metas_all, sequence["start_time_s"],
                        sequence["end_time_s"],
                        eval_config.get("eval_infer_all", False))
    chunk_t = runner.chunk_t
    capacity = plan_capacity(metas_all[i]["event_count"] for i in proc)
    dtypes = wire_dtypes("f32", np.issubdtype(seq.xy.dtype, np.integer),
                         seq.sensor_resolution)
    pool = alloc_buffers((chunk_t,), capacity, dtypes)
    use = specs if seq.has_images else []

    def stack_refs(metas):
        u8 = [seq.frame_u8(m["frame_index"]) for m in metas]
        if all(r is not None for r in u8):
            return np.stack(u8)
        return np.stack([seq.frame(m["frame_index"]) for m in metas])

    def dispatch(state, c0):
        chunk = proc[c0:c0 + chunk_t]
        valid_t = len(chunk)
        metas = [metas_all[i] for i in chunk]
        chunk_max = max(m["event_count"] for m in metas)
        if chunk_max <= capacity:
            bufs, zeroed = pool, False
        else:  # outlier chunk (rare by plan_capacity): one-off buffers
            _, bufs = outlier_buffers((chunk_t,), chunk_max, dtypes)
            zeroed = True
        cap_c = bufs["xs"].shape[1]
        pack_windows(seq, chunk, capacity=cap_c,
                     out={k: v[:valid_t] for k, v in bufs.items()},
                     out_zeroed=zeroed, metas=metas)
        bufs["count"][valid_t:] = 0  # ragged last chunk: empty windows
        state, _, clipped = runner.run(state, runner.upload(bufs), valid_t)
        out = {}
        if tracker.save_images:
            out["images"] = runner.quantize_u8(clipped)
        if use:
            refs = runner.upload({"refs": stack_refs(metas)})["refs"]
            out.update(runner.metric_scores(use, clipped, refs))
        host, event = _to_host(out)
        return state, (chunk, metas, host, event)

    def drain(entry):
        chunk, metas, host, event = entry
        if event is not None:
            event.synchronize()
        host = {k: v.numpy() for k, v in host.items()}
        images = host.pop("images", None)
        for j, (i, meta) in enumerate(zip(chunk, metas)):
            tracker.update(
                i, images[j] if images is not None else None,
                meta["voxel_timestamp"],
                meta["frame_timestamp"] if seq.has_images else None,
                scores={k: v[j] for k, v in host.items()})
            rate = (0 if meta["event_count"] <= 1 or meta["dt"] == 0
                    else meta["event_count"] / meta["dt"])
            tracker.save_custom_metric(i, "event_rate", rate)

    timings = timings if timings is not None else TimingLog()
    state = runner.init_state()
    pending = []
    with DeviceTimer(timings, method_name, len(proc), device) as timer:
        for ci, c0 in enumerate(range(0, len(proc), chunk_t)):
            state, entry = dispatch(state, c0)
            pending.append(entry)
            if ci == 0 and len(proc) > chunk_t:
                # the first chunk bears the kernel build and cuDNN's
                # algorithm search: time the steady state after it
                drain(pending.pop(0))
                timer.exclude_warmup(len(entry[0]))
            if len(pending) >= PIPELINE_DEPTH:
                drain(pending.pop(0))
        for entry in pending:
            drain(entry)
    tracker.finalize()
    return tracker.get_num_quan_evaluations(), tracker.get_mean_scores()


# ---------------------------------------------------------------------------
# top-level loops (reference eval.py:333-455)
# ---------------------------------------------------------------------------

def accumulate_mean_scores(dataset_metrics, results):
    """Fold per-sequence ``(num_evaluated, mean_scores)`` into the dataset
    tracker, skipping the -1 no-result sentinel."""
    for num_eval, mean_scores in results:
        for metric_name, score in mean_scores.items():
            if score == -1:
                continue
            dataset_metrics.update(metric_name, score, num_eval)


def eval_method_with_config(eval_config, method_name, datasets, metrics,
                            device, timings):
    num_sequences = sum(len(d["sequences"]) for d in datasets)
    method_config = get_method_config(method_name)
    print(color_progress("Starting method " + method_name))
    method_metrics = []
    try:
        bundle = MethodBundle(method_name, method_config, device)
    except Exception as e:  # noqa: BLE001 — containment, reference eval.py:344-352
        print(color_error(f"Exception while getting method {method_name}"))
        print(color_error(str(e)))
        print(color_error(traceback.format_exc()))
        return method_metrics

    seq_no = 1
    for dataset in datasets:
        dataset_metrics = MetricTracker()
        try:
            for sequence in dataset["sequences"]:
                print(color_progress(
                    f"Evaluating {method_name} method with "
                    f"{eval_config['name']} evaluation config on "
                    f"{sequence['name']} sequence from {dataset['name']} "
                    f"dataset. ({seq_no}/{num_sequences} for this method "
                    f"and config)"))
                seq_no += 1
                result = eval_method_on_sequence(
                    dataset["name"], eval_config, method_name, bundle,
                    method_config, sequence, metrics, timings)
                accumulate_mean_scores(dataset_metrics, [result])
        except Exception as e:  # noqa: BLE001 — containment, eval.py:369-375
            print(color_error(f"Exception while evaluating method "
                              f"{method_name} on {dataset['name']} dataset:"))
            print(color_error(str(e)))
            print(color_error(traceback.format_exc()))
        finally:
            method_metrics.append(dataset_metrics)
    return method_metrics


def evaluate(method_names, eval_config_names=None, dataset_names=None,
             metrics=None, device=None, timings=None):
    """The reference ``evaluate`` (eval.py:413-444) on ``device`` (CUDA
    unless the caller asks for another; raises without a card). Steady
    ms/frame samples go to ``timings`` (a ``TimingLog``) when given.
    Returns {eval config name: per-method lists of dataset trackers}."""
    device = resolve_device(device)
    eval_config_names = eval_config_names or ["std"]
    dataset_names = dataset_names or ["ECD", "MVSEC", "HQF"]
    metrics = metrics or DEFAULT_METRICS
    metric_fns.resolve(metrics)  # an unknown or unported name fails here
    timings = timings if timings is not None else TimingLog()
    dataset_configs = get_dataset_configs(dataset_names)
    results = {}
    for eval_config in get_eval_configs(eval_config_names):
        datasets = get_datasets(dataset_configs,
                                eval_config.get("dataset_kwargs", {}))
        info = (f"evaluating {', '.join(method_names)} on "
                f"{', '.join(dataset_names)} with {eval_config['name']} "
                f"evaluation config")
        print(color_progress("Started " + info))
        config_all_metrics = [
            eval_method_with_config(eval_config, m, datasets, metrics,
                                    device, timings)
            for m in method_names]
        print(color_progress("Finished " + info))
        print_scores(config_all_metrics, method_names,
                     [d["name"] for d in datasets], eval_config["name"])
        results[eval_config["name"]] = config_all_metrics
    return results
