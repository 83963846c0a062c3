"""Evaluation (``evreal_tpu/harness/runner.py``; reference
eval.py:189-455): the runner of one (model, resolution), the pieces of the
eval loop, and the grouping that sends each dataset's sequences, in
same-resolution groups or one at a time, to the one eval loop
(``harness/batched.py:eval_method_on_sequence_group``; a single sequence
is a group of one lane, ``eval_method_on_sequence``).

Per chunk of ``chunk_t`` windows:

    packed (T, E) event buffers (the native packer) -> device -> ONE
    voxelize_windows launch -> input norm (f32) -> cast to the serving
    dtype -> pad -> per window: model step -> f32 -> crop -> post-norm ->
    clip -> u8 quantization and the chunk's metrics (always f32, TF32 off
    unless ``EVREAL_PRECISION`` says otherwise): full-reference ones against
    the reference frames, no-reference ones alone (a sequence without
    reference frames has only those), device metrics as one batch, MANIQA
    a frame at a time, host metrics (NIQE, BRISQUE, pyiqa) on one host
    copy of the frames

then the quantized frames and scores come back to the host, where the
tracker writes the output tree. Chunk k's results are copied back
asynchronously and written while chunk k + 1 runs on the device.

Color configs (``models/colornet.py:ColorRunner``, one sequence at a time):
one voxelizer launch per chunk in f32, the four Bayer channels as a
batch-4 state and the grayscale as batch 1, the uint8 merge and the
post-norm of the merged frames on the device; frames are saved and not
scored. Hist-eq configs (``harness/histeq.py``) bring the clipped frames
to the host, equalize them and the f32 references there, and score the
equalized pair on the device with the same metric functions.

Metrics come from ``metrics/registry.py``: names are resolved per sequence
(a gated metric without its file, or an unknown name, is skipped with the
JAX package's line), each is validated at the frame shape (dropped with
its message when it cannot score it), and one that raises while scoring
is dropped for the rest of the sequence or group (``MetricContainment``)
and left out of ``done.json``.

``EVREAL_RESUME=1`` skips sequences whose ``done.json`` records a finished
run under the same settings; ``create_video`` encodes each sequence's
frames with ffmpeg at the end (``harness/video.py``).

The JAX package's switches, with its parsing and errors:
``EVREAL_DTYPE`` (float32 | bfloat16 serving mode), ``EVREAL_WIRE``
(f32 | compact | compact4, checked once at the start of ``evaluate``),
``EVREAL_VOXEL_PRECISION`` (highest | default; "high" cannot be honored by
the voxelizer and raises), ``EVREAL_PRECISION`` (highest | high | default
for the f32 stages: ``utils.matmul_precision_ctx``, read at each stage),
``EVREAL_NATIVE`` ("0": pack with numpy, ``data/packing.py``),
``EVREAL_PROFILE`` (a trace directory, ``profile_ctx``), ``EVREAL_BATCHED``
(lockstep groups, on unless "0"), ``EVREAL_BATCH_N`` (group width cap) and
``EVREAL_CHUNK_T``; the last two are parsed at import, as there.

Every method config runs (``models/``, weights from a converted ``.npz``
or a reference ``.pth``). A lockstep group shards its lanes over the eval
mesh (``harness/batched.py:eval_mesh_for``, ``EVREAL_MESH``) when it
runs on ``cuda`` and more than one card is visible. The TPU-only levers (staging, S2D, UPFUSE, scan
unroll) have no counterpart.

A runner never moves the model it is given: it runs the model itself when
that already lies on its device in its dtype, else a copy
(``parallel.mesh.replica_on``); ``MethodBundle`` makes one such replica
per (device, dtype) and hands it to every runner there.
"""

import contextlib
import copy
import glob
import os
import traceback
from collections import OrderedDict

import numpy as np
import torch

from evreal_tpu_torch.convert.checkpoint import load_method_checkpoint
from evreal_tpu_torch.convert.params import from_jax_tree, load_params
from evreal_tpu_torch.data import Sequence
from evreal_tpu_torch.data.packing import wire_dtypes, wire_format
from evreal_tpu_torch.harness.config import (
    get_dataset_configs,
    get_eval_configs,
    get_method_config,
    REPO_ROOT,
)
from evreal_tpu_torch.harness.histeq import histogram_equalization
from evreal_tpu_torch.harness.tables import (
    color_error,
    color_progress,
    print_scores,
)
from evreal_tpu_torch.harness.timers import (
    BUNDLE,
    OPEN,
    PNG_DRAIN,
    STEP_COUNTS,
    TimingLog,
)
from evreal_tpu_torch.harness.video import require_ffmpeg
from evreal_tpu_torch.kernels.attention_cuda import counts as attention_counts
from evreal_tpu_torch.metrics.tracker import (
    EvalMetricsTracker,
    MetricTracker,
    load_completed,
    resume_enabled,
    resume_settings,
    sequence_settings,
)
from evreal_tpu_torch.models import build_from_meta
from evreal_tpu_torch.ops.normalize import (
    normalize_event_tensor,
    post_process_normalization,
)
from evreal_tpu_torch.ops.pad import CropParams
from evreal_tpu_torch.ops.voxelize import voxelize_windows
from evreal_tpu_torch.parallel.mesh import canonical_device, replica_on
from evreal_tpu_torch.utils import (
    U8_LUT,
    cudnn_benchmark,
    matmul_precision_ctx,
    resolve_device,
    upload,
)
from evreal_tpu_torch.utils.spans import span

# parsed at import, as in the JAX package (runner.py:46-50), so a malformed
# value fails at once rather than inside the per-dataset containment
DEFAULT_CHUNK_T = int(os.environ.get("EVREAL_CHUNK_T", "32"))
DEFAULT_BATCH_N = int(os.environ.get("EVREAL_BATCH_N", "0"))
PIPELINE_DEPTH = 2  # chunks in flight before the host drains the oldest
DEFAULT_METRICS = ["mse", "ssim", "lpips"]


# ---------------------------------------------------------------------------
# compute dtype and the voxel stage (evreal_tpu/harness/runner.py:78-267)
# ---------------------------------------------------------------------------

def compute_dtype():
    """Model compute dtype: ``EVREAL_DTYPE=bfloat16`` (or ``bf16``) is the
    bf16 serving mode; anything else is float32, for reference parity."""
    name = os.environ.get("EVREAL_DTYPE", "float32")
    return torch.bfloat16 if name in ("bfloat16", "bf16") else torch.float32


def voxel_precision_choice(dtype):
    """Binning precision of the voxelizer: the validated
    ``EVREAL_VOXEL_PRECISION`` override, else "default" (bf16 factors) for
    bf16 stages, else None (the voxelizer's own default, HIGHEST). A pin
    the voxelizer cannot honor (``voxelize_windows.supported_precisions``)
    is an operator error, not a silent no-op."""
    supported = voxelize_windows.supported_precisions
    choice = os.environ.get("EVREAL_VOXEL_PRECISION")
    if choice is not None:
        if choice not in ("highest", "high", "default"):
            raise ValueError(f"EVREAL_VOXEL_PRECISION={choice!r}: "
                             "expected highest|high|default")
        if choice not in supported:
            raise ValueError(
                f"EVREAL_VOXEL_PRECISION={choice!r}: the voxelizer cannot "
                f"honor it (supports: {', '.join(supported)})")
        return choice
    if dtype == torch.bfloat16:
        return "default"
    return None


def make_voxel_stage(num_bins, hw, event_norm, out_dtype=torch.float32):
    """Event-buffer dict -> ``(T, num_bins, H, W)`` voxel grids in
    ``out_dtype``: one ``voxelize_windows`` launch (binning in f32), the
    event norm in f32, then the cast to the serving dtype — after the norm
    and before the pad, as ``make_voxel_stage`` does in the JAX package."""
    precision = voxel_precision_choice(out_dtype)

    def stage(bufs):
        vox = voxelize_windows(bufs, num_bins, hw, precision=precision)
        if event_norm:
            vox = normalize_event_tensor(vox)
        return vox.to(out_dtype)

    return stage


def quantize_u8(clipped):
    """``round(clip(img) * 255)`` as uint8 (round half to even, like the
    JAX package's device quantization)."""
    return torch.round(clipped * 255).to(torch.uint8)


# the ``rollout_key`` of every rollout so far in this process: a rollout
# at a new one pays cuDNN's algorithm search, whose picks cuDNN keeps for
# the process (``conv.searches`` counts them)
ROLLOUT_KEYS = set()


def rollout_key(model, vox):
    """What sets the convolutions' shapes in the model steps over ``vox``
    (N, n, B, H, W): the model's class and parameter shapes, a step
    input's shape (N, B, H, W), dtype and device."""
    return (type(model).__name__,
            tuple(tuple(p.shape) for p in model.parameters()),
            (vox.shape[0],) + tuple(vox.shape[2:]), vox.dtype, vox.device)



class MethodRunner:
    """Chunked eval pipeline for one (model, sensor resolution) on one
    device, over ``lanes`` sequences at once (1 here; the lockstep
    ``BatchedRunner`` of ``harness/batched.py`` runs more)."""

    lanes = 1

    def __init__(self, model, *, event_norm, post_norm, height, width,
                 num_bins, device, chunk_t=None):
        self.device = torch.device(device)
        self.dtype = compute_dtype()
        self.model = replica_on(model, self.device, self.dtype).eval()
        self.post_norm = post_norm
        self.h, self.w = height, width
        self.num_bins = num_bins
        self.chunk_t = DEFAULT_CHUNK_T if chunk_t is None else chunk_t
        self.crop = CropParams(width, height, model.num_encoders)
        self.u8_lut = torch.from_numpy(U8_LUT).to(self.device)
        self.voxel_stage = make_voxel_stage(num_bins, (height, width),
                                            event_norm, self.dtype)

    def init_state(self):
        ph, pw = self.crop.padded_shape
        return self.model.init_state(self.lanes, ph, pw, device=self.device,
                                     dtype=self.dtype)

    def upload(self, arrays):
        return upload(arrays, self.device)

    def voxelize(self, bufs):
        """Device event buffers (any wire) -> ``(T, num_bins, H, W)`` input
        grids in the serving dtype (``make_voxel_stage``)."""
        return self.voxel_stage(bufs)

    @torch.no_grad()
    def rollout(self, state, vox):
        """Run the model over ``vox`` (N, n, B, H, W), window by window,
        all lanes in one step. Returns (state, images (N, n, H, W) in f32,
        cropped, before post-norm). cuDNN picks each convolution's
        algorithm by measurement (``cudnn_benchmark``), searching at the
        first step of a shape new to the process (``ROLLOUT_KEYS``)."""
        with matmul_precision_ctx(self.dtype), cudnn_benchmark():
            vox = self.crop.pad(vox)
            ROLLOUT_KEYS.add(rollout_key(self.model, vox))
            imgs = []
            for i in range(vox.shape[1]):
                out, state = self.model(vox[:, i], state)
                imgs.append(out["image"][:, 0])
            return state, self.crop.crop(torch.stack(imgs, 1).float())

    def reconstruct(self, state, vox):
        """One sequence: ``vox`` (n, B, H, W) -> (state, images (n, H, W))
        f32, cropped, before post-norm."""
        state, imgs = self.rollout(state, vox[None])
        return state, imgs[0]

    def post(self, imgs):
        """Post-norm of each image of ``imgs`` (..., H, W), then clip.
        Returns (images, clipped)."""
        flat = imgs.reshape((-1,) + tuple(imgs.shape[-2:]))
        imgs = post_process_normalization(flat, self.post_norm).view(
            imgs.shape)
        return imgs, imgs.clamp(0.0, 1.0)

    @torch.no_grad()
    def run(self, state, bufs, valid_t):
        """One chunk: voxelize all of ``bufs`` in one launch, reconstruct
        its first ``valid_t`` windows. Returns (state, images, clipped)."""
        vox = self.voxelize(bufs)
        state, imgs = self.reconstruct(state, vox[:valid_t])
        return (state,) + self.post(imgs)

    def cost_analysis(self, state, buffers):
        """(FLOPs, None) of one ``run`` call at the shapes of ``state`` and
        ``buffers`` (host arrays or tensors; ``count`` gives the lanes and
        windows): the model over every window and the post-norm, counted
        on ``meta`` copies (``utils.mfu.count_flops``), so the runner's
        state, weights and launch counters are untouched. The voxelizer is
        left out: a zero grid of its output's shape takes its place (the
        CUDA kernels are not ops the counter knows; the JAX count includes
        its jnp voxelizer, a small share). Bytes are None: torch has no
        counterpart of XLA's bytes-accessed estimate."""
        from evreal_tpu_torch.utils.mfu import count_flops

        lanes_t = tuple(buffers["count"].shape)
        vox = torch.empty((self.lanes, int(np.prod(lanes_t)) // self.lanes,
                           self.num_bins, self.h, self.w), dtype=self.dtype,
                          device="meta")

        def chunk(model, state, vox):
            probe = copy.copy(self)
            probe.model = model
            probe.post(probe.rollout(state, vox)[1])

        return count_flops(chunk, self.model, state, vox), None

    @torch.no_grad()
    def metric_scores(self, specs, clipped, refs=None, on_error=None,
                      probe=False):
        """{name: scores on the device, shaped like ``clipped``'s leading
        dims} of the frames ``clipped`` (..., H, W): full-reference specs
        against ``refs`` (the same shape, f32 or uint8), no-reference ones
        alone. In f32 under the f32 precision context
        (``matmul_precision_ctx``: TF32 off unless ``EVREAL_PRECISION``
        says otherwise) whatever the serving dtype, as the JAX package
        scores its metrics. Host specs share one host copy of the frames.
        A spec that raises, a malformed ``EVREAL_PRECISION`` included, is
        left out after ``on_error(spec, exc)`` when that is given; else the
        error propagates. ``probe``: a shape check (``usable_metrics``)
        scored outside the precision context, as the JAX package validates
        its metrics outside it."""
        lead, hw = clipped.shape[:-2], tuple(clipped.shape[-2:])
        frames = {"imgs": clipped.reshape((-1,) + hw)}
        if refs is not None:
            if refs.dtype == torch.uint8:
                refs = self.u8_lut[refs.to(torch.int64)]
            frames["refs"] = refs.reshape((-1,) + hw)
        host = {}
        out = {}
        for spec in specs:
            keys = ("imgs",) if spec.no_ref else ("imgs", "refs")
            args = [frames[k] for k in keys]
            if spec.host:
                for k in keys:
                    if k not in host:
                        host[k] = frames[k].cpu().numpy()
                args = [host[k] for k in keys]
            try:
                with (contextlib.nullcontext() if probe
                      else matmul_precision_ctx()):
                    got = score_batch(spec, args)
            except Exception as exc:  # noqa: BLE001 — containment
                if on_error is None:
                    raise
                on_error(spec, exc)
                continue
            if spec.host:
                got = torch.from_numpy(np.asarray(got, np.float32)).to(
                    self.device)
            out[spec.name] = got.reshape(lead)
        return out


def score_batch(spec, frames):
    """``spec`` on (N, H, W) frames [and references]: one call, or one per
    frame for a ``serial`` spec (an empty batch still makes one call, so
    the validation probe reaches the spec's own checks)."""
    n = len(frames[0])
    if not spec.serial or n == 0:
        return spec.score(*frames)
    parts = [spec.score(*(f[i:i + 1] for f in frames)) for i in range(n)]
    return np.concatenate(parts) if spec.host else torch.cat(parts)


class MetricContainment:
    """Runtime containment over one sequence or lockstep group (the JAX
    package's ``make_metric_containment``): a metric that raises while
    scoring is dropped, with a message, for the rest of the ``scope``; the
    others go on, and ``dead`` goes to ``finalize(dropped=...)``."""

    def __init__(self, scope):
        self.scope = scope
        self.dead = set()

    def live(self, specs):
        return [s for s in specs if s.name not in self.dead]

    def __call__(self, spec, exc):
        self.dead.add(spec.name)
        lines = str(exc).strip().splitlines()
        print(f"Metric {spec.name} failed at runtime; dropping it for the "
              f"rest of this {self.scope} "
              f"({lines[-1][:200] if lines else exc})")


# ---------------------------------------------------------------------------
# model loading
# ---------------------------------------------------------------------------

def load_method_params(method_config):
    """A method's weights -> (torch-layout ``state_dict``, meta), by the
    JAX package's path resolution (``evreal_tpu/harness/runner.py:321-364``):
    a relative ``model_path`` resolves against the working directory, then
    the repository root; a converted ``.npz`` with its sidecar beside the
    named path is read when there is one, else the reference ``.pth``
    (``convert.checkpoint``). Nothing is written: no cache, nothing beside
    the ``.pth``."""
    path = method_config["model_path"]
    stem = os.path.splitext(path)[0]
    if not os.path.isabs(path) and not any(
            os.path.exists(p) for p in (path, stem + ".npz", stem + ".pth")):
        path = os.path.join(REPO_ROOT, path)
        stem = os.path.splitext(path)[0]
    npz, pth = stem + ".npz", stem + ".pth"
    if os.path.exists(npz):
        try:
            tree, meta = load_params(npz)
            return from_jax_tree(tree), meta
        except FileNotFoundError:
            # an .npz without its sidecar: the .pth, where there is one
            if not os.path.exists(pth):
                raise
    if not os.path.exists(pth):
        raise FileNotFoundError(
            f"neither {npz} nor {pth} exists; place the reference "
            f"checkpoint at {pth}")
    return load_method_checkpoint(method_config["model_name"], pth)


class MethodBundle:
    """A method's model with its weights, and its runners per sensor
    resolution."""

    def __init__(self, method_name, method_config, device):
        self.method_name = method_name
        self.device = torch.device(device)
        state_dict, meta = load_method_params(method_config)
        self.model = build_from_meta(meta, state_dict)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self._replicas = {}
        self._runners = {}

    def model_for(self, device, dtype):
        """The model on ``device`` in ``dtype``: one replica per (device,
        dtype), shared by every runner there; the bundle's own model where
        it already is that."""
        key = (canonical_device(device), dtype)
        if key not in self._replicas:
            self._replicas[key] = replica_on(self.model, device, dtype)
        return self._replicas[key]

    def _make(self, cls, sensor_resolution, method_config, num_bins, device,
              **kwargs):
        h, w = sensor_resolution
        return cls(self.model_for(device, compute_dtype()),
                   event_norm=method_config.get("event_tensor_normalization",
                                                False),
                   post_norm=method_config.get("post_process_norm", "none"),
                   height=h, width=w, num_bins=num_bins, device=device,
                   **kwargs)

    def runner_for(self, sensor_resolution, method_config, num_bins):
        key = tuple(sensor_resolution)
        if key not in self._runners:
            self._runners[key] = self._make(MethodRunner, sensor_resolution,
                                            method_config, num_bins,
                                            self.device)
        return self._runners[key]

    def batched_runner_for(self, sensor_resolution, method_config, num_bins,
                           n, mesh=None):
        """The lockstep runner of ``n`` lanes: a ``BatchedRunner`` on the
        bundle's device, or with a ``mesh`` a ``ShardedRunner`` with one
        ``BatchedRunner`` of ``n / dp`` lanes per dp entry, on that entry's
        device (the JAX package's runner with ``mesh=get_eval_mesh()``)."""
        from evreal_tpu_torch.harness.batched import (
            BatchedRunner,
            ShardedRunner,
        )
        from evreal_tpu_torch.parallel.mesh import dp_devices

        key = (("batched", n) + tuple(sensor_resolution)
               + ((mesh.key(),) if mesh is not None else ()))
        if key not in self._runners:
            if mesh is None:
                runner = self._make(BatchedRunner, sensor_resolution,
                                    method_config, num_bins, self.device,
                                    n=n)
            else:
                devices = dp_devices(mesh)
                if n % len(devices):
                    raise ValueError(f"{n} lanes do not split over the "
                                     f"mesh's dp = {len(devices)}")
                runner = ShardedRunner([
                    self._make(BatchedRunner, sensor_resolution,
                               method_config, num_bins, d,
                               n=n // len(devices)) for d in devices])
            self._runners[key] = runner
        return self._runners[key]

    def color_runner_for(self, sensor_resolution, method_config, num_bins):
        """The f32 ``ColorRunner`` of the full sensor resolution (the
        model's own weights: the color path is never cast to bf16)."""
        from evreal_tpu_torch.models.colornet import ColorRunner

        key = ("color",) + tuple(sensor_resolution)
        if key not in self._runners:
            h, w = sensor_resolution
            stage = make_voxel_stage(
                num_bins, (h, w),
                method_config.get("event_tensor_normalization", False))
            self._runners[key] = ColorRunner(
                self.model, height=h, width=w, voxel_stage=stage,
                post_norm=method_config.get("post_process_norm", "none"),
                device=self.device)
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


def no_ref_specs(specs):
    return [s for s in specs if s.no_ref]


def check_resume(eval_config, dataset_name, sequence, method_name, specs):
    """``EVREAL_RESUME``: the recorded (count, mean scores) of a finished
    run of this sequence under the same settings, with the skip line
    printed, else None (and always None without the switch). A sequence
    without reference frames records its no-reference metrics only."""
    if not resume_enabled():
        return None
    output_dir = sequence_output_dir(eval_config, dataset_name,
                                     sequence["name"], method_name)
    expected = [s.name for s in (specs if sequence["dataset"].has_images
                                 else no_ref_specs(specs))]
    done = load_completed(output_dir, expected, sequence_settings(
        resume_settings(eval_config), sequence))
    if done is not None:
        print(f"Skipping finished {output_dir} (EVREAL_RESUME)")
    return done


def check_color_histeq(eval_config):
    """A color config may equalize only globally: CLAHE and the local rank
    filter take one channel (the reference rejects three as well). Raised
    before the sequence runs (the JAX package raises at its first frame)."""
    hist_eq = eval_config.get("histeq", "none")
    if eval_config.get("color", False) and hist_eq in ("clahe", "local"):
        raise ValueError(f"histeq '{hist_eq}' supports grayscale images "
                         f"only")


def usable_metrics(runner, specs):
    """The ``specs`` that can score the runner's frame shape: each scores
    an empty batch of frames of that shape on the runner's device (its
    shape checks, its weights' loading, ``EVREAL_MANIQA_CROPS``), and one
    that raises is dropped with the JAX package's message (the reference's
    per-metric containment)."""
    hw = (runner.h, runner.w)
    probe = torch.zeros((0,) + hw, device=runner.device)
    out = []
    for spec in specs:
        try:
            runner.metric_scores([spec], probe, probe, probe=True)
        except Exception as exc:  # noqa: BLE001 — containment
            print(color_error(f"metric {spec.name} failed at {hw}: {exc}; "
                              f"skipping"))
            continue
        out.append(spec)
    return out


def make_tracker(eval_config, dataset_name, sequence, method_name, specs):
    """The sequence's ``EvalMetricsTracker``."""
    seq = sequence["dataset"]
    return EvalMetricsTracker(
        sequence_output_dir(eval_config, dataset_name, sequence["name"],
                            method_name),
        [s.name for s in specs],
        save_images=eval_config.get("save_images", True),
        quan_eval_start_time=sequence["start_time_s"],
        quan_eval_end_time=sequence["end_time_s"],
        quan_eval_ts_tol_ms=eval_config["ts_tol_ms"],
        has_reference_frames=seq.has_images,
        run_settings=sequence_settings(resume_settings(eval_config),
                                       sequence),
        hist_eq=eval_config.get("histeq", "none"),
        color=eval_config.get("color", False),
        no_ref_metric_names={s.name for s in specs if s.no_ref})


@contextlib.contextmanager
def abandon_on_error(trackers):
    """When the eval loop raises, stop the trackers' frame writers (their
    queued frames are dropped and no ``done.json`` is written, as in the
    JAX package) so that no writer thread outlives the call."""
    try:
        yield
    except BaseException:
        for tracker in trackers:
            tracker.abandon()
        raise


def finish_tracker(tracker, eval_config, dropped, timings=None):
    """Close a sequence's outputs (``dropped``: the metrics dropped at
    runtime; ``finalize`` waits for the frame writer), then make its
    videos when asked, from every written frame. The writer's totals
    (``png.*``) go to ``timings``' counts when given."""
    with span(PNG_DRAIN):
        try:
            tracker.finalize(dropped)
        finally:
            if timings is not None:
                for name, n in tracker.writer_totals.items():
                    timings.count(name, n)
        if eval_config.get("create_video", False):
            tracker.create_video()
            if eval_config.get("histeq", "none") != "none":
                tracker.create_processed_video()


@contextlib.contextmanager
def count_step(timings):
    """Add to ``timings`` what the ``with`` block, a chunk's step, made of
    the attention wrapper's counts (``kernels/attention_cuda.py:
    counts()``: every call, those that launched the fused kernel, and the
    products N * heads * Lq * Lk) and the rollouts at a new
    ``rollout_key`` (``conv.searches``)."""
    def now():
        return attention_counts() + (len(ROLLOUT_KEYS),)

    before = now()
    yield
    for name, after, then in zip(STEP_COUNTS, now(), before):
        timings.count(name, after - then)


def event_dtypes(seqs):
    """Event-buffer dtypes of the active wire (``EVREAL_WIRE``) for
    sequences of one resolution: integer coordinates only when every
    sequence stores them."""
    int_coords = all(np.issubdtype(s.xy.dtype, np.integer) for s in seqs)
    return wire_dtypes(wire_format(), int_coords, seqs[0].sensor_resolution)


def equalized_refs(seq, metas, hist_eq):
    """The windows' f32 reference frames (``Sequence.frame``), clipped and
    equalized on the host."""
    return np.stack([histogram_equalization(
        np.clip(seq.frame(m["frame_index"]), 0, 1), hist_eq) for m in metas])


def record_window(tracker, seq, i, meta, image, scores, processed=None):
    """One window's frame, scores, hist-eq'd copy and event rate into its
    tracker."""
    tracker.update(i, image, meta["voxel_timestamp"],
                   meta["frame_timestamp"] if seq.has_images else None,
                   scores=scores, processed_img=processed)
    rate = (0 if meta["event_count"] <= 1 or meta["dt"] == 0
            else meta["event_count"] / meta["dt"])
    tracker.save_custom_metric(i, "event_rate", rate)


def to_host(tensors):
    """Start device->host copies of a dict of tensors (on one device or on
    several, as a mesh's shards give them); returns the host dict and the
    events to wait on: one per CUDA device, recorded on that device's
    current stream, where its copies run (none on the CPU)."""
    host, devices = {}, []
    for k, v in tensors.items():
        if v.device.type != "cuda":
            host[k] = v
            continue
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
        if v.device not in devices:
            devices.append(v.device)
    events = []
    for device in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        events.append(event)
    return host, events


def from_host(host, events):
    """Wait for ``to_host``'s copies; the dict as numpy arrays."""
    for event in events:
        event.synchronize()
    return {k: v.numpy() for k, v in host.items()}


def run_chunks(n_chunks, dispatch, drain, timer):
    """Dispatch chunks ``0..n_chunks-1`` in order (``dispatch(k)`` returns
    (entry, frames)), draining the oldest once ``PIPELINE_DEPTH`` are in
    flight. The first chunk bears the kernel build and cuDNN's algorithm
    search: when more follow it is drained at once and its frames leave
    the timer's steady-state sample."""
    pending = []
    for k in range(n_chunks):
        entry, frames = dispatch(k)
        pending.append(entry)
        if k == 0 and n_chunks > 1:
            drain(pending.pop(0))
            timer.exclude_warmup(frames)
        if len(pending) >= PIPELINE_DEPTH:
            drain(pending.pop(0))
    for entry in pending:
        drain(entry)


def eval_method_on_sequence(dataset_name, eval_config, method_name, bundle,
                            method_config, sequence, metrics, timings=None):
    """One sequence, run as a lockstep group of one lane (the eval loop,
    ``harness/batched.py:eval_method_on_sequence_group``). Returns
    ``(num_evaluated, mean_scores)``."""
    from evreal_tpu_torch.harness.batched import eval_method_on_sequence_group

    return eval_method_on_sequence_group(
        dataset_name, eval_config, method_name, bundle, method_config,
        [sequence], metrics, timings)[0]


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


def split_groups(groups, cap_n):
    """Cap lockstep group width at ``cap_n`` sequences (EVREAL_BATCH_N);
    0 = unlimited."""
    if cap_n <= 0:
        return groups
    return [g[i:i + cap_n] for g in groups
            for i in range(0, len(g), cap_n)]


def sequence_groups(eval_config, sequences):
    """The dataset's sequences in evaluation groups: same-resolution
    groups of at most EVREAL_BATCH_N for the lockstep runner, unless
    ``EVREAL_BATCHED=0`` or a color config, which take one at a time."""
    if (eval_config.get("color", False)
            or os.environ.get("EVREAL_BATCHED", "1") == "0"):
        return [[s] for s in sequences]
    by_res = OrderedDict()
    for sequence in sequences:
        key = tuple(sequence["dataset"].sensor_resolution)
        by_res.setdefault(key, []).append(sequence)
    return split_groups(list(by_res.values()), DEFAULT_BATCH_N)


def eval_method_with_config(eval_config, method_name, datasets, metrics,
                            device, timings):
    from evreal_tpu_torch.harness.batched import eval_method_on_sequence_group

    num_sequences = sum(len(d["sequences"]) for d in datasets)
    method_config = get_method_config(method_name)
    print(color_progress("Starting method " + method_name))
    method_metrics = []
    try:
        with span(BUNDLE):
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
            for group in sequence_groups(eval_config, dataset["sequences"]):
                for sequence in group:
                    print(color_progress(
                        f"Evaluating {method_name} method with "
                        f"{eval_config['name']} evaluation config on "
                        f"{sequence['name']} sequence from {dataset['name']} "
                        f"dataset. ({seq_no}/{num_sequences} for this method "
                        f"and config)"))
                    seq_no += 1
                results = eval_method_on_sequence_group(
                    dataset["name"], eval_config, method_name, bundle,
                    method_config, group, metrics, timings)
                accumulate_mean_scores(dataset_metrics, results)
        except Exception as e:  # noqa: BLE001 — containment, eval.py:369-375
            print(color_error(f"Exception while evaluating method "
                              f"{method_name} on {dataset['name']} dataset:"))
            print(color_error(str(e)))
            print(color_error(traceback.format_exc()))
        finally:
            method_metrics.append(dataset_metrics)
    return method_metrics


ALL_METHODS = ["E2VID", "E2VID+", "FireNet", "FireNet+", "SPADE-E2VID",
               "SSL-E2VID", "ET-Net", "HyperE2VID"]


def profile_ctx(device):
    """``EVREAL_PROFILE=<dir>``: a ``torch.profiler`` trace of what runs
    inside (CPU activity, and the card's when ``device`` is one), written
    on exit, a raise's too, as a Chrome trace (``*.pt.trace.json``, read by
    Perfetto or TensorBoard) into the directory, made if absent — the JAX
    package's ``jax.profiler`` trace of its whole ``evaluate``
    (``evreal_tpu/harness/runner.py:1237-1250``). Unset or empty: no
    profiler."""
    profile_dir = os.environ.get("EVREAL_PROFILE")
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def evaluate(method_names=None, eval_config_names=None, dataset_names=None,
             metrics=None, device=None, timings=None):
    """The reference ``evaluate`` (eval.py:413-444) on ``device`` (CUDA
    unless the caller asks for another; raises without a card), over all
    eight methods unless ``method_names`` names some. Steady ms/frame
    samples go to ``timings`` (a ``TimingLog``) when given. Returns {eval
    config name: per-method lists of dataset trackers}. Set
    ``EVREAL_PROFILE=<dir>`` to trace the whole run (``profile_ctx``)."""
    device = resolve_device(device)
    with profile_ctx(device):
        return _evaluate(method_names, eval_config_names, dataset_names,
                         metrics, device, timings)


def _evaluate(method_names, eval_config_names, dataset_names, metrics,
              device, timings):
    method_names = method_names or ALL_METHODS
    # a malformed EVREAL_WIRE fails here, not inside the per-dataset
    # containment (evreal_tpu/harness/runner.py:1255-1260)
    wire_format()
    eval_config_names = eval_config_names or ["std"]
    dataset_names = dataset_names or ["ECD", "MVSEC", "HQF"]
    metrics = metrics or DEFAULT_METRICS
    timings = timings if timings is not None else TimingLog()
    eval_configs = get_eval_configs(eval_config_names)
    for eval_config in eval_configs:
        # before any work: a missing ffmpeg would otherwise fail each
        # sequence inside the per-dataset containment, after its run
        if eval_config.get("create_video", False):
            require_ffmpeg()
    dataset_configs = get_dataset_configs(dataset_names)
    results = {}
    for eval_config in eval_configs:
        with span(OPEN):
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
