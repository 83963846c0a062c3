"""Input / output normalizations (``evreal_tpu/ops/normalize.py``).

  * ``normalize_event_tensor`` — zero-mean/unit-std over the *nonzero*
    entries of one voxel tensor (reference eval.py:398-410; E2VID and
    FireNet), with the variance clamped at 0;
  * ``post_process_normalization`` — none / robust (1-99 pct) / standard
    (0-100 pct) / exprobust image normalization (reference eval.py:380-395)
    with exact percentiles (``ops/percentile.py``);
  * ``post_process_normalization_frames`` — the same four on merged color
    frames, with numpy's percentile rule.

All take a leading batch dimension: each item is normalized on its own.
"""

import torch

from evreal_tpu_torch.ops.percentile import numpy_percentiles, percentiles


def normalize_event_tensor(voxel):
    """Normalize each item of ``voxel`` (N, ...) over its own nonzero
    entries; an all-zero item passes through unchanged."""
    dims = tuple(range(1, voxel.dim()))
    shape = (-1,) + (1,) * (voxel.dim() - 1)
    nonzero = voxel != 0
    num = nonzero.sum(dim=dims).to(voxel.dtype)
    safe = num.clamp(min=1)
    mean = voxel.sum(dim=dims) / safe
    var = (voxel * voxel).sum(dim=dims) / safe - mean * mean
    # E[x^2] - mean^2 can round a hair negative in f32 (all-equal nonzero
    # entries); sqrt of that would be NaN and poison the whole recurrent
    # reconstruction, so clamp at 0
    std = torch.sqrt(var.clamp(min=0.0)).clamp(min=1e-6)
    out = torch.where(nonzero, (voxel - mean.view(shape)) / std.view(shape),
                      torch.zeros((), dtype=voxel.dtype, device=voxel.device))
    return torch.where((num > 0).view(shape), out, voxel)


def robust_normalize(img, q_min, q_max):
    """``(img - p[q_min]) / (p[q_max] - p[q_min])`` per item of
    ``img`` (N, H, W)."""
    stats = percentiles(img.reshape(img.shape[0], -1), (q_min, q_max))
    lo = stats[:, 0].view(-1, 1, 1)
    hi = stats[:, 1].view(-1, 1, 1)
    return (img - lo) / (hi - lo)


def post_process_normalization(img, norm):
    if norm == "robust":
        return robust_normalize(img, 1, 99)
    if norm == "standard":
        return robust_normalize(img, 0, 100)
    if norm == "exprobust":
        return robust_normalize(torch.exp(img), 1, 99)
    if norm == "none" or norm is None:
        return img
    raise ValueError(f"Unrecognized normalization argument: {norm}")


def post_process_normalization_frames(frames, norm):
    """The post-norm of merged color frames (N, H, W, 3) f32, each frame
    over all of its channels with numpy's f32 percentile rule
    (``post_process_normalization_np``, evreal_tpu/harness/runner.py:274-
    287, which the JAX package runs on the host)."""
    if norm == "none" or norm is None:
        return frames
    if norm == "exprobust":
        frames = torch.exp(frames)
        norm = "robust"
    if norm not in ("robust", "standard"):
        raise ValueError(f"Unrecognized image normalization: {norm}")
    qs = (1, 99) if norm == "robust" else (0, 100)
    stats = numpy_percentiles(frames.reshape(frames.shape[0], -1), qs)
    shape = (-1,) + (1,) * (frames.dim() - 1)
    lo, hi = stats[:, 0].view(shape), stats[:, 1].view(shape)
    return (frames - lo) / (hi - lo)
