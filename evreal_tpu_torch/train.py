"""Truncated-BPTT reconstruction training of event-video models
(``evreal_tpu/train.py``).

``make_train_step`` builds a step that runs the model over a chunk of T
windows with its recurrent state carried from window to window, takes
the gradient of the chunk's loss through all of them (each window's
forward optionally rematerialized in the backward pass, trading FLOPs
for device memory), and applies one optimizer update::

    loss = step({"voxels": (N, T, B, H, W), "frames": (N, T, H, W),
                 "mask": (N, T)})

The loss is per-frame MSE, soft-target BCE, LPIPS on the raw outputs, or
a '+'-joined sum of them, with the JAX package's formulas. The optimizer
is optax's stack computed in torch (``build_optimizer``): optional
global-norm clipping, Adam or AdamW, and a constant or warmup/cosine
learning rate read at the update count before the update.

Forward and backward run in f32 with TF32 off (unless
``EVREAL_PRECISION`` says otherwise) and cuDNN's deterministic
algorithms (``training_precision``): XLA's training step is deterministic
and uses full f32 matmuls, and a checkpointed run resumes to the same
parameters as an uninterrupted one. On a CUDA device the step runs
channels-last (NHWC): with NCHW tensors cuDNN's heuristics pick FFT and
Winograd algorithms for the deterministic backward pass, whose f32
gradient of E2VID's 5-channel head conv strays from the CPU's far beyond
f32 rounding (``tests/test_torch_cuda_train.py``) and whose FFT tiles
slow FireNet's small convolutions (``chip_smoke.py``'s train phase times
both layouts). The CPU keeps NCHW.

With a device mesh (``make_train_step(..., mesh=)``) the step is data
parallel over the mesh's dp entries, in one process: each entry holds a
replica of the model (its own copy, even where the mesh repeats a
device) and a contiguous block of the batch's samples; each replica's
loss is its masked sum over the whole batch's denominator, so the
replicas' losses sum to the meshless loss; one backward call runs them
all; the gradients are summed onto the first replica (NCCL's reduce
across distinct cards, a plain sum where a device repeats), clipped and
applied there once, and the updated parameters copied to the others.

The voxelizer that feeds a batch runs outside the step (``train_cli``);
no kernel of this module has a backward: the gradient flows through
the convolutions (cuDNN) and the loss only, as in the JAX package, where
``jax.value_and_grad`` differentiates XLA's convolutions and never the
Pallas voxelizer.
"""

import contextlib

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from evreal_tpu_torch.parallel.mesh import (
    canonical_device,
    copy_module,
    dp_devices,
    split_lanes,
)
from evreal_tpu_torch.utils import matmul_precision_ctx

LOSS_TERMS = ("mse", "lpips", "bce")


@contextlib.contextmanager
def training_precision():
    """The f32 precision context (``matmul_precision_ctx``: TF32 off
    unless ``EVREAL_PRECISION`` says otherwise, as the JAX package's
    training step takes it) and deterministic cuDNN algorithms for the
    duration. cuDNN reads these flags when it launches a kernel, so the
    backward pass must run inside the context too."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    with matmul_precision_ctx():
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            yield
        finally:
            cudnn.deterministic, cudnn.benchmark = saved


def channels_last(tree):
    """Every 4-D tensor of a (nested dict / list / tuple) state in the
    channels-last memory format (the same values)."""
    if isinstance(tree, torch.Tensor):
        return tree.contiguous(memory_format=torch.channels_last) \
            if tree.dim() == 4 else tree
    if isinstance(tree, dict):
        return {k: channels_last(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(channels_last(v) for v in tree)
    return tree


def sequence_loss(model, voxels, frames, remat=True, loss="mse",
                  lpips_weights=None, lpips_scale=1.0, mask=None, denom=None):
    """The chunk's loss: voxels (N, T, B, H, W), frames (N, T, H, W),
    ``mask`` an optional (N, T) window validity (1 = a window with a
    reference frame; a zero-padded tail window of a short sequence must
    not be scored against a black frame). ``denom``: the loss's
    denominator, by default this batch's count of valid windows (at least
    1); a shard of a larger batch passes the whole batch's, so that the
    shards' losses sum to the batch's.

    ``loss`` is '+'-joined terms of {mse, lpips, bce}. LPIPS runs
    ``metrics/lpips.py`` (plain torch convolutions, differentiable) on the
    raw outputs, unclipped, with ``lpips_weights`` in its layout ({name:
    tensor}, OIHW, on the voxels' device). BCE is the soft-target
    cross-entropy on the sigmoid output, clipped to [1e-35, 1 - 1e-7] in
    f32: bounds at the edge of f32, since a clip passes no gradient
    outside its range and a looser floor would zero the gradient of any
    deeper-saturated pixel (the saturation BCE exists to escape).

    On a CUDA device each window and the recurrent state go in as
    channels-last tensors (module docstring)."""
    n, t, _, h, w = voxels.shape
    parts = loss.split("+")
    if set(parts) - set(LOSS_TERMS) or not parts:
        raise ValueError(f"loss={loss!r}: terms must be mse|lpips|bce")
    if "lpips" in parts and lpips_weights is None:
        raise ValueError("loss includes lpips but lpips_weights is None "
                         "(convert them with tools/convert_lpips.py)")

    nhwc = voxels.is_cuda
    state = model.init_state(n, h, w, device=voxels.device,
                             dtype=voxels.dtype)
    if nhwc:
        state = channels_last(state)
    imgs = []
    for i in range(t):
        v = channels_last(voxels[:, i]) if nhwc else voxels[:, i]
        if remat:
            out, state = checkpoint(model, v, state, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            out, state = model(v, state)
        imgs.append(out["image"][:, 0])
    imgs = torch.stack(imgs, 1)  # (N, T, H, W)

    total = 0.0
    m = torch.ones((n, t), dtype=voxels.dtype, device=voxels.device) \
        if mask is None else mask.to(voxels.dtype)
    if denom is None:
        denom = torch.clamp(m.sum(), min=1.0)
    if "mse" in parts:
        per_frame = ((imgs - frames) ** 2).mean(dim=(2, 3))  # (N, T)
        total = total + (per_frame * m).sum() / denom
    if "bce" in parts:
        p = torch.clamp(imgs.to(torch.float32), 1e-35, 1.0 - 1e-7)
        f = frames.to(torch.float32)
        per_frame = -(f * torch.log(p)
                      + (1.0 - f) * torch.log1p(-p)).mean(dim=(2, 3))
        total = total + (per_frame * m).sum() / denom
    if "lpips" in parts:
        from evreal_tpu_torch.metrics.lpips import lpips

        d = lpips(lpips_weights, imgs.reshape(n * t, h, w),
                  frames.reshape(n * t, h, w))
        total = total + lpips_scale * (d * m.reshape(-1)).sum() / denom
    return total


# ---------------------------------------------------------------------------
# the optimizer: optax's clip -> adam(w) -> learning-rate stack
# ---------------------------------------------------------------------------

def _f32(x):
    return np.float32(x)


def _warmup(lr, warmup, count):
    """``optax.linear_schedule(0, lr, warmup)`` at ``count < warmup``."""
    frac = _f32(1) - _f32(count) / _f32(warmup)
    return (_f32(0) - _f32(lr)) * frac + _f32(lr)


def constant_schedule(lr, warmup=0):
    """``lr``, after a linear warmup from 0 over ``warmup`` updates
    (``optax.join_schedules`` of ``linear_schedule`` and
    ``constant_schedule``)."""
    def schedule(count):
        return _warmup(lr, warmup, count) if count < warmup else _f32(lr)
    return schedule


def cosine_schedule(lr, steps, warmup=0):
    """``optax.warmup_cosine_decay_schedule(init_value=0 if warmup else
    lr, peak_value=lr, warmup_steps=warmup, decay_steps=steps)``: a linear
    warmup, then a cosine decay to 0 over ``steps - warmup`` updates."""
    decay = steps - warmup
    if not decay > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay}.")

    def schedule(count):
        if count < warmup:
            return _warmup(lr, warmup, count)
        c = _f32(min(count - warmup, decay))
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c / _f32(decay)))
        return _f32(lr) * cos
    return schedule


class Adam:
    """Adam (AdamW with ``weight_decay``) after optional global-norm
    clipping, on a list of parameter tensors, in optax's arithmetic: b1
    0.9, b2 0.999, eps 1e-8 outside the square root; the bias-corrected
    moments divided as ``mu_hat / (sqrt(nu_hat) + eps)``; decoupled decay
    ``+ weight_decay * p`` before the learning rate; the learning rate
    ``schedule(count)`` at the update count before the update; the clip
    ``g / norm * max_norm`` only when ``norm >= max_norm`` (optax's
    ``clip_by_global_norm``; ``torch.nn.utils.clip_grad_norm_`` adds 1e-6
    to the norm and differs). The state (``state_dict``) is the count and
    the two moments, created at the first ``step``."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, schedule, weight_decay=0.0, clip_grad=0.0):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip_grad = clip_grad
        self.count = 0
        self.mu = self.nu = None

    @torch.no_grad()
    def step(self, params):
        """One update of ``params`` (tensors) from their ``.grad``."""
        params = list(params)
        grads = [p.grad for p in params]
        if self.mu is None:
            self.mu = [torch.zeros_like(p) for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
        if self.clip_grad:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.clip_grad
            grads = [torch.where(keep, g, g / norm * self.clip_grad)
                     for g in grads]
        self.count += 1
        bc1 = float(_f32(1) - _f32(self.b1) ** _f32(self.count))
        bc2 = float(_f32(1) - _f32(self.b2) ** _f32(self.count))
        neg_lr = -float(self.schedule(self.count - 1))
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.add_(neg_lr * update)

    def state_dict(self):
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self.mu, self.nu = state["mu"], state["nu"]


def build_optimizer(lr=1e-4, schedule="constant", steps=None, warmup=0,
                    weight_decay=0.0, clip_grad=0.0):
    """The training optimizer: optional global-norm gradient clipping,
    Adam or AdamW, and a constant or linear-warmup cosine-decay schedule
    (``steps`` required for cosine)."""
    if schedule == "cosine":
        if not steps:
            raise ValueError("cosine schedule needs total steps")
        sched = cosine_schedule(lr, steps, warmup)
    elif schedule == "constant":
        sched = constant_schedule(lr, warmup)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return Adam(sched, weight_decay=weight_decay, clip_grad=clip_grad)


def make_train_step(model, optimizer=None, mesh=None, remat=True,
                    loss="mse", lpips_weights=None, lpips_scale=1.0):
    """``(step, optimizer)``: ``step(batch)`` runs the forward and the
    backward pass (both under ``training_precision``) and one update of
    ``model``'s parameters, and returns the loss as a 0-d tensor on the
    model's device (reading it waits for the device). A model on a CUDA
    device is turned channels-last here, once (module docstring).

    ``mesh``: data parallel over its dp entries (module docstring); the
    model must lie on the first, where it is the first replica, the one
    the optimizer updates and checkpoints read. The batch's N must divide
    over dp. ``step.replicas`` lists the replicas."""
    if optimizer is None:
        optimizer = build_optimizer(1e-4)
    home = canonical_device(next(model.parameters()).device)
    devices = [home]
    if mesh is not None:
        devices = [canonical_device(d) for d in dp_devices(mesh)]
        if devices[0] != home:
            raise ValueError(f"the model lies on {home}, the mesh's first "
                             f"device is {devices[0]}")
    replicas = [model] + [copy_module(model, d) for d in devices[1:]]
    for r in replicas:
        if any(p.is_cuda for p in r.parameters()):
            r.to(memory_format=torch.channels_last)
    params = [[p for p in r.parameters() if p.requires_grad]
              for r in replicas]
    lpips_on = {}
    if lpips_weights is not None:
        lpips_on = {d: {k: v.to(d) for k, v in lpips_weights.items()}
                    for d in dict.fromkeys(devices)}

    def step(batch):
        for ps in params:
            for p in ps:
                p.grad = None
        shards = [batch] if len(replicas) == 1 else \
            shard_batch(batch, devices)
        with training_precision():
            losses = [sequence_loss(
                r, b["voxels"], b["frames"], remat, loss=loss,
                lpips_weights=lpips_on.get(d), lpips_scale=lpips_scale,
                mask=b.get("mask"), denom=b.get("denom"))
                for r, b, d in zip(replicas, shards, devices)]
            # one call: autograd's per-device threads run the replicas'
            # backward passes together
            torch.autograd.backward(losses)
        if len(replicas) > 1:
            reduce_grads(params, devices)
        optimizer.step(params[0])
        if len(replicas) > 1:
            with torch.no_grad():
                for ps in params[1:]:
                    for p, p0 in zip(ps, params[0]):
                        p.copy_(p0)
        total = losses[0].detach()
        for other in losses[1:]:
            total = total + other.detach().to(devices[0])
        return total

    step.replicas = replicas
    return step, optimizer


def shard_batch(batch, devices):
    """A batch's dp blocks of samples, each on its device, with the whole
    batch's loss denominator (its valid windows, at least 1)."""
    n, t = batch["voxels"].shape[:2]
    mask = batch.get("mask")
    denom = (torch.clamp(mask.to(batch["voxels"].dtype).sum(), min=1.0)
             if mask is not None else
             torch.tensor(float(n * t), dtype=batch["voxels"].dtype))
    parts = split_lanes({k: v for k, v in batch.items() if v is not None},
                        len(devices))
    return [{**{k: v.to(d, non_blocking=True) for k, v in part.items()},
             "denom": denom.to(d)} for part, d in zip(parts, devices)]


@torch.no_grad()
def reduce_grads(params, devices):
    """Each parameter's gradients of every replica (``params[r]``, the
    replicas' parameter lists) summed into the first replica's ``.grad``:
    NCCL's reduce (``torch.cuda.comm``) when the replicas lie on distinct
    cards, else (a device that repeats, the CPU) a plain sum in replica
    order on the first device."""
    grads = [[p.grad for p in ps] for ps in params]
    distinct = len(set(devices)) == len(devices)
    if distinct and all(d.type == "cuda" for d in devices):
        sums = torch.cuda.comm.reduce_add_coalesced(
            grads, destination=devices[0].index)
    else:
        sums = []
        for per_replica in zip(*grads):
            acc = per_replica[0]
            for g in per_replica[1:]:
                acc = acc + g.to(devices[0])
            sums.append(acc)
    for p, g in zip(params[0], sums):
        p.grad = g
