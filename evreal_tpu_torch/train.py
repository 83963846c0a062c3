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

Forward and backward run in f32 with TF32 off and cuDNN's deterministic
algorithms (``training_precision``): XLA's training step is deterministic
and uses full f32 matmuls, and a checkpointed run resumes to the same
parameters as an uninterrupted one. On a CUDA device the step runs
channels-last (NHWC): with NCHW tensors cuDNN's heuristics pick FFT and
Winograd algorithms for the deterministic backward pass, whose f32
gradient of E2VID's 5-channel head conv strays from the CPU's far beyond
f32 rounding (``tests/test_torch_cuda_train.py``) and whose FFT tiles
slow FireNet's small convolutions (``chip_smoke.py``'s train phase times
both layouts). The CPU keeps NCHW.

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

from evreal_tpu_torch.utils import f32_parity

LOSS_TERMS = ("mse", "lpips", "bce")


@contextlib.contextmanager
def training_precision():
    """f32 convolutions and matmuls (TF32 off) and deterministic cuDNN
    algorithms for the duration. cuDNN reads these flags when it launches
    a kernel, so the backward pass must run inside the context too."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    with f32_parity():
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
                  lpips_weights=None, lpips_scale=1.0, mask=None):
    """The chunk's loss: voxels (N, T, B, H, W), frames (N, T, H, W),
    ``mask`` an optional (N, T) window validity (1 = a window with a
    reference frame; a zero-padded tail window of a short sequence must
    not be scored against a black frame).

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


def make_train_step(model, optimizer=None, remat=True, loss="mse",
                    lpips_weights=None, lpips_scale=1.0):
    """``(step, optimizer)``: ``step(batch)`` runs the forward and the
    backward pass (both under ``training_precision``) and one update of
    ``model``'s parameters, and returns the loss as a 0-d tensor on the
    batch's device (reading it waits for the device). A model on a CUDA
    device is turned channels-last here, once (module docstring)."""
    if optimizer is None:
        optimizer = build_optimizer(1e-4)
    if any(p.is_cuda for p in model.parameters()):
        model.to(memory_format=torch.channels_last)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch):
        for p in params:
            p.grad = None
        with training_precision():
            loss_val = sequence_loss(
                model, batch["voxels"], batch["frames"], remat, loss=loss,
                lpips_weights=lpips_weights, lpips_scale=lpips_scale,
                mask=batch.get("mask"))
            loss_val.backward()
        optimizer.step(params)
        return loss_val.detach()

    return step, optimizer
