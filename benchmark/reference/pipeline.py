"""The reference reconstruction of N lanes in lockstep, window by window:
event norm (where the method asks for it), pad, one network step for
every lane, crop, output normalization, clip; and the precision it runs
in.

``precision``: ``"float32"`` (the configurations' precision: TF32 off in
cuDNN and cuBLAS) or ``"tf32"``, the control's (TF32 on, on the card; on
the CPU, where there is no TF32, every convolution's input and weights
are rounded to TF32's 10-bit mantissa, as the card's tensor cores round
them)."""

import contextlib

import torch

from benchmark.reference.events import event_norm
from benchmark.reference.frames import post_norm
from benchmark.reference.models import PadCrop, build

PRECISIONS = ("float32", "tf32")
# A frame whose network output spans less than this between its 1st and
# 99th percentiles (an empty window: a flat image) is stretched over the
# grey levels by the robust post-norm by 1 / span: float32 rounding of
# the output, about 1e-7, then moves whole grey levels. Such frames are
# ill-conditioned and are held only to being present.
STRETCH_MIN = 1e-2


def tf32_round(x):
    """``x`` (f32) rounded to TF32 (10 mantissa bits), to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def precision(mode, device):
    """TF32 in cuDNN and cuBLAS on for ``"tf32"`` on the card, else off."""
    if mode not in PRECISIONS:
        raise ValueError(f"precision {mode!r}: expected one of {PRECISIONS}")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    on = mode == "tf32" and torch.device(device).type == "cuda"
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def emulate_tf32(module):
    """Round ``module``'s convolution weights, and each convolution's input
    on every call, to TF32 (the CPU's stand-in for the card's TF32)."""
    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            with torch.no_grad():
                m.weight.copy_(tf32_round(m.weight))
            m.register_forward_pre_hook(
                lambda _m, args: (tf32_round(args[0]),) + args[1:])
    return module


class Recon:
    """The configuration's network over ``n`` lanes of (h, w) frames, its
    recurrent state from zeros."""

    def __init__(self, config, state_dict, h, w, n, device,
                 mode="float32"):
        self.net = build(config)
        self.net.load_state_dict({k: v.to("cpu") for k, v in
                                  state_dict.items()}, strict=True)
        self.net.to(device)
        if mode == "tf32" and torch.device(device).type != "cuda":
            emulate_tf32(self.net)
        self.mode, self.device = mode, device
        self.pc = PadCrop(h, w, self.net.num_encoders)
        self.state = self.net.init_state(n, self.pc.hp, self.pc.wp, device)
        method = config["method_config"]
        self.event_norm = method.get("event_tensor_normalization", False)
        self.post = method.get("post_process_norm", "none")

    @torch.no_grad()
    def step(self, vox):
        """(n, bins, h, w) f32 grids -> ((n, h, w) clipped frames in [0, 1],
        (n,) bool: the frames whose post-norm stretch ``p99 - p1`` is at
        least ``STRETCH_MIN``)."""
        if self.event_norm:
            vox = event_norm(vox)
        with precision(self.mode, self.device):
            img, self.state = self.net.step(self.pc.pad(vox), self.state)
        img, stretch = post_norm(self.pc.crop(img[:, 0]), self.post)
        return img.clamp(0.0, 1.0), (stretch >= STRETCH_MIN).tolist()
