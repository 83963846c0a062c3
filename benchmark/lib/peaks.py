"""The chips' published peaks, by ``torch.cuda.get_device_name()``
(NVIDIA's H100 SXM data sheet: dense rates without sparsity, at the
700 W limit), and the operations the model step needs."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.models import PadCrop, build

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "flops": {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12},
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(device_name):
    """The row of ``PEAKS`` for the card, or None for another device."""
    return PEAKS.get(device_name)


def flops_per_window(config, height, width):
    """FLOPs of one window of the configuration's network for one lane:
    its convolutions at the padded frame size, counted by
    ``FlopCounterMode`` on ``meta`` tensors of the reference network."""
    net = build(config).to("meta")
    pc = PadCrop(height, width, net.num_encoders)
    x = torch.empty((1, config["kwargs"]["num_bins"], pc.hp, pc.wp),
                    device="meta")
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        net.step(x, net.init_state(1, pc.hp, pc.wp, "meta"))
    return counter.get_total_flops()
