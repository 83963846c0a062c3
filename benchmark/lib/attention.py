"""The attention products of a configuration's window, counted from its
shapes, and the least time the card needs for them: what
``metrics/attention_roofline.etnet.py`` holds the program's
``attention_*`` kernels to. The program's own counts are not read here.

ET-Net (``reference/etnet.py``) attends over the L = (H/8) (W/8) tokens
of the padded frame at each of its three scales: per scale
``num_encoder_layers`` self-attentions and ``num_decoder_layers``
self- and cross-attentions, each of ``NUM_HEADS`` heads of ``D_MODEL /
NUM_HEADS``, every one L x L."""

from benchmark.reference.etnet import D_MODEL, NUM_HEADS
from benchmark.reference.models import PadCrop

SCALES = 3
BYTES = 4  # float32


def calls(config, height, width):
    """[(heads, Lq, Lk, dh)] of one lane-window's attention calls."""
    kw = config["kwargs"]
    pc = PadCrop(height, width, 3)
    tokens = (pc.hp // 8) * (pc.wp // 8)
    n = SCALES * (kw["num_encoder_layers"] + 2 * kw["num_decoder_layers"])
    return [(NUM_HEADS, tokens, tokens, D_MODEL // NUM_HEADS)] * n


def flops(heads, lq, lk, dh):
    """QKᵀ and PV: 2 dh operations each a score and head."""
    return 4 * heads * lq * lk * dh


def bytes_moved(heads, lq, lk, dh):
    """q, k, v read once and the output written once."""
    return BYTES * heads * dh * (2 * lq + 2 * lk)


def least_seconds(config, height, width, lane_windows, peak_flops,
                  hbm_bytes_per_s):
    """The least time of ``lane_windows`` windows' attention calls: each
    call the larger of its operations over the FP32 peak and its bytes
    over the HBM bandwidth."""
    return lane_windows * sum(
        max(flops(*c) / peak_flops, bytes_moved(*c) / hbm_bytes_per_s)
        for c in calls(config, height, width))
