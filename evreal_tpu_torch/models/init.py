"""Parameter initialization (numpy only; the port's own copy of
``evreal_tpu/models/init.py``). Trees come out in the converted-checkpoint
layout (HWIO convs); ``evreal_tpu_torch.convert.params.from_jax_tree`` turns
them into a ``state_dict``.

The reference is inference-only (no training code anywhere, README.md:8);
this module extends the framework with trainable param trees matching the
converted-checkpoint layout, using torch-equivalent default initializers
(kaiming-uniform fan-in for convs, orthogonal GRU gates per
submodules.py:263-268).
"""

import numpy as np


def _kaiming_uniform(rng, shape_hwio, gain_a=np.sqrt(5)):
    """torch Conv2d default: kaiming_uniform_(a=sqrt(5)) -> bound =
    gain * sqrt(3/fan_in) with gain = sqrt(2/(1+a^2)), i.e. 1/sqrt(fan_in)."""
    h, w, i, o = shape_hwio
    fan_in = h * w * i
    gain = np.sqrt(2.0 / (1 + gain_a ** 2))
    bound = gain * np.sqrt(3.0 / fan_in)
    return rng.uniform(-bound, bound, size=shape_hwio).astype(np.float32)


def _bias_uniform(rng, fan_in, size):
    bound = 1.0 / np.sqrt(fan_in) if fan_in > 0 else 0
    return rng.uniform(-bound, bound, size=size).astype(np.float32)


def conv(rng, kh, kw, cin, cout, bias=True):
    p = {"weight": _kaiming_uniform(rng, (kh, kw, cin, cout))}
    if bias:
        p["bias"] = _bias_uniform(rng, kh * kw * cin, cout)
    return p


def _orthogonal(rng, shape_hwio):
    h, w, i, o = shape_hwio
    rows, cols = o, h * w * i
    a = rng.normal(size=(max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if rows < cols:
        q = q.T
    return q.reshape(o, h, w, i).transpose(1, 2, 3, 0).astype(np.float32)


def gru(rng, k, cin, hidden):
    cat = cin + hidden
    return {
        name: {"weight": _orthogonal(rng, (k, k, cat, hidden)),
               "bias": np.zeros(hidden, np.float32)}
        for name in ("reset_gate", "update_gate", "out_gate")
    }


def lstm(rng, k, cin, hidden):
    cat = cin + hidden
    return {"Gates": conv(rng, k, k, cat, 4 * hidden)}


def resblock(rng, ch):
    return {"conv1": conv(rng, 3, 3, ch, ch), "conv2": conv(rng, 3, 3, ch, ch)}


def init_firenet(seed=0, num_bins=5, base_num_channels=16, kernel_size=3):
    """Param tree for models.firenet.FireNet."""
    rng = np.random.default_rng(seed)
    k, b = kernel_size, base_num_channels
    return {
        "head": {"conv2d": conv(rng, k, k, num_bins, b)},
        "G1": gru(rng, k, b, b),
        "R1": resblock(rng, b),
        "G2": gru(rng, k, b, b),
        "R2": resblock(rng, b),
        "pred": {"conv2d": conv(rng, 1, 1, b, 1)},
    }


def init_e2vid(seed=0, num_bins=5, base_num_channels=32, kernel_size=5,
               num_encoders=3, num_residual_blocks=2,
               recurrent_block_type="convlstm", channel_multiplier=2):
    """Param tree for models.unet.E2VIDRecurrent (sum skip, no norm,
    upsample-conv decoders)."""
    rng = np.random.default_rng(seed)
    k, b = kernel_size, base_num_channels
    cell = lstm if recurrent_block_type == "convlstm" else gru
    enc_in = [int(b * channel_multiplier ** i) for i in range(num_encoders)]
    enc_out = [int(b * channel_multiplier ** (i + 1))
               for i in range(num_encoders)]
    p = {"head": {"conv2d": conv(rng, k, k, num_bins, b)}}
    p["encoders"] = {
        str(i): {"conv": {"conv2d": conv(rng, k, k, enc_in[i], enc_out[i])},
                 "recurrent_block": cell(rng, 3, enc_out[i], enc_out[i])}
        for i in range(num_encoders)}
    p["resblocks"] = {str(i): resblock(rng, enc_out[-1])
                      for i in range(num_residual_blocks)}
    p["decoders"] = {
        str(i): {"conv2d": conv(rng, k, k, list(reversed(enc_out))[i],
                                list(reversed(enc_in))[i])}
        for i in range(num_encoders)}
    p["pred"] = {"conv2d": conv(rng, 1, 1, b, 1)}
    return {"unetrecurrent": p}
