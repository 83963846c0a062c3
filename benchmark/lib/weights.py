"""Weights from the seed, made on the device in a few large calls, and the
files the program loads them from: a method's ``.pth`` in its reference
schema (a frozen copy of the two schemas of
``evreal_tpu_torch/convert/checkpoint.py:save_method_checkpoint`` that the
configurations use) and LPIPS's ``.npz`` at AlexNet's widths, as
``tools/convert_lpips.py`` writes it. The reference is handed the same
tensors."""

import sys
import types

import numpy as np
import torch

from benchmark.lib.scene import generator

# AlexNet's convolutions as LPIPS taps them: (features index, in, out, k)
LPIPS_CONVS = ((0, 3, 64, 11), (3, 64, 192, 5), (6, 192, 384, 3),
               (8, 384, 256, 3), (10, 256, 256, 3))


def fan_in(shapes, name):
    """The fan-in of the layer a parameter belongs to: its own for a
    weight, its sibling weight's for a bias."""
    shape = shapes.get(name) if len(shapes[name]) >= 2 else shapes.get(
        name[:-len("bias")] + "weight")
    return int(np.prod(shape[1:])) if shape is not None else 1


def draw(shapes, init, device, seed):
    """{name: tensor} of ``shapes`` on ``device``: every weight and bias
    uniform in +-1/sqrt(fan_in) (torch's default bound), drawn as one
    flat tensor, then the constants of ``init["set"]`` ({name suffix:
    value}) written over the parameters whose name ends with it."""
    names = list(shapes)
    sizes = [int(np.prod(shapes[n])) for n in names]
    bounds = torch.tensor([fan_in(shapes, n) ** -0.5 for n in names],
                          device=device)
    flat = torch.rand(sum(sizes), generator=generator(device, seed, 1 << 20),
                      device=device) * 2 - 1
    flat *= torch.repeat_interleave(bounds, torch.tensor(sizes,
                                                         device=device))
    out = {n: t.view(shapes[n]) for n, t in zip(names, flat.split(sizes))}
    for suffix, value in init.get("set", {}).items():
        for n in names:
            if n.endswith(suffix):
                out[n].fill_(float(value))
    return out


def install_parse_config_shim():
    """The ``parse_config.ConfigParser`` stand-in the reference schema
    pickles (a frozen copy of the program's shim, which reuses this one
    when it finds it)."""
    if "parse_config" in sys.modules:
        return sys.modules["parse_config"]
    mod = types.ModuleType("parse_config")

    class ConfigParser:
        def __init__(self, *a, **k):
            self._config = {}

        def __setstate__(self, state):
            self.__dict__.update(state)

        def __getitem__(self, name):
            return self._config[name]

    ConfigParser.__module__ = "parse_config"
    ConfigParser.__qualname__ = "ConfigParser"
    mod.ConfigParser = ConfigParser
    sys.modules["parse_config"] = mod
    return mod


def save_pth(path, config, state_dict):
    """The method's reference checkpoint: ``{"model": kwargs,
    "state_dict"}`` for the ``e2vid`` schema, ``{"config": ConfigParser
    with arch {type, args}, "state_dict"}`` for the ``parse_config``
    schema."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    kwargs = dict(config["kwargs"])
    if config["schema"] == "e2vid":
        obj = {"model": kwargs, "state_dict": sd}
    elif config["schema"] == "parse_config":
        parsed = install_parse_config_shim().ConfigParser()
        parsed._config = {"arch": {"type": config["class"], "args": kwargs}}
        obj = {"config": parsed, "state_dict": sd}
    else:
        raise ValueError(f"unknown checkpoint schema {config['schema']!r}")
    torch.save(obj, path)


def lpips_weights(device, seed):
    """{name: OIHW tensor} of LPIPS at AlexNet's widths from the seed:
    He-scaled convolutions, small biases, non-negative ``lin`` heads."""
    gen = generator(device, seed, 1 << 21)
    w = {}
    for i, (idx, cin, cout, k) in enumerate(LPIPS_CONVS):
        w[f"features.{idx}.weight"] = torch.randn(
            (cout, cin, k, k), generator=gen, device=device) * (
                2.0 / (cin * k * k)) ** 0.5
        w[f"features.{idx}.bias"] = torch.randn(
            (cout,), generator=gen, device=device) * 0.01
        w[f"lin.{i}.weight"] = torch.randn(
            (1, cout, 1, 1), generator=gen, device=device).abs() * 0.1
    return w


def save_lpips(path, weights):
    """``weights`` as ``tools/convert_lpips.py`` writes them: every 4-D
    array HWIO."""
    np.savez(path, **{k: (v.permute(2, 3, 1, 0) if v.ndim == 4 else v)
                      .float().cpu().numpy() for k, v in weights.items()})
