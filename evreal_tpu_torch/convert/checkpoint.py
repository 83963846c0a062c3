"""Reference ``.pth`` checkpoints in the four schemas of EVREAL's eval.py
(:124-158), read straight into a torch ``state_dict``
(``evreal_tpu/convert/torch_ckpt.py:143-185`` reads them into the JAX
layout):

1. SPADE-E2VID: the checkpoint *is* the state_dict;
2. SSL-E2VID: a raw state_dict, the architecture hard-coded;
3. E2VID: ``ckpt['model']`` holds the UNet kwargs; FireNet:
   ``ckpt['config']['model']``;
4. E2VID+, FireNet+, ET-Net, HyperE2VID: ``ckpt['config']`` is a pickled
   ``parse_config.ConfigParser`` whose ``arch`` names class and kwargs.

The arrays keep torch's layout; ``num_batches_tracked`` is dropped as the
JAX package's converter drops it. ``save_method_checkpoint`` writes a
model's weights in its method's schema (for tests and the smoke run, which
have no published checkpoints).
"""

import sys
import types

import torch

SSL_E2VID_KWARGS = {"base_num_channels": 32, "kernel_size": 5,
                    "num_bins": 5, "num_encoders": 3,
                    "recurrent_block_type": "convlstm",
                    "num_residual_blocks": 2, "skip_type": "sum",
                    "norm": None, "use_upsample_conv": True}


def install_parse_config_shim():
    """The checkpoints pickle ``parse_config.ConfigParser`` instances
    (reference parse_config.py:1-23); a minimal stand-in module lets them
    unpickle, and lets ``save_method_checkpoint`` pickle one."""
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


def load_method_checkpoint(model_name, checkpoint_path):
    """One reference checkpoint -> (torch-layout ``state_dict``, meta):
    meta carries the class name, constructor kwargs and, where eval.py
    forces one, ``num_encoders``, as the JAX package's loader gives it."""
    install_parse_config_shim()
    ckpt = torch.load(checkpoint_path, map_location="cpu",
                      weights_only=False)

    if model_name == "SPADE-E2VID":
        state_dict = ckpt
        meta = {"class": "SpadeE2vid", "kwargs": {}, "num_encoders": 3}
    elif model_name == "SSL-E2VID":
        state_dict = ckpt
        meta = {"class": "E2VIDRecurrent", "kwargs": dict(SSL_E2VID_KWARGS)}
    elif model_name == "E2VID":
        kwargs = dict(ckpt["model"])
        kwargs["final_activation"] = "sigmoid"
        state_dict = ckpt["state_dict"]
        meta = {"class": "E2VIDRecurrent", "kwargs": kwargs}
    elif model_name == "FireNet":
        kwargs = dict(ckpt["config"]["model"])
        kwargs["final_activation"] = ""
        state_dict = ckpt["state_dict"]
        meta = {"class": "FireNet_legacy", "kwargs": kwargs}
    else:
        arch = ckpt["config"]["arch"]
        state_dict = ckpt["state_dict"]
        meta = {"class": arch["type"], "kwargs": dict(arch.get("args", {}))}
        if model_name == "ET-Net":
            meta["num_encoders"] = 3
        elif model_name == "FireNet+":
            meta["num_encoders"] = 0

    meta["model_name"] = model_name
    return ({k: v for k, v in state_dict.items()
             if not k.endswith("num_batches_tracked")}, meta)


def save_method_checkpoint(path, model_name, model, kwargs=None):
    """Write ``model``'s weights as ``model_name``'s reference checkpoint:
    ``kwargs`` are the constructor kwargs its schema records (unwrapped;
    ignored by the two schemas that record none). Every norm with running
    statistics gets the ``num_batches_tracked`` counter torch saves."""
    sd = {}
    for k, v in model.state_dict().items():
        sd[k] = v
        if k.endswith("running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.int64)
    kwargs = dict(kwargs or {})
    if model_name in ("SPADE-E2VID", "SSL-E2VID"):
        obj = sd
    elif model_name == "E2VID":
        obj = {"model": kwargs, "state_dict": sd}
    elif model_name == "FireNet":
        obj = {"config": {"model": kwargs}, "state_dict": sd}
    else:
        args = {"ET-Net": {"eitr_kwargs": kwargs}, "FireNet+": kwargs}.get(
            model_name, {"unet_kwargs": kwargs})
        config = install_parse_config_shim().ConfigParser()
        config._config = {"arch": {"type": type(model).__name__,
                                   "args": args}}
        obj = {"config": config, "state_dict": sd}
    torch.save(obj, path)
