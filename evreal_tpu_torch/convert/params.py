"""Weight bridge between converted checkpoints and the port's modules.

Converted checkpoints (``.npz`` of flat torch-style keys plus a
``.npz.json`` sidecar with ``{"model_name", "class", "kwargs"}``) hold
arrays in the JAX package's layout (``evreal_tpu/convert/torch_ckpt.py``):
conv weights (and HyperE2VID's 4-D ``compositional_coefficients``) HWIO,
transposed-conv weights HWIO with the spatial flip applied, 2-D weights
(linear layers, attention's packed ``in_proj_weight``) as (I, O), except
HyperE2VID's ``bases`` buffer, which keeps its layout; everything else
(biases, norm statistics) as in torch.

``from_jax_tree`` undoes that into a ``state_dict`` for the port's
modules, whose parameter paths are the same torch module paths the trees
already use; ``to_jax_tree`` is its exact inverse (a model the port
trained is written in the JAX layout, so either package loads it). The
file I/O here is the port's own numpy-only copy of the JAX package's
``save_params`` / ``load_params`` / ``nest``, so both packages read the
same files.
"""

import json
import os

import numpy as np
import torch


def flatten(tree, prefix=""):
    """Nested {'a': {'b': x}} -> flat {'a.b': x}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def nest(flat):
    """Flat {'a.b.c': x} -> nested {'a': {'b': {'c': x}}}."""
    tree = {}
    for key, val in flat.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


# 2-D arrays that are not linear weights (evreal_tpu/convert/torch_ckpt.py:30)
_KEEP_2D = ("bases",)


def to_torch_layout(key, a):
    """One converted array (JAX layout) -> the torch module's layout: the
    inverse of the JAX package's ``convert_tensor``."""
    a = np.asarray(a)
    if a.ndim == 4 and (key.endswith("weight")
                        or key.endswith("compositional_coefficients")):
        if "transposed_conv2d" in key:
            # HWIO with spatial flip -> ConvTranspose2d (I, O, kh, kw)
            return a[::-1, ::-1].transpose(2, 3, 0, 1)
        return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if a.ndim == 2 and not key.endswith(_KEEP_2D):
        return a.T  # linear (I, O) -> (O, I)
    return a


def from_jax_tree(tree):
    """JAX-layout param tree (nested dicts of numpy arrays, or a flat dict)
    -> ``state_dict`` of contiguous float tensors for the port's modules."""
    flat = flatten(tree) if any(isinstance(v, dict) for v in tree.values()) \
        else tree
    return {k: torch.from_numpy(np.ascontiguousarray(to_torch_layout(k, v)))
            for k, v in flat.items()}


def to_jax_layout(key, a):
    """One torch-layout array -> the JAX layout: the inverse of
    ``to_torch_layout`` (the JAX package's ``convert_tensor``)."""
    a = np.asarray(a)
    if a.ndim == 4 and (key.endswith("weight")
                        or key.endswith("compositional_coefficients")):
        if "transposed_conv2d" in key:
            # ConvTranspose2d (I, O, kh, kw) -> HWIO with spatial flip
            return a.transpose(2, 3, 0, 1)[::-1, ::-1]
        return a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if a.ndim == 2 and not key.endswith(_KEEP_2D):
        return a.T  # linear (O, I) -> (I, O)
    return a


def to_jax_tree(state_dict):
    """A module's ``state_dict`` -> nested JAX-layout tree of contiguous
    numpy arrays (the tree ``models/init.py`` makes and converted
    checkpoints hold)."""
    return nest({k: np.ascontiguousarray(to_jax_layout(
        k, v.detach().cpu().numpy())) for k, v in state_dict.items()})


def _sidecar_path(path):
    """'<file>.npz.json' beside the array file, for base or '.npz' paths."""
    s = str(path)
    if not s.endswith(".npz"):
        s += ".npz"
    return s + ".json"


def save_params(path, flat, meta):
    """Write ``flat`` (JAX-layout arrays under torch-style keys) and its
    sidecar; each file goes to a temporary name first and is renamed into
    place, so a reader never finds a truncated file."""
    s = str(path)
    if not s.endswith(".npz"):
        s += ".npz"
    tmp = s + ".tmp.npz"  # np.savez appends .npz unless present
    np.savez(tmp, **flat)
    os.replace(tmp, s)
    side_tmp = _sidecar_path(s) + ".tmp"
    with open(side_tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    os.replace(side_tmp, _sidecar_path(s))


def load_params(path):
    """Converted ``.npz`` -> (nested tree of numpy arrays, meta dict)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    try:
        with open(_sidecar_path(path), encoding="utf-8") as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"missing meta sidecar {_sidecar_path(path)} for {path}: the "
            f"model class and kwargs cannot be recovered") from None
    return nest(flat), meta
