"""The weight bridge (evreal_tpu_torch/convert/params.py): converted
checkpoints (JAX layout) round-trip through save/load and into the port's
modules, and a torch state_dict taken through the JAX package's converter
comes back unchanged."""

import json

import numpy as np
import pytest
import torch

from evreal_tpu.convert.torch_ckpt import convert_state_dict
from evreal_tpu.convert.torch_ckpt import load_params as j_load_params
from evreal_tpu_torch.convert.params import (
    flatten,
    from_jax_tree,
    load_params,
    nest,
    save_params,
)
from evreal_tpu_torch.models import build_from_meta, build_model
from evreal_tpu_torch.models.init import init_e2vid, init_firenet

torch.set_num_threads(1)

E2VID_META = {"class": "E2VIDRecurrent", "model_name": "E2VID",
              "kwargs": {"num_bins": 5, "base_num_channels": 8,
                         "kernel_size": 3, "num_encoders": 2,
                         "num_residual_blocks": 1,
                         "recurrent_block_type": "convlstm",
                         "final_activation": "sigmoid"}}


def test_save_load_round_trip_readable_by_both_packages(tmp_path):
    tree = init_e2vid(seed=1, base_num_channels=8, kernel_size=3,
                      num_encoders=2, num_residual_blocks=1)
    path = tmp_path / "model"  # base path: .npz is appended
    save_params(path, flatten(tree), E2VID_META)
    assert (tmp_path / "model.npz.json").exists()
    got, meta = load_params(tmp_path / "model.npz")
    assert meta == E2VID_META
    assert flatten(got).keys() == flatten(tree).keys()
    for k, v in flatten(tree).items():
        np.testing.assert_array_equal(flatten(got)[k], v)
    j_tree, j_meta = j_load_params(str(tmp_path / "model.npz"))
    assert j_meta == E2VID_META
    np.testing.assert_array_equal(
        np.asarray(j_tree["unetrecurrent"]["head"]["conv2d"]["weight"]),
        tree["unetrecurrent"]["head"]["conv2d"]["weight"])
    model = build_from_meta(meta)
    model.load_state_dict(from_jax_tree(got), strict=True)


def test_missing_sidecar_raises(tmp_path):
    np.savez(tmp_path / "x.npz", a=np.zeros(2))
    with pytest.raises(FileNotFoundError, match="sidecar"):
        load_params(tmp_path / "x.npz")


def test_layouts():
    w = np.arange(3 * 5 * 2 * 4, dtype=np.float32).reshape(3, 5, 2, 4)
    sd = from_jax_tree({"a": {"conv2d": {"weight": w}},
                        "b": {"transposed_conv2d": {"weight": w}},
                        "c": {"bias": np.ones(3, np.float32)}})
    np.testing.assert_array_equal(sd["a.conv2d.weight"].numpy(),
                                  w.transpose(3, 2, 0, 1))  # HWIO -> OIHW
    np.testing.assert_array_equal(sd["b.transposed_conv2d.weight"].numpy(),
                                  w[::-1, ::-1].transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(sd["c.bias"].numpy(), np.ones(3))
    lin = np.arange(6, dtype=np.float32).reshape(2, 3)
    sd2 = from_jax_tree({"l": {"weight": lin}, "d": {"bases": lin},
                         "h": {"compositional_coefficients": w}})
    np.testing.assert_array_equal(sd2["l.weight"].numpy(), lin.T)  # (I, O)
    np.testing.assert_array_equal(sd2["d.bases"].numpy(), lin)
    np.testing.assert_array_equal(sd2["h.compositional_coefficients"]
                                  .numpy(), w.transpose(3, 2, 0, 1))
    assert all(v.is_contiguous() for v in sd.values())
    assert nest({"x.y": 1, "x.z": 2}) == {"x": {"y": 1, "z": 2}}


@pytest.mark.parametrize("kwargs", [
    E2VID_META["kwargs"],
    {**E2VID_META["kwargs"], "use_upsample_conv": False, "norm": "BN",
     "recurrent_block_type": "convgru", "skip_type": "concat"}])
def test_state_dict_through_jax_converter_and_back(kwargs):
    """state_dict -> evreal_tpu.convert (torch layout to JAX layout) ->
    from_jax_tree: the identity, for conv, transposed-conv and norm keys."""
    torch.manual_seed(0)
    model = build_model("E2VIDRecurrent", kwargs)
    sd = model.state_dict()
    back = from_jax_tree(nest(convert_state_dict(sd)))
    assert back.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


def test_firenet_tree_loads_strictly():
    tree = init_firenet(seed=2, base_num_channels=8)
    model = build_model("FireNet", {"base_num_channels": 8})
    missing = model.load_state_dict(from_jax_tree(tree), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    meta = json.loads(json.dumps({"class": "FireNet", "kwargs": {}}))
    assert build_from_meta(meta).base == 16


@pytest.mark.parametrize("cls,kwargs", [
    ("E2VIDRecurrent", {**E2VID_META["kwargs"], "num_encoders": 3,
                        "use_dynamic_decoder": True}),
    ("EITR", {"num_encoder_layers": 1, "num_decoder_layers": 1,
              "dim_feedforward": 16}),
    ("SpadeE2vid", {}),
    ("FireNet_legacy", {"base_num_channels": 8, "norm": "BN"})])
def test_zoo_state_dicts_through_jax_converter_and_back(cls, kwargs):
    """The layouts of the other models: linear and packed attention
    weights (I, O), HyperE2VID's compositional coefficients (HWIO) and its
    ``bases`` buffer (kept) come back unchanged."""
    torch.manual_seed(1)
    sd = build_model(cls, kwargs).state_dict()
    back = from_jax_tree(nest(convert_state_dict(sd)))
    assert back.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
        assert back[k].is_contiguous()
