"""The port's models (evreal_tpu_torch/models) against the JAX package's:
8-step recurrent rollouts at an odd sensor size (37 x 53, center-padded by
CropParams as the runner pads it), same numpy-made weights and inputs;
atol 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evreal_tpu.convert.torch_ckpt import convert_state_dict, nest
from evreal_tpu.models import build_model as j_build
from evreal_tpu_torch.convert.params import from_jax_tree
from evreal_tpu_torch.models import build_from_meta, build_model
from evreal_tpu_torch.models.init import init_e2vid, init_firenet
from evreal_tpu_torch.ops.pad import CropParams

torch.set_num_threads(1)

ATOL = 1e-4
H, W, STEPS = 37, 53, 8

NARROW_E2VID = dict(num_bins=5, base_num_channels=8, kernel_size=5,
                    num_encoders=3, recurrent_block_type="convlstm",
                    num_residual_blocks=2, skip_type="sum", norm=None,
                    use_upsample_conv=True, final_activation="sigmoid")


def voxels(seed, steps=STEPS, b=5, h=H, w=W):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(steps, 1, b, h, w)).astype(np.float32)
    return v * (rng.uniform(size=v.shape) < 0.3)


def jax_tree_of(model):
    """The port model's weights through the JAX package's checkpoint
    converter: the path a converted reference checkpoint takes."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return nest(convert_state_dict(sd))


def rollout(tmodel, jmodel, params, vox, num_encoders):
    """Both models over the same windows; returns the per-step max abs
    difference of the cropped images."""
    crop = CropParams(W, H, num_encoders)
    ph, pw = crop.padded_shape
    t_state = tmodel.init_state(1, ph, pw)
    j_state = jmodel.init_state(1, ph, pw)
    errs = []
    for v in vox:
        x = crop.pad(torch.from_numpy(v))
        with torch.no_grad():
            t_out, t_state = tmodel(x, t_state)
        j_out, j_state = jmodel.apply(
            params, j_state, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)))
        t_img = crop.crop(t_out["image"]).numpy()[:, 0]
        j_img = np.asarray(j_out["image"])[:, crop.iy0:crop.iy1,
                                           crop.ix0:crop.ix1, 0]
        errs.append(float(np.abs(t_img - j_img).max()))
    return errs


def test_e2vid_rollout_matches_jax():
    params = init_e2vid(seed=0, num_bins=5, base_num_channels=8,
                        kernel_size=5, num_encoders=3, num_residual_blocks=2)
    tmodel = build_model("E2VIDRecurrent", NARROW_E2VID)
    tmodel.load_state_dict(from_jax_tree(params), strict=True)
    jmodel = j_build("E2VIDRecurrent", NARROW_E2VID)
    errs = rollout(tmodel.eval(), jmodel, params, voxels(1), 3)
    assert max(errs) <= ATOL, errs


@pytest.mark.parametrize("variant", [
    dict(recurrent_block_type="convgru", skip_type="concat",
         use_upsample_conv=False, num_encoders=2, kernel_size=3),
    dict(norm="BN", final_activation="none"),
    dict(norm="IN", num_residual_blocks=1)])
def test_e2vid_variants_match_jax(variant):
    kw = {**NARROW_E2VID, **variant}
    torch.manual_seed(0)
    tmodel = build_model("E2VIDRecurrent", kw).eval()
    with torch.no_grad():  # non-trivial running statistics
        for name, buf in tmodel.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    jmodel = j_build("E2VIDRecurrent", kw)
    errs = rollout(tmodel, jmodel, jax_tree_of(tmodel), voxels(2, steps=4),
                   kw["num_encoders"])
    assert max(errs) <= ATOL, errs


def test_firenet_rollout_matches_jax():
    params = init_firenet(seed=3, num_bins=5, base_num_channels=8,
                          kernel_size=3)
    meta = {"class": "FireNet", "kwargs": {"num_bins": 5,
                                           "base_num_channels": 8,
                                           "kernel_size": 3},
            "num_encoders": 0}
    tmodel = build_from_meta(meta)
    tmodel.load_state_dict(from_jax_tree(params), strict=True)
    jmodel = j_build("FireNet", meta["kwargs"], 0)
    errs = rollout(tmodel.eval(), jmodel, params, voxels(4), 0)
    assert max(errs) <= ATOL, errs


def test_odd_size_state_shapes():
    model = build_model("E2VIDRecurrent", NARROW_E2VID)
    state = model.init_state(1, H, W)
    shapes = [tuple(h.shape) for h, _ in state["cells"]]
    assert shapes == [(1, 16, 19, 27), (1, 32, 10, 14), (1, 64, 5, 7)]
    assert tuple(state["prev_recs"].shape) == (1, 1, H, W)


def test_unet_kwargs_are_strict():
    with pytest.raises(TypeError, match="unexpected unet_kwargs"):
        build_model("E2VIDRecurrent", {**NARROW_E2VID, "num_bin": 5})
    nested = build_model("E2VIDRecurrent", {"unet_kwargs": NARROW_E2VID})
    assert nested.num_encoders == 3


# every registry class: (kwargs, sidecar meta extras); the kwargs are what
# the reference checkpoint schemas record
HYPER = dict(NARROW_E2VID, recurrent_block_type="convgru",
             final_activation="none", use_dynamic_decoder=True)
REGISTRY_CASES = {
    "FireNet": ({"base_num_channels": 8}, {"num_encoders": 0}),
    "FireNet_legacy": ({"base_num_channels": 8, "kernel_size": 3}, {}),
    "E2VIDRecurrent": ({"unet_kwargs": HYPER}, {}),
    "FlowNet": (dict(NARROW_E2VID, num_output_channels=3), {}),
    "SpadeE2vid": ({}, {"num_encoders": 3}),
    "EITR": ({"eitr_kwargs": {"num_bins": 5, "norm": None}},
             {"num_encoders": 3}),
}


@pytest.mark.parametrize("cls", sorted(REGISTRY_CASES))
def test_registry_builds_from_kwargs_and_meta(cls):
    """Every class of the JAX package's registry builds from kwargs and
    from a sidecar meta (with and without its arrays), as JAX builds it."""
    kwargs, extra = REGISTRY_CASES[cls]
    model = build_model(cls, kwargs)
    assert type(model).__name__ == {"FireNet_legacy": "FireNetLegacy"}.get(
        cls, cls)
    meta = {"class": cls, "kwargs": kwargs, **extra}
    jmodel = j_build(cls, kwargs, extra.get("num_encoders"))
    for sd in (None, model.state_dict()):
        again = build_from_meta(meta, sd)
        again.load_state_dict(model.state_dict(), strict=True)
        assert again.num_encoders == jmodel.num_encoders
        assert again.num_bins == jmodel.num_bins == 5


@pytest.mark.parametrize("key", ["num_atom", "dynamic_shapes"])
def test_hyper_unet_kwargs_stay_strict(key):
    """A typo'd key, or the dynamic decoder's widths (which only a
    checkpoint's arrays set), in unet_kwargs raise as the reference's
    BaseUNet does."""
    with pytest.raises(TypeError, match="unexpected unet_kwargs"):
        build_model("E2VIDRecurrent", {"unet_kwargs": {**HYPER, key: 6}})
