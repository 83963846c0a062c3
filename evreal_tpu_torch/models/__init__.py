"""Model registry: reference class name -> the port's model class
(``evreal_tpu/models/__init__.py``), restricted to the classes ported so
far. ``build_model`` follows the reference's constructor conventions
(eval.py:124-158): kwargs possibly nested under ``unet_kwargs``."""

from evreal_tpu_torch.models.firenet import FireNet
from evreal_tpu_torch.models.unet import E2VIDRecurrent

_REGISTRY = {"FireNet": FireNet, "E2VIDRecurrent": E2VIDRecurrent}


def build_model(class_name, kwargs=None, num_encoders=None):
    kwargs = dict(kwargs or {})
    if "unet_kwargs" in kwargs:
        kwargs = dict(kwargs["unet_kwargs"])
    if class_name not in _REGISTRY:
        raise NotImplementedError(
            f"model class {class_name!r} is not ported yet (ported: "
            f"{sorted(_REGISTRY)}); see ROADMAP.md, Queue 1")
    model = _REGISTRY[class_name](**kwargs)
    if num_encoders is not None:
        model.num_encoders = num_encoders
    return model


def build_from_meta(meta):
    """Build a model from a converted checkpoint's sidecar meta dict."""
    return build_model(meta["class"], meta.get("kwargs"),
                       meta.get("num_encoders"))


def flagship_e2vid_kwargs(num_bins=5):
    """The published E2VID architecture (reference eval.py:134-139, shared
    by the E2VID-family checkpoints)."""
    return dict(num_bins=num_bins, base_num_channels=32, kernel_size=5,
                num_encoders=3, recurrent_block_type="convlstm",
                num_residual_blocks=2, skip_type="sum", norm=None,
                use_upsample_conv=True, final_activation="sigmoid")
