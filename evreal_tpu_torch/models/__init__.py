"""Model registry: reference class name -> the port's model class
(``evreal_tpu/models/__init__.py``). ``build_model`` follows the
reference's constructor conventions (eval.py:124-158): kwargs possibly
nested under ``unet_kwargs`` or ``eitr_kwargs``."""

from evreal_tpu_torch.models.etnet import EITR
from evreal_tpu_torch.models.firenet import FireNet, FireNetLegacy
from evreal_tpu_torch.models.spade import SpadeE2vid
from evreal_tpu_torch.models.unet import E2VIDRecurrent, FlowNet

_REGISTRY = {
    "FireNet": FireNet,
    "FireNet_legacy": FireNetLegacy,
    "E2VIDRecurrent": E2VIDRecurrent,
    "FlowNet": FlowNet,
    "SpadeE2vid": SpadeE2vid,
    "EITR": EITR,
}


def build_model(class_name, kwargs=None, num_encoders=None, state_dict=None):
    """The model of ``class_name``; with ``state_dict`` (torch layout),
    the sizes that the JAX package reads implicitly from the weights
    (ET-Net's layer counts and FFN width, SPADE's hidden width:
    ``shape_kwargs``; HyperE2VID's dynamic-decoder widths, which no
    unet_kwargs may set: ``shape_args``) come from its arrays."""
    kwargs = dict(kwargs or {})
    if "unet_kwargs" in kwargs:
        kwargs = dict(kwargs["unet_kwargs"])
    if "eitr_kwargs" in kwargs:
        kwargs = dict(kwargs["eitr_kwargs"])
    cls = _REGISTRY[class_name]
    args = ()
    if state_dict is not None and hasattr(cls, "shape_kwargs"):
        kwargs.update(cls.shape_kwargs(state_dict))
    if state_dict is not None and hasattr(cls, "shape_args"):
        args = cls.shape_args(state_dict)
    model = cls(*args, **kwargs)
    if num_encoders is not None:
        model.num_encoders = num_encoders
    return model


def build_from_meta(meta, state_dict=None):
    """Build a model from a checkpoint's meta dict (a converted file's
    sidecar or ``convert.checkpoint.load_method_checkpoint``'s)."""
    return build_model(meta["class"], meta.get("kwargs"),
                       meta.get("num_encoders"), state_dict)


def flagship_e2vid_kwargs(num_bins=5):
    """The published E2VID architecture (reference eval.py:134-139, shared
    by the E2VID-family checkpoints)."""
    return dict(num_bins=num_bins, base_num_channels=32, kernel_size=5,
                num_encoders=3, recurrent_block_type="convlstm",
                num_residual_blocks=2, skip_type="sum", norm=None,
                use_upsample_conv=True, final_activation="sigmoid")


def build_flagship_e2vid(seed=0, num_bins=5):
    """(model, params) of the flagship E2VID architecture
    (``evreal_tpu/models/__init__.py:build_flagship_e2vid``): ``params``
    the host numpy tree of ``models.init.init_e2vid`` in the converted
    layout (the JAX function's arrays for the same seed), ``model`` the
    port's module on the CPU with those weights loaded."""
    from evreal_tpu_torch.convert.params import from_jax_tree
    from evreal_tpu_torch.models.init import init_e2vid

    model = build_model("E2VIDRecurrent", flagship_e2vid_kwargs(num_bins))
    params = init_e2vid(seed=seed, num_bins=num_bins, base_num_channels=32,
                        kernel_size=5, num_encoders=3)
    model.load_state_dict(from_jax_tree(params), strict=True)
    return model, params
