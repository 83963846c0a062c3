"""The bf16 serving mode (EVREAL_DTYPE=bfloat16) of the models this slice
adds, after tests/test_torch_bf16.py: raw reconstructions of the port in
bf16 against the port in f32 (mean 0.02 / max 0.2, tests/test_bf16_mode.py
:39-40) and against the JAX package in bf16 (mean 1.5e-3 / max 2^-7, the
bound of tests/test_torch_bf16.py), the port pinned to f32 voxel factors
as there; the state and every activation stay bf16 through a step.

ET-Net has no JAX bf16 run to compare with: the JAX package adds its f32
sinusoid table to the bf16 tokens, which promotes the transformer stream
to f32, and the first decoder conv then meets bf16 weights and raises a
TypeError (ROADMAP.md, Queue 3). The port adds the table in the stream's
dtype; its bf16 run is held to the port's f32 run."""

import numpy as np
import pytest
import torch

from evreal_tpu.convert import convert_state_dict, nest
from evreal_tpu.harness import runner as jrunner
from evreal_tpu.models import build_from_meta as j_build_from_meta
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.models import build_from_meta

from .test_torch_bf16 import JAX_BF16_MAX, JAX_BF16_MEAN, within

torch.set_num_threads(1)

H, W, T, CAP = 32, 48, 4, 2048
HYPER = {"num_bins": 5, "base_num_channels": 8, "kernel_size": 5,
         "num_encoders": 3, "recurrent_block_type": "convgru",
         "num_residual_blocks": 1, "skip_type": "sum", "norm": None,
         "use_upsample_conv": True, "use_dynamic_decoder": True}
METHODS = {  # method -> (meta, event norm)
    "FireNet": ({"class": "FireNet_legacy",
                 "kwargs": {"num_bins": 5, "base_num_channels": 8,
                            "kernel_size": 3, "norm": "BN"}}, True),
    "HyperE2VID": ({"class": "E2VIDRecurrent",
                    "kwargs": {"unet_kwargs": HYPER}}, False),
    "SPADE-E2VID": ({"class": "SpadeE2vid", "kwargs": {},
                     "num_encoders": 3}, False),
    "ET-Net": ({"class": "EITR", "kwargs": {"eitr_kwargs": {"num_bins": 5}},
                "num_encoders": 3}, False),
}


def buffers():
    """4 windows of 1500 events (tests/test_bf16_mode.py's)."""
    rng = np.random.default_rng(0)
    bufs = {
        "xs": rng.integers(0, W, (T, CAP)).astype(np.float32),
        "ys": rng.integers(0, H, (T, CAP)).astype(np.float32),
        "ts": np.sort(rng.uniform(0, 0.04, (T, CAP)).astype(np.float32), 1),
        "ps": (rng.integers(0, 2, (T, CAP)) * 2 - 1).astype(np.float32),
        "count": np.full((T,), 1500, np.int32),
    }
    bufs["ts"] -= bufs["ts"][:, :1]
    return bufs


def weights(method):
    """The method's model in f32 with seeded weights and BN statistics."""
    meta, _ = METHODS[method]
    torch.manual_seed(sorted(METHODS).index(method))
    model = build_from_meta(meta)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=g)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=g)
    return model


def port_raw(method):
    runner = trunner.MethodRunner(weights(method),
                                  event_norm=METHODS[method][1],
                                  post_norm="none", height=H, width=W,
                                  num_bins=5, device="cpu", chunk_t=T)
    state, imgs, _ = runner.run(runner.init_state(),
                                runner.upload(buffers()), T)
    return imgs.numpy(), state, runner


def jax_raw(method):
    meta, event_norm = METHODS[method]
    sd = {k: v.numpy() for k, v in weights(method).state_dict().items()}
    runner = jrunner.MethodRunner(j_build_from_meta(meta),
                                  nest(convert_state_dict(sd)),
                                  event_norm=event_norm, post_norm="none",
                                  height=H, width=W, num_bins=5, chunk_t=T)
    _, imgs, _ = runner.run(runner.init_state(), buffers())
    return np.asarray(imgs)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_bf16_tracks_port_f32_and_jax_bf16(method, monkeypatch):
    monkeypatch.delenv("EVREAL_VOXEL_PRECISION", raising=False)
    monkeypatch.setenv("EVREAL_DTYPE", "float32")
    f32 = port_raw(method)[0]
    monkeypatch.setenv("EVREAL_DTYPE", "bfloat16")
    bf16 = port_raw(method)[0]
    assert f32.shape == bf16.shape == (T, H, W)
    assert np.abs(f32 - bf16).max() > 0  # the bf16 mode really ran
    assert within(bf16, f32, 0.02, 0.2)
    if method == "ET-Net":
        with pytest.raises(TypeError, match="same dtypes"):
            jax_raw(method)
        return
    jax_bf16 = jax_raw(method)
    monkeypatch.setenv("EVREAL_VOXEL_PRECISION", "highest")
    assert within(port_raw(method)[0], jax_bf16, JAX_BF16_MEAN, JAX_BF16_MAX)


def leaves(x):
    if isinstance(x, dict):
        return [t for v in x.values() for t in leaves(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    return [x]


@pytest.mark.parametrize("method", sorted(METHODS))
def test_state_and_activations_stay_bf16(method, monkeypatch):
    monkeypatch.setenv("EVREAL_DTYPE", "bfloat16")
    seen = []

    def hook(module, args, out):
        # SPADE's 0-d bool flag rides in the state it returns
        seen.extend((type(module).__name__, t.dtype) for t in leaves(out)
                    if isinstance(t, torch.Tensor)
                    and not (t.dtype == torch.bool and t.ndim == 0))

    runner = port_raw(method)[2]
    for m in runner.model.modules():
        m.register_forward_hook(hook)
    state, _, _ = runner.run(runner.init_state(), runner.upload(buffers()), T)
    assert seen and {d for _, d in seen} == {torch.bfloat16}, set(seen)
    flags = [state.pop("initialized")] if method == "SPADE-E2VID" else []
    assert all(f.dtype == torch.bool and f.ndim == 0 and bool(f)
               for f in flags)
    assert all(t.dtype == torch.bfloat16 for t in leaves(state))
    assert all(v.dtype == torch.bfloat16
               for v in runner.model.state_dict().values())
