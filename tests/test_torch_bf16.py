"""The port's bf16 serving mode (EVREAL_DTYPE=bfloat16) against the JAX
package's (tests/test_bf16_mode.py is the template): raw reconstructions,
before any post-norm, of narrow random-init E2VID and FireNet in bf16
against the port in f32, within mean 0.02 and max 0.2
(tests/test_bf16_mode.py:39-40), and against the JAX package in bf16 at a
bound set from readings; the weights' bf16 bits against ``cast_params``;
the state and every activation staying bf16 through a step; and the
dtype / voxel-precision switches against the JAX package's parsing and
errors.

On the CPU the JAX package voxelizes with ``scatter`` and keeps f32 voxel
factors, while the port follows the Pallas kernel's ``supported_precisions``
and takes bf16 factors in bf16 mode; the comparison with the JAX package's
bf16 run pins the port to f32 factors (EVREAL_VOXEL_PRECISION=highest), so
both sides see the same voxels and the same bf16 weights."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evreal_tpu.harness import runner as jrunner
from evreal_tpu.models import build_from_meta as j_build_from_meta
from evreal_tpu.ops.voxelize import voxelize_scatter
from evreal_tpu_torch.convert.params import flatten, from_jax_tree
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.models import build_from_meta
from evreal_tpu_torch.models.init import init_e2vid, init_firenet
from evreal_tpu_torch.ops import voxelize as tvox

torch.set_num_threads(1)

H, W, T, CAP = 32, 48, 4, 2048
METHODS = {
    "FireNet": ({"class": "FireNet", "num_encoders": 0,
                 "kwargs": {"num_bins": 5, "base_num_channels": 8,
                            "kernel_size": 3}},
                lambda: init_firenet(seed=1, base_num_channels=8), False),
    "E2VID": ({"class": "E2VIDRecurrent",
               "kwargs": {"num_bins": 5, "base_num_channels": 8,
                          "kernel_size": 3, "num_encoders": 2,
                          "recurrent_block_type": "convlstm",
                          "num_residual_blocks": 1, "skip_type": "sum",
                          "norm": None, "use_upsample_conv": True,
                          "final_activation": "sigmoid"}},
              lambda: init_e2vid(seed=0, base_num_channels=8, kernel_size=3,
                                 num_encoders=2, num_residual_blocks=1),
              True),
}


def buffers():
    """The windows of tests/test_bf16_mode.py: 4 x 1500 events."""
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


def port_runner(method):
    meta, make, event_norm = METHODS[method]
    model = build_from_meta(meta)
    model.load_state_dict(from_jax_tree(make()), strict=True)
    return trunner.MethodRunner(model, event_norm=event_norm,
                                post_norm="none", height=H, width=W,
                                num_bins=5, device="cpu", chunk_t=T)


def port_raw(method):
    """Raw reconstructions (post-norm 'none') and the final state."""
    runner = port_runner(method)
    state, imgs, _ = runner.run(runner.init_state(),
                                runner.upload(buffers()), T)
    return imgs.numpy(), state


def jax_raw(method):
    meta, make, event_norm = METHODS[method]
    runner = jrunner.MethodRunner(j_build_from_meta(meta), make(),
                                  event_norm=event_norm, post_norm="none",
                                  height=H, width=W, num_bins=5, chunk_t=T)
    _, imgs, _ = runner.run(runner.init_state(), buffers())
    return np.asarray(imgs)


# Port bf16 against JAX bf16, the same weights and voxels: the outputs lie
# in (0, 1), where one bf16 step is at most 2^-8. Readings on the CPU:
# mean 7.3e-4 / max 3.9e-3 (E2VID), 1.1e-4 / 9.8e-4 (FireNet), one step
# at the top of each output's range (XLA keeps f32 between fused
# elementwise operations, PyTorch rounds after each); the bound is twice
# the larger reading.
JAX_BF16_MEAN, JAX_BF16_MAX = 1.5e-3, 2 ** -7


def within(a, b, mean, max_):
    d = np.abs(a - b)
    return d.mean() < mean and d.max() < max_


@pytest.mark.parametrize("method", sorted(METHODS))
def test_bf16_tracks_jax_bf16_and_port_f32(method, monkeypatch):
    monkeypatch.delenv("EVREAL_VOXEL_PRECISION", raising=False)
    monkeypatch.setenv("EVREAL_DTYPE", "float32")
    f32, _ = port_raw(method)
    monkeypatch.setenv("EVREAL_DTYPE", "bfloat16")
    bf16, _ = port_raw(method)
    jax_bf16 = jax_raw(method)
    monkeypatch.setenv("EVREAL_VOXEL_PRECISION", "highest")
    bf16_f32_voxels, _ = port_raw(method)
    assert f32.dtype == bf16.dtype == np.float32
    assert f32.shape == bf16.shape == jax_bf16.shape == (T, H, W)
    assert np.abs(f32 - bf16).max() > 0  # the bf16 mode really ran
    assert within(bf16, f32, 0.02, 0.2)
    assert within(bf16_f32_voxels, jax_bf16, JAX_BF16_MEAN, JAX_BF16_MAX)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_state_and_activations_stay_bf16(method, monkeypatch):
    """Nothing promotes to f32 inside a bf16 step (on the card, a bf16
    weight against an f32 state raises in cuDNN)."""
    monkeypatch.setenv("EVREAL_DTYPE", "bfloat16")
    runner = port_runner(method)
    seen = []

    def hook(module, args, out):
        outs = out if isinstance(out, tuple) else (out,)
        for o in outs:
            for t in (o if isinstance(o, (tuple, list)) else (o,)):
                if isinstance(t, torch.Tensor):
                    seen.append((type(module).__name__, t.dtype))

    for m in runner.model.modules():
        m.register_forward_hook(hook)
    state, _, _ = runner.run(runner.init_state(), runner.upload(buffers()), T)
    assert seen and {d for _, d in seen} == {torch.bfloat16}, set(seen)
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        else:
            leaves.append(x)

    walk(state)
    assert leaves and all(t.dtype == torch.bfloat16 for t in leaves)
    if method == "E2VID":
        assert state["prev_recs"].dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16
               for p in runner.model.state_dict().values())


@pytest.mark.parametrize("method", sorted(METHODS))
def test_bf16_weights_bit_equal_cast_params(method):
    meta, make, _ = METHODS[method]
    tree = make()
    model = build_from_meta(meta)
    model.load_state_dict(from_jax_tree(tree), strict=True)
    got = trunner.cast_model(model, torch.bfloat16).state_dict()
    assert trunner.cast_model(model, torch.float32) is model
    cast = jrunner.cast_params(tree, jnp.bfloat16)
    # the same layout transform on the bf16 bits
    bits = from_jax_tree({k: np.asarray(v).view(np.uint16)
                          for k, v in flatten(cast).items()})
    assert got.keys() == bits.keys()
    for k, v in got.items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            v.view(torch.int16).numpy().view(np.uint16), bits[k].numpy(),
            err_msg=k)


@pytest.mark.parametrize("env", [None, "float32", "bfloat16", "bf16",
                                 "float16"])
def test_compute_dtype_parses_like_jax(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("EVREAL_DTYPE", raising=False)
    else:
        monkeypatch.setenv("EVREAL_DTYPE", env)
    want = jrunner.compute_dtype()
    got = trunner.compute_dtype()
    assert (got == torch.bfloat16) == (want == jnp.bfloat16)
    assert got in (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("env", [None, "highest", "default", "high", "low"])
@pytest.mark.parametrize("bf16", [False, True])
def test_voxel_precision_choice_like_jax(env, bf16, monkeypatch):
    """The port's voxelizer takes K2's precisions (highest, default): a
    "high" pin cannot be honored and raises, as for the Pallas kernel. The
    JAX package's message names its EVREAL_VOXELIZE impl, which the port
    does not have; everything up to the reason is the same."""
    if env is None:
        monkeypatch.delenv("EVREAL_VOXEL_PRECISION", raising=False)
    else:
        monkeypatch.setenv("EVREAL_VOXEL_PRECISION", env)
    supported = ("highest", "default")
    assert tvox.voxelize_windows.supported_precisions == supported
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    try:
        want = jrunner.voxel_precision_choice(supported, jdt)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            trunner.voxel_precision_choice(tdt)
        assert str(got.value).split(":")[0] == str(exc).split(":")[0]
        if env == "high":
            assert "cannot honor" in str(exc)
            assert "cannot honor it (supports: highest, default)" in str(
                got.value)
            with pytest.raises(ValueError, match="cannot honor"):
                trunner.make_voxel_stage(5, (H, W), False, tdt)
        else:
            assert str(got.value) == str(exc)
        return
    assert trunner.voxel_precision_choice(tdt) == want
    assert want == (env or ("default" if bf16 else None))


def test_stage_casts_after_the_event_norm(monkeypatch):
    """Binning and the event norm stay f32; the cast to bf16 comes after
    the norm (evreal_tpu/harness/runner.py:162-170)."""
    monkeypatch.delenv("EVREAL_VOXEL_PRECISION", raising=False)
    jstage = jrunner.make_voxel_stage(voxelize_scatter, 5, (H, W), True,
                                      out_dtype=jnp.bfloat16)
    want = np.asarray(jstage(buffers()).astype(jnp.float32))
    bufs = {k: torch.from_numpy(v) for k, v in buffers().items()}
    f32 = trunner.make_voxel_stage(5, (H, W), True, torch.float32)(bufs)
    # pin f32 weights, as the JAX package's scatter stage has them
    monkeypatch.setenv("EVREAL_VOXEL_PRECISION", "highest")
    bf16 = trunner.make_voxel_stage(5, (H, W), True, torch.bfloat16)(bufs)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    got = bf16.float().numpy().transpose(0, 2, 3, 1)
    # f32 binning may differ by ulps, which can move a bf16 rounding by one
    # step (2^-8 relative)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
