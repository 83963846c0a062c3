"""The rest of EVREAL's model zoo in the port (FireNet_legacy, HyperE2VID,
FlowNet, SPADE-E2VID, ET-Net) against the JAX package's models: recurrent
rollouts at an odd sensor size (37 x 53, padded by CropParams as the
runner pads it), the same weights (made by the port's modules from a
seed, BN running statistics randomized, taken through the JAX package's
converter) and the same inputs; atol 1e-4 in f32. Plus the sizes read
from the weights, the Fourier-Bessel bases, SPADE's batch equivariance and
ET-Net's split execution."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evreal_tpu.convert.torch_ckpt import convert_state_dict, nest
from evreal_tpu.models import build_model as j_build
from evreal_tpu_torch.convert.params import from_jax_tree
from evreal_tpu_torch.models import build_model
from evreal_tpu_torch.models.unet import E2VIDRecurrent
from evreal_tpu_torch.ops.pad import CropParams

torch.set_num_threads(1)

ATOL = 1e-4
H, W = 37, 53

NARROW_UNET = dict(num_bins=5, base_num_channels=8, kernel_size=5,
                   num_encoders=3, recurrent_block_type="convgru",
                   num_residual_blocks=1, skip_type="sum", norm=None,
                   use_upsample_conv=True, final_activation="none")
HYPER = dict(NARROW_UNET, use_dynamic_decoder=True)
FIRENET_LEGACY = dict(num_bins=5, base_num_channels=8, kernel_size=3,
                      recurrent_block_type="convgru", num_residual_blocks=2)

# (class, kwargs, steps): FireNet_legacy's recurrent-block rules, the
# dynamic decoder, the fixed-width models at few steps (they are the
# widest; their spatial size is the small one)
ROLLOUTS = {
    "firenet_legacy": ("FireNet_legacy", FIRENET_LEGACY, 8),
    "firenet_legacy_01": ("FireNet_legacy", dict(
        FIRENET_LEGACY, recurrent_blocks={"resblock": [0, 1]}), 6),
    "firenet_legacy_none": ("FireNet_legacy", dict(
        FIRENET_LEGACY, recurrent_blocks={}, norm="BN",
        recurrent_block_type="convlstm"), 4),
    "firenet_legacy_all_k5": ("FireNet_legacy", dict(
        num_bins=5, base_num_channels=8,
        recurrent_blocks={"resblock": [-1]}), 4),
    "hyper": ("E2VIDRecurrent", HYPER, 8),
    "hyper_concat": ("E2VIDRecurrent", dict(HYPER, skip_type="concat",
                                            kernel_size=3), 4),
    "spade": ("SpadeE2vid", {}, 4),
    "etnet": ("EITR", {"eitr_kwargs": {"num_bins": 5, "norm": None}}, 4),
}


def voxels(seed, steps, b=5, h=H, w=W, n=1):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(steps, n, b, h, w)).astype(np.float32)
    return v * (rng.uniform(size=v.shape) < 0.3)


def randomize_running_stats(model, seed):
    """Non-trivial BN statistics, as trained checkpoints carry."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    return model


def make_model(cls, kwargs, seed):
    torch.manual_seed(seed)
    return randomize_running_stats(build_model(cls, kwargs), seed).eval()


def jax_tree_of(model):
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return nest(convert_state_dict(sd))


def through_bridge(cls, kwargs, model):
    """A second port model loaded from the JAX-layout tree (the bridge
    ``from_jax_tree``), built with the sizes its arrays fix."""
    sd = from_jax_tree(jax_tree_of(model))
    other = build_model(cls, kwargs, state_dict=sd)
    other.load_state_dict(sd, strict=True)
    return other.eval()


def rollout(tmodel, jmodel, params, vox, num_encoders):
    """Per-step max abs difference of the cropped images."""
    crop = CropParams(W, H, num_encoders)
    ph, pw = crop.padded_shape
    n = vox.shape[1]
    t_state = tmodel.init_state(n, ph, pw)
    j_state = jmodel.init_state(n, ph, pw)
    j_step = jax.jit(jmodel.apply)  # one compile instead of op by op
    errs = []
    for v in vox:
        x = crop.pad(torch.from_numpy(v))
        with torch.no_grad():
            t_out, t_state = tmodel(x, t_state)
        j_out, j_state = j_step(
            params, j_state, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)))
        t_img = crop.crop(t_out["image"]).numpy()[:, 0]
        j_img = np.asarray(j_out["image"])[:, crop.iy0:crop.iy1,
                                           crop.ix0:crop.ix1, 0]
        errs.append(float(np.abs(t_img - j_img).max()))
    return errs


@pytest.mark.parametrize("case", sorted(ROLLOUTS))
def test_rollout_matches_jax(case):
    cls, kwargs, steps = ROLLOUTS[case]
    seed = sorted(ROLLOUTS).index(case)
    tmodel = through_bridge(cls, kwargs, make_model(cls, kwargs, seed))
    jmodel = j_build(cls, kwargs)
    assert tmodel.num_encoders == jmodel.num_encoders
    errs = rollout(tmodel, jmodel, jax_tree_of(tmodel),
                   voxels(seed, steps), jmodel.num_encoders)
    assert max(errs) <= ATOL, errs


def test_flownet_splits_image_and_flow():
    kw = dict(NARROW_UNET, num_encoders=2, num_output_channels=3)
    tmodel = make_model("FlowNet", kw, 3)
    assert all(k.startswith("unetflow.") for k in tmodel.state_dict())
    jmodel = j_build("FlowNet", kw)
    params = jax_tree_of(tmodel)
    vox = voxels(3, 3, h=32, w=40)
    t_state, j_state = tmodel.init_state(1, 32, 40), jmodel.init_state(1, 32,
                                                                        40)
    assert tuple(t_state["prev_recs"].shape) == (1, 1, 32, 40)
    j_step = jax.jit(jmodel.apply)
    for v in vox:
        with torch.no_grad():
            t_out, t_state = tmodel(torch.from_numpy(v), t_state)
        j_out, j_state = j_step(params, j_state,
                                jnp.asarray(v.transpose(0, 2, 3, 1)))
        assert set(t_out) == set(j_out) == {"image", "flow"}
        assert tuple(t_out["flow"].shape) == (1, 2, 32, 40)
        for k in t_out:
            np.testing.assert_allclose(
                t_out[k].numpy(),
                np.asarray(j_out[k]).transpose(0, 3, 1, 2), atol=ATOL)


@pytest.mark.parametrize("ks,nb", [(3, 6), (5, 6), (5, 4), (7, 6)])
def test_bases_list_matches_jax(ks, nb):
    from evreal_tpu.models.hyper import bases_list as j_bases
    from evreal_tpu_torch.models.hyper import bases_list

    got, want = bases_list(ks, nb), j_bases(ks, nb)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


def test_spade_batch_equivariance():
    """Two lanes in one batch equal each lane alone: the first frame's
    min/max normalization reduces per sample."""
    model = make_model("SpadeE2vid", {}, 8)
    rng = np.random.default_rng(8)
    both = torch.from_numpy(np.concatenate([
        rng.normal(0, 1, (1, 5, 32, 40)),
        rng.normal(0, 10, (1, 5, 32, 40))]).astype(np.float32))

    def run(x, steps=2):
        st = model.init_state(x.shape[0], 32, 40)
        outs = []
        with torch.no_grad():
            for _ in range(steps):
                out, st = model(x, st)
                outs.append(out["image"])
        assert st["initialized"].dtype == torch.bool
        return outs

    batch, lane0, lane1 = run(both), run(both[:1]), run(both[1:])
    for t in range(2):
        torch.testing.assert_close(batch[t][:1], lane0[t], atol=1e-5,
                                   rtol=0)
        torch.testing.assert_close(batch[t][1:], lane1[t], atol=1e-5,
                                   rtol=0)


def test_etnet_split_execution_matches_forward():
    """The recurrent prefix window by window, then the state-free suffix
    over all windows at once, equals the per-window forward."""
    model = make_model("EITR", {"num_bins": 5}, 11)
    vox = torch.from_numpy(voxels(12, 4, h=16, w=24)[:, 0])
    with torch.no_grad():
        st = model.init_state(1, 16, 24)
        per_frame = []
        for v in vox:
            out, st = model(v[None], st)
            per_frame.append(out["image"][0])
        st2, feats = model.init_state(1, 16, 24), []
        for v in vox:
            f, st2 = model.encode_recurrent(v[None], st2)
            feats.append(f)
        batched = model.decode_batched(
            tuple(torch.cat(parts) for parts in zip(*feats)))["image"]
    torch.testing.assert_close(batched, torch.stack(per_frame), atol=1e-5,
                               rtol=0)
    for (h1, c1), (h2, c2) in zip(st, st2):
        torch.testing.assert_close(h1, h2, atol=1e-6, rtol=0)
        torch.testing.assert_close(c1, c2, atol=1e-6, rtol=0)


def test_sizes_come_from_the_weights():
    """ET-Net's layer counts, FFN width and head width, SPADE's hidden
    width and the dynamic decoder's widths are read from the arrays."""
    torch.manual_seed(0)
    et = build_model("EITR", {"base_num_channels": 16,
                              "num_encoder_layers": 1,
                              "num_decoder_layers": 2,
                              "dim_feedforward": 64})
    got = build_model("EITR", {}, state_dict=et.state_dict())
    assert got.state_dict().keys() == et.state_dict().keys()
    assert {k: v.shape for k, v in got.state_dict().items()} == \
        {k: v.shape for k, v in et.state_dict().items()}
    sp = build_model("SpadeE2vid", {"spade_hidden": 16})
    assert build_model("SpadeE2vid", {}, state_dict=sp.state_dict()) \
        .up1.norm.mlp_beta.in_channels == 16
    shapes = dict(context_channels=8, context_kernel=5, atom_hidden=12,
                  atom_kernel=1, num_bases=4)
    hy = E2VIDRecurrent(shapes, **HYPER)
    again = build_model("E2VIDRecurrent", HYPER, state_dict=hy.state_dict())
    again.load_state_dict(hy.state_dict(), strict=True)


@pytest.mark.parametrize("case", ["etnet", "firenet_legacy", "hyper",
                                  "spade"])
def test_lockstep_matches_single(case):
    """Two lanes through the lockstep runner, one of them ending early
    (its last windows hold no events), equal each lane run alone; the
    state trees (SPADE's 0-d flag, ET-Net's list of LSTM states) carry
    through."""
    from evreal_tpu_torch.harness.batched import BatchedRunner
    from evreal_tpu_torch.harness.runner import MethodRunner

    cls, kwargs, _ = ROLLOUTS[case]
    model = make_model(cls, kwargs, 5)
    t, cap = 3, 600
    rng = np.random.default_rng(5)
    bufs = {"xs": rng.integers(0, W, (2, t, cap)).astype(np.float32),
            "ys": rng.integers(0, H, (2, t, cap)).astype(np.float32),
            "ts": np.sort(rng.uniform(0, 0.04, (2, t, cap)), -1).astype(
                np.float32),
            "ps": (rng.integers(0, 2, (2, t, cap)) * 2 - 1).astype(
                np.float32),
            "count": np.array([[cap, 500, 400], [cap, 0, 0]], np.int32)}
    args = dict(event_norm=False, post_norm="none", height=H, width=W,
                num_bins=5, device="cpu", chunk_t=t)
    lock = BatchedRunner(model, n=2, **args)
    state, imgs, _ = lock.run(lock.init_state(), lock.upload(bufs), t)
    single = MethodRunner(model, **args)
    for j in range(2):
        _, want, _ = single.run(single.init_state(), single.upload(
            {k: v[j] for k, v in bufs.items()}), t)
        torch.testing.assert_close(imgs[j], want, atol=1e-5, rtol=0)
    if case == "spade":
        assert state["initialized"].dtype == torch.bool
        assert state["initialized"].ndim == 0
    if case == "etnet":
        assert [tuple(h.shape[:2]) for h, _ in state] == [
            (2, 64), (2, 128), (2, 256)]


@pytest.mark.parametrize("op,size", [
    ("resize_bilinear", (9, 13)), ("resize_bilinear", (74, 106)),
    ("resize_nearest", (15, 20)), ("resize_nearest", (37, 53)),
    ("unfold", 5), ("pixel_shuffle", 2)])
def test_layers_match_jax(op, size):
    """The layers the new models add, against the JAX package's on NHWC:
    bilinear down and up by a given size, nearest by the JAX index rule
    at a non-integer ratio and at equal sizes, torch-ordered patches,
    pixel shuffle."""
    import torch.nn.functional as F

    from evreal_tpu.nn import layers as jl
    from evreal_tpu_torch.nn import layers as tl

    x = np.random.default_rng(0).normal(size=(2, 8, H, W)).astype(
        np.float32)
    t, j = torch.from_numpy(x), jnp.asarray(x.transpose(0, 2, 3, 1))
    if op == "unfold":
        got, want = tl.unfold(t, size, size // 2), jl.unfold(j, size, 1,
                                                             size // 2)
    elif op == "pixel_shuffle":
        got, want = F.pixel_shuffle(t, size), jl.pixel_shuffle(j, size)
    else:
        got, want = getattr(tl, op)(t, *size), getattr(jl, op)(j, *size)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-6, rtol=0)
