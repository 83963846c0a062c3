"""The port's training (``evreal_tpu_torch/train.py``, ``train_cli.sample_batch``)
against the JAX package's (``evreal_tpu/train.py``, ``train_cli.py``) on the
CPU, at small widths (FireNet base 8; E2VIDRecurrent base 8 with one
ConvLSTM or two ConvGRU encoders), the same numpy-made weights and inputs:

* ``sequence_loss``: the loss within 1e-5 relative and every gradient
  within ``1e-5 * max|g| + 1e-4 * |g|`` of ``jax.value_and_grad`` (JAX
  gradients in HWIO, compared through ``to_torch_layout``), for mse, bce,
  lpips and mse+lpips, with and without a mask, remat on and off; remat
  on and off give identical gradients in the port;
* ``build_optimizer`` against optax on 12 seeded gradient trees: params
  within 1e-6 after each update;
* three ``make_train_step`` steps of FireNet: losses within 1e-5 relative,
  params within 3e-4 at lr 1e-3 (Adam's sign flips where a gradient is
  near 0, ``tests/test_train_parallel.py``'s bound for the same effect);
* the meshless cases of ``tests/test_train_parallel.py``, and
  ``sample_batch`` against the JAX CLI's on a synthetic sequence."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from evreal_tpu.models import build_model as j_build
from evreal_tpu.models.init import init_e2vid, init_firenet
from evreal_tpu.train import build_optimizer as j_build_optimizer
from evreal_tpu.train import make_train_step as j_make_train_step
from evreal_tpu.train import sequence_loss as j_sequence_loss
from evreal_tpu_torch import train
from evreal_tpu_torch.convert.params import flatten, from_jax_tree
from evreal_tpu_torch.models import build_model

from .test_torch_lpips import jax_layout_weights

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4  # x max|g| of the tensor, x |g|
OPT_TOL = 1e-6
STEP_PARAM_TOL = 3e-4  # tests/test_train_parallel.py:65-69

FIRENET = {"num_bins": 5, "base_num_channels": 8, "kernel_size": 3}
E2VID_LSTM = dict(num_bins=5, base_num_channels=8, kernel_size=3,
                  num_encoders=1, num_residual_blocks=1, skip_type="sum",
                  norm=None, use_upsample_conv=True,
                  recurrent_block_type="convlstm",
                  final_activation="sigmoid")
E2VID_GRU = dict(E2VID_LSTM, num_encoders=2, recurrent_block_type="convgru",
                 final_activation="none")


def e2vid_tree(kw):
    return init_e2vid(base_num_channels=8, kernel_size=3,
                      num_encoders=kw["num_encoders"], num_residual_blocks=1,
                      recurrent_block_type=kw["recurrent_block_type"])


ARCHS = {
    "firenet": ("FireNet", FIRENET,
                lambda: init_firenet(base_num_channels=8)),
    "e2vid_convlstm": ("E2VIDRecurrent", E2VID_LSTM,
                       lambda: e2vid_tree(E2VID_LSTM)),
    "e2vid_convgru": ("E2VIDRecurrent", E2VID_GRU,
                      lambda: e2vid_tree(E2VID_GRU)),
}


def models(arch):
    """(port model, JAX model, JAX param tree) of the same weights."""
    cls, kw, init = ARCHS[arch]
    tree = init()
    tmodel = build_model(cls, kw)
    tmodel.load_state_dict(from_jax_tree(tree), strict=True)
    return tmodel, j_build(cls, kw), tree


def batch(n, t, h, w, seed=0):
    """Seeded voxels (N, T, B, H, W) and frames (N, T, H, W) in [0, 1]."""
    rng = np.random.default_rng(seed)
    vox = rng.normal(size=(n, t, 5, h, w)).astype(np.float32)
    frames = rng.uniform(size=(n, t, h, w)).astype(np.float32)
    return vox, frames


def nhwc(vox):
    return np.ascontiguousarray(vox.transpose(0, 1, 3, 4, 2))


def lpips_weights():
    """Random LPIPS weights: the JAX layout (HWIO) for the JAX package,
    OIHW tensors for the port (what ``metrics/lpips.load_weights`` reads
    from the same file)."""
    w = jax_layout_weights(3)
    port = {k: torch.from_numpy(np.ascontiguousarray(
        v.transpose(3, 2, 0, 1)) if v.ndim == 4 else v)
        for k, v in w.items()}
    return w, port


def port_loss_and_grads(model, vox, frames, **kw):
    for p in model.parameters():
        p.grad = None
    mask = kw.pop("mask", None)
    with train.training_precision():
        loss = train.sequence_loss(
            model, torch.from_numpy(vox), torch.from_numpy(frames),
            mask=None if mask is None else torch.from_numpy(mask), **kw)
        loss.backward()
    return float(loss.detach()), {k: p.grad.numpy().copy()
                         for k, p in model.named_parameters()}


def jax_loss_and_grads(model, tree, vox, frames, **kw):
    mask = kw.pop("mask", None)
    loss, grads = jax.value_and_grad(lambda p: j_sequence_loss(
        model, p, jnp.asarray(nhwc(vox)), jnp.asarray(frames),
        mask=None if mask is None else jnp.asarray(mask), **kw))(tree)
    grads = jax.tree.map(np.array, grads)
    return float(loss), {k: v.numpy() for k, v in from_jax_tree(
        grads).items()}


def assert_grads_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        bound = GRAD_ATOL * np.abs(want[k]).max() + GRAD_RTOL * np.abs(
            want[k])
        err = np.abs(got[k] - want[k])
        assert (err <= bound).all(), (k, float(err.max()),
                                      float(np.abs(want[k]).max()))


# ---------------------------------------------------------------------------
# sequence_loss: loss and every gradient against jax.value_and_grad
# ---------------------------------------------------------------------------

MASK = np.array([[1, 1, 0], [1, 0, 1]], np.float32)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("loss", ["mse", "bce", "lpips", "mse+lpips"])
def test_firenet_loss_and_grads_match_jax(loss, masked, remat):
    tmodel, jmodel, tree = models("firenet")
    vox, frames = batch(2, 3, 48, 64, seed=1)
    jw, tw = lpips_weights()
    kw = dict(remat=remat, loss=loss, lpips_scale=0.5,
              mask=MASK if masked else None)
    t_loss, t_grads = port_loss_and_grads(tmodel, vox, frames,
                                          lpips_weights=tw, **kw)
    j_loss, j_grads = jax_loss_and_grads(jmodel, tree, vox, frames,
                                         lpips_weights=jw, **kw)
    assert t_loss == pytest.approx(j_loss, rel=LOSS_RTOL)
    assert_grads_close(t_grads, j_grads)


@pytest.mark.parametrize("loss", ["mse", "bce", "mse+lpips"])
@pytest.mark.parametrize("arch", ["e2vid_convlstm", "e2vid_convgru"])
def test_e2vid_loss_and_grads_match_jax(arch, loss):
    tmodel, jmodel, tree = models(arch)
    vox, frames = batch(2, 3, 48, 64, seed=2)
    jw, tw = lpips_weights()
    kw = dict(remat=True, loss=loss, mask=MASK)
    t_loss, t_grads = port_loss_and_grads(tmodel, vox, frames,
                                          lpips_weights=tw, **kw)
    j_loss, j_grads = jax_loss_and_grads(jmodel, tree, vox, frames,
                                         lpips_weights=jw, **kw)
    assert t_loss == pytest.approx(j_loss, rel=LOSS_RTOL)
    assert_grads_close(t_grads, j_grads)


@pytest.mark.parametrize("arch", ["firenet", "e2vid_convlstm",
                                  "e2vid_convgru"])
def test_remat_gives_identical_gradients(arch):
    tmodel = models(arch)[0]
    vox, frames = batch(2, 4, 16, 24, seed=3)
    off = port_loss_and_grads(tmodel, vox, frames, remat=False)
    on = port_loss_and_grads(tmodel, vox, frames, remat=True)
    assert on[0] == off[0]
    assert all(np.array_equal(on[1][k], off[1][k]) for k in off[1])


def test_prev_recs_carry_no_gradient():
    """E2VIDRecurrent's previous reconstruction is detached between
    windows (``jax.lax.stop_gradient`` at evreal_tpu/models/unet.py:157)."""
    tmodel = models("e2vid_convlstm")[0]
    state = tmodel.init_state(1, 16, 16)
    vox = torch.randn(1, 5, 16, 16)
    out, state = tmodel(vox, state)
    assert out["image"].requires_grad
    assert not state["prev_recs"].requires_grad


@pytest.mark.parametrize("name", ["init_firenet", "init_e2vid"])
def test_init_matches_jax_and_torch_default(name):
    """tests/test_train_parallel.py:140, in the port: the trainer's
    random init (the port's copy of evreal_tpu/models/init.py) is the JAX
    package's bit for bit, and its convolutions fill torch Conv2d's
    default range, 1/sqrt(fan_in)."""
    from evreal_tpu.models import init as j_init
    from evreal_tpu_torch.models import init as t_init

    got = flatten(getattr(t_init, name)(seed=5))
    want = flatten(getattr(j_init, name)(seed=5))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    w = t_init._kaiming_uniform(np.random.default_rng(0), (3, 3, 16, 32))
    bound = 1.0 / np.sqrt(3 * 3 * 16)
    assert bound * 0.98 < np.abs(w).max() <= bound * (1 + 1e-6)


# ---------------------------------------------------------------------------
# build_optimizer against optax
# ---------------------------------------------------------------------------

def grad_trees(n=12, seed=0):
    """``n`` seeded gradient trees (a 4-D conv weight, a bias, a 2-D
    weight) whose scales alternate around a global norm of 1, so a
    clip at 1 both triggers and does not."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        scale = 0.3 if i % 2 else 0.003
        out.append({
            "conv": {"weight": (rng.normal(size=(3, 3, 4, 8)) * scale),
                     "bias": rng.normal(size=(8,)) * scale},
            "lin": {"weight": rng.normal(size=(5, 7)) * scale}})
    return [jax.tree.map(lambda a: a.astype(np.float32), t) for t in out]


OPT_VARIANTS = {
    "adam": {},
    "cosine_warmup": {"schedule": "cosine", "steps": 12, "warmup": 3},
    "cosine": {"schedule": "cosine", "steps": 10},
    "warmup": {"warmup": 3},
    "weight_decay": {"weight_decay": 1e-2},
    "clip_grad": {"clip_grad": 1.0},
}


@pytest.mark.parametrize("variant", sorted(OPT_VARIANTS))
def test_optimizer_matches_optax(variant):
    kw = OPT_VARIANTS[variant]
    rng = np.random.default_rng(1)
    init = {"conv": {"weight": rng.normal(size=(3, 3, 4, 8)),
                     "bias": rng.normal(size=(8,))},
            "lin": {"weight": rng.normal(size=(5, 7))}}
    init = jax.tree.map(lambda a: a.astype(np.float32), init)
    j_opt = j_build_optimizer(lr=1e-2, **kw)
    j_params = jax.tree.map(jnp.asarray, init)
    j_state = j_opt.init(j_params)
    t_opt = train.build_optimizer(lr=1e-2, **kw)
    t_params = {k: torch.tensor(v) for k, v in flatten(init).items()}
    for g in grad_trees():
        updates, j_state = j_opt.update(jax.tree.map(jnp.asarray, g),
                                        j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, v in flatten(g).items():
            t_params[k].grad = torch.tensor(v)
        t_opt.step(t_params.values())
        for k, v in flatten(jax.tree.map(np.asarray, j_params)).items():
            np.testing.assert_allclose(t_params[k].numpy(), v, rtol=0,
                                       atol=OPT_TOL, err_msg=k)
    assert t_opt.count == len(grad_trees())


def test_optimizer_schedule_errors():
    with pytest.raises(ValueError, match="cosine schedule needs"):
        train.build_optimizer(schedule="cosine")
    with pytest.raises(ValueError, match="unknown schedule"):
        train.build_optimizer(schedule="linear")


def test_clip_bounds_update_by_lr():
    """A clipped Adam update is at most lr in magnitude whatever the
    gradient (tests/test_train_parallel.py:185-189)."""
    p = torch.ones(4)
    p.grad = torch.full((4,), 100.0)
    train.build_optimizer(lr=1e-2, clip_grad=1.0).step([p])
    assert float((p - 1).abs().max()) <= 1e-2 * 1.01


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------

def test_train_steps_match_jax():
    tmodel, jmodel, tree = models("firenet")
    vox, frames = batch(2, 3, 16, 16, seed=4)
    j_step, j_opt = j_make_train_step(jmodel, optax.adam(1e-3))
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = j_opt.init(params)
    t_step, _ = train.make_train_step(tmodel, train.build_optimizer(1e-3))
    j_batch = {"voxels": nhwc(vox), "frames": frames}
    t_batch = {"voxels": torch.from_numpy(vox),
               "frames": torch.from_numpy(frames)}
    for _ in range(3):
        params, opt_state, j_loss = j_step(params, opt_state, j_batch)
        t_loss = t_step(t_batch)
        assert t_loss.dim() == 0
        assert float(t_loss) == pytest.approx(float(j_loss), rel=LOSS_RTOL)
    want = from_jax_tree(jax.tree.map(np.asarray, params))
    for k, v in tmodel.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=STEP_PARAM_TOL, err_msg=k)


def test_train_step_reduces_loss():
    """tests/test_train_parallel.py:22, in the port."""
    tmodel = models("firenet")[0]
    vox, frames = batch(2, 3, 16, 16)
    step, _ = train.make_train_step(tmodel, train.build_optimizer(1e-3))
    b = {"voxels": torch.from_numpy(vox), "frames": torch.from_numpy(frames)}
    losses = [float(step(b)) for _ in range(5)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_perceptual_loss_trains():
    """tests/test_train_parallel.py:101, in the port: mse+lpips trains;
    pure lpips differs from pure mse; the two errors."""
    tmodel = models("firenet")[0]
    _, tw = lpips_weights()
    vox, frames = batch(1, 2, 48, 64, seed=2)
    b = {"voxels": torch.from_numpy(vox), "frames": torch.from_numpy(frames)}
    step, _ = train.make_train_step(tmodel, train.build_optimizer(1e-3),
                                    loss="mse+lpips", lpips_weights=tw,
                                    lpips_scale=0.5)
    losses = [float(step(b)) for _ in range(4)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    with torch.no_grad():
        a = train.sequence_loss(tmodel, b["voxels"], b["frames"],
                                remat=False, loss="lpips", lpips_weights=tw)
        m = train.sequence_loss(tmodel, b["voxels"], b["frames"],
                                remat=False, loss="mse")
    assert float(a) != pytest.approx(float(m))
    with pytest.raises(ValueError, match="lpips_weights"):
        train.sequence_loss(tmodel, b["voxels"], b["frames"], loss="lpips")
    with pytest.raises(ValueError, match="terms"):
        train.sequence_loss(tmodel, b["voxels"], b["frames"],
                            loss="mse+ssim")


@pytest.mark.parametrize("loss_kind", ["mse", "mse+lpips"])
def test_sequence_loss_masks_padded_tail(loss_kind):
    """tests/test_train_parallel.py:193, in the port: masked tail windows
    are not scored, through both terms."""
    tmodel = models("firenet")[0]
    tw = lpips_weights()[1] if "lpips" in loss_kind else None
    rng = np.random.default_rng(0)
    vox = np.zeros((1, 4, 5, 48, 64), np.float32)
    frames = np.zeros((1, 4, 48, 64), np.float32)
    vox[:, :2] = rng.normal(0, 1, (1, 2, 5, 48, 64))
    frames[:, :2] = rng.uniform(0, 1, (1, 2, 48, 64))
    mask = torch.tensor([[1, 1, 0, 0]], dtype=torch.float32)
    kw = dict(remat=False, loss=loss_kind, lpips_weights=tw)
    v, f = torch.from_numpy(vox), torch.from_numpy(frames)
    with torch.no_grad():
        masked = float(train.sequence_loss(tmodel, v, f, mask=mask, **kw))
        short = float(train.sequence_loss(tmodel, v[:, :2], f[:, :2], **kw))
        full = float(train.sequence_loss(tmodel, v, f, **kw))
    assert masked == pytest.approx(short, rel=1e-5)
    assert full != pytest.approx(short, rel=1e-4)


def test_bce_gradient_survives_sigmoid_saturation():
    """tests/test_train_parallel.py:231, in the port: with the pred bias
    at -20 the MSE gradient through it is ~dead, BCE's stays (p - y)."""
    tmodel = models("e2vid_convlstm")[0]
    with torch.no_grad():
        tmodel.core.pred.conv2d.bias -= 20.0
    rng = np.random.default_rng(0)
    vox = torch.from_numpy(rng.normal(size=(1, 2, 5, 16, 16)).astype(
        np.float32))
    frames = torch.from_numpy(rng.uniform(0.05, 0.3, (1, 2, 16, 16)).astype(
        np.float32))

    def bias_grad(kind):
        tmodel.zero_grad()
        train.sequence_loss(tmodel, vox, frames, remat=False,
                            loss=kind).backward()
        return float(tmodel.core.pred.conv2d.bias.grad.abs().max())

    g_mse, g_bce = bias_grad("mse"), bias_grad("bce")
    assert g_mse < 1e-7, g_mse
    assert g_bce > 0.05, g_bce


# ---------------------------------------------------------------------------
# sample_batch
# ---------------------------------------------------------------------------

def test_sample_batch_emits_gt_mask(tmp_path):
    """tests/test_train_parallel.py:270, in the port."""
    from evreal_tpu_torch.data import Sequence
    from evreal_tpu_torch.ops.pad import CropParams
    from evreal_tpu_torch.train_cli import sample_batch

    make_sequence(str(tmp_path / "seq0"), height=32, width=48,
                  duration_s=0.5, fps=20, events_per_frame=400, seed=3)
    seq = Sequence(str(tmp_path / "seq0"), num_bins=5,
                   voxel_method={"method": "between_frames"})
    crop = CropParams(48, 32, 0)

    def voxelize(buffers):
        return torch.zeros((buffers["count"].shape[0], 5, 32, 48))

    chunk_t = len(seq) + 4  # longer than the sequence: a padded tail
    b = sample_batch([seq], voxelize, np.random.default_rng(0), 2, chunk_t,
                     5, crop)
    mask = b["mask"].numpy()
    assert mask.shape == (2, chunk_t) and mask.sum() > 0
    assert (mask[:, -4:] == 0).all()
    assert ((b["frames"].numpy().reshape(2, chunk_t, -1).max(-1) > 0)
            <= (mask > 0)).all()


@pytest.mark.parametrize("event_norm", [False, True])
def test_sample_batch_matches_jax(tmp_path, event_norm):
    """The same rng draws pick the same chunks: frames and mask equal to
    the JAX CLI's, voxels within 2e-5 (its scatter voxelizer)."""
    from evreal_tpu.data import Sequence as JSequence
    from evreal_tpu.harness.runner import make_voxel_stage as j_stage
    from evreal_tpu.ops.pad import CropParams as JCrop
    from evreal_tpu.ops.voxelize import voxelize_scatter
    from evreal_tpu.train_cli import sample_batch as j_sample_batch
    from evreal_tpu_torch.data import Sequence
    from evreal_tpu_torch.harness.runner import make_voxel_stage
    from evreal_tpu_torch.ops.pad import CropParams
    from evreal_tpu_torch.train_cli import sample_batch

    h, w = 30, 45
    for i in range(2):
        make_sequence(str(tmp_path / f"seq{i}"), height=h, width=w,
                      duration_s=0.6, fps=20, events_per_frame=500, seed=i)
    dirs = [str(tmp_path / f"seq{i}") for i in range(2)]
    vm = {"method": "between_frames"}
    j_crop, crop = JCrop(w, h, 3), CropParams(w, h, 3)
    stage = jax.jit(j_stage(voxelize_scatter, 5, (h, w), event_norm))
    t_stage = make_voxel_stage(5, (h, w), event_norm)
    want = j_sample_batch(
        [JSequence(d, num_bins=5, voxel_method=vm) for d in dirs],
        lambda bufs: j_crop.pad(stage(dict(bufs))),
        np.random.default_rng((7, 1)), 3, 6, 5, j_crop)
    got = sample_batch(
        [Sequence(d, num_bins=5, voxel_method=vm) for d in dirs],
        lambda bufs: crop.pad(t_stage({k: torch.from_numpy(v)
                                       for k, v in bufs.items()})),
        np.random.default_rng((7, 1)), 3, 6, 5, crop)
    np.testing.assert_array_equal(got["frames"].numpy(), want["frames"])
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    np.testing.assert_allclose(got["voxels"].numpy(),
                               want["voxels"].transpose(0, 1, 4, 2, 3),
                               rtol=0, atol=2e-5)
