"""The port's data-parallel training step (``make_train_step(mesh=)``,
``train_cli --mesh``) on CPU meshes whose entries repeat the one CPU
device, each a replica of its own: tests/test_train_parallel.py:38-71's
case (narrow convgru E2VID, batch 4 of 2 x 16 x 32, remat off) at dp = 2
and dp = 4 against the port's meshless step and the JAX package's
meshless step (loss ``rtol=1e-5``, parameters after one step
``atol=3e-4``, that test's own bounds), a masked batch whose shards hold
different numbers of valid windows, ``clip_grad`` on, checkpoints that
cross between meshless and mesh runs, and the CLI's dp rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evreal_tpu.models import build_model as j_build
from evreal_tpu.train import build_optimizer as j_build_optimizer
from evreal_tpu.train import make_train_step as j_make_train_step
from evreal_tpu_torch import train, train_cli
from evreal_tpu_torch.convert.params import from_jax_tree
from evreal_tpu_torch.models import build_model
from evreal_tpu_torch.parallel import mesh as tmesh

from .test_torch_train import (
    E2VID_GRU,
    assert_grads_close,
    e2vid_tree,
    jax_loss_and_grads,
    nhwc,
)

torch.set_num_threads(1)

LOSS_RTOL = 1e-5        # tests/test_train_parallel.py:63
PARAM_ATOL = 3e-4       # tests/test_train_parallel.py:69
GRAD_RTOL = 1e-5        # the reduced gradient against the meshless one


def cpu_mesh(dp):
    return tmesh.make_mesh(dp, axes=("dp",), devices=["cpu"] * dp)


def port_model(tree):
    model = build_model("E2VIDRecurrent", E2VID_GRU)
    model.load_state_dict(from_jax_tree(tree), strict=True)
    return model


def make_batch(seed=1, mask=None):
    rng = np.random.default_rng(seed)
    vox = rng.normal(size=(4, 2, 5, 16, 32)).astype(np.float32)
    frames = rng.uniform(size=(4, 2, 16, 32)).astype(np.float32)
    return vox, frames, mask


def port_step(tree, batch, mesh, steps=1, **opt):
    vox, frames, mask = batch
    model = port_model(tree)
    optimizer = train.build_optimizer(1e-3, **opt)
    step, _ = train.make_train_step(model, optimizer, mesh=mesh, remat=False)
    b = {"voxels": torch.from_numpy(vox), "frames": torch.from_numpy(frames)}
    if mask is not None:
        b["mask"] = torch.from_numpy(mask)
    losses = [float(step(b)) for _ in range(steps)]
    return losses, model, step, optimizer


def jax_step(tree, batch, **opt):
    vox, frames, mask = batch
    jmodel = j_build("E2VIDRecurrent", E2VID_GRU)
    step, opt_ = j_make_train_step(jmodel, j_build_optimizer(1e-3, **opt),
                                   remat=False)
    params = jax.tree.map(jnp.asarray, tree)
    b = {"voxels": nhwc(vox), "frames": frames}
    if mask is not None:
        b["mask"] = mask
    params, _, loss = step(params, opt_.init(params), b)
    return float(loss), from_jax_tree(jax.tree.map(np.asarray, params))


def grads_of(model):
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


def assert_params_close(model, want):
    for k, v in model.state_dict().items():
        w = want[k].numpy() if isinstance(want[k], torch.Tensor) else want[k]
        np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


# unequal shards: at dp = 2 the first holds 1 valid window, the second 4
UNEQUAL_MASK = np.array([[1, 0], [0, 0], [1, 1], [1, 1]], np.float32)


@pytest.mark.parametrize("case", ["plain", "masked", "clip"])
@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_step_matches_meshless_and_jax(dp, case):
    tree = e2vid_tree(E2VID_GRU)
    batch = make_batch(mask=UNEQUAL_MASK if case == "masked" else None)
    opt = {"clip_grad": 0.05} if case == "clip" else {}
    (loss0,), model0, _, opt0 = port_step(tree, batch, None, **opt)
    (loss1,), model1, step1, opt1 = port_step(tree, batch, cpu_mesh(dp),
                                              **opt)
    jloss, jparams = jax_step(tree, batch, **opt)
    assert len(step1.replicas) == dp and step1.replicas[0] is model1
    assert loss1 == pytest.approx(loss0, rel=LOSS_RTOL)
    assert loss1 == pytest.approx(jloss, rel=LOSS_RTOL)
    assert_params_close(model1, model0.state_dict())
    assert_params_close(model1, jparams)
    # Adam and the clip are invariant to a uniform scale of the gradient,
    # so the parameters alone cannot tell a summed reduction from a mean:
    # the first replica's reduced gradient is held to the meshless one and
    # to jax.value_and_grad's (the port's standing gradient bound), and the
    # (clipped) gradient Adam took to the meshless step's, through its
    # first moment (1 - b1) * g
    got, want = grads_of(model1), grads_of(model0)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want[k]).max(),
                                   err_msg=k)
    vox, frames, mask = batch
    assert_grads_close(got, jax_loss_and_grads(
        j_build("E2VIDRecurrent", E2VID_GRU), tree, vox, frames,
        remat=False, mask=mask)[1])
    for k, a, b in zip(want, opt1.mu, opt0.mu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(b.numpy()).max(),
                                   err_msg=k)
    # every replica holds the updated parameters
    for r in step1.replicas[1:]:
        for (k, v), p in zip(r.state_dict().items(),
                             model1.state_dict().values()):
            assert torch.equal(v, p), k


def test_shard_losses_use_the_whole_batch_denominator():
    """Each replica's loss is its masked sum over the whole batch's valid
    windows: the shards' losses sum to the meshless loss even when the
    shards hold different counts (a shard's own mean would weight them
    wrongly)."""
    tree = e2vid_tree(E2VID_GRU)
    vox, frames, mask = make_batch(mask=UNEQUAL_MASK)
    model = port_model(tree)
    b = {"voxels": torch.from_numpy(vox), "frames": torch.from_numpy(frames),
         "mask": torch.from_numpy(mask)}
    shards = train.shard_batch(b, [torch.device("cpu")] * 2)
    assert [float(s["mask"].sum()) for s in shards] == [1.0, 4.0]
    assert all(float(s["denom"]) == 5.0 for s in shards)
    with torch.no_grad():
        whole = train.sequence_loss(model, b["voxels"], b["frames"], False,
                                    mask=b["mask"])
        parts = [train.sequence_loss(model, s["voxels"], s["frames"], False,
                                     mask=s["mask"], denom=s["denom"])
                 for s in shards]
        own_means = [train.sequence_loss(model, s["voxels"], s["frames"],
                                         False, mask=s["mask"])
                     for s in shards]
    assert float(sum(parts)) == pytest.approx(float(whole), rel=1e-6)
    assert float(sum(own_means)) / 2 != pytest.approx(float(whole), rel=1e-3)


@pytest.mark.parametrize("first,second", [("meshless", "mesh"),
                                          ("mesh", "meshless")])
def test_checkpoints_cross_between_mesh_and_meshless(tmp_path, first,
                                                     second):
    """One step, a checkpoint, a fresh model resumed from it under the
    other kind of step, one more step: the parameters of two meshless
    steps (the optimizer state lives on the first replica, in one
    format)."""
    tree = e2vid_tree(E2VID_GRU)
    batch = make_batch(seed=3)
    meshes = {"meshless": None, "mesh": cpu_mesh(2)}
    _, want, _, _ = port_step(tree, batch, None, steps=2)

    vox, frames, _ = batch
    b = {"voxels": torch.from_numpy(vox), "frames": torch.from_numpy(frames)}
    model = port_model(tree)
    opt = train.build_optimizer(1e-3)
    step, _ = train.make_train_step(model, opt, mesh=meshes[first],
                                    remat=False)
    step(b)
    train_cli.save_checkpoint(str(tmp_path), 1, model, opt)

    model2 = port_model(tree)
    opt2 = train.build_optimizer(1e-3)
    assert train_cli.restore_checkpoint(str(tmp_path), model2, opt2,
                                        "cpu") == 1
    step2, _ = train.make_train_step(model2, opt2, mesh=meshes[second],
                                     remat=False)
    step2(b)
    assert opt2.count == 2
    assert_params_close(model2, want.state_dict())


def test_mesh_model_must_lie_on_the_first_device():
    model = port_model(e2vid_tree(E2VID_GRU)).to("meta")
    with pytest.raises(ValueError, match="mesh's first device"):
        train.make_train_step(model, mesh=cpu_mesh(2))


@pytest.mark.parametrize("cards,batch,device,want", [
    (8, 4, 0, (4, [0, 1, 2, 3])),
    (4, 6, 0, (3, [0, 1, 2])),
    (4, 5, 0, (1, [0])),
    (2, 4, 1, (2, [1, 0])),
])
def test_cli_mesh_dp_is_the_largest_divisor(monkeypatch, cards, batch,
                                            device, want):
    """``--mesh`` on a multi-card host: dp is the largest divisor of
    ``--batch`` not above the card count, the training device first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    mesh = train_cli.train_mesh(torch.device("cuda", device), batch)
    assert mesh.shape == {"dp": want[0]}
    assert [d.index for d in mesh.devices.flat] == want[1]


def test_cli_mesh_is_a_no_op_on_the_cpu(tmp_path):
    """``--mesh --device cpu`` trains exactly what a run without it does
    (``evreal_tpu/train_cli.py:149``: one device, no mesh)."""
    from .test_torch_train import make_sequence

    make_sequence(str(tmp_path / "data" / "seq0"), height=16, width=16,
                  duration_s=1.0, fps=24, events_per_frame=150, seed=0)
    data = str(tmp_path / "data")
    out = {}
    for label, extra in (("plain", []), ("mesh", ["--mesh"])):
        out[label] = tmp_path / label
        train_cli.main(["--data", data, "--arch", "firenet", "--steps", "2",
                        "--batch", "2", "--chunk-t", "3", "--device", "cpu",
                        "--out", str(out[label]), "--log-every", "1"]
                       + extra)
    a, b = (np.load(out[k] / "model.npz") for k in ("plain", "mesh"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
