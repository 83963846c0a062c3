"""The port's training CLI (``evreal_tpu_torch/train_cli.py``) on the CPU:
checkpoint and resume (the port of ``tests/test_train_cli.py``), the
trained ``model.npz`` read by the JAX package's loader and a JAX-trained
one read by the port's (forwards within 2e-5), ``to_jax_tree`` as the exact
inverse of ``from_jax_tree``, and the JAX CLI against the port's on the
same data and seed (step-1 loss within 1e-5 relative, final weights within
3e-4, the bound of ``tests/test_train_parallel.py`` for Adam's sign flips
near a zero gradient)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evreal_tpu.convert.torch_ckpt import convert_state_dict
from evreal_tpu.harness.runner import load_method_params as j_load
from evreal_tpu.models import build_from_meta as j_build_from_meta
from evreal_tpu.models.init import init_e2vid, init_firenet
from evreal_tpu_torch import train as ttrain
from evreal_tpu_torch import train_cli
from evreal_tpu_torch.cli import train_main
from evreal_tpu_torch.convert.params import (flatten, from_jax_tree,
                                             to_jax_tree)
from evreal_tpu_torch.harness.runner import load_method_params as t_load
from evreal_tpu_torch.models import build_from_meta, build_model

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

torch.set_num_threads(1)

FORWARD_TOL = 2e-5
LOSS_RTOL = 1e-5
PARAM_TOL = 3e-4
COMMON = ["--batch", "2", "--chunk-t", "4", "--log-every", "1",
          "--seed", "3"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    make_sequence(str(root / "seq0"), height=16, width=16, duration_s=1.0,
                  fps=24, events_per_frame=150, seed=0)
    return str(root)


def run(argv, capsys):
    train_cli.main(argv)
    return capsys.readouterr().out


def forward_pair(npz, name, seed=0):
    """One window through the JAX package's model loaded from ``npz`` by
    its loader, and through the port's loaded by the port's: the images."""
    cfg = {"model_name": name, "model_path": str(npz)}
    params, meta = j_load(cfg)
    jmodel = j_build_from_meta(meta)
    sd, t_meta = t_load(cfg)
    assert t_meta == meta
    tmodel = build_from_meta(t_meta, sd)
    tmodel.load_state_dict(sd, strict=True)
    x = np.random.default_rng(seed).normal(size=(1, 5, 16, 16)).astype(
        np.float32)
    j_out, _ = jmodel.apply(params, jmodel.init_state(1, 16, 16),
                            jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        t_out, _ = tmodel(torch.from_numpy(x), tmodel.init_state(1, 16, 16))
    return np.asarray(j_out["image"])[..., 0], t_out["image"].numpy()[:, 0]


def test_train_checkpoint_resume(data, tmp_path, capsys):
    """tests/test_train_cli.py:28 on --device cpu: 2 steps with a
    checkpoint per step, then --resume to 4, equal to 4 uninterrupted
    steps within 1e-5."""
    cpu = COMMON + ["--data", data, "--arch", "firenet", "--device", "cpu"]
    run(cpu + ["--steps", "4", "--out", str(tmp_path / "full")], capsys)
    full = dict(np.load(tmp_path / "full" / "model.npz"))
    out = str(tmp_path / "resumed")
    run(cpu + ["--steps", "2", "--save-every", "1", "--out", out], capsys)
    stdout = run(cpu + ["--steps", "4", "--save-every", "1", "--resume",
                        "--out", out], capsys)
    assert "resumed from step 2" in stdout, stdout
    assert stdout.splitlines()[1].startswith("step 3: loss ")
    resumed = dict(np.load(os.path.join(out, "model.npz")))
    assert full.keys() == resumed.keys()
    for k in full:
        np.testing.assert_allclose(resumed[k], full[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    # the newest 3 job checkpoints are kept
    assert sorted(train_cli.checkpoint_steps(os.path.join(out, "ckpt"))) \
        == [2, 3, 4]


@pytest.mark.parametrize("arch,name", [("firenet", "FireNet+"),
                                       ("e2vid", "E2VID")])
def test_trained_npz_loads_in_jax(data, tmp_path, capsys, arch, name):
    """The port's model.npz and sidecar load through the JAX package's
    load_method_params / build_from_meta; its forward matches the port's
    within 2e-5."""
    train_main(COMMON + ["--data", data, "--arch", arch, "--steps", "2",
                         "--device", "cpu", "--out", str(tmp_path)])
    stdout = capsys.readouterr().out
    assert f"saved {tmp_path / 'model.npz'}" in stdout
    j_img, t_img = forward_pair(tmp_path / "model.npz", name)
    assert np.isfinite(t_img).all()
    assert float(np.abs(j_img - t_img).max()) <= FORWARD_TOL


@pytest.fixture(scope="module")
def both_clis(data, tmp_path_factory):
    """3 FireNet steps of the JAX CLI and of the port's on the same data
    and seed: ({"jax": losses, "torch": losses}, the root of the two out
    dirs). The losses are read from each step function, unrounded."""
    from evreal_tpu import train as jtrain
    from evreal_tpu.train_cli import main as j_main

    root = tmp_path_factory.mktemp("clis")
    losses = {"jax": [], "torch": []}

    def recording(module, key):
        real = module.make_train_step

        def make(*a, **k):
            step, opt = real(*a, **k)

            def wrapped(*args):
                out = step(*args)
                losses[key].append(float(out[-1] if key == "jax" else out))
                return out
            return wrapped, opt
        return make

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtrain, "make_train_step", recording(jtrain, "jax"))
        mp.setattr(ttrain, "make_train_step", recording(ttrain, "torch"))
        args = COMMON + ["--data", data, "--arch", "firenet", "--steps",
                         "3", "--lr", "1e-3"]
        j_main(args + ["--out", str(root / "jax")])
        train_cli.main(args + ["--device", "cpu", "--out",
                               str(root / "torch")])
    finally:
        mp.undo()
    return losses, root


def test_cli_matches_jax_cli(both_clis):
    losses, root = both_clis
    assert len(losses["jax"]) == len(losses["torch"]) == 3
    assert losses["torch"][0] == pytest.approx(losses["jax"][0],
                                               rel=LOSS_RTOL)
    want = dict(np.load(root / "jax" / "model.npz"))
    got = dict(np.load(root / "torch" / "model.npz"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_TOL,
                                   err_msg=k)


def test_jax_trained_npz_loads_in_port(both_clis):
    """A model.npz the JAX CLI trained loads through the port's loader;
    the port's forward matches the JAX package's within 2e-5."""
    j_img, t_img = forward_pair(both_clis[1] / "jax" / "model.npz",
                                "FireNet+", seed=1)
    assert float(np.abs(j_img - t_img).max()) <= FORWARD_TOL


@pytest.mark.parametrize("init", [init_firenet, init_e2vid])
def test_to_jax_tree_inverts_from_jax_tree(init):
    tree = init()
    back = flatten(to_jax_tree(from_jax_tree(tree)))
    want = flatten(tree)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == want[k].dtype and np.array_equal(
            back[k], want[k]), k


def test_to_jax_tree_matches_the_jax_converter():
    """Transposed-conv (flipped HWIO), conv and bias arrays of a torch
    state_dict: to_jax_tree gives the JAX package's convert_state_dict."""
    torch.manual_seed(0)
    model = build_model("E2VIDRecurrent", dict(
        num_bins=5, base_num_channels=8, kernel_size=3, num_encoders=2,
        recurrent_block_type="convgru", num_residual_blocks=1,
        use_upsample_conv=False))
    for p in model.parameters():
        torch.nn.init.normal_(p)
    sd = model.state_dict()
    got = flatten(to_jax_tree(sd))
    want = convert_state_dict(sd)
    assert got.keys() == want.keys()
    assert any("transposed_conv2d" in k for k in got)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_needs_a_card_without_device(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--data", data, "--steps", "1", "--out",
                        str(tmp_path)])


def test_mesh_on_several_cards_raises(data, tmp_path, monkeypatch, capsys):
    """--mesh with more than one visible card no longer exits: it builds
    the dp mesh over the cards (dp the largest divisor of --batch) and
    prints it before the model is built; it never trains on one card
    silently. (The test fakes two cards and stops the run at ``build``.)"""
    class Stop(Exception):
        pass

    def build(*args):
        raise Stop()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(train_cli, "build", build)
    with pytest.raises(Stop):
        train_cli.main(["--data", data, "--steps", "1", "--mesh",
                        "--batch", "4", "--out", str(tmp_path)])
    assert capsys.readouterr().out.startswith(
        "mesh: dp = 2 over cuda:0, cuda:1\n")


def test_mesh_on_one_device_is_a_no_op(data, tmp_path, capsys):
    stdout = run(COMMON + ["--data", data, "--steps", "1", "--mesh",
                           "--device", "cpu", "--out", str(tmp_path)],
                 capsys)
    assert stdout.startswith("step 1: loss ")


def test_lpips_loss_without_weights_exits(data, tmp_path, monkeypatch):
    monkeypatch.setenv("EVREAL_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    with pytest.raises(SystemExit, match="converted weights are missing"):
        train_cli.main(["--data", data, "--steps", "1", "--loss",
                        "mse+lpips", "--device", "cpu", "--out",
                        str(tmp_path)])


def test_lpips_loss_trains_through_the_cli(data, tmp_path, monkeypatch,
                                           capsys):
    from .test_torch_lpips import jax_layout_weights

    path = tmp_path / "lpips.npz"
    np.savez(path, **jax_layout_weights(0))
    monkeypatch.setenv("EVREAL_LPIPS_WEIGHTS", str(path))
    data32 = tmp_path / "data32"
    make_sequence(str(data32 / "seq0"), height=48, width=64,
                  duration_s=0.4, fps=20, events_per_frame=300, seed=1)
    stdout = run(["--data", str(data32), "--steps", "2", "--batch", "1",
                  "--chunk-t", "2", "--loss", "mse+lpips", "--log-every",
                  "1", "--device", "cpu", "--out", str(tmp_path / "o")],
                 capsys)
    losses = [float(line.split()[3]) for line in stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
