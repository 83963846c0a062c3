"""Reference ``.pth`` checkpoints in the port (evreal_tpu_torch/convert/
checkpoint.py): random-weight checkpoints of all eight method configs in
their four schemas, written from the port's modules, read by the port's
loader and by the JAX package's (evreal_tpu.convert): the same meta, and
arrays bit-equal once the port's state_dict goes through the JAX package's
converter. Then the port's command line runs all eight methods from those
``.pth`` files on the CPU, at the paths the repository's
config/method/*.json name."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evreal_tpu.convert import convert_state_dict
from evreal_tpu.convert import load_method_checkpoint as j_load
from evreal_tpu_torch.cli import main as torch_main
from evreal_tpu_torch.convert.checkpoint import (
    SSL_E2VID_KWARGS,
    load_method_checkpoint,
    save_method_checkpoint,
)
from evreal_tpu_torch.convert.params import flatten, save_params
from evreal_tpu_torch.harness.runner import ALL_METHODS, load_method_params
from evreal_tpu_torch.models import build_model
from evreal_tpu_torch.models.init import init_firenet

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

torch.set_num_threads(1)

NARROW_UNET = {"num_bins": 5, "base_num_channels": 8, "kernel_size": 3,
               "num_encoders": 2, "recurrent_block_type": "convlstm",
               "num_residual_blocks": 1, "skip_type": "sum", "norm": None,
               "use_upsample_conv": True}
HYPER = dict(NARROW_UNET, num_encoders=3, use_dynamic_decoder=True,
             recurrent_block_type="convgru")
FIRENET_LEGACY = {"num_bins": 5, "base_num_channels": 8, "kernel_size": 3,
                  "recurrent_block_type": "convgru", "num_residual_blocks": 2,
                  "recurrent_blocks": {"resblock": [0]}, "skip_type": "sum",
                  "norm": "none"}
FIRENET = {"num_bins": 5, "base_num_channels": 8, "kernel_size": 3}
EITR = {"num_bins": 5, "norm": None}

# method -> (registry class, constructor kwargs, kwargs the schema records)
METHODS = {
    "E2VID": ("E2VIDRecurrent", NARROW_UNET, NARROW_UNET),
    "E2VID+": ("E2VIDRecurrent", NARROW_UNET, NARROW_UNET),
    "FireNet": ("FireNet_legacy", FIRENET_LEGACY, FIRENET_LEGACY),
    "FireNet+": ("FireNet", FIRENET, FIRENET),
    "SPADE-E2VID": ("SpadeE2vid", {}, None),
    "SSL-E2VID": ("E2VIDRecurrent", SSL_E2VID_KWARGS, None),
    # fixed widths; a narrow FFN (the loader reads it from the arrays)
    "ET-Net": ("EITR", dict(EITR, dim_feedforward=64), EITR),
    "HyperE2VID": ("E2VIDRecurrent", HYPER, HYPER),
}


def write_checkpoints(root):
    """Random-weight reference checkpoints of all eight methods under
    ``root/pretrained/<method>/model.pth`` (the repository's configs name
    these paths); BN statistics randomized."""
    paths = {}
    for i, (method, (cls, kwargs, recorded)) in enumerate(METHODS.items()):
        torch.manual_seed(i)
        model = build_model(cls, kwargs)
        g = torch.Generator().manual_seed(100 + i)
        with torch.no_grad():
            for name, buf in model.named_buffers():
                if name.endswith("running_mean"):
                    buf.normal_(0.0, 0.1, generator=g)
                elif name.endswith("running_var"):
                    buf.uniform_(0.5, 1.5, generator=g)
        path = root / "pretrained" / method / "model.pth"
        path.parent.mkdir(parents=True)
        save_method_checkpoint(path, method, model, recorded)
        paths[method] = path
    return paths


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    return root, write_checkpoints(root)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_pth_loader_matches_jax_loader(checkpoints, method):
    _, paths = checkpoints
    sd, meta = load_method_checkpoint(method, str(paths[method]))
    j_flat, j_meta = j_load(method, str(paths[method]))
    assert meta == j_meta
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    got = convert_state_dict(sd)
    assert got.keys() == j_flat.keys()
    for k, v in j_flat.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(got[k], v), k
    # and the port builds the model the arrays describe, strictly
    cls = meta["class"]
    model = build_model(cls, meta["kwargs"], meta.get("num_encoders"), sd)
    model.load_state_dict(sd, strict=True)
    assert type(model).__name__ == {"FireNet_legacy": "FireNetLegacy"}.get(
        cls, cls)


def test_npz_beside_the_pth_wins_and_nothing_is_written(tmp_path,
                                                       monkeypatch):
    """A converted .npz with its sidecar beside the named .pth is read;
    without its sidecar the .pth is; without either the loader raises.
    No file is written anywhere in the tree."""
    monkeypatch.chdir(tmp_path)
    d = tmp_path / "pretrained" / "FireNet+"
    d.mkdir(parents=True)
    torch.manual_seed(0)
    model = build_model("FireNet", FIRENET)
    save_method_checkpoint(d / "model.pth", "FireNet+", model, FIRENET)
    cfg = {"model_name": "FireNet+", "model_path": "pretrained/FireNet+/"
                                                   "model.pth"}
    sd, meta = load_method_params(cfg)
    assert meta["num_encoders"] == 0 and meta["model_name"] == "FireNet+"
    torch.testing.assert_close(sd["head.conv2d.weight"],
                               model.state_dict()["head.conv2d.weight"])
    assert sorted(p.name for p in d.iterdir()) == ["model.pth"]

    tree = init_firenet(seed=5, base_num_channels=8)
    save_params(d / "model.npz", flatten(tree),
                {"class": "FireNet", "kwargs": FIRENET, "num_encoders": 0})
    sd, meta = load_method_params(cfg)
    assert "model_name" not in meta  # the sidecar's meta
    np.testing.assert_array_equal(
        sd["head.conv2d.weight"].numpy(),
        tree["head"]["conv2d"]["weight"].transpose(3, 2, 0, 1))
    os.remove(d / "model.npz.json")
    assert load_method_params(cfg)[1]["model_name"] == "FireNet+"
    os.remove(d / "model.pth")
    with pytest.raises(FileNotFoundError, match="sidecar"):
        load_method_params(cfg)
    with pytest.raises(FileNotFoundError, match="neither"):
        load_method_params({"model_name": "E2VID",
                            "model_path": "pretrained/E2VID/model.pth"})


def test_all_eight_methods_run_from_pth_on_cpu(checkpoints, capsys):
    """``python -m evreal_tpu_torch`` over every method config of the
    repository, weights from the reference checkpoints: eight output trees
    with finite scores, and no contained exception."""
    root, _ = checkpoints
    make_sequence(str(root / "data" / "SYN" / "seq0"), height=32, width=48,
                  duration_s=0.6, fps=15, events_per_frame=400, seed=9)
    (root / "config" / "dataset").mkdir(parents=True)
    (root / "config" / "dataset" / "SYN.json").write_text(json.dumps(
        {"root_path": "data/SYN", "sequences": {"seq0": {}}}))
    cwd = os.getcwd()
    try:
        os.chdir(root)
        torch_main(["-m", *ALL_METHODS, "-c", "std", "-d", "SYN", "-qm",
                    "mse", "ssim", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    out = capsys.readouterr().out
    assert "Exception while" not in out, out
    assert sorted(ALL_METHODS) == sorted(METHODS)
    for method in ALL_METHODS:
        tree = root / "outputs" / "std" / "SYN" / "seq0" / method
        stamps = (tree / "timestamps.txt").read_text().splitlines()
        assert len(stamps) >= 8, method
        assert len(list(tree.glob("frame_*.png"))) == len(stamps), method
        for metric in ("mse", "ssim"):
            rows = np.atleast_2d(np.loadtxt(tree / f"{metric}.txt"))
            assert len(rows) >= len(stamps) - 1, (method, metric)
            assert np.isfinite(rows).all(), (method, metric)


def test_evaluate_defaults_to_the_jax_method_list(monkeypatch):
    """Without method names, both packages' ``evaluate`` run the same
    eight methods in the same order."""
    from evreal_tpu.harness import runner as jrunner
    from evreal_tpu_torch.harness import runner as trunner

    seen = {"jax": [], "torch": []}
    for name, mod in (("jax", jrunner), ("torch", trunner)):
        monkeypatch.setattr(mod, "eval_method_with_config",
                            lambda cfg, m, *a, _s=seen[name]: _s.append(m)
                            or [])
        monkeypatch.setattr(mod, "get_dataset_configs",
                            lambda names: [{"name": "X"}])
        monkeypatch.setattr(mod, "get_datasets", lambda *a: [])
        monkeypatch.setattr(mod, "print_scores", lambda *a: None)
    monkeypatch.setattr(jrunner, "get_eval_info_str", lambda *a: "")
    jrunner.evaluate(eval_config_names=["std"], metrics=["mse"])
    trunner.evaluate(eval_config_names=["std"], metrics=["mse"],
                     device="cpu")
    assert seen["torch"] == seen["jax"] == ALL_METHODS
