"""Both command lines on the CPU over one small synthetic sequence, for the
methods this slice adds (FireNet, HyperE2VID, SPADE-E2VID, ET-Net): the
JAX package's (``eval.py``, evreal_tpu.cli) and the port's (``python -m
evreal_tpu_torch``), with the same random weights saved as ``.npz`` +
sidecar (made by the port's modules, BN statistics randomized, laid out by
the JAX package's converter). Score rows agree within 2e-5, PNG frames
within 1 grey level, and timestamps, event rates and frame sets byte for
byte (the pattern of tests/test_torch_eval.py)."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evreal_tpu.convert import convert_state_dict
from evreal_tpu_torch.cli import main as torch_main
from evreal_tpu_torch.convert.params import save_params
from evreal_tpu_torch.models import build_model

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

torch.set_num_threads(1)

HYPER = {"num_bins": 5, "base_num_channels": 8, "kernel_size": 5,
         "num_encoders": 3, "recurrent_block_type": "convgru",
         "num_residual_blocks": 1, "skip_type": "sum", "norm": None,
         "use_upsample_conv": True, "use_dynamic_decoder": True}
# method -> (class, kwargs, extra meta, the method's config flags)
METHODS = {
    "FireNet": ("FireNet_legacy", {
        "num_bins": 5, "base_num_channels": 8, "kernel_size": 3,
        "recurrent_block_type": "convgru", "num_residual_blocks": 2,
        "recurrent_blocks": {"resblock": [0]}, "final_activation": ""}, {},
        {"event_tensor_normalization": True, "post_process_norm": "none"}),
    "HyperE2VID": ("E2VIDRecurrent", {"unet_kwargs": HYPER}, {},
                   {"event_tensor_normalization": False,
                    "post_process_norm": "robust"}),
    "SPADE-E2VID": ("SpadeE2vid", {}, {"num_encoders": 3},
                    {"event_tensor_normalization": False,
                     "post_process_norm": "none"}),
    "ET-Net": ("EITR", {"eitr_kwargs": {"num_bins": 5, "norm": None}},
               {"num_encoders": 3},
               {"event_tensor_normalization": False,
                "post_process_norm": "none"}),
}
ARGS = ["-m", *METHODS, "-c", "std", "-d", "SYN", "-qm", "mse", "ssim"]


def write_inputs(root):
    make_sequence(str(root / "data" / "SYN" / "seq0"), height=40, width=56,
                  duration_s=0.7, fps=20, events_per_frame=600, seed=7)
    for group in ("method", "dataset"):
        (root / "config" / group).mkdir(parents=True)
    for i, (name, (cls, kwargs, extra, flags)) in enumerate(METHODS.items()):
        torch.manual_seed(i)
        model = build_model(cls, kwargs)
        g = torch.Generator().manual_seed(50 + i)
        with torch.no_grad():
            for key, buf in model.named_buffers():
                if key.endswith("running_mean"):
                    buf.normal_(0.0, 0.1, generator=g)
                elif key.endswith("running_var"):
                    buf.uniform_(0.5, 1.5, generator=g)
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        path = root / "pretrained" / name / "model.npz"
        path.parent.mkdir(parents=True)
        save_params(path, convert_state_dict(sd),
                    {"class": cls, "kwargs": kwargs, "model_name": name,
                     **extra})
        cfg = {"model_name": name, "model_path": str(path.relative_to(root)),
               **flags}
        (root / "config" / "method" / f"{name}.json").write_text(
            json.dumps(cfg))
    (root / "config" / "dataset" / "SYN.json").write_text(json.dumps(
        {"root_path": "data/SYN", "sequences": {"seq0": {}}}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Output trees of both command lines: {"jax": dir, "torch": dir}."""
    import evreal_tpu.utils
    from evreal_tpu.cli import eval_main
    from evreal_tpu.harness import staging

    root = tmp_path_factory.mktemp("zoo_eval")
    write_inputs(root)
    cwd = os.getcwd()
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(evreal_tpu.utils, "enable_compile_cache",
                       lambda: None)
            mp.setattr(staging, "_compute_seen", False)
            mp.setattr(staging, "_staged_bytes", 0)
            for name, run in (("jax", lambda: eval_main(ARGS)),
                              ("torch", lambda: torch_main(
                                  ARGS + ["--device", "cpu"]))):
                os.chdir(root)
                run()
                out[name] = root / f"outputs_{name}"
                (root / "outputs").rename(out[name])
    finally:
        os.chdir(cwd)
    return out


def seq_dir(base, method):
    return base / "std" / "SYN" / "seq0" / method


@pytest.mark.parametrize("method", sorted(METHODS))
def test_score_rows_agree(runs, method):
    for metric in ("mse", "ssim"):
        rows = [np.loadtxt(seq_dir(runs[k], method) / f"{metric}.txt")
                for k in ("jax", "torch")]
        assert rows[0].shape == rows[1].shape and len(rows[0]) >= 10
        np.testing.assert_array_equal(rows[0][:, 0], rows[1][:, 0])
        np.testing.assert_allclose(rows[1][:, 1], rows[0][:, 1], atol=2e-5)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_tree_text_files_and_frames_match(runs, method):
    a, b = seq_dir(runs["jax"], method), seq_dir(runs["torch"], method)
    assert sorted(p.name for p in a.iterdir()) == \
        sorted(p.name for p in b.iterdir())
    for name in ("timestamps.txt", "event_rate.txt"):
        assert (a / name).read_bytes() == (b / name).read_bytes()
    ja, jb = (json.loads((d / "done.json").read_text()) for d in (a, b))
    assert ja["num_evaluated"] == jb["num_evaluated"]
    cv2 = pytest.importorskip("cv2")
    frames = sorted(a.glob("frame_*.png"))
    assert len(frames) >= 10
    for p in frames:
        want = cv2.imread(str(p), cv2.IMREAD_UNCHANGED).astype(int)
        got = cv2.imread(str(b / p.name), cv2.IMREAD_UNCHANGED).astype(int)
        assert got.shape == want.shape == (40, 56)
        assert np.abs(got - want).max() <= 1
