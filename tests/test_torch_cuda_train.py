"""Training (evreal_tpu_torch/train.py, train_cli.py) on the card: a step
on the card against the same step on the CPU, and the voxelizer's
training launches (T = chunk_t windows of a sampled chunk, f32 wire)
bit-equal to its int64 plain version, one launch per sampled chunk. These
tests need an NVIDIA GPU and skip without one; the file imports nothing
of JAX, so on the card they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from evreal_tpu_torch import train, train_cli
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.kernels import voxelize_cuda
from evreal_tpu_torch.ops import voxelize as tvox

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

pytestmark = pytest.mark.cuda

H, W, B = 64, 96, 5
TOL_LOSS = 1e-5  # card (TF32 off) vs CPU, relative
TOL_GRAD = 1e-4  # x max|g| of each gradient tensor


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda_train.py)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _switches(monkeypatch):
    monkeypatch.delenv("EVREAL_VOXEL_PRECISION", raising=False)


@pytest.fixture
def data(tmp_path):
    for j in range(2):
        make_sequence(str(tmp_path / f"seq{j}"), height=H, width=W,
                      duration_s=0.8, fps=25, events_per_frame=3000, seed=j)
    return str(tmp_path)


@pytest.mark.parametrize("arch", ["firenet", "e2vid"])
def test_card_step_matches_cpu(cuda_device, arch):
    """The same weights and batch: the loss within 1e-5 relative and
    every gradient within 1e-4 x its max of the CPU's."""
    rng = np.random.default_rng(0)
    vox = torch.from_numpy(rng.normal(size=(2, 3, B, H, W)).astype(
        np.float32))
    frames = torch.from_numpy(rng.uniform(size=(2, 3, H, W)).astype(
        np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        model, _ = train_cli.build(arch, B, dev)
        step, _ = train.make_train_step(model)
        loss = step({"voxels": vox.to(dev), "frames": frames.to(dev)})
        assert loss.device.type == dev and loss.dim() == 0
        out[dev] = (float(loss), {k: p.grad.cpu().numpy()
                                  for k, p in model.named_parameters()})
    (c_loss, c_grads), (h_loss, h_grads) = out["cuda"], out["cpu"]
    assert c_loss == pytest.approx(h_loss, rel=TOL_LOSS)
    for k, g in h_grads.items():
        assert np.abs(c_grads[k] - g).max() <= TOL_GRAD * np.abs(g).max(), k


def test_training_launches_bit_equal_to_int64_plain(cuda_device, data,
                                                    tmp_path, monkeypatch):
    """Two CLI steps at --batch 3 --chunk-t 8: six HIGHEST launches of
    T = 8 windows, each bit-equal to the int64 plain version on its own
    buffers."""
    seen = []
    real = trunner.voxelize_windows

    def recorder(bufs, num_bins, hw, precision=None):
        out = real(bufs, num_bins, hw, precision=precision)
        seen.append(({k: v.clone() for k, v in bufs.items()}, out.clone(),
                     precision))
        return out

    recorder.supported_precisions = real.supported_precisions
    monkeypatch.setattr(trunner, "voxelize_windows", recorder)
    voxelize_cuda.reset_launches()
    train_cli.main(["--data", data, "--arch", "firenet", "--steps", "2",
                    "--batch", "3", "--chunk-t", "8", "--out",
                    str(tmp_path / "out")])
    want = dict.fromkeys(voxelize_cuda.PRECISIONS, 0)
    want["highest"] = 6
    assert voxelize_cuda.launches_by_precision == want
    assert len(seen) == 6
    for bufs, got, prec in seen:
        assert prec is None and bufs["count"].shape == (8,)
        assert bufs["ts"].dtype == torch.float32  # the f32 wire
        exact = tvox.voxelize_buffers_plain(bufs, B, (H, W),
                                            accum_dtype=torch.int64)
        assert torch.equal(got, exact)
