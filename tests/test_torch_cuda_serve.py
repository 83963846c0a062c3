"""The serving engine (evreal_tpu_torch/serve.py) on the card: against the
engine on the CPU, and the voxelizer's launches at the serve shapes (T = 1
for a stream's push, T = n for an n-lane group's) bit-equal to its int64
plain version. These tests need an NVIDIA GPU and skip without one; the
file imports nothing of JAX, so on the card they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serve.py
"""

import numpy as np
import pytest
import torch

from evreal_tpu_torch import serve
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.kernels import voxelize_cuda
from evreal_tpu_torch.models import build_model, flagship_e2vid_kwargs
from evreal_tpu_torch.ops import voxelize as tvox

pytestmark = pytest.mark.cuda

H, W, B = 180, 240, 5
EVENTS = 30000
TOL_RECON = 1e-4  # raw E2VID output, card (TF32 off) vs CPU (chip_smoke.py)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda_serve.py)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _switches(monkeypatch):
    monkeypatch.setenv("EVREAL_WIRE", "f32")
    monkeypatch.delenv("EVREAL_DTYPE", raising=False)
    monkeypatch.delenv("EVREAL_VOXEL_PRECISION", raising=False)


def model():
    torch.manual_seed(0)
    return build_model("E2VIDRecurrent", flagship_e2vid_kwargs()).eval()


def windows(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ts = np.sort(rng.uniform(0.03 * i, 0.03 * (i + 1), EVENTS))
        out.append((rng.integers(0, W, EVENTS).astype(np.int16),
                    rng.integers(0, H, EVENTS).astype(np.int16), ts,
                    rng.integers(0, 2, EVENTS).astype(np.uint8)))
    return out


def test_engine_on_the_card_matches_the_cpu(cuda_device):
    """A stream and a 4-lane group with an idle lane: raw frames
    (post-norm 'none') of the card within 1e-4 of the CPU engine's."""
    wins = windows(0, 4)
    lanes = [windows(j + 1, 3) for j in range(4)]
    out = {}
    for dev in ("cuda", "cpu"):
        engine = serve.ReconEngine(model(), device=dev, event_norm=True,
                                   post_norm="none")
        sid, gid = engine.open_stream(H, W), engine.open_group(4, H, W)
        out[dev] = ([engine.push(sid, *w) for w in wins],
                    [engine.push_group(gid, [None if (t, j) == (1, 3)
                                             else lanes[j][t]
                                             for j in range(4)])
                     for t in range(3)])
    for a, b in zip(out["cuda"][0] + out["cuda"][1],
                    out["cpu"][0] + out["cpu"][1]):
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= TOL_RECON


@pytest.mark.parametrize("switches,lanes,precision", [
    ({}, 1, "highest"), ({}, 4, "highest"),
    ({"EVREAL_DTYPE": "bfloat16", "EVREAL_WIRE": "compact4"}, 1, "default"),
    ({"EVREAL_DTYPE": "bfloat16", "EVREAL_WIRE": "compact4"}, 4, "default")])
def test_serve_launches_bit_equal_to_int64_plain(cuda_device, monkeypatch,
                                                 switches, lanes, precision):
    """One launch per push (T = 1, the direct path) or push_group (T =
    lanes, the tiled path), each output bit-equal to
    ``voxelize_buffers_plain(accum_dtype=torch.int64)`` on the launch's own
    buffers; the tiled accumulate kernel's grid is one block per (window,
    tile) pair while the pairs fit one block an SM."""
    for k, v in switches.items():
        monkeypatch.setenv(k, v)
    seen = []
    real = trunner.voxelize_windows

    def recorder(bufs, num_bins, hw, precision=None):
        out = real(bufs, num_bins, hw, precision=precision)
        seen.append(({k: v.clone() for k, v in bufs.items()}, out.clone(),
                     precision))
        return out

    recorder.supported_precisions = real.supported_precisions
    monkeypatch.setattr(trunner, "voxelize_windows", recorder)
    engine = serve.ReconEngine(model(), device="cuda", event_norm=True,
                               post_norm="robust")
    wins = windows(7, 2 * lanes)
    voxelize_cuda.reset_launches()
    if lanes == 1:
        sid = engine.open_stream(H, W)
        for w in wins:
            engine.push(sid, *w)
    else:
        gid = engine.open_group(lanes, H, W)
        for t in range(2):
            engine.push_group(gid, wins[t * lanes:(t + 1) * lanes])
    pushes = len(wins) if lanes == 1 else 2
    want = dict.fromkeys(voxelize_cuda.PRECISIONS, 0)
    want[precision] = pushes
    assert voxelize_cuda.launches_by_precision == want
    path = voxelize_cuda.route((lanes, 1))
    assert voxelize_cuda.launches_by_path == dict(
        dict.fromkeys(voxelize_cuda.PATHS, 0), **{path: pushes})
    if path == "tiled":
        pairs = lanes * voxelize_cuda.tile_count(
            voxelize_cuda.tile_plan(B, H, W), H, W)
        assert pairs <= torch.cuda.get_device_properties(
            0).multi_processor_count
        assert voxelize_cuda.last_accumulate_grid() == pairs
    assert len(seen) == pushes
    for bufs, got, prec in seen:
        assert bufs["count"].shape == (lanes,)
        assert (prec or "highest") == precision
        exact = tvox.voxelize_buffers_plain(
            bufs, B, (H, W), accum_dtype=torch.int64,
            bf16_factors=precision == "default")
        assert torch.equal(got, exact)
