"""The port's background PNG writer on the card: a numpy view of a pinned
host tensor keeps its block out of the caching host allocator, and
``evaluate`` on ``cuda``, lockstep and one sequence at a time (frames
fetched through ``to_host``'s pinned tensors, several chunks, writers of
two frames), writes PNGs that decode to the frames the loop fetched, byte
for byte. These tests need an NVIDIA GPU and skip without one; the file
imports nothing of JAX, so on the card they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_writer.py
"""

import json
import threading

import numpy as np
import pytest
import torch

from evreal_tpu_torch.convert.params import flatten, save_params
from evreal_tpu_torch.data.synthetic import make_sequence
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.harness.outputs import AsyncImageWriter, decode_png
from evreal_tpu_torch.metrics import tracker as ttracker
from evreal_tpu_torch.models.init import init_e2vid

pytestmark = pytest.mark.cuda

CHUNK_T = 8  # 3 and 4 chunks a lane, above the pipeline depth of 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda_writer.py)")
    return torch.device("cuda")


def test_pinned_view_keeps_its_block(cuda_device):
    src = torch.arange(64 * 1024, dtype=torch.uint8, device=cuda_device)
    host, events = trunner.to_host({"images": src.view(64, 1024)})
    assert host["images"].is_pinned()
    ptr = host["images"].data_ptr()
    frame = trunner.from_host(host, events)["images"][3]
    del host, events
    # the view still holds the block: a new pinned tensor of the same size
    # is handed another one
    other = torch.empty(64 * 1024, dtype=torch.uint8, pin_memory=True)
    assert other.data_ptr() != ptr
    np.testing.assert_array_equal(frame, src.view(64, 1024)[3].cpu().numpy())


@pytest.mark.parametrize("batched", ["1", "0"], ids=["lockstep", "single"])
def test_pngs_are_the_fetched_frames(cuda_device, tmp_path, monkeypatch,
                                     batched):
    """Lockstep: the lanes' frames are copied out of the pinned tensors;
    single: each queued frame is a view of one."""
    for i, dur in enumerate((1.0, 1.4)):
        make_sequence(str(tmp_path / "data" / "SYNW" / f"seq{i}"), height=48,
                      width=64, duration_s=dur, fps=25, events_per_frame=800,
                      seed=60 + i)
    kwargs = {"num_bins": 5, "base_num_channels": 8, "kernel_size": 3,
              "num_encoders": 2, "recurrent_block_type": "convlstm",
              "num_residual_blocks": 1, "skip_type": "sum", "norm": None,
              "use_upsample_conv": True, "final_activation": "sigmoid"}
    path = tmp_path / "E2VID.npz"
    save_params(path, flatten(init_e2vid(seed=0, base_num_channels=8,
                                         kernel_size=3, num_encoders=2,
                                         num_residual_blocks=1)),
                {"class": "E2VIDRecurrent", "kwargs": kwargs,
                 "model_name": "E2VID"})
    for group, name, cfg in (
            ("method", "E2VID", {"model_name": "E2VID",
                                 "model_path": str(path),
                                 "event_tensor_normalization": True,
                                 "post_process_norm": "robust"}),
            ("dataset", "SYNW", {"root_path": "data/SYNW",
                                 "sequences": {"seq0": {}, "seq1": {}}})):
        (tmp_path / "config" / group).mkdir(parents=True, exist_ok=True)
        (tmp_path / "config" / group / f"{name}.json").write_text(
            json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EVREAL_BATCHED", batched)
    monkeypatch.setattr(trunner, "DEFAULT_CHUNK_T", CHUNK_T)
    monkeypatch.setattr(ttracker, "AsyncImageWriter",
                        lambda: AsyncImageWriter(maxsize=2))
    fetched = {}
    real_update = ttracker.EvalMetricsTracker.update

    def update(self, idx, img_u8, *args, **kwargs):
        fetched[self.output_dir, idx] = np.array(img_u8)  # a copy
        return real_update(self, idx, img_u8, *args, **kwargs)

    monkeypatch.setattr(ttracker.EvalMetricsTracker, "update", update)
    trunner.evaluate(["E2VID"], ["std"], ["SYNW"], ["mse", "ssim"],
                     device="cuda")
    assert not [t for t in threading.enumerate()
                if t.name == AsyncImageWriter.THREAD_NAME]
    assert len({d for d, _ in fetched}) == 2
    assert len(fetched) > 6 * CHUNK_T
    for (out, idx), frame in fetched.items():
        with open(f"{out}/frame_{idx:010d}.png", "rb") as f:
            np.testing.assert_array_equal(decode_png(f.read()), frame)
    for i in range(2):
        assert (tmp_path / "outputs/std/SYNW" / f"seq{i}" / "E2VID" /
                "done.json").exists()
