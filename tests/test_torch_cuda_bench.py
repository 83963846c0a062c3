"""The port's measurement entry point (evreal_tpu_torch/bench/) on the card:
the flagship, methods and profile modes at full width but short, their
device metrics present and in range, the voxelizer launched on every leg.
These tests need an NVIDIA GPU and skip without one; the file imports
nothing of JAX, so on the card they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_bench.py
"""

import json

import pytest
import torch

from evreal_tpu_torch.bench.__main__ import main

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda_bench.py)")
    return torch.device("cuda")


def last_line(argv, capsys):
    assert main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "W" in lines[0]  # nvidia-smi's name, power limit
    line = json.loads(lines[-1])
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["power_limit_w"] > 0
    return line


def test_flagship_on_the_card(cuda_device, capsys):
    line = last_line(["flagship", "--windows", "32", "--repeats", "1"],
                     capsys)
    assert line["metric"] == "e2vid_recon_fps_ecd_b16"
    assert 0 < line["mfu_vs_bf16_peak"] <= 1
    assert 0 < line["device_busy_share"] <= 1
    assert line["lane0_vs_single_max_abs_err"] <= 1e-4
    assert all(n["highest"] + n["default"] > 0
               for n in line["voxelize_launches"].values())
    assert line["voxelize_launches"]["device_resident_bf16_compact4"][
        "default"] > 0
    assert line["probes"]["matmul_bf16_tflops"] > 0


def test_methods_on_the_card(cuda_device, capsys):
    line = last_line(["methods", "-m", "FireNet", "--windows", "32",
                      "--repeats", "1"], capsys)
    row = line["methods"]["FireNet"]
    assert row["ms_per_frame"] > 0 and 0 < row["mfu_vs_bf16_peak"] <= 1


def test_profile_on_the_card(cuda_device, capsys, tmp_path):
    line = last_line(["profile", "--lanes", "4", "--windows", "32",
                      "--trace", str(tmp_path / "t.json")], capsys)
    assert 0 < line["device_busy_share"] <= 1
    assert line["kernel_ms_by_category"]["conv"] > 0
    assert line["kernel_ms_by_category"]["voxelize"] > 0
