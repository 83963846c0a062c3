"""The port's robustness sweep (``python -m evreal_tpu_torch.sweep``) on the
card: every condition ok, the voxelizer launched in each CLI run, the
score rows within 1e-3 of the same sweep on the CPU. These tests need an
NVIDIA GPU and skip without one; the file imports nothing of JAX, so on
the card they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sweep.py
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from evreal_tpu_torch import sweep
from evreal_tpu_torch.bench.models import write_method_checkpoints

pytestmark = pytest.mark.cuda

TOL_SCORE = 1e-3  # mse / ssim rows, card vs CPU
METHOD = "FireNet+"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda_sweep.py)")
    return torch.device("cuda")


def run_sweep(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = sweep.main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("family, conditions", [("t", ["t10ms", "t40ms"]),
                                                ("k", ["k5k"]),
                                                ("kr", ["kr0.5"])])
def test_sweep_on_the_card_matches_the_cpu(cuda_device, tmp_path, family,
                                           conditions):
    sweep.provision_dataset(str(tmp_path), height=64, width=96,
                            duration=0.8, events_per_frame=4000)
    # seed 1 + 3: FireNet+'s random output lies inside (0, 1)
    write_method_checkpoints(torch, str(tmp_path), [METHOD], seed=1)
    rows = {}
    for device in ("cuda", "cpu"):
        rc, summary = run_sweep(["--device", device, "--root", str(tmp_path),
                                 "--methods", METHOD, "--family", family,
                                 "--conditions", *conditions])
        assert rc == 0 and summary["ok"], summary
        for r in summary["conditions"]:
            want = r["voxelize_launches"]["highest"]
            assert (want > 0) if device == "cuda" else want == 0, r
        assert set(summary["means"][METHOD]) == set(conditions)
        rows[device] = {
            (c, s, m): np.loadtxt(tmp_path / "outputs" / c / sweep.DATASET
                                  / s / METHOD / f"{m}.txt", ndmin=2)
            for c in conditions for s in ("seq0", "seq1")
            for m in ("mse", "ssim")}
    for key, want in rows["cpu"].items():
        got = rows["cuda"][key]
        assert got.shape == want.shape and len(want) >= 1, key
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0,
                                   atol=TOL_SCORE)
