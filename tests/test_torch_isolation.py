"""The port imports nothing of JAX, of the JAX package, of OpenCV, of
matplotlib or of pandas (the card's machine has none of them), and no
pyiqa (looked for only when a metric name is not a built-in). Checked in a
fresh interpreter: this test process has imported jax already
(tests/conftest.py)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
import evreal_tpu_torch
names = [m.name for m in pkgutil.walk_packages(evreal_tpu_torch.__path__,
                                               "evreal_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "evreal_tpu", "cv2",
                                    "pyiqa", "optax", "orbax",
                                    "matplotlib", "pandas"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_evreal_tpu():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          check=False)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert {"evreal_tpu_torch.harness.runner",
            "evreal_tpu_torch.harness.batched", "evreal_tpu_torch.cli",
            "evreal_tpu_torch.kernels.voxelize_cuda",
            "evreal_tpu_torch.ops.voxelize",
            "evreal_tpu_torch.__main__",
            "evreal_tpu_torch.utils.color",
            "evreal_tpu_torch.models.colornet",
            "evreal_tpu_torch.harness.histeq",
            "evreal_tpu_torch.harness.video",
            "evreal_tpu_torch.native",
            "evreal_tpu_torch.metrics.registry",
            "evreal_tpu_torch.metrics.lpips",
            "evreal_tpu_torch.metrics.niqe",
            "evreal_tpu_torch.metrics.brisque",
            "evreal_tpu_torch.metrics.maniqa",
            "evreal_tpu_torch.metrics.pyiqa_bridge",
            "evreal_tpu_torch.serve",
            "evreal_tpu_torch.train",
            "evreal_tpu_torch.train_cli",
            "evreal_tpu_torch.parallel.mesh",
            "evreal_tpu_torch.utils.mfu",
            "evreal_tpu_torch.sweep",
            "evreal_tpu_torch.analysis",
            "evreal_tpu_torch.data.synthetic"} <= set(report["modules"])
