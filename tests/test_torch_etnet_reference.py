"""The benchmark's plain ET-Net (``benchmark/reference/etnet.py``) against
the port's ``EITR`` (``evreal_tpu_torch/models/etnet.py``) on the CPU:
the weights the benchmark draws from a seed (its ``configs/etnet.json``
at a narrow head and FFN) load ``strict=True`` into both, and two lanes
at 48 x 64 over six windows give the same frames and recurrent state,
within 1e-5 (float32 sums taken in another order: blocked attention
against the written-out one, grouped projections against packed ones).
The reference takes EVREAL's nested ``eitr_kwargs`` as it takes
keywords."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib.spec import read_json  # noqa: E402
from benchmark.lib.weights import draw  # noqa: E402
from benchmark.reference import etnet as ref  # noqa: E402
from benchmark.reference.models import build, param_shapes  # noqa: E402
from evreal_tpu_torch.models import build_model  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
H, W, LANES, WINDOWS = 48, 64, 2, 6


@pytest.fixture(scope="module")
def nets():
    config = read_json(os.path.join(ROOT, "benchmark/configs/etnet.json"))
    config["kwargs"] = dict(config["kwargs"], base_num_channels=8,
                            dim_feedforward=64)
    sd = draw(param_shapes(config), config["init"], "cpu", 3)
    reference = build(config)
    reference.load_state_dict(sd, strict=True)
    port = build_model("EITR", {"eitr_kwargs": config["kwargs"]},
                       state_dict=sd).eval()
    port.load_state_dict(sd, strict=True)
    return reference, port, sd


def test_state_dicts_have_one_layout(nets):
    reference, port, sd = nets
    assert list(reference.state_dict()) == list(port.state_dict())
    for k, v in port.state_dict().items():
        assert v.shape == sd[k].shape, k
    # every LayerNorm at torch's own initialisation (init.set)
    norms = [k for k in sd if ".norm" in k]
    assert norms and all(
        torch.all(sd[k] == (1.0 if k.endswith("weight") else 0.0))
        for k in norms)


def test_nested_kwargs_build_the_same_network():
    kw = {"num_bins": 5, "norm": None, "base_num_channels": 8,
          "num_encoder_layers": 1, "num_decoder_layers": 1,
          "dim_feedforward": 32}
    nested = ref.EITR(eitr_kwargs=kw).state_dict()
    flat = ref.EITR(**kw).state_dict()
    assert {k: v.shape for k, v in nested.items()} == \
        {k: v.shape for k, v in flat.items()}


def test_frames_and_state_match_the_port(nets):
    reference, port, _ = nets
    rng = np.random.default_rng(4)
    vox = rng.normal(size=(WINDOWS, LANES, 5, H, W)).astype(np.float32)
    vox *= rng.uniform(size=vox.shape) < 0.3
    st_ref = reference.init_state(LANES, H, W, "cpu")
    st_port = port.init_state(LANES, H, W)
    with torch.no_grad():
        for t in range(WINDOWS):
            x = torch.from_numpy(vox[t])
            img_ref, st_ref = reference.step(x, st_ref)
            out, st_port = port(x, st_port)
            torch.testing.assert_close(out["image"], img_ref, atol=TOL,
                                       rtol=0, msg=f"frame {t}")
            for i, (a, b) in enumerate(zip(st_port, st_ref)):
                for j in range(2):
                    torch.testing.assert_close(
                        a[j], b[j], atol=TOL, rtol=0,
                        msg=f"window {t} stage {i} {('h', 'c')[j]}")
        assert float(img_ref.std()) > 0  # frames that carry something
