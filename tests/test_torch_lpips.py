"""The port's LPIPS (``evreal_tpu_torch/metrics/lpips.py``) against the JAX
package's (``evreal_tpu/metrics/lpips.py``) on the CPU: random AlexNet and
``lin`` weights written in the JAX layout (HWIO, as
``tests/test_lpips_parity.py`` writes them), a batch of frames at 96 x 96
and at an odd 95 x 101, within 2e-5; identical frames score under 1e-6;
and the ``.npz`` read through ``EVREAL_LPIPS_WEIGHTS`` by the registry."""

import numpy as np
import pytest
import torch

from evreal_tpu.metrics import lpips as jl
from evreal_tpu_torch.metrics import lpips as tl
from evreal_tpu_torch.metrics import registry

torch.set_num_threads(1)

TOL = 2e-5  # tests/test_lpips_parity.py's bound against its torch oracle
# torchvision AlexNet features: (index, in, out, kernel)
CONVS = [(0, 3, 64, 11), (3, 64, 192, 5), (6, 192, 384, 3), (8, 384, 256, 3),
         (10, 256, 256, 3)]


def jax_layout_weights(seed):
    """Random weights as ``tools/convert_lpips.py`` writes them: every 4-D
    array HWIO, the lin heads non-negative 1x1 convs without bias."""
    rng = np.random.default_rng(seed)
    w = {}
    for idx, cin, cout, k in CONVS:
        w[f"features.{idx}.weight"] = rng.normal(
            0, 0.1, (cout, cin, k, k)).astype(np.float32)
        w[f"features.{idx}.bias"] = rng.normal(0, 0.1, cout).astype(
            np.float32)
    for i, (_, _, cout, _) in enumerate(CONVS):
        w[f"lin.{i}.weight"] = np.abs(rng.normal(
            0, 0.1, (1, cout, 1, 1))).astype(np.float32)
    return {k: (v.transpose(2, 3, 1, 0) if v.ndim == 4 else v)
            for k, v in w.items()}


def frames(seed, n, hw):
    rng = np.random.default_rng(seed)
    img = rng.random((n,) + hw).astype(np.float32)
    ref = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1).astype(
        np.float32)
    return img, ref


def jax_lpips(w, img, ref):
    import jax.numpy as jnp

    jw = {k: jnp.asarray(v) for k, v in w.items()}
    return np.asarray(jl.lpips(jw, img, ref))


def port_weights(tmp_path, w):
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **w)
    return {k: torch.from_numpy(v) for k, v in tl.load_weights(path).items()}


@pytest.mark.parametrize("hw", [(96, 96), (95, 101)])
def test_batched_lpips_matches_jax(tmp_path, hw):
    w = jax_layout_weights(0)
    img, ref = frames(1, 3, hw)
    got = tl.lpips(port_weights(tmp_path, w), torch.from_numpy(img),
                   torch.from_numpy(ref)).numpy()
    want = jax_lpips(w, img, ref)
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert got.min() > 0


def test_identical_frames_score_zero(tmp_path):
    w = port_weights(tmp_path, jax_layout_weights(2))
    img = torch.from_numpy(frames(3, 2, (96, 96))[0])
    assert float(tl.lpips(w, img, img).abs().max()) < 1e-6


def test_loader_turns_every_4d_array_to_oihw(tmp_path):
    w = jax_layout_weights(4)
    path = tmp_path / "w.npz"
    np.savez(path, **w)
    loaded = tl.load_weights(path)
    assert loaded["features.0.weight"].shape == (64, 3, 11, 11)
    assert loaded["lin.4.weight"].shape == (1, 256, 1, 1)
    assert loaded["features.10.bias"].shape == (256,)
    np.testing.assert_array_equal(loaded["features.3.weight"],
                                  w["features.3.weight"].transpose(3, 2, 0, 1))


def test_registry_reads_weights_through_env(tmp_path, monkeypatch):
    w = jax_layout_weights(5)
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **w)
    monkeypatch.setenv("EVREAL_LPIPS_WEIGHTS", str(path))
    (spec,) = registry.resolve(["LPIPS"])
    assert spec.name == "lpips" and not spec.no_ref and not spec.serial
    img, ref = frames(6, 2, (64, 80))
    got = spec.score(torch.from_numpy(img), torch.from_numpy(ref)).numpy()
    np.testing.assert_allclose(got, jax_lpips(w, img, ref), rtol=0,
                               atol=TOL)
    # the weights load once per process and device
    assert spec.loaded("cpu") is spec.loaded(torch.device("cpu"))
    assert registry.resolve(["lpips"])[0] is spec
