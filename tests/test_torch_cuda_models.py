"""Every model class of the port on the card against the CPU: 4-step
recurrent rollouts at a padded odd sensor size, f32 with TF32 off, within
1e-4; and one bf16 step whose state stays bf16 (SPADE's flag bool). Then
LPIPS (AlexNet widths) and MANIQA (small widths, an upscaled odd frame) on
the card against the CPU under ``f32_parity``, within 1e-4. These
tests need an NVIDIA GPU and skip without one; the file imports nothing of
JAX, so on the card they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_models.py
"""

import numpy as np
import pytest
import torch

from evreal_tpu_torch.models import build_model
from evreal_tpu_torch.ops.pad import CropParams
from evreal_tpu_torch.parallel.mesh import replica_on
from evreal_tpu_torch.utils import f32_parity

H, W, STEPS = 37, 53, 4
UNET = {"num_bins": 5, "base_num_channels": 8, "kernel_size": 5,
        "num_encoders": 3, "recurrent_block_type": "convgru",
        "num_residual_blocks": 1, "use_dynamic_decoder": True}
CLASSES = {
    "FireNet": {"base_num_channels": 8},
    "FireNet_legacy": {"base_num_channels": 8, "kernel_size": 3,
                       "recurrent_blocks": {"resblock": [-1]}},
    "E2VIDRecurrent": UNET,
    "FlowNet": dict(UNET, use_dynamic_decoder=False, num_output_channels=3),
    "SpadeE2vid": {},
    "EITR": {"dim_feedforward": 64},
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda_models.py)")
    return torch.device("cuda")


def model_and_inputs(cls):
    torch.manual_seed(0)
    model = build_model(cls, CLASSES[cls]).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=g)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=g)
    rng = np.random.default_rng(2)
    vox = rng.normal(size=(STEPS, 1, 5, H, W)).astype(np.float32)
    vox *= rng.uniform(size=vox.shape) < 0.3
    crop = CropParams(W, H, model.num_encoders)
    return model, [crop.pad(torch.from_numpy(v)) for v in vox], crop


def rollout(model, vox, crop, device, dtype=torch.float32):
    model = replica_on(model, device, dtype)
    ph, pw = crop.padded_shape
    state = model.init_state(1, ph, pw, device=device, dtype=dtype)
    outs = []
    with torch.no_grad(), f32_parity():
        for v in vox:
            out, state = model(v.to(device, dtype), state)
            outs.append(out["image"].float().cpu())
    return outs, state


@pytest.mark.cuda
@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_card_matches_cpu(cuda_device, cls):
    model, vox, crop = model_and_inputs(cls)
    want, _ = rollout(model, vox, crop, torch.device("cpu"))
    got, _ = rollout(model, vox, crop, cuda_device)
    for t, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0,
                                   msg=f"{cls} step {t}")


@pytest.mark.cuda
@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_bf16_step_stays_bf16(cuda_device, cls):
    model, vox, crop = model_and_inputs(cls)
    outs, state = rollout(model, vox[:2], crop, cuda_device, torch.bfloat16)
    assert all(torch.isfinite(o).all() for o in outs)

    def leaves(x):
        if isinstance(x, dict):
            return [t for v in x.values() for t in leaves(v)]
        if isinstance(x, (tuple, list)):
            return [t for v in x for t in leaves(v)]
        return [x]

    dtypes = {t.dtype for t in leaves(state)}
    assert dtypes == ({torch.bfloat16, torch.bool} if cls == "SpadeE2vid"
                      else {torch.bfloat16})


# ---------------------------------------------------------------------------
# the learned metrics: LPIPS and MANIQA on the card against the CPU


def lpips_weights(seed=0):
    """Random LPIPS weights in the port's layout (OIHW), AlexNet widths."""
    rng = np.random.default_rng(seed)
    w = {}
    for i, (idx, cin, cout, k) in enumerate(
            [(0, 3, 64, 11), (3, 64, 192, 5), (6, 192, 384, 3),
             (8, 384, 256, 3), (10, 256, 256, 3)]):
        w[f"features.{idx}.weight"] = rng.normal(0, 0.1, (cout, cin, k, k))
        w[f"features.{idx}.bias"] = rng.normal(0, 0.1, cout)
        w[f"lin.{i}.weight"] = np.abs(rng.normal(0, 0.1, (1, cout, 1, 1)))
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in w.items()}


@pytest.mark.cuda
def test_lpips_card_matches_cpu(cuda_device):
    from evreal_tpu_torch.metrics.lpips import lpips

    w = lpips_weights()
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((4, H * 2, W * 2)).astype(np.float32))
    ref = (img + 0.1 * torch.from_numpy(rng.normal(
        size=img.shape).astype(np.float32))).clamp(0, 1)
    with torch.no_grad(), f32_parity():
        want = lpips(w, img, ref)
        got = lpips({k: v.to(cuda_device) for k, v in w.items()},
                    img.to(cuda_device), ref.to(cuda_device)).cpu()
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_maniqa_card_matches_cpu(cuda_device):
    from evreal_tpu_torch.metrics import maniqa

    raw = maniqa.random_params(0, vit_dim=24, vit_blocks=10, swin_dims=(8, 4),
                               dim_mlp=16)
    w = {k: torch.from_numpy(v) for k, v in raw.items()
         if not k.startswith("_meta")}
    img = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(181, 239)).astype(np.float32))
    with torch.no_grad(), f32_parity():
        want = maniqa.maniqa(w, img, n_crops=2)
        got = maniqa.maniqa({k: v.to(cuda_device) for k, v in w.items()},
                            img.to(cuda_device), n_crops=2).cpu()
    assert abs(float(got - want)) <= 1e-4
