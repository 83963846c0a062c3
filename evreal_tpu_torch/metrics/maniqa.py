"""MANIQA, the multi-dimension attention network for no-reference IQA
(Yang et al., CVPRW 2022; ``evreal_tpu/metrics/maniqa.py``), the third
no-reference metric of the reference's Table-3 commands (README.md:99-102,
through its pyiqa factory, utils/eval_metrics.py:100-159).

The published architecture (IIGROUP/MANIQA ``models/maniqa.py``, which
pyiqa vendors as ``archs/maniqa_arch.py``):

  1. ViT-B/8 (timm ``vit_base_patch8_224``, 12 heads, LayerNorm eps 1e-6):
     the tokens of blocks 6-9, cls dropped, concatenated -> (784, 3072).
  2. Stage 1: two TABlocks (attention over channels, with the official
     transpose-then-reshape layout quirk) -> 1x1 conv -> a windowed (Swin)
     transformer: relative-position bias, shifted windows with their mask,
     scaled residuals, LayerNorm eps 1e-5.
  3. Stage 2: the same at the next width.
  4. Per-patch score and sigmoid-weight heads; a crop's score is
     sum(w * s) / sum(w); the frame's is the mean over its crops.

Every width and depth is read off the weights, keyed by the torch
state-dict names that ``tools/convert_maniqa.py`` writes (with
``_meta_scale`` and ``_meta_window``) to ``weights/maniqa.npz`` or the file
``EVREAL_MANIQA_PARAMS`` names. Crop positions are seeded (pyiqa's are
not), and frames under 224 px a side are upscaled bilinearly first.
``EVREAL_MANIQA_CROPS`` (default 20) is checked at each call: a bad value
raises, and the runner drops the metric with the message.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_PARAMS = os.path.join(os.path.dirname(__file__), os.pardir,
                              os.pardir, "weights", "maniqa.npz")

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CROP = 224  # ViT-B/8 input resolution
FEATURE_BLOCKS = (6, 7, 8, 9)  # maniqa_arch extract_feature
VIT_HEADS = 12  # ViT-B


def params_path():
    return os.environ.get("EVREAL_MANIQA_PARAMS", DEFAULT_PARAMS)


def load_params(path=None):
    """{name: numpy array} of the weights, ``_meta_scale`` and
    ``_meta_window`` as Python numbers (0.8 and 4 when absent)."""
    data = np.load(path or params_path())
    params = {k: data[k] for k in data.files}
    params["_meta_scale"] = float(params.pop("_meta_scale", 0.8))
    params["_meta_window"] = int(params.pop("_meta_window", 4))
    return params


def n_crops_from_env():
    raw = os.environ.get("EVREAL_MANIQA_CROPS", "20")
    try:
        n_crops = int(raw)
    except ValueError:
        raise ValueError(
            f"EVREAL_MANIQA_CROPS={raw!r} is not an integer") from None
    if n_crops < 1:
        raise ValueError(f"EVREAL_MANIQA_CROPS={n_crops} must be >= 1")
    return n_crops


# ---------------------------------------------------------------------------
# layers (torch conventions: Linear weight (out, in))


def _linear(x, p, name):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _layer_norm(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def _attend(q, k, v, scale, *biases):
    attn = (q @ k.transpose(-2, -1)) * scale
    for bias in biases:
        attn = attn + bias
    return attn.softmax(-1) @ v


def _mha(x, p, prefix, num_heads):
    """Multi-head self-attention over (B, N, C), fused qkv (timm)."""
    b, n, c = x.shape
    hd = c // num_heads
    qkv = _linear(x, p, f"{prefix}.qkv").reshape(b, n, 3, num_heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    out = _attend(q, k, v, hd ** -0.5).transpose(1, 2).reshape(b, n, c)
    return _linear(out, p, f"{prefix}.proj")


def _vit_features(x, p):
    """(B, 3, 224, 224) normalized crops -> the block 6-9 tokens
    concatenated, (B, 784, 4 C). Blocks past the last tap are skipped."""
    w = p["vit.patch_embed.proj.weight"]  # (C, 3, 8, 8)
    x = F.conv2d(x, w, p["vit.patch_embed.proj.bias"], stride=w.shape[-1])
    x = x.flatten(2).transpose(1, 2)  # (B, gh * gw, C)
    cls = p["vit.cls_token"].expand(x.shape[0], 1, x.shape[2])
    x = torch.cat([cls, x], 1) + p["vit.pos_embed"]
    feats = []
    for i in range(max(FEATURE_BLOCKS) + 1):
        pre = f"vit.blocks.{i}"
        x = x + _mha(_layer_norm(x, p, f"{pre}.norm1", 1e-6), p,
                     f"{pre}.attn", VIT_HEADS)
        h = F.gelu(_linear(_layer_norm(x, p, f"{pre}.norm2", 1e-6), p,
                           f"{pre}.mlp.fc1"))
        x = x + _linear(h, p, f"{pre}.mlp.fc2")
        if i in FEATURE_BLOCKS:
            feats.append(x[:, 1:])
    return torch.cat(feats, -1)


def _tablock(x, p, prefix):
    """(B, C, N): the linears act on N, the attention is C x C; the
    official forward's (attn @ v).transpose(-2, -1).reshape(B, C, N)
    layout quirk kept."""
    b, c, n = x.shape
    q, k, v = (_linear(x, p, f"{prefix}.{name}")
               for name in ("c_q", "c_k", "c_v"))
    out = _attend(q, k, v, n ** -0.5).transpose(-2, -1).reshape(b, c, n)
    return out + x


def rel_position_index(ws):
    """Swin's relative-position index of a ws x ws window."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_mask(hw, ws, shift):
    """Additive attention mask of the shifted windows, (nW, N, N)."""
    img = np.zeros((hw, hw), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    win = img.reshape(hw // ws, ws, hw // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    return (win[:, None, :] != win[:, :, None]).astype(np.float32) * -100.0


def _window_attention(x, p, prefix, ws, mask):
    """(B, nW, N, C) window tokens, relative-position-biased attention."""
    b, nw, n, c = x.shape
    table = p[f"{prefix}.relative_position_bias_table"]  # ((2ws-1)^2, nH)
    heads = table.shape[1]
    hd = c // heads
    qkv = _linear(x, p, f"{prefix}.qkv").reshape(b, nw, n, 3, heads, hd)
    q, k, v = qkv.permute(3, 0, 1, 4, 2, 5)  # (B, nW, nH, N, hd) each
    idx = torch.from_numpy(rel_position_index(ws).reshape(-1)).to(x.device)
    biases = [table[idx].reshape(n, n, heads).permute(2, 0, 1)]
    if mask is not None:
        biases.append(mask[:, None])  # (nW, 1, N, N)
    out = _attend(q, k, v, hd ** -0.5, *biases)
    return _linear(out.permute(0, 1, 3, 2, 4).reshape(b, nw, n, c), p,
                   f"{prefix}.proj")


def _swin_block(x, p, prefix, hw, ws, shift, scale):
    """(B, H * W, C); each residual branch scaled by ``scale`` (MANIQA's
    Swin variant)."""
    b, n, c = x.shape
    h = _layer_norm(x, p, f"{prefix}.norm1", 1e-5).reshape(b, hw, hw, c)
    mask = None
    if shift:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        mask = torch.from_numpy(shift_mask(hw, ws, shift)).to(x.device)
    nw = hw // ws
    h = h.reshape(b, nw, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
    h = _window_attention(h.reshape(b, nw * nw, ws * ws, c), p,
                          f"{prefix}.attn", ws, mask)
    h = h.reshape(b, nw, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    h = h.reshape(b, hw, hw, c)
    if shift:
        h = torch.roll(h, (shift, shift), dims=(1, 2))
    x = x + scale * h.reshape(b, n, c)
    h = F.gelu(_linear(_layer_norm(x, p, f"{prefix}.norm2", 1e-5), p,
                       f"{prefix}.mlp.fc1"))
    return x + scale * _linear(h, p, f"{prefix}.mlp.fc2")


def _swin_stage(x, p, prefix, ws, scale):
    """(B, C, H, W) -> (B, C, H, W); layers and blocks read off ``p``."""
    b, c, hw, _ = x.shape
    x = x.reshape(b, c, hw * hw).transpose(1, 2)
    i = 0
    while f"{prefix}.layers.{i}.blocks.0.norm1.weight" in p:
        j = 0
        while f"{prefix}.layers.{i}.blocks.{j}.norm1.weight" in p:
            x = _swin_block(x, p, f"{prefix}.layers.{i}.blocks.{j}", hw, ws,
                            0 if j % 2 == 0 else ws // 2, scale)
            j += 1
        i += 1
    return x.transpose(1, 2).reshape(b, c, hw, hw)


def _head(x, p, name):
    return _linear(F.relu(_linear(x, p, f"{name}.0")), p, f"{name}.3")[..., 0]


def maniqa_scores(params, crops, window_size=4, scale=0.8):
    """(B, 3, 224, 224) imagenet-normalized crops -> (B,) scores."""
    x = _vit_features(crops, params)  # (B, 784, 4 C)
    b, n, c = x.shape
    hw = int(round(n ** 0.5))
    x = x.transpose(1, 2)  # (B, C, N)
    for stage in (1, 2):
        for i in (0, 1):
            x = _tablock(x, params, f"tablock{stage}.{i}")
        x = F.conv2d(x.reshape(b, -1, hw, hw), params[f"conv{stage}.weight"],
                     params[f"conv{stage}.bias"])
        x = _swin_stage(x, params, f"swintransformer{stage}", window_size,
                        scale).reshape(b, -1, n)
    x = x.transpose(1, 2)  # (B, N, C)
    s = F.relu(_head(x, params, "fc_score"))
    w = torch.sigmoid(_head(x, params, "fc_weight"))
    return (s * w).sum(1) / w.sum(1)


def crop_positions(h, w, n_crops, seed=0):
    """Seeded crop top-left corners (pyiqa's random_crop is unseeded)."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, h - CROP + 1, n_crops)
    xs = rng.integers(0, w - CROP + 1, n_crops)
    return list(zip(ys.tolist(), xs.tolist()))


def maniqa(params, img, n_crops=20, seed=0, window_size=4, scale=0.8):
    """One (H, W) grayscale frame in [0, 1] -> its MANIQA score (higher
    is better): repeated to RGB, upscaled when under 224 px a side, scored
    on ``n_crops`` seeded crops as one batch and averaged."""
    h, w = img.shape
    x = img.to(torch.float32)[None, None]
    if h < CROP or w < CROP:
        s = max(CROP / h, CROP / w)
        h, w = max(int(round(h * s)), CROP), max(int(round(w * s)), CROP)
        x = F.interpolate(x, size=(h, w), mode="bilinear",
                          align_corners=False, antialias=False)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    x = ((x.expand(1, 3, h, w) - mean) / std)[0]
    crops = torch.stack([x[:, y:y + CROP, cx:cx + CROP]
                         for y, cx in crop_positions(h, w, n_crops, seed)])
    return maniqa_scores(params, crops, window_size, scale).mean()


def score_frames(params, imgs):
    """(N, H, W) frames -> (N,) scores, a frame at a time, with
    ``EVREAL_MANIQA_CROPS`` crops each (checked first, even for N = 0)."""
    n_crops = n_crops_from_env()
    if not len(imgs):
        return imgs.new_zeros((0,))
    return torch.stack([maniqa(params, im, n_crops=n_crops,
                               window_size=params["_meta_window"],
                               scale=params["_meta_scale"]) for im in imgs])


def random_params(seed, vit_dim=768, vit_blocks=12, swin_dims=(768, 384),
                  dim_mlp=768, depths=(2, 2), heads=4, window=4, scale=0.8,
                  tokens=784):
    """Seeded random weights in ``tools/convert_maniqa.py``'s names and
    layout, at the published widths of IIGROUP/MANIQA by default (pyiqa's
    ``maniqa``: ViT-B/8 at 224, embed 768, two TABlocks a stage, Swin
    depths [2, 2], 4 heads, window 4, ``dim_mlp`` 768, scale 0.8). Linear
    and conv weights uniform in +-1/sqrt(fan_in) (torch's default), biases
    in +-0.1, norm gains in 0.8..1.2; the score head's last bias is lifted
    by 1 so its ReLU is not stuck at 0."""
    rng = np.random.default_rng(seed)
    p = {}

    def linear(name, n_out, n_in, conv=False):
        bound = n_in ** -0.5
        shape = (n_out, n_in, 1, 1) if conv else (n_out, n_in)
        p[f"{name}.weight"] = rng.uniform(-bound, bound, shape)
        p[f"{name}.bias"] = rng.uniform(-0.1, 0.1, n_out)

    def norm(name, dim):
        p[f"{name}.weight"] = rng.uniform(0.8, 1.2, dim)
        p[f"{name}.bias"] = rng.uniform(-0.1, 0.1, dim)

    patch = int(round(CROP / tokens ** 0.5))
    bound = (3 * patch * patch) ** -0.5
    p["vit.patch_embed.proj.weight"] = rng.uniform(
        -bound, bound, (vit_dim, 3, patch, patch))
    p["vit.patch_embed.proj.bias"] = rng.uniform(-0.1, 0.1, vit_dim)
    p["vit.cls_token"] = rng.normal(0, 0.02, (1, 1, vit_dim))
    p["vit.pos_embed"] = rng.normal(0, 0.02, (1, tokens + 1, vit_dim))
    for i in range(vit_blocks):
        pre = f"vit.blocks.{i}"
        norm(f"{pre}.norm1", vit_dim)
        linear(f"{pre}.attn.qkv", 3 * vit_dim, vit_dim)
        linear(f"{pre}.attn.proj", vit_dim, vit_dim)
        norm(f"{pre}.norm2", vit_dim)
        linear(f"{pre}.mlp.fc1", 4 * vit_dim, vit_dim)
        linear(f"{pre}.mlp.fc2", vit_dim, 4 * vit_dim)
    dims = (4 * vit_dim,) + tuple(swin_dims)
    for stage in (1, 2):
        for i in (0, 1):
            for name in ("c_q", "c_k", "c_v"):
                linear(f"tablock{stage}.{i}.{name}", tokens, tokens)
        dim = dims[stage]
        linear(f"conv{stage}", dim, dims[stage - 1], conv=True)
        for layer, depth in enumerate(depths):
            for j in range(depth):
                pre = f"swintransformer{stage}.layers.{layer}.blocks.{j}"
                norm(f"{pre}.norm1", dim)
                linear(f"{pre}.attn.qkv", 3 * dim, dim)
                linear(f"{pre}.attn.proj", dim, dim)
                p[f"{pre}.attn.relative_position_bias_table"] = rng.normal(
                    0, 0.02, ((2 * window - 1) ** 2, heads))
                norm(f"{pre}.norm2", dim)
                linear(f"{pre}.mlp.fc1", dim_mlp, dim)
                linear(f"{pre}.mlp.fc2", dim, dim_mlp)
    for head in ("fc_score", "fc_weight"):
        linear(f"{head}.0", dims[2], dims[2])
        linear(f"{head}.3", 1, dims[2])
    p["fc_score.3.bias"] += 1.0
    p = {k: v.astype(np.float32) for k, v in p.items()}
    p["_meta_scale"] = np.float64(scale)
    p["_meta_window"] = np.int64(window)
    return p


def make_spec(path):
    """Serial (a frame at a time: 20 crops of ViT-B/8 take ~0.6 GB of
    attention), weights loaded once per process and device."""
    from evreal_tpu_torch.metrics.registry import MetricSpec

    return MetricSpec("maniqa", score_frames, no_ref=True, serial=True,
                      params=lambda: load_params(path))
