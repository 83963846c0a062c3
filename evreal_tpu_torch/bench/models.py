"""The methods at their published widths with seeded random weights: the
models the bench, the robustness sweep and ``chip_smoke.py`` run (no
checkpoint ships with the repository, and none is downloaded)."""

import os

from evreal_tpu_torch.harness.config import get_method_config

# methods whose widths the repository does not record: their defaults are
# assumptions (PERF.md §4), so they run only when asked for by name
GUESSED_WIDTH = ("ET-Net", "SPADE-E2VID", "HyperE2VID")


def published_methods():
    """method -> (registry class, constructor kwargs, kwargs the method's
    checkpoint schema records) at the published widths: the E2VID family's
    (reference eval.py:134-139), HyperE2VID's (the same plus the dynamic
    decoder and ConvGRU cells), FireNet's (base 16, kernel 3, ConvGRU,
    block 0 of 2 recurrent; Scheerlinck et al., WACV 2020), SPADE-E2VID's
    and ET-Net's fixed ones (ET-Net's FFN width, 4 x 256, is an
    assumption: the repository does not record it)."""
    from evreal_tpu_torch.convert.checkpoint import SSL_E2VID_KWARGS
    from evreal_tpu_torch.models import flagship_e2vid_kwargs

    e2vid = {k: v for k, v in flagship_e2vid_kwargs().items()
             if k != "final_activation"}
    hyper = dict(e2vid, use_dynamic_decoder=True,
                 recurrent_block_type="convgru")
    firenet = {"num_bins": 5, "base_num_channels": 16, "kernel_size": 3}
    legacy = dict(firenet, recurrent_block_type="convgru",
                  num_residual_blocks=2, recurrent_blocks={"resblock": [0]})
    eitr = {"num_bins": 5, "norm": None}
    return {
        "E2VID": ("E2VIDRecurrent", e2vid, e2vid),
        "E2VID+": ("E2VIDRecurrent", e2vid, e2vid),
        "FireNet": ("FireNet_legacy", legacy, legacy),
        "FireNet+": ("FireNet", firenet, firenet),
        "SPADE-E2VID": ("SpadeE2vid", {}, None),
        "SSL-E2VID": ("E2VIDRecurrent", SSL_E2VID_KWARGS, None),
        "ET-Net": ("EITR", dict(eitr, dim_feedforward=4 * 256), eitr),
        "HyperE2VID": ("E2VIDRecurrent", hyper, hyper),
    }


def random_init(torch, model, seed):
    """Seeded random weights from an explicit generator: weights uniform
    in +-1/sqrt(fan_in) (torch's default bound), biases in +-0.1, norm
    gains in 0.8..1.2, BN statistics random."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                bound = p[0].numel() ** -0.5
                p.uniform_(-bound, bound, generator=g)
            elif name.endswith("weight"):
                p.uniform_(0.8, 1.2, generator=g)
            else:
                p.uniform_(-0.1, 0.1, generator=g)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.1, generator=g)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=g)
    return model


def method_model(torch, method, seed):
    """(model on the CPU with seeded random weights, the runner's flags
    ``{"event_norm", "post_norm"}`` from ``config/method/<method>.json``)."""
    from evreal_tpu_torch.models import build_model

    cls, kwargs, _ = published_methods()[method]
    cfg = get_method_config(method)
    model = random_init(torch, build_model(cls, kwargs), seed).eval()
    return model, {"event_norm": cfg.get("event_tensor_normalization",
                                         False),
                   "post_norm": cfg.get("post_process_norm", "none")}


def write_method_checkpoints(torch, root, methods=None, seed=0):
    """Reference-schema ``.pth`` files at the published widths, one per
    method of ``methods`` (default: all eight), at
    ``<root>/pretrained/<method>/model.pth``, the path the repository's
    ``config/method/<method>.json`` names. Method ``i`` of
    ``published_methods()`` takes the seed ``seed + i``, whichever others
    are written with it. An existing file is left in place. Returns
    {method: path} of every method asked for."""
    from evreal_tpu_torch.convert.checkpoint import save_method_checkpoint
    from evreal_tpu_torch.models import build_model

    table = published_methods()
    unknown = sorted(set(methods or ()) - set(table))
    if unknown:
        raise ValueError(f"no published widths for {unknown}; known: "
                         f"{sorted(table)}")
    paths = {}
    for i, (method, (cls, kwargs, recorded)) in enumerate(table.items()):
        if methods is not None and method not in methods:
            continue
        path = os.path.join(root, "pretrained", method, "model.pth")
        paths[method] = path
        if os.path.exists(path):
            continue
        model = random_init(torch, build_model(cls, kwargs), seed=seed + i)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_method_checkpoint(path, method, model, recorded)
    return paths
