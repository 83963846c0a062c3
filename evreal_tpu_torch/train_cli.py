"""Train an event-video reconstruction model from scratch
(``evreal_tpu/train_cli.py``; the reference is inference-only).

Truncated BPTT over fixed-length chunks of windows; a batch is ``--batch``
(sequence, chunk) pairs sampled from the dataset, voxelized on the device
(one voxelizer launch per chunk) and zero-padded to the model's crop:

    python -m evreal_tpu_torch.train_cli --data data/SYN --arch firenet \\
        --steps 200 --chunk-t 8 --batch 4 --out runs/firenet [--device cpu]

It runs on the CUDA card unless ``--device`` names another device. The
trained weights are written as ``<out>/model.npz`` with its ``.npz.json``
sidecar in the JAX package's converted-checkpoint format, so a method
config's ``model_path`` of either package loads them. Job checkpoints
(``--save-every``, ``--resume``) are the port's own: ``torch.save`` files
under ``<out>/ckpt/``, the newest 3 kept.
"""

import argparse
import glob
import os
import re
import time

import numpy as np
import torch

CKPT_KEEP = 3


def build(arch, num_bins, device):
    """(model on ``device``, meta): random-init weights (seed 0) of the
    arch; meta is the converted-checkpoint sidecar, so the trained
    ``model.npz`` reloads through ``load_method_params`` like a converted
    reference checkpoint."""
    from evreal_tpu_torch.convert.params import from_jax_tree
    from evreal_tpu_torch.models import build_model, flagship_e2vid_kwargs
    from evreal_tpu_torch.models.init import init_e2vid, init_firenet

    if arch == "firenet":
        kwargs = {"num_bins": num_bins, "base_num_channels": 16,
                  "kernel_size": 3}
        tree = init_firenet(num_bins=num_bins)
        # the reference forces num_encoders 0 for this arch (eval.py:154-155)
        meta = {"class": "FireNet", "kwargs": kwargs, "num_encoders": 0}
    elif arch == "e2vid":
        kwargs = flagship_e2vid_kwargs(num_bins)
        tree = init_e2vid(num_bins=num_bins)
        meta = {"class": "E2VIDRecurrent", "kwargs": kwargs}
    else:
        raise SystemExit(f"unknown arch {arch}")
    model = build_model(meta["class"], kwargs)
    model.load_state_dict(from_jax_tree(tree), strict=True)
    return model.to(device), meta


def sample_batch(seqs, voxelize, rng, batch, chunk_t, num_bins, crop):
    """Random (sequence, start) chunks -> {'voxels' (N, T, B, H, W),
    'frames' (N, T, H, W), 'mask' (N, T)} tensors on ``voxelize``'s device
    at the padded model resolution: GT frames zero-padded into the crop
    region, ``mask`` 1 only where a window has a frame. ``voxelize`` maps
    a chunk's packed host buffers to its (t, B, H, W) padded grids."""
    from evreal_tpu_torch.data import pack_windows
    from evreal_tpu_torch.utils import upload

    ph, pw = crop.padded_shape
    pt, pl = crop.padding_top, crop.padding_left
    h, w = crop.height, crop.width
    voxels = None
    frames = np.zeros((batch, chunk_t, ph, pw), np.float32)
    mask = np.zeros((batch, chunk_t), np.float32)
    for b in range(batch):
        seq = seqs[rng.integers(len(seqs))]
        start = int(rng.integers(max(len(seq) - chunk_t, 1)))
        idxs = list(range(start, min(start + chunk_t, len(seq))))
        buffers, metas = pack_windows(seq, idxs)
        vox = voxelize(buffers)
        if voxels is None:
            voxels = vox.new_zeros((batch, chunk_t, num_bins, ph, pw))
        voxels[b, :len(idxs)] = vox
        for t, meta in enumerate(metas):
            if meta["frame_index"] is not None:
                frames[b, t, pt:pt + h, pl:pl + w] = seq.frame(
                    meta["frame_index"])
                mask[b, t] = 1.0  # only real windows with a GT frame score
    return {"voxels": voxels,
            **upload({"frames": frames, "mask": mask}, voxels.device)}


def checkpoint_steps(ckpt_dir):
    """{step: path} of the job checkpoints under ``ckpt_dir``."""
    out = {}
    for path in glob.glob(os.path.join(ckpt_dir, "step_*.pt")):
        m = re.fullmatch(r"step_(\d+)\.pt", os.path.basename(path))
        if m:
            out[int(m.group(1))] = path
    return out


def save_checkpoint(ckpt_dir, step, model, optimizer):
    """Params, optimizer state and step, written to a temporary name and
    renamed into place (a reader never finds a truncated file); only the
    newest ``CKPT_KEEP`` checkpoints are kept."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.pt")
    torch.save({"params": model.state_dict(),
                "opt_state": optimizer.state_dict(), "step": step},
               path + ".tmp")
    os.replace(path + ".tmp", path)
    steps = sorted(checkpoint_steps(ckpt_dir))
    for old in steps[:-CKPT_KEEP]:
        os.remove(os.path.join(ckpt_dir, f"step_{old:08d}.pt"))


def restore_checkpoint(ckpt_dir, model, optimizer, device):
    """Load the newest checkpoint into ``model`` and ``optimizer``;
    returns its step, or None when there is none."""
    steps = checkpoint_steps(ckpt_dir)
    if not steps:
        return None
    latest = max(steps)
    state = torch.load(steps[latest], map_location=device, weights_only=True)
    model.load_state_dict(state["params"], strict=True)
    optimizer.load_state_dict(state["opt_state"])
    return int(state["step"])


def main(argv=None):
    from evreal_tpu_torch.convert.params import flatten, save_params, \
        to_jax_tree
    from evreal_tpu_torch.data import Sequence
    from evreal_tpu_torch.harness.runner import make_voxel_stage
    from evreal_tpu_torch.ops.pad import CropParams
    from evreal_tpu_torch.train import build_optimizer, make_train_step
    from evreal_tpu_torch.utils import resolve_device, upload

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True,
                    help="dataset root of memmap sequence dirs")
    ap.add_argument("--arch", default="firenet",
                    choices=["firenet", "e2vid"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--chunk-t", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "cosine"])
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear LR warmup steps")
    ap.add_argument("--weight-decay", type=float, default=0.0,
                    help="adamw decoupled weight decay (0 = plain adam)")
    ap.add_argument("--clip-grad", type=float, default=0.0,
                    help="global-norm gradient clip (0 = off)")
    ap.add_argument("--loss", default="mse",
                    help="'+'-joined terms from {mse, lpips, bce} (lpips "
                         "needs converted weights, weights/README.md; bce "
                         "is the saturation-stable choice for sigmoid-"
                         "output models — see train.sequence_loss)")
    ap.add_argument("--lpips-scale", type=float, default=1.0)
    ap.add_argument("--num-bins", type=int, default=5)
    ap.add_argument("--event-norm", action="store_true",
                    help="zero-mean/unit-std normalize each voxel's nonzero "
                         "entries (the E2VID/FireNet eval-time input norm); "
                         "unnormalized event-count voxels scale with scene "
                         "activity and saturate a sigmoid-output model "
                         "early. Evaluate a checkpoint trained with this "
                         "flag with event_tensor_normalization: true")
    ap.add_argument("--mesh", action="store_true",
                    help="shard over all local devices; one device only "
                         "here (multi-GPU training is not in the port yet)")
    ap.add_argument("--out", default="runs/train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint (params+opt_state+step) every N steps "
                         "under <out>/ckpt; 0 disables")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint under --out")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain CPU path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.mesh and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise SystemExit(
            "--mesh: multi-GPU training (the batch sharded over the visible "
            f"cards, {torch.cuda.device_count()} here) is not in the port "
            "yet; make one card visible (CUDA_VISIBLE_DEVICES) to train on "
            "it")

    seq_dirs = sorted(d for d in glob.glob(os.path.join(args.data, "*"))
                      if os.path.isdir(d))
    seqs = [Sequence(d, num_bins=args.num_bins,
                     voxel_method={"method": "between_frames"})
            for d in seq_dirs]
    if not seqs:
        raise SystemExit(f"no sequences under {args.data}")
    h, w = seqs[0].sensor_resolution
    crop = CropParams(w, h, 3)
    stage = make_voxel_stage(args.num_bins, (h, w), args.event_norm)

    def voxelize(buffers):
        return crop.pad(stage(upload(buffers, device)))

    model, ckpt_meta = build(args.arch, args.num_bins, device)
    lpips_weights = None
    if "lpips" in args.loss.split("+"):
        from evreal_tpu_torch.metrics import lpips as lpips_mod

        if not os.path.exists(lpips_mod.params_path()):
            raise SystemExit("--loss includes lpips but converted weights "
                             "are missing (tools/convert_lpips.py)")
        lpips_weights = {k: torch.from_numpy(v).to(device) for k, v in
                         lpips_mod.load_weights().items()}
    optimizer = build_optimizer(
        lr=args.lr, schedule=args.lr_schedule, steps=args.steps,
        warmup=args.warmup, weight_decay=args.weight_decay,
        clip_grad=args.clip_grad)
    step_fn, optimizer = make_train_step(
        model, optimizer, loss=args.loss, lpips_weights=lpips_weights,
        lpips_scale=args.lpips_scale)

    os.makedirs(args.out, exist_ok=True)
    ckpt_dir = os.path.join(args.out, "ckpt")
    start_step = 0
    if args.resume:
        restored = restore_checkpoint(ckpt_dir, model, optimizer, device)
        if restored is not None:
            start_step = restored
            print(f"resumed from step {restored}", flush=True)

    log_t, log_step = None, start_step
    for step in range(start_step + 1, args.steps + 1):
        # per-step generator: a resumed run reproduces exactly the batch
        # stream an uninterrupted run would have consumed, with no replay
        rng = np.random.default_rng((args.seed, step))
        batch = sample_batch(seqs, voxelize, rng, args.batch, args.chunk_t,
                             args.num_bins, crop)
        loss = step_fn(batch)
        if step % args.log_every == 0 or step == 1:
            loss_v = float(loss)  # device sync: wall below is real work
            now = time.perf_counter()
            rate = ""
            if log_t is not None and step > log_step:
                rate = (f" ({(step - log_step) / (now - log_t):.2f} "
                        f"steps/s)")
            log_t, log_step = now, step
            print(f"step {step}: loss {loss_v:.5f}{rate}", flush=True)
        if args.save_every > 0 and step % args.save_every == 0:
            save_checkpoint(ckpt_dir, step, model, optimizer)

    out_path = os.path.join(args.out, "model.npz")
    # npz + meta sidecar in the JAX layout: the trained checkpoint drops
    # into a method config's model_path of either package
    save_params(out_path, flatten(to_jax_tree(model.state_dict())),
                ckpt_meta)
    print(f"saved {out_path}")


if __name__ == "__main__":
    main()
