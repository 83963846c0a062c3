#!/usr/bin/env python
"""Time the CUDA voxelizer of two checkouts of this repository on one card.

    python3 tools/voxelizer_ab.py --parent build/parent [--rounds 2]

``--parent`` is a checkout of another commit (for example unpacked from
``git archive <commit>`` into the ignored ``build/parent``); the other
side is the checkout this script lives in. Each side runs in fresh
processes of this script, in turns (parent, change, change, parent per
two rounds), and times the call the runner and the serve engine make,
``evreal_tpu_torch.ops.voxelize.voxelize_windows``, on the serve packer's
buffers (30,000-event windows, capacity 32768, 5 bins at 180 x 240) at
T = 1, 4, 8 and 16 windows: HIGHEST on the f32 wire, DEFAULT on
compact4. Per shape: the median ms of 25 CUDA-event timings with the L2
flushed (``chip_smoke.time_turns``) and the host enqueue us per call
over 200 calls (``chip_smoke.host_enqueue_us``). Each side builds its
own kernels. Prints the card's name and power limit, then one JSON line.
Needs a CUDA device.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (1, 4, 8, 16)
WIRES = (("highest", "f32"), ("default", "compact4"))


def harness():
    """This checkout's ``chip_smoke.py`` as a module (its timing helpers
    and the serve phase's buffers), whichever checkout is imported."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def worker(root):
    """Times ``root``'s voxelizer; returns {precision: {T: {ms, host_us}}}."""
    sys.path.insert(0, root)
    import torch

    from evreal_tpu_torch import serve
    from evreal_tpu_torch.data.packing import bucket_capacity
    from evreal_tpu_torch.ops import voxelize as vox

    cs = harness()
    hw = (cs.ECD["h"], cs.ECD["w"])
    cap = bucket_capacity(cs.EVENTS_PER_WINDOW)
    wins = cs.serve_windows(max(SHAPES), hw)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for prec, wire in WIRES:
        for t_n in SHAPES:
            bufs = cs.serve_shape_bufs(torch, serve, wins, hw, cap, wire,
                                       t_n, "cuda")

            def call(bufs=bufs, prec=prec):
                return vox.voxelize_windows(bufs, cs.ECD["b"], hw,
                                            precision=prec)

            out.setdefault(prec, {})[t_n] = {
                "ms": cs.time_turns(torch, {"call": call}, flush)["call"],
                "host_us": cs.host_enqueue_us(torch, call)}
    return {"root": root, "device": torch.cuda.get_device_name(0),
            "times": out}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the commit to compare")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return
    if not args.parent:
        ap.error("--parent is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    sides = {"parent": os.path.abspath(args.parent), "change": ROOT}
    runs = {name: [] for name in sides}
    for i in range(args.rounds):
        for name in (("parent", "change") if i % 2 == 0
                     else ("change", "parent")):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--worker", sides[name]],
                                  capture_output=True, text=True, timeout=900,
                                  check=False)
            if proc.returncode != 0:
                sys.exit(f"voxelizer_ab: {name} worker failed "
                         f"({proc.returncode}): {proc.stderr[-3000:]}")
            runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(smi, flush=True)
    print(json.dumps({"card": smi, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
