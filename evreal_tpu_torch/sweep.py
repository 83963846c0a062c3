"""The robustness sweep on the port (``tools/run_robustness_sweep.py`` for
the JAX package; reference README.md:109-115, analyze_robustness.py): the
metric against window duration (``--family t``: t10ms..t100ms), against
events per window (``k``: k5k..k45k) and against the share of discarded
frames (``kr``: kr0.1..kr1.0).

    python -m evreal_tpu_torch.sweep                         # t, all eight
    python -m evreal_tpu_torch.sweep --family k --methods FireNet+ E2VID
    python -m evreal_tpu_torch.sweep --device cpu --root /tmp/sweep

Under ``--root`` (the repository by default) it provisions what it needs:

  1. two 180 x 240 synthetic sequences under ``data/SYN_SWEEP/`` (3 s at
     25 fps, 24,000 events a frame, seeds 100 and 101), so the t family's
     windows hold 6,000 to 60,000 events;
  2. ``config/dataset/SYN_SWEEP.json``, written where absent and otherwise
     checked against what it would write;
  3. reference-schema ``.pth`` files at the published widths with seeded
     random weights (``bench.models.write_method_checkpoints``) where
     ``pretrained/<method>/model.pth`` is absent;

then runs the port's CLI once per condition, in a subprocess from the
root,

    python -m evreal_tpu_torch -m <methods> -c <condition> -d SYN_SWEEP -qm mse ssim --device <device>

recording per condition its wall seconds, the new files under
``build/evreal_tpu_torch/`` (the voxelizer's and the native packer's
libraries, built at first use: the measure of reuse across conditions),
the steady ms/frame per method and the voxelizer's launches that the CLI
prints. The mean mse per method and condition over the output tree
(``evreal_tpu_torch.analysis.read_scores``) is the summary's ``means``;
``--plots`` runs ``analysis/robustness.py``, which needs matplotlib and
pandas. The summary is one JSON line.

Unlike the JAX tool, which prints ``ok: false`` and exits 0, the sweep
exits 1 when a condition failed: a non-zero exit, a timeout, or an
exception the CLI contained (it prints ``Exception while`` and exits 0).
Every condition runs either way.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

from evreal_tpu_torch.cli import LAUNCHES_PREFIX
from evreal_tpu_torch.harness.config import REPO_ROOT

ALL_METHODS = ["E2VID", "FireNet", "E2VID+", "FireNet+", "SPADE-E2VID",
               "SSL-E2VID", "ET-Net", "HyperE2VID"]
T_CONDITIONS = [f"t{t}ms" for t in range(10, 101, 10)]
K_CONDITIONS = [f"k{k}k" for k in range(5, 46, 5)]
KR_CONDITIONS = [f"kr{r / 10:.1f}" for r in range(1, 11)]
FAMILIES = {"t": T_CONDITIONS, "k": K_CONDITIONS, "kr": KR_CONDITIONS}
# the condition directories analysis/robustness.py reads for each family
PATTERNS = {"t": "t*ms", "k": "k*k", "kr": "kr*"}
DATASET = "SYN_SWEEP"
BUILD_DIR = os.path.join(REPO_ROOT, "build", "evreal_tpu_torch")
CONTAINED = "Exception while"
MS_PER_FRAME = re.compile(r"^(\S+): ([0-9.]+) ms/frame ")


def provision_dataset(root, n_seqs=2, height=180, width=240, duration=3.0,
                      fps=25, events_per_frame=24000):
    """The sweep's sequences under ``<root>/data/SYN_SWEEP`` (each made
    unless its ``metadata.json`` exists) and its dataset config, written
    where absent; an existing config that differs raises."""
    from evreal_tpu_torch.data.synthetic import make_sequence

    seqs = {}
    for i in range(n_seqs):
        seq = f"seq{i}"
        d = os.path.join(root, "data", DATASET, seq)
        if not os.path.exists(os.path.join(d, "metadata.json")):
            make_sequence(d, height=height, width=width,
                          duration_s=duration, fps=fps,
                          events_per_frame=events_per_frame, seed=100 + i)
            print(f"synthesized {d}", flush=True)
        seqs[seq] = {}
    cfg = os.path.join(root, "config", "dataset", DATASET + ".json")
    want = {"name": DATASET, "root_path": f"data/{DATASET}",
            "sequences": seqs}
    if not os.path.exists(cfg):
        os.makedirs(os.path.dirname(cfg), exist_ok=True)
        with open(cfg, "w", encoding="utf-8") as f:
            json.dump(want, f)
            f.write("\n")
        print(f"wrote {cfg}", flush=True)
    else:  # a checked-in config must not drift from what we'd generate
        with open(cfg, encoding="utf-8") as f:
            have = json.load(f)
        if have != want:
            raise SystemExit(f"{cfg} does not match what provision_dataset "
                             f"would write; delete it to regenerate")


def provision_checkpoints(root, methods):
    """Seeded random ``.pth`` files at the published widths for the
    methods whose ``<root>/pretrained/<method>/model.pth`` is absent."""
    import torch

    from evreal_tpu_torch.bench.models import write_method_checkpoints

    missing = [m for m in methods if not os.path.exists(
        os.path.join(root, "pretrained", m, "model.pth"))]
    if missing:
        print(f"synthesizing checkpoints: {missing}", flush=True)
        write_method_checkpoints(torch, root, missing)


def build_entries():
    """Files under the build directory of the port's libraries."""
    return (len(os.listdir(BUILD_DIR)) if os.path.isdir(BUILD_DIR)
            else 0)


def parse_run(stdout):
    """(steady ms/frame per method, voxelizer launches by precision) from
    the CLI's output; either empty where it printed none."""
    ms, launches = {}, {}
    for line in stdout.splitlines():
        match = MS_PER_FRAME.match(line)
        if match:
            ms[match.group(1)] = float(match.group(2))
        elif line.startswith(LAUNCHES_PREFIX):
            launches = json.loads(line[len(LAUNCHES_PREFIX):])
    return ms, launches


def _text(out):
    return out.decode(errors="replace") if isinstance(out, bytes) else (
        out or "")


def run_condition(root, condition, methods, device, timeout):
    """One CLI run of ``condition`` from ``root``. Returns its record."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    cmd = [sys.executable, "-u", "-m", "evreal_tpu_torch", "-m", *methods,
           "-c", condition, "-d", DATASET, "-qm", "mse", "ssim",
           "--device", device]
    b0 = build_entries()
    t0 = time.time()
    try:
        r = subprocess.run(cmd, cwd=root, env=env, timeout=timeout,
                           capture_output=True, text=True, check=False)
        stdout, stderr, rc = r.stdout, r.stderr, r.returncode
    except subprocess.TimeoutExpired as e:  # its output may be bytes
        stdout, stderr, rc = _text(e.stdout), _text(e.stderr), None
    wall_s = time.time() - t0
    contained = CONTAINED in stdout
    ok = rc == 0 and not contained
    ms, launches = parse_run(stdout)
    record = {"condition": condition, "wall_s": wall_s,
              "new_build_entries": build_entries() - b0, "ok": ok,
              "returncode": rc, "contained_exception": contained,
              "ms_per_frame": ms, "voxelize_launches": launches}
    print(f"{condition}: {wall_s:.1f}s, {record['new_build_entries']} new "
          f"build entries, ok={ok}", flush=True)
    if not ok:
        print(stdout[-3000:], file=sys.stderr)
        print(stderr[-3000:], file=sys.stderr)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="robustness sweep of the PyTorch/CUDA port")
    ap.add_argument("--family", choices=sorted(FAMILIES), default="t")
    ap.add_argument("--methods", nargs="+", default=ALL_METHODS)
    ap.add_argument("--timeout", type=int, default=3600,
                    help="per-condition CLI timeout (s)")
    ap.add_argument("--skip-analysis", action="store_true")
    ap.add_argument("--plots", action="store_true",
                    help="also run analysis/robustness.py (matplotlib, "
                         "pandas) over the output tree")
    ap.add_argument("--conditions", nargs="+", default=None,
                    help="resume subset (e.g. t60ms t70ms); default = all")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the CLI runs (default: cuda)")
    ap.add_argument("--root", default=REPO_ROOT,
                    help="directory of the data, checkpoints, configs and "
                         "outputs (default: the repository)")
    args = ap.parse_args(argv)
    conditions = FAMILIES[args.family]
    if args.conditions:
        bad = [c for c in args.conditions if c not in conditions]
        if bad:
            ap.error(f"--conditions {' '.join(bad)}: not in the "
                     f"--family {args.family} sweep; allowed: "
                     f"{' '.join(conditions)}")
        conditions = args.conditions
    root = os.path.abspath(args.root)

    provision_dataset(root)
    provision_checkpoints(root, args.methods)

    t_start = time.time()
    results = [run_condition(root, cond, args.methods, args.device,
                             args.timeout) for cond in conditions]
    summary = {"family": args.family, "methods": args.methods,
               "device": args.device, "conditions": results,
               "total_wall_s": time.time() - t_start,
               "total_new_build_entries": sum(
                   r["new_build_entries"] for r in results)}
    ok = all(r["ok"] for r in results)

    if not args.skip_analysis:
        from evreal_tpu_torch.analysis import read_scores

        outputs = os.path.join(root, "outputs")
        means = read_scores(outputs, PATTERNS[args.family], "mse",
                            datasets=[DATASET])
        summary["means"] = {m: {c: v for c, v in means[m].items()
                                if c in conditions}
                            for m in args.methods if m in means}
        if args.plots:
            cmd = [sys.executable, os.path.join(REPO_ROOT, "analysis",
                                                "robustness.py"),
                   "--metric", "mse", "--datasets", DATASET,
                   "--outputs", outputs]
            r = subprocess.run(cmd, cwd=root, capture_output=True,
                               text=True, timeout=600, check=False)
            print(r.stdout[-2000:], flush=True)
            summary["plots_ok"] = r.returncode == 0
            if r.returncode != 0:
                print(r.stderr[-2000:], file=sys.stderr)
            ok = ok and summary["plots_ok"]

    summary["ok"] = ok
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
