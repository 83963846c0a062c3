"""The control of a cell's comparison: the plain reference put in the
program's place, computed in the precision just below the
configuration's (TF32 for float32 with TF32 off), on the cell's own
inputs from each seed, compared by the same numbers as a run:

    python benchmark/control.py --workload <cell> --seeds 1,2,3 [--rehearse]

Prints one JSON line a seed: the numbers and the cell's limits. On the
card it uses the card's TF32; with ``--rehearse``, on the CPU at the
mix's tiny size, TF32 is emulated by rounding (``reference/pipeline.py``).
The benchmark's own runs never run it."""

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload, seed, rehearse, mode="tf32", spec=None):
    """The compared numbers of the control on ``seed``'s inputs
    (``spec``: this checkout's ``BENCHMARK.json`` by default)."""
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.lib.spec import Spec, kind_module
    from benchmark.run import Run, program_env

    spec = spec or Spec()
    cell, _, config, mix = spec.cell(workload)
    program_env(config)
    device = torch.device("cpu" if rehearse else "cuda")
    args = argparse.Namespace(seed=seed, rehearse=rehearse)
    workdir = tempfile.mkdtemp(prefix=f"control-{workload}-",
                               dir=os.environ.get("TMPDIR"))
    try:
        k = kind_module(mix["kind"]).Run(
            Run(spec, cell, config, mix, args, device, workdir))
        k.inputs()
        return k.control(mode, spec.bench["run_seconds"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.lib.check import judge, limits
    from benchmark.lib.spec import ROOT as root

    lims = limits(root, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        values = readings(args.workload, seed, args.rehearse)
        correct, _ = judge(values, lims)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": values, "limits": lims,
                          "correct": correct}), flush=True)


if __name__ == "__main__":
    main()
