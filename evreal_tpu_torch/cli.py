"""Command line of the port, with the flags of the repository's ``eval.py``:

    python -m evreal_tpu_torch -m E2VID -c std -d ECD -qm mse ssim lpips [--device cpu]

It writes the same output tree (``outputs/<config>/<dataset>/<sequence>/
<method>/``) and runs on the CUDA card unless ``--device`` names another
device. A method's ``model_path`` may name a reference ``.pth`` or a
converted ``.npz`` with its sidecar. A metric whose weights are absent
(``lpips`` without ``weights/lpips_alex.npz`` or ``EVREAL_LPIPS_WEIGHTS``)
is skipped with a message, as is an unknown name. Its last line counts
the CUDA voxelizer's launches of the run by precision (0 on the CPU, whose
plain path launches no kernel); ``python -m evreal_tpu_torch.sweep`` reads
it.
"""

import argparse
import json

LAUNCHES_PREFIX = "voxelizer launches: "


def main(argv=None):
    from evreal_tpu_torch.harness.runner import DEFAULT_METRICS, evaluate
    from evreal_tpu_torch.harness.timers import TimingLog
    from evreal_tpu_torch.kernels import voxelize_cuda

    parser = argparse.ArgumentParser(
        description="event2im evaluation script (PyTorch/CUDA port)")
    parser.add_argument("-c", "--config", nargs="+", type=str,
                        help="evaluation configs")
    parser.add_argument("-m", "--method", nargs="+", type=str,
                        help="methods (default: all eight)")
    parser.add_argument("-d", "--dataset", nargs="+", type=str,
                        help="datasets")
    parser.add_argument("-qm", "--metrics", nargs="+", type=str,
                        default=DEFAULT_METRICS,
                        help="quantitative evaluation metrics that will be "
                             "used calculate scores (default: "
                             f"{' '.join(DEFAULT_METRICS)})")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs the "
                             "plain CPU path)")
    args = parser.parse_args(argv)
    timings = TimingLog()
    before = dict(voxelize_cuda.launches_by_precision)
    results = evaluate(args.method, args.config, args.dataset, args.metrics,
                       device=args.device, timings=timings)
    if timings.samples:
        print("== Timing statistics ==")
        for line in timings.summary():
            print(line)
    print(LAUNCHES_PREFIX + json.dumps(
        {k: n - before[k]
         for k, n in voxelize_cuda.launches_by_precision.items()}))
    return results


def train_main(argv=None):
    """``python -m evreal_tpu_torch.train_cli`` as a function (the JAX
    package's ``evreal_tpu.cli.train_main``)."""
    from evreal_tpu_torch.train_cli import main as train

    train(argv)
