"""The port's FLOP count of an E2VID chunk against the JAX package's.

    JAX_PLATFORMS=cpu python -m tests.flop_ratio [--hw 180 240] [--t 32]

Builds E2VID at its published width from the same random weights in both
packages and prints one JSON line: the port's
``MethodRunner.cost_analysis`` (``torch.utils.flop_counter`` on ``meta``
tensors: convolutions only; the CUDA voxelizer counts nothing), the JAX
package's (XLA's cost analysis composed over the loop's trip counts,
compiled on the host CPU: convolutions plus elementwise work, its jnp
voxelizer and the post-norm), and their ratio, for one single-sequence
chunk and one 4-lane lockstep chunk. Both counts are arithmetic on
shapes: no device is measured. The two are not equal by design, so no
test asserts the ratio.
"""

import argparse
import json

import numpy as np


def buffers(lanes, t, cap, h, w, count):
    rng = np.random.default_rng(0)
    shape = lanes + (t, cap)
    ts = np.sort(rng.uniform(0, 0.03, shape).astype(np.float32), axis=-1)
    return {"xs": rng.integers(0, w, shape).astype(np.int16),
            "ys": rng.integers(0, h, shape).astype(np.int16),
            "ts": ts - ts[..., :1],
            "ps": (rng.integers(0, 2, shape) * 2 - 1).astype(np.int8),
            "count": np.full(lanes + (t,), count, np.int32)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hw", type=int, nargs=2, default=(180, 240))
    ap.add_argument("--t", type=int, default=32)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--events", type=int, default=30000)
    args = ap.parse_args(argv)

    import jax

    from evreal_tpu.harness.batched import BatchedRunner as JBatched
    from evreal_tpu.harness.runner import MethodRunner as JRunner
    from evreal_tpu.models import build_flagship_e2vid
    from evreal_tpu_torch.convert.params import from_jax_tree
    from evreal_tpu_torch.harness.batched import BatchedRunner
    from evreal_tpu_torch.harness.runner import MethodRunner
    from evreal_tpu_torch.models import build_model, flagship_e2vid_kwargs

    h, w = args.hw
    cap = 32768
    jmodel, params = build_flagship_e2vid(seed=0)
    model = build_model("E2VIDRecurrent", flagship_e2vid_kwargs(5))
    model.load_state_dict(from_jax_tree(params), strict=True)
    common = dict(event_norm=True, post_norm="robust", height=h, width=w,
                  num_bins=5, chunk_t=args.t)
    out = {"sensor": [h, w], "windows": args.t, "capacity": cap,
           "events": args.events, "jax_backend": jax.default_backend()}
    for label, lanes in (("single", ()), ("lockstep", (args.lanes,))):
        bufs = buffers(lanes, args.t, cap, h, w, args.events)
        if lanes:
            jr = JBatched(jmodel, params, n=lanes[0], **common)
            tr = BatchedRunner(model, n=lanes[0], device="cpu", **common)
        else:
            jr = JRunner(jmodel, params, **common)
            tr = MethodRunner(model, device="cpu", **common)
        jflops, jbytes = jr.cost_analysis(jr.init_state(), bufs)
        tflops, _ = tr.cost_analysis(tr.init_state(), bufs)
        out[label] = {"lanes": lanes[0] if lanes else 1,
                      "port_flops": tflops, "jax_flops": jflops,
                      "jax_bytes": jbytes,
                      "port_over_jax": tflops / jflops if jflops else None}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
