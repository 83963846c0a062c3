"""FLOP accounting of the port (evreal_tpu_torch/utils/mfu.py) and the
runners' ``cost_analysis``, on the CPU: counts on ``meta`` tensors (the CPU
where an op refuses ``meta``), a FireNet chunk equal to the analytic sum
of its convolutions, counts linear in the lanes and in the windows (the
counterpart of tests/test_mfu.py:107), the ``mfu`` fraction against the
card's peak (:31), the runner surface (:126), and a call that leaves the
runner's state, weights and launch counters as they were."""

import numpy as np
import pytest
import torch

from evreal_tpu_torch.convert.params import from_jax_tree
from evreal_tpu_torch.harness.batched import (
    BatchedRunner,
    ShardedRunner,
    part_states,
)
from evreal_tpu_torch.harness.runner import MethodRunner
from evreal_tpu_torch.kernels import voxelize_cuda
from evreal_tpu_torch.models import build_model, flagship_e2vid_kwargs
from evreal_tpu_torch.models.init import init_e2vid, init_firenet
from evreal_tpu_torch.utils import mfu as m

torch.set_num_threads(1)


def firenet():
    model = build_model("FireNet", {"num_bins": 5, "base_num_channels": 8,
                                    "kernel_size": 3})
    model.load_state_dict(from_jax_tree(init_firenet(seed=0,
                                                     base_num_channels=8)))
    return model


def e2vid():
    model = build_model("E2VIDRecurrent", flagship_e2vid_kwargs(5))
    model.load_state_dict(from_jax_tree(init_e2vid(seed=0)))
    return model


def buffers(lanes, t, cap, h, w, count):
    """Packed f32-wire buffers, lanes first (none for a single runner)."""
    rng = np.random.default_rng(0)
    shape = lanes + (t, cap)
    ts = np.sort(rng.uniform(0, 0.04, shape).astype(np.float32), axis=-1)
    return {"xs": rng.integers(0, w, shape).astype(np.int16),
            "ys": rng.integers(0, h, shape).astype(np.int16),
            "ts": ts - ts[..., :1],
            "ps": (rng.integers(0, 2, shape) * 2 - 1).astype(np.int8),
            "count": np.full(lanes + (t,), count, np.int32)}


def runner(cls, model, h, w, t, **kw):
    return cls(model, event_norm=True, post_norm="robust", height=h,
               width=w, num_bins=5, device="cpu", chunk_t=t, **kw)


def test_count_flops_matmul():
    n = 64
    a = torch.ones(n, n)
    assert m.count_flops(lambda x, y: x @ y, a, a) == 2 * n ** 3


def test_count_flops_falls_back_to_the_cpu():
    """An op that refuses ``meta`` is counted on the CPU at the same
    shapes; an error on the CPU propagates."""
    seen = []

    def fn(x):
        seen.append(x.device.type)
        if x.is_meta:
            raise NotImplementedError("no meta kernel")
        return x @ x

    assert m.count_flops(fn, torch.ones(8, 8)) == 2 * 8 ** 3
    assert seen == ["meta", "cpu"]
    with pytest.raises(RuntimeError):
        m.count_flops(lambda x: x @ torch.ones(3, 3), torch.ones(2, 2))


@pytest.mark.parametrize("lanes", [(), (2,)])
def test_firenet_count_is_the_analytic_conv_sum(lanes):
    """Every convolution of FireNet runs once a window at full resolution
    (stride 1, same padding): 2 * Cin * Cout * k * k * H * W per image."""
    h, w, t = 24, 40, 3
    model = firenet()
    n = lanes[0] if lanes else 1
    want = sum(2 * p.shape[0] * p.shape[1] * p.shape[2] * p.shape[3]
               * h * w * n * t for p in model.parameters() if p.dim() == 4)
    cls = BatchedRunner if lanes else MethodRunner
    r = runner(cls, model, h, w, t, **({"n": n} if lanes else {}))
    flops, nbytes = r.cost_analysis(r.init_state(),
                                    buffers(lanes, t, 256, h, w, 100))
    assert flops == want and nbytes is None


def test_counts_are_linear_in_lanes_and_windows():
    h, w, cap = 32, 48, 512
    model = e2vid()
    flops = {}
    for n, t in ((1, 2), (2, 2), (1, 4), (4, 3)):
        r = runner(BatchedRunner, model, h, w, t, n=n)
        flops[n, t], _ = r.cost_analysis(r.init_state(),
                                         buffers((n,), t, cap, h, w, 300))
    single = runner(MethodRunner, model, h, w, 2)
    one, _ = single.cost_analysis(single.init_state(),
                                  buffers((), 2, cap, h, w, 300))
    assert one == flops[1, 2] > 1e6
    assert flops[2, 2] == 2 * flops[1, 2]
    assert flops[1, 4] == 2 * flops[1, 2]
    assert flops[4, 3] == 6 * flops[1, 2]


def test_sharded_runner_counts_every_shard():
    h, w, t = 32, 48, 2
    model = e2vid()
    whole = runner(BatchedRunner, model, h, w, t, n=4)
    shards = ShardedRunner([runner(BatchedRunner, model, h, w, t, n=2)
                            for _ in range(2)])
    bufs = buffers((4,), t, 256, h, w, 100)
    assert shards.cost_analysis(part_states(shards), bufs) == \
        whole.cost_analysis(whole.init_state(), bufs)


def test_method_runner_cost_analysis_surface():
    """tests/test_mfu.py:126: (flops, bytes) of one run call, a real model
    step's megaflops; bytes None."""
    r = runner(MethodRunner, e2vid(), 32, 48, 2)
    flops, nbytes = r.cost_analysis(r.init_state(),
                                    buffers((), 2, 2048, 32, 48, 100))
    assert flops > 1e6 and nbytes is None


def test_cost_analysis_leaves_the_runner_untouched():
    """No data is read or written: the state, the weights, their devices
    and the voxelizer's launch counters are as they were, and a run after
    the count gives what it gives without one."""
    h, w, t = 32, 48, 2
    model = e2vid()
    r = runner(BatchedRunner, model, h, w, t, n=2)
    bufs = buffers((2,), t, 512, h, w, 300)
    state = r.init_state()
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    counters = dict(voxelize_cuda.launches_by_precision)

    def flat(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        items = tree.values() if isinstance(tree, dict) else tree
        return [x for v in items for x in flat(v)]

    before = [x.clone() for x in flat(state)]
    _, _, want = r.run(r.init_state(), r.upload(bufs), t)
    r.cost_analysis(state, bufs)
    assert voxelize_cuda.launches_by_precision == counters
    for a, b in zip(flat(state), before):
        assert a.device.type == "cpu" and torch.equal(a, b)
    for k, v in model.state_dict().items():
        assert v.device.type == "cpu" and torch.equal(v, weights[k]), k
    _, _, got = r.run(r.init_state(), r.upload(bufs), t)
    assert torch.equal(got, want)


def test_mfu_fraction_uses_the_card_peak(monkeypatch):
    """tests/test_mfu.py:31: achieved TFLOP/s and the fraction of the
    card's dense bf16 peak; None for a card the table does not know and
    for the CPU."""
    assert m.mfu(1e12, 1.0, "cpu") == (1.0, None)
    assert m.bf16_peak_tflops("cpu") is None
    names = {0: "NVIDIA H100 80GB HBM3", 1: "Some Other Card"}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: names[torch.device(d).index or 0])
    assert m.bf16_peak_tflops("cuda:0") == 989.0
    achieved, frac = m.mfu(989e12 / 2, 1.0, "cuda:0")
    assert achieved == pytest.approx(494.5)
    assert frac == pytest.approx(0.5)
    assert m.mfu(2e12, 2.0, "cuda:1") == (1.0, None)
