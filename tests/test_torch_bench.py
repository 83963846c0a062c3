"""The port's measurement entry point (evreal_tpu_torch/bench/) on the CPU:
``build_flagship_e2vid`` against the JAX package's (byte-equal params),
the flagship chunk on the bench's compact4 buffers against the JAX
``BatchedRunner`` (2e-5), the compact4 words against the JAX encoder
(byte-equal), every mode through ``main`` at tiny sizes (a parseable last
line on the CPU with no device metric), ``--device cuda`` without a card,
the union arithmetic of ``timing.device_time``, the profile report of a
synthetic Chrome trace, the reported FLOPs against the runners'
``cost_analysis``, and the ``.pth`` files of ``write_method_checkpoints``
read back tensor for tensor."""

import json
import types

import numpy as np
import pytest
import torch

import chip_smoke
from evreal_tpu.data.packing import encode_compact4 as jax_encode_compact4
from evreal_tpu.harness.batched import BatchedRunner as JaxBatchedRunner
from evreal_tpu.models import build_flagship_e2vid as jax_flagship
from evreal_tpu_torch.bench import common, flagship, profile_chunk, timing
from evreal_tpu_torch.bench.__main__ import main
from evreal_tpu_torch.bench.models import (method_model, published_methods,
                                           random_init,
                                           write_method_checkpoints)
from evreal_tpu_torch.convert.checkpoint import load_method_checkpoint
from evreal_tpu_torch.convert.params import flatten, from_jax_tree
from evreal_tpu_torch.harness.runner import MethodRunner
from evreal_tpu_torch.models import build_flagship_e2vid, build_model

torch.set_num_threads(1)

TOL_JAX = 2e-5
TINY = ["--device", "cpu", "--height", "32", "--width", "48", "--events",
        "500"]
CHUNK = ["--chunk-t", "4", "--windows", "8", "--repeats", "1"]
MODE_ARGS = {
    "flagship": ["--lanes", "2"] + CHUNK,
    "methods": ["-m", "E2VID", "FireNet+"] + CHUNK,
    "serve": ["-m", "FireNet+", "--windows", "10", "--warmup", "2"],
    "serve_group": ["-m", "FireNet+", "--lanes", "3", "--dtype", "bfloat16",
                    "--wire", "compact4", "--windows", "4", "--warmup", "1"],
    "scaling": ["--batches", "1", "2"] + CHUNK,
    "profile": ["--lanes", "2"] + CHUNK,
    "probes": [],
}
# device metrics, which a CPU run must not write
DEVICE_KEYS = {"mfu_vs_bf16_peak", "model_tflops_per_s", "device_busy_share",
               "device_busy_ms_per_chunk", "device_busy_ms", "device_idle_ms",
               "device_busy_ms_per_push", "device_idle_share", "peak_mib",
               "probes", "matmul_bf16_tflops", "hbm_gb_per_s", "h2d_gb_per_s",
               "op_latency_us", "top_kernels", "kernels", "idle_gaps",
               "push_profile", "kernel_ms_by_category"}


def run_main(argv, capsys):
    assert main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return lines, json.loads(lines[-1])


@pytest.fixture(scope="module")
def mode_lines(tmp_path_factory):
    """{mode: (stdout lines, last line)}, each mode run once through
    ``main`` (module-scoped: several tests read one run)."""
    cache = {}

    def get(mode, capsys):
        if mode not in cache:
            argv = [mode.split("_")[0]] + TINY + MODE_ARGS[mode]
            if mode == "profile":
                argv += ["--trace", str(tmp_path_factory.mktemp("trace")
                                        / "t.json")]
            cache[mode] = run_main(argv, capsys)
        return cache[mode]

    return get


@pytest.mark.parametrize("seed", [0, 3])
def test_flagship_params_byte_equal_to_jax(seed):
    model, params = build_flagship_e2vid(seed=seed)
    _, want = jax_flagship(seed=seed)
    got, want = flatten(params), flatten(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == np.asarray(v).tobytes(), k
    loaded = model.state_dict()
    for k, v in from_jax_tree(params).items():
        assert torch.equal(loaded[k], v), k


def test_flagship_chunk_matches_jax():
    """The bench's 2-lane x 4-window chunk on its compact4 buffers: the
    port's lockstep runner against the JAX ``BatchedRunner`` (2e-5), and
    the compact4 words byte-equal to the JAX encoder's."""
    lanes, t, h, w = 2, 4, 32, 48
    bufs, compact = flagship.make_buffers(0, lanes, t, h, w, 500)
    want_ev = np.zeros_like(compact["ev"])
    for i in range(lanes):
        for k in range(t):
            want_ev[i, k, :500] = jax_encode_compact4(
                bufs["xs"][i, k, :500], bufs["ys"][i, k, :500],
                bufs["ts"][i, k, :500].astype(np.float64),
                bufs["ps"][i, k, :500], (h, w))
    assert compact["ev"].dtype == want_ev.dtype
    assert compact["ev"].tobytes() == want_ev.tobytes()

    model, _ = build_flagship_e2vid(seed=0)
    runner = flagship.lockstep_runner(model, lanes, t, h, w, "cpu")
    _, imgs, clipped = runner.run(runner.init_state(),
                                  runner.upload(compact), t)
    jmodel, jparams = jax_flagship(seed=0)
    jr = JaxBatchedRunner(jmodel, jparams, event_norm=True,
                          post_norm="robust", height=h, width=w,
                          num_bins=5, n=lanes, chunk_t=t)
    _, jimgs, jclipped = jr.run(jr.init_state(), compact)
    np.testing.assert_allclose(clipped.numpy(), np.asarray(jclipped),
                               rtol=0, atol=TOL_JAX)
    np.testing.assert_allclose(imgs.numpy(), np.asarray(jimgs), rtol=0,
                               atol=TOL_JAX)


@pytest.mark.parametrize("mode", sorted(MODE_ARGS))
def test_mode_on_the_cpu(mode, mode_lines, capsys):
    lines, line = mode_lines(mode, capsys)
    assert lines[0].startswith("cpu:")
    assert line["mode"] == mode.split("_")[0]
    assert line["device"] == {"platform": "cpu", "name": line["device"][
        "name"], "count": 1, "power_limit_w": None}
    assert not DEVICE_KEYS & common.keys_in(line)
    assert set(line["units"]) <= common.keys_in(
        {k: v for k, v in line.items() if k != "units"})
    if mode != "probes":  # no kernel runs on the CPU: every count is 0
        launches = line["voxelize_launches"]
        assert launches and all(sum(n.values()) == 0
                                for n in launches.values())


def test_flagship_line(mode_lines, capsys):
    _, line = mode_lines("flagship", capsys)
    assert line["metric"] == "e2vid_recon_fps_32x48_b2_t4"
    for key in ("value", "device_resident_fps", "f32_wire_fps",
                "bf16_device_resident_fps"):
        assert line[key] > 0 and len(line[key + "_runs"]) == 1
    assert line["lane0_vs_single_max_abs_err"] <= flagship.TOL_SINGLE
    host = line["host_ms_per_chunk"]
    assert set(host) == {"pack", "upload", "fetch", "png"}
    assert all(v["n"] == 1 and v["median_ms"] > 0 for v in host.values())
    assert host["pack"]["native_pack_calls"] == 2  # one a lane
    assert set(line["voxelize_launches"]) == {
        "first_chunk_f32_compact4", "device_resident_f32_compact4",
        "streamed_f32_compact4", "streamed_f32_f32wire",
        "device_resident_bf16_compact4"}
    assert flagship.metric_name(16, 32, 180, 240) == "e2vid_recon_fps_ecd_b16"


def test_reported_flops_equal_cost_analysis(mode_lines, capsys):
    """The flagship's and the methods mode's GFLOP a window are the
    runners' ``cost_analysis`` of the same chunk."""
    _, line = mode_lines("flagship", capsys)
    _, compact = flagship.make_buffers(0, 2, 4, 32, 48, 500)
    model, _ = build_flagship_e2vid(seed=0)
    runner = flagship.lockstep_runner(model, 2, 4, 32, 48, "cpu")
    flops = runner.cost_analysis(runner.init_state(), compact)[0]
    assert flops > 0
    assert line["gflop_per_window"] == flops / 8 / 1e9

    _, line = mode_lines("methods", capsys)
    model, flags = method_model(torch, "E2VID", 0)
    single = MethodRunner(model, height=32, width=48, num_bins=5,
                          device="cpu", chunk_t=4, **flags)
    bufs = common.event_buffers(np.random.default_rng(0), (4,), 2048, 500,
                                32, 48)
    flops = single.cost_analysis(single.init_state(), bufs)[0]
    assert line["methods"]["E2VID"]["gflop_per_window"] == flops / 4 / 1e9
    assert line["methods"]["E2VID"]["guessed_width"] is False


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["probes", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["flagship"])  # the default device


def _event(kind, name, start, end):
    return types.SimpleNamespace(
        device_type=kind, name=name,
        time_range=types.SimpleNamespace(start=start, end=end,
                                         elapsed_us=lambda: end - start))


def test_device_time_union():
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    prof = types.SimpleNamespace(events=lambda: [
        _event(cuda, "a", 10.0, 20.0), _event(cuda, "b", 15.0, 30.0),
        _event(cuda, "a", 40.0, 45.0), _event(cpu, "host", 0.0, 100.0),
        _event(cuda, "c", 41.0, 42.0)])
    busy, span, by_name = timing.device_time(torch, prof)
    assert busy == pytest.approx((20 + 5) / 1e3)  # [10, 30] and [40, 45]
    assert span == pytest.approx(35 / 1e3)
    assert by_name == {"a": (15.0, 2), "b": (15.0, 1), "c": (1.0, 1)}
    none = types.SimpleNamespace(events=lambda: [_event(cpu, "x", 0, 1)])
    assert timing.device_time(torch, none)[:2] == (None, None)


def test_profile_report_of_a_chrome_trace(tmp_path, capsys):
    spans = [("pack", 0, 100), ("upload", 100, 110), ("run", 110, 300),
             ("fetch", 300, 320)]
    kernels = [
        ("kernel", "void voxelize_count_kernel<false>(int)", 112, 115),
        ("kernel", "sm90_xmma_fprop_implicit_gemm_f32f32_tile", 115, 250),
        ("kernel", "void at::native::(anonymous namespace)::"
         "upsample_bilinear2d_out_frame<float>(at::IndexBoundsCheck)",
         240, 260),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 300, 305),
    ]
    trace = {"deviceProperties": [{"name": "NVIDIA H100 80GB HBM3"}],
             "traceEvents": [
                 {"ph": "X", "cat": "user_annotation", "name": "bench." + n,
                  "ts": a, "dur": b - a} for n, a, b in spans]
             + [{"ph": "X", "cat": c, "name": n, "ts": a, "dur": b - a}
                for c, n, a, b in kernels]
             + [{"ph": "X", "cat": "cpu_op", "name": "aten::conv2d",
                 "ts": 0, "dur": 999}]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    _, line = run_main(["profile", "--trace-only", str(path), "--windows",
                        "64"], capsys)
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["name"] == "NVIDIA H100 80GB HBM3"
    assert line["chunks"] == 2
    assert line["wall_ms"] == pytest.approx(0.320)
    assert line["device_busy_ms"] == pytest.approx(0.153)
    assert line["device_idle_ms"] == pytest.approx(0.167)
    assert line["device_busy_share"] == pytest.approx(153 / 320)
    assert line["kernel_ms_by_category"] == pytest.approx(
        {"voxelize": 0.003, "conv": 0.135, "elementwise": 0.020,
         "copy": 0.005})
    assert [g["host_in"] for g in line["idle_gaps"]] == ["pack", "run",
                                                         "fetch"]
    assert [g["ms"] for g in line["idle_gaps"]] == pytest.approx(
        [0.112, 0.040, 0.015])
    assert line["host_ms_per_chunk"] == pytest.approx(
        {"pack": 0.05, "upload": 0.005, "run": 0.095, "fetch": 0.01})
    assert profile_chunk.categorize(
        "void at::native::unrolled_elementwise_kernel<at::native::"
        "direct_copy_kernel_cuda>") == "copy"
    assert profile_chunk.categorize("ampere_sgemm_128x64_nn") == "gemm"
    assert profile_chunk.categorize(
        "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_"
        "optimized_bf16_64x64_64x4_nhwc_align8>(Params)") == "conv"
    assert profile_chunk.categorize(
        "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>"
        "(int)") == "copy"
    assert profile_chunk.categorize(
        "void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<int>"
    ) == "sort/percentile"


def test_chip_smoke_shares_the_bench_helpers():
    """``tools/voxelizer_ab.py`` loads ``chip_smoke`` and calls its timing
    helpers: they are the bench's."""
    assert chip_smoke.time_turns is timing.time_turns
    assert chip_smoke.host_enqueue_us is timing.host_enqueue_us


@pytest.mark.parametrize("method", sorted(published_methods()))
def test_method_checkpoints_read_back(tmp_path, method):
    """A method's ``.pth`` at its published width, written alone, holds the
    weights of its seed (its index in ``published_methods()``) tensor for
    tensor; a second call leaves it in place."""
    path = write_method_checkpoints(torch, str(tmp_path), [method])[method]
    assert path == str(tmp_path / "pretrained" / method / "model.pth")
    table = published_methods()
    cls, kwargs, _ = table[method]
    want = random_init(torch, build_model(cls, kwargs),
                       seed=list(table).index(method)).state_dict()
    got, meta = load_method_checkpoint(method, path)
    assert meta["model_name"] == method
    want = {k: v for k, v in want.items()
            if not k.endswith("num_batches_tracked")}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    stamp = (tmp_path / "pretrained" / method / "model.pth").stat().st_mtime_ns
    write_method_checkpoints(torch, str(tmp_path), [method], seed=5)
    assert (tmp_path / "pretrained" / method
            / "model.pth").stat().st_mtime_ns == stamp
    with pytest.raises(ValueError, match="no published widths"):
        write_method_checkpoints(torch, str(tmp_path), ["nosuch"])
