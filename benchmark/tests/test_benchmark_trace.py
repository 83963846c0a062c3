"""The copied trace reader gives the busy and idle time and the kernel
categories that the program's ``bench/profile_chunk.analyze`` gives."""

import json

import pytest

from benchmark.lib import trace


def write_trace(path):
    dev = [("void at::native::elementwise_kernel<128>(x)", 100, 140),
           ("cudnn::fprop_conv_kernel", 130, 300),
           ("voxelize_scatter_kernel", 320, 330),
           ("Memcpy DtoH (Device -> Pinned)", 500, 520),
           ("void at::native::radix_sort_kernel", 600, 650),
           ("outside", 2000, 2100)]
    host = [("bench.pack", 50, 200), ("bench.run", 200, 480),
            ("bench.fetch", 480, 900)]
    events = [{"ph": "X", "cat": "kernel" if "Memcpy" not in n
               else "gpu_memcpy", "name": n, "ts": a, "dur": b - a}
              for n, a, b in dev]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a,
                "dur": b - a} for n, a, b in host]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events}, f)


def test_window_matches_profile_chunk(tmp_path):
    from evreal_tpu_torch.bench import profile_chunk

    path = tmp_path / "t.json"
    write_trace(path)
    theirs = profile_chunk.analyze(str(path), chunks=1)
    dev, host, _ = trace.read_trace(path)
    lo, hi = 50, 900
    w = trace.Window(dev, host, lo, hi)
    assert w.busy_us / 1e3 == pytest.approx(theirs["device_busy_ms"])
    assert (w.window_us - w.busy_us) / 1e3 == pytest.approx(
        theirs["device_idle_ms"])
    ours = {k: v / 1e3 for k, v in w.by_category().items()}
    assert ours == pytest.approx(theirs["kernel_ms_by_category"])
    gaps = w.breakdown()["idle_gaps"]
    assert [g[1] * 1e3 for g in gaps] == pytest.approx(
        [g["ms"] for g in theirs["idle_gaps"]])
    assert [g[0] for g in gaps] == [
        "bench." + g["host_in"] if g["host_in"] != "between spans"
        else g["host_in"] for g in theirs["idle_gaps"]]
    assert w.kernel_us("voxelize_") == 10


def test_categories_match_profile_chunk():
    from evreal_tpu_torch.bench import profile_chunk

    names = ["void at::native::direct_copy_kernel_cuda", "sm90_xmma_gemm",
             "void cudnn::engines_precompiled::nchwToNhwcKernel",
             "upsample_bilinear2d_out_frame", "voxelize_deposit_kernel",
             "cutlass::Kernel<fprop>", "something"]
    assert [trace.categorize(n) for n in names] == [
        profile_chunk.categorize(n) for n in names]
