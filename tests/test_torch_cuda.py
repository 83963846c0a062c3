"""The CUDA voxelizer on the card, against its plain PyTorch version on the
same CUDA tensors. These tests need an NVIDIA GPU and skip without one;
the file imports nothing of JAX, so on the card they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have)."""

import numpy as np
import pytest
import torch

from evreal_tpu_torch.data.packing import (compact4_layout,
                                           encode_compact4, quantize_ts)
from evreal_tpu_torch.kernels import voxelize_cuda
from evreal_tpu_torch.ops import voxelize as tvox

ATOL = 2e-5  # tests/test_pallas_voxelize.py:25
H, W, B = 180, 240, 5
# (H, W, B, T, E): ECD/HQF, MVSEC/CED and BS-ERGB sensors, many tiles each
SHAPES = {"180x240": (180, 240, 5, 8, 4096),
          "260x346": (260, 346, 5, 8, 8192),
          "260x346 B15": (260, 346, 15, 4, 8192),
          "625x970": (625, 970, 5, 4, 131072)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


def windows(seed, t=8, e=4096, float_coords=False, h=H, w=W):
    """(T, E) f32-wire buffers: count 0 and E, a degenerate dt, an unsorted
    timestamp with t_norm <= -1, out-of-bounds coordinates."""
    rng = np.random.default_rng(seed)
    if float_coords:
        xs = rng.uniform(-2.0, w + 2.0, (t, e)).astype(np.float32)
        ys = rng.uniform(-2.0, h + 2.0, (t, e)).astype(np.float32)
        xs[:, :8] = -0.5
    else:
        xs = rng.integers(-3, w + 3, (t, e)).astype(np.int16)
        ys = rng.integers(-3, h + 3, (t, e)).astype(np.int16)
    ts = np.sort(rng.uniform(0.0, 0.03, (t, e)), axis=1)
    ts = (ts - ts[:, :1]).astype(np.float32)
    ps = (rng.integers(0, 2, (t, e)) * 2 - 1).astype(np.int8)
    count = rng.integers(e // 2, e + 1, t).astype(np.int32)
    count[0], count[1] = 0, e
    ts[2] = 0.0
    ts[3, 5] = -ts[3, count[3] - 1]
    return xs, ys, ts, ps, count


def on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def wires(h=H, w=W, t=8, e=4096):
    xs, ys, ts, ps, count = windows(1, t, e, h=h, w=w)
    q = np.zeros(ts.shape, np.uint16)
    for i, n in enumerate(count):
        q[i, :n] = quantize_ts(ts[i, :n], 65535.0).astype(np.uint16)
    fx, fy, _, _, _ = windows(2, t, e, float_coords=True, h=h, w=w)
    u8 = lambda a: np.where((a >= 0) & (a < 256), a, 255).astype(np.uint8)  # noqa: E731
    return {"int16 / f32 / int8": (xs, ys, ts, ps, count),
            "fractional f32 coords": (fx, fy, ts, ps, count),
            "uint8 / uint16": (u8(xs), u8(ys), q, ps, count),
            "int32 / f32 ps": (xs.astype(np.int32), ys.astype(np.int32), ts,
                               ps.astype(np.float32), count)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("wire", ["int16 / f32 / int8", "fractional f32 coords",
                                  "uint8 / uint16", "int32 / f32 ps"])
def test_kernel_matches_plain(cuda_device, wire, shape):
    """Within 2e-5 of the float64 plain version, and bit-equal to the int64
    fixed-point plain version (the kernels' arithmetic)."""
    h, w, b, t, e = SHAPES[shape]
    args = on(cuda_device, *wires(h, w, t, e)[wire])
    before = voxelize_cuda.launch_count()
    got = tvox.voxelize_windows(
        dict(zip(("xs", "ys", "ts", "ps", "count"), args)), b, (h, w))
    want = tvox.voxelize_windows_plain(*args, b, (h, w),
                                       accum_dtype=torch.float64)
    exact = tvox.voxelize_windows_plain(*args, b, (h, w),
                                        accum_dtype=torch.int64)
    torch.cuda.synchronize()
    assert voxelize_cuda.launch_count() == before + 1
    assert got.shape == (t, b, h, w) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= ATOL
    assert torch.equal(got, exact)


@pytest.mark.cuda
def test_zero_capacity_returns_zeros_without_launch(cuda_device):
    z = torch.zeros((4, 0), dtype=torch.int16, device=cuda_device)
    f = torch.zeros((4, 0), device=cuda_device)
    count = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    before = voxelize_cuda.launch_count()
    out = voxelize_cuda.voxelize(z, z, f, z.to(torch.int8), count, B, (H, W))
    assert voxelize_cuda.launch_count() == before and not bool(out.any())


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    xs, ys, ts, ps, count = on(cuda_device, *windows(3))
    with pytest.raises(ValueError, match="contiguous"):
        voxelize_cuda.voxelize(xs.t().contiguous().t(), ys, ts, ps, count,
                               B, (H, W))
    with pytest.raises(ValueError, match="dtype"):
        voxelize_cuda.voxelize(xs, ys, ts.double(), ps, count, B, (H, W))
    with pytest.raises(ValueError, match="count"):
        voxelize_cuda.voxelize(xs, ys, ts, ps, count.long(), B, (H, W))


def compact4(xs, ys, ts, ps, count, hw=(H, W)):
    ev = np.zeros(ts.shape, np.uint32)
    for i, n in enumerate(count):
        ev[i, :n] = encode_compact4(xs[i, :n], ys[i, :n], ts[i, :n],
                                    ps[i, :n], hw)
    return ev


@pytest.mark.cuda
@pytest.mark.parametrize("wire,shape", [
    ("int16 / f32 / int8", s) for s in SHAPES] + [
    ("compact4", s) for s in SHAPES if s != "625x970"])  # no compact4 layout
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_precisions_and_compact4_match_plain(cuda_device, wire, precision,
                                             shape):
    """K2-HIGHEST and K2-DEFAULT (bf16 factors) on the split f32 wire and
    on compact4 decoded in the kernel, against the plain version (bf16
    factors where asked) on the same tensors: within 2e-5 of its float64
    sums and bit-equal to its int64 fixed-point sums."""
    h, w, b, t, e = SHAPES[shape]
    args = wires(h, w, t, e)["int16 / f32 / int8"]
    if wire == "compact4":
        bufs = dict(zip(("ev", "count"),
                        on(cuda_device, compact4(*args, hw=(h, w)), args[4])))
    else:
        bufs = dict(zip(("xs", "ys", "ts", "ps", "count"),
                        on(cuda_device, *args)))
    bf16 = precision == "default"
    before = voxelize_cuda.launch_count()
    got = tvox.voxelize_windows(bufs, b, (h, w), precision=precision)
    want = tvox.voxelize_buffers_plain(bufs, b, (h, w),
                                       accum_dtype=torch.float64,
                                       bf16_factors=bf16)
    exact = tvox.voxelize_buffers_plain(bufs, b, (h, w),
                                        accum_dtype=torch.int64,
                                        bf16_factors=bf16)
    torch.cuda.synchronize()
    assert voxelize_cuda.launch_count() == before + 1
    assert float((got - want).abs().max()) <= ATOL
    assert torch.equal(got, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_deterministic_across_launches_and_groupings(cuda_device,
                                                     precision):
    """The same inputs give the same bits on every launch, and a window's
    grid does not depend on which windows share its launch."""
    args = windows(4, t=32, e=8192)
    for bufs in (dict(zip(("xs", "ys", "ts", "ps", "count"),
                          on(cuda_device, *args))),
                 dict(zip(("ev", "count"),
                          on(cuda_device, compact4(*args), args[4])))):
        def vox(sl):
            return tvox.voxelize_windows({k: v[sl].contiguous()
                                          for k, v in bufs.items()},
                                         B, (H, W), precision=precision)
        whole = vox(slice(0, 32))
        assert torch.equal(whole, vox(slice(0, 32)))
        halves = torch.cat([vox(slice(0, 16)), vox(slice(16, 32))])
        assert torch.equal(whole, halves)


# ---------------------------------------------------------------------------
# the direct path (one window): voxelize_cuda._voxelize_direct
# ---------------------------------------------------------------------------

def every_wire(cuda_device, h=H, w=W, t=8, e=4096):
    """{wire: (events, layout)} for the private paths: every split wire of
    ``wires`` and compact4, with ``windows``' edge cases."""
    out = {k: (on(cuda_device, *v), None)
           for k, v in wires(h, w, t, e).items()}
    args = wires(h, w, t, e)["int16 / f32 / int8"]
    out["compact4"] = (on(cuda_device, compact4(*args, hw=(h, w)), args[4]),
                       compact4_layout((h, w)))
    return out


def window_of(arrays, t):
    """Window ``t`` of (T, E) buffers and their (T,) count, as (1, E)."""
    return [a[t:t + 1].contiguous() for a in arrays]


def paths(arrays, layout, precision):
    """Both private paths on ``arrays`` (events then count)."""
    *events, count = arrays
    return {p: fn(tuple(events), count, B, (H, W), precision, layout)
            for p, fn in (("direct", voxelize_cuda._voxelize_direct),
                          ("tiled", voxelize_cuda._voxelize_tiled))}


def scratch_is_zero():
    return all(not bool(c.any()) for c in voxelize_cuda._scratch.values())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("wire", ["int16 / f32 / int8", "fractional f32 coords",
                                  "uint8 / uint16", "int32 / f32 ps",
                                  "compact4"])
def test_direct_path_matches_plain_and_tiled(cuda_device, wire, precision):
    """Each window of ``windows`` (count 0 and E, a degenerate dt, an
    unsorted timestamp with t_norm <= -1, out-of-bounds and fractional
    negative coordinates) alone at T = 1: the direct path bit-equal to the
    int64 plain version and to the tiled path; the public entry routes
    there, one launch a call; the scratch is zero after every call."""
    arrays, layout = every_wire(cuda_device)[wire]
    bf16 = precision == "default"
    keys = ("ev", "count") if layout else ("xs", "ys", "ts", "ps", "count")
    for t in range(arrays[0].shape[0]):
        one = window_of(arrays, t)
        bufs = dict(zip(keys, one))
        exact = tvox.voxelize_buffers_plain(bufs, B, (H, W),
                                            accum_dtype=torch.int64,
                                            bf16_factors=bf16)
        got = paths(one, layout, precision)
        voxelize_cuda.reset_launches()
        routed = tvox.voxelize_windows(bufs, B, (H, W), precision=precision)
        torch.cuda.synchronize()
        assert voxelize_cuda.launches_by_path == {"direct": 1, "tiled": 0}
        assert got["direct"].is_contiguous() and routed.is_contiguous()
        assert torch.equal(got["direct"], exact)
        assert torch.equal(got["tiled"], exact)
        assert torch.equal(routed, exact)
        assert scratch_is_zero()


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 8, 16])
def test_direct_path_at_several_windows_matches_tiled(cuda_device, t):
    """The direct path takes any T (the smoke times it beside the tiled
    path at T = 4, 8, 16; only T = 1 is routed to it): bit-equal."""
    for wire in ("int16 / f32 / int8", "compact4"):
        arrays, layout = every_wire(cuda_device, t=t)[wire]
        got = paths(arrays, layout, "highest")
        torch.cuda.synchronize()
        assert torch.equal(got["direct"], got["tiled"])
        assert scratch_is_zero()


@pytest.mark.cuda
def test_direct_zero_capacity_returns_zeros_without_launch(cuda_device):
    z = torch.zeros((1, 0), dtype=torch.int16, device=cuda_device)
    f = torch.zeros((1, 0), device=cuda_device)
    count = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    before = dict(voxelize_cuda.launches_by_path)
    out = voxelize_cuda.voxelize(z, z, f, z.to(torch.int8), count, B, (H, W))
    assert voxelize_cuda.launches_by_path == before
    assert out.shape == (1, B, H, W) and not bool(out.any())


@pytest.mark.cuda
def test_direct_calls_on_two_streams_match_serial(cuda_device):
    """Calls alternating between two streams (a scratch each) give what
    the same calls give one after another on one stream, bit for bit, and
    two calls on the same input are bit-identical."""
    arrays, _ = every_wire(cuda_device, t=6)["int16 / f32 / int8"]
    one = [window_of(arrays, t) for t in range(6)]
    serial = [voxelize_cuda.voxelize(*a, B, (H, W)) for a in one]
    again = [voxelize_cuda.voxelize(*a, B, (H, W)) for a in one]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    alternating = []
    for k, a in enumerate(one):
        with torch.cuda.stream(streams[k % 2]):
            alternating.append(voxelize_cuda.voxelize(*a, B, (H, W)))
    torch.cuda.synchronize()
    for a, b, c in zip(serial, again, alternating):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert len(voxelize_cuda._scratch) >= 3 and scratch_is_zero()


@pytest.mark.cuda
def test_wrapper_rejects_on_first_and_cached_keys(cuda_device):
    """What ``test_wrapper_rejects_what_the_kernel_does_not_take`` covers,
    at T = 1 (the direct path) and T = 8 (the tiled path), once with an
    empty check cache and once after the valid call of the same shapes
    cached its key: the same errors."""
    full = on(cuda_device, *windows(3))
    for args in (window_of(full, 0), full):
        xs, ys, ts, ps, count = args
        strided = torch.stack([xs, xs], dim=-1)[..., 0]  # same values
        bad = {"contiguous": (strided, ys, ts, ps, count),
               "dtype": (xs, ys, ts.double(), ps, count),
               "count": (xs, ys, ts, ps, count.long())}
        for cached in (False, True):
            voxelize_cuda._plans.clear()
            if cached:
                voxelize_cuda.voxelize(*args, B, (H, W))
            for match, a in bad.items():
                with pytest.raises(ValueError, match=match):
                    voxelize_cuda.voxelize(*a, B, (H, W))


# ---------------------------------------------------------------------------
# the color merge, CLAHE and the merged frames' post-norm on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("full", [(180, 240), (260, 346), (261, 347)])
def test_color_merge_on_card_matches_cpu(cuda_device, full):
    """The OpenCV-free merge (integer arithmetic throughout, LAB->BGR
    included) gives the same bytes on the card as on the CPU."""
    from evreal_tpu_torch.utils import color

    rng = np.random.default_rng(full[1])
    h, w = full[0] // 2, full[1] // 2
    ch = torch.from_numpy(rng.integers(0, 256, (4, 4, h, w), dtype=np.uint8))
    gray = torch.from_numpy(rng.integers(0, 256, (4,) + full,
                                         dtype=np.uint8))
    got = color.merge_channels_into_color_image(ch.to(cuda_device),
                                                gray.to(cuda_device))
    assert torch.equal(got.cpu(), color.merge_channels_into_color_image(
        ch, gray))
    up = color.resize_linear_u8(ch.to(cuda_device), (2 * h + 1, 2 * w + 1))
    assert torch.equal(up.cpu(), color.resize_linear_u8(
        ch, (2 * h + 1, 2 * w + 1)))


@pytest.mark.cuda
def test_lab_on_card_matches_cpu_on_every_colour(cuda_device):
    from evreal_tpu_torch.utils import color

    v = torch.arange(256, dtype=torch.uint8)
    allc = torch.stack(torch.meshgrid(v, v, v, indexing="ij"), -1)
    allc = allc.reshape(4096, 4096, 3)
    for fn in (color.bgr_to_lab_u8, color.lab_to_bgr_u8):
        assert torch.equal(fn(allc.to(cuda_device)).cpu(), fn(allc))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(180, 240), (260, 346), (47, 63), (64, 64),
                                (5, 30)])
def test_clahe_on_card_matches_cpu(cuda_device, hw):
    from evreal_tpu_torch.harness.histeq import clahe_u8

    rng = np.random.default_rng(hw[0])
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    for img in (rng.integers(0, 256, hw, dtype=np.uint8),
                (127 + 120 * np.sin(yy / 9.0) * np.cos(xx / 7.0)).astype(
                    np.uint8)):
        t = torch.from_numpy(img)
        assert torch.equal(clahe_u8(t.to(cuda_device)).cpu(), clahe_u8(t))


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["robust", "standard"])
def test_color_post_norm_on_card_matches_cpu(cuda_device, norm):
    from evreal_tpu_torch.ops.normalize import (
        post_process_normalization_frames)

    rng = np.random.default_rng(3)
    frames = torch.from_numpy(
        rng.integers(0, 256, (4, 260, 346, 3)).astype(np.float32) / 255)
    got = post_process_normalization_frames(frames.to(cuda_device), norm)
    assert torch.equal(got.cpu(), post_process_normalization_frames(
        frames, norm))
