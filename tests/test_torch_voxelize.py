"""The port's voxelizer (evreal_tpu_torch/ops/voxelize.py) against the JAX
package's: the XLA scatter path, and the Pallas kernels K1 (``voxelize``)
and K2 (``voxelize_pallas_windows``) run in interpret mode, as
tests/test_pallas_voxelize.py runs them. Same inputs, made with numpy from a
seed; tolerance atol 2e-5 (tests/test_pallas_voxelize.py:25)."""

import jax
import numpy as np
import pytest
import torch

from evreal_tpu.kernels.voxelize_pallas import voxelize as vox_pallas_k1
from evreal_tpu.kernels.voxelize_pallas import voxelize_pallas_windows
from evreal_tpu.ops.voxelize import decode_compact4, voxelize_scatter
from evreal_tpu_torch.data.packing import encode_compact4, quantize_ts
from evreal_tpu_torch.kernels import voxelize_cuda
from evreal_tpu_torch.ops import voxelize as tvox

torch.set_num_threads(1)

ATOL = 2e-5
H, W, B = 24, 32, 5

_jax_scatter = jax.jit(voxelize_scatter, static_argnums=(5, 6))


def windows(seed, t, e, coords="int16", h=H, w=W):
    """(T, E) f32-wire buffers; window 0 has count 0, window 1 count E,
    window 2 a degenerate dt, window 3 an unsorted timestamp with
    t_norm <= -1; coordinates run out of bounds on every side."""
    rng = np.random.default_rng(seed)
    if coords == "float":  # fractional, incl. negative: -0.5 truncates to 0
        xs = rng.uniform(-2.0, w + 2.0, (t, e)).astype(np.float32)
        ys = rng.uniform(-2.0, h + 2.0, (t, e)).astype(np.float32)
        xs[:, :8] = -0.5
        ys[:, 8:16] = -0.9
    else:
        xs = rng.integers(-3, w + 3, (t, e)).astype(np.int16)
        ys = rng.integers(-3, h + 3, (t, e)).astype(np.int16)
    ts = np.sort(rng.uniform(0.0, 0.03, (t, e)), axis=1)
    ts = (ts - ts[:, :1]).astype(np.float32)
    ps = (rng.integers(0, 2, (t, e)) * 2 - 1).astype(np.int8)
    count = rng.integers(e // 2, e + 1, t).astype(np.int32)
    if t >= 4:
        count[0], count[1] = 0, e
        ts[2] = 0.0
        ts[3, 5] = -ts[3, count[3] - 1]
    return xs, ys, ts, ps, count


def jax_windows(xs, ys, ts, ps, count, num_bins=B, hw=(H, W)):
    """Per-window JAX scatter voxelization, stacked: (T, B, H, W)."""
    out = []
    for i in range(xs.shape[0]):
        ps_f = ps[i].astype(np.float32)
        t_i = ts[i] if ts.dtype == np.uint16 else ts[i].astype(np.float32)
        out.append(np.asarray(_jax_scatter(xs[i], ys[i], t_i, ps_f,
                                           np.int32(count[i]), num_bins,
                                           hw)))
    return np.stack(out)


def port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def split(*arrays):
    """The split wire's buffer dict of numpy ``(xs, ys, ts, ps, count)``."""
    return dict(zip(("xs", "ys", "ts", "ps", "count"), port(*arrays)))


def port_windows(xs, ys, ts, ps, count, num_bins=B, hw=(H, W)):
    return tvox.voxelize_windows(split(xs, ys, ts, ps, count), num_bins,
                                 hw).numpy()


@pytest.mark.parametrize("coords", ["int16", "float"])
def test_f32_wire_matches_jax_scatter(coords):
    args = windows(1, 6, 700, coords)
    np.testing.assert_allclose(port_windows(*args), jax_windows(*args),
                               atol=ATOL)


def test_uint16_wire_matches_jax_scatter():
    xs, ys, ts, ps, count = windows(2, 5, 600)
    q = np.zeros(ts.shape, np.uint16)
    for i, n in enumerate(count):
        q[i, :n] = quantize_ts(ts[i, :n], 65535.0).astype(np.uint16)
    u8 = lambda a: np.where((a >= 0) & (a < 256), a, 255).astype(np.uint8)  # noqa: E731
    args = (u8(xs), u8(ys), q, ps, count)
    np.testing.assert_allclose(port_windows(*args), jax_windows(*args),
                               atol=ATOL)


def test_decode_compact4_matches_jax_incl_sentinel():
    xs, ys, ts, ps, count = windows(3, 4, 500)
    ev = np.zeros(ts.shape, np.uint32)
    for i, n in enumerate(count):
        ev[i, :n] = encode_compact4(xs[i, :n], ys[i, :n], ts[i, :n],
                                    ps[i, :n], (H, W))
    assert (ev & ((1 << 10) - 1) == H * W).any()  # OOB events -> sentinel
    got = tvox.decode_compact4(torch.from_numpy(ev), (H, W))
    want = decode_compact4(ev, (H, W))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    bufs = dict(zip(("xs", "ys", "ts", "ps"), got))
    vox = tvox.voxelize_windows({**bufs, "count": torch.from_numpy(count)},
                                B, (H, W)).numpy()
    jx, jy, jt, jp = (np.asarray(a) for a in want)
    np.testing.assert_allclose(vox, jax_windows(jx, jy, jt, jp, count),
                               atol=ATOL)


def test_zero_capacity_and_zero_count():
    z = np.zeros((3, 0), np.float32)
    out = tvox.voxelize_windows(split(z, z, z, z, np.zeros(3, np.int32)), B,
                                (H, W))
    assert out.shape == (3, B, H, W) and not out.any()
    single = tvox.voxelize_scatter(*port(*(np.zeros(0, np.float32),) * 4),
                                   0, B, (H, W))
    assert single.shape == (B, H, W) and not single.any()
    xs, ys, ts, ps, count = windows(4, 2, 300)
    count[:] = 0
    assert not port_windows(xs, ys, ts, ps, count).any()


@pytest.mark.parametrize("n,cap", [(3000, 4096), (100, 2048), (0, 1024)])
def test_single_window_matches_pallas_k1(n, cap):
    xs, ys, ts, ps, count = windows(5, 1, cap)
    count[0] = n
    got = tvox.voxelize_scatter(*port(xs[0], ys[0], ts[0], ps[0]), n, B,
                                (H, W)).numpy()
    want = np.asarray(vox_pallas_k1(
        xs[0].astype(np.float32), ys[0].astype(np.float32), ts[0],
        ps[0].astype(np.float32), np.int32(n), num_bins=B,
        sensor_size=(H, W), interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_windows_match_pallas_k2():
    """T not a multiple of K2's 8-window tile, with count 0 and count E."""
    args = windows(6, 11, 1024)
    want = np.asarray(voxelize_pallas_windows(*args, B, (H, W),
                                              interpret=True))
    np.testing.assert_allclose(port_windows(*args), want, atol=ATOL)


def test_float64_accumulation_agrees():
    args = port(*windows(7, 4, 800))
    f32 = tvox.voxelize_windows_plain(*args, B, (H, W))
    f64 = tvox.voxelize_windows_plain(*args, B, (H, W),
                                      accum_dtype=torch.float64)
    assert f64.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), f64.numpy(), atol=ATOL)


def test_cuda_wrapper_never_falls_back_to_cpu():
    args = port(*windows(8, 2, 64))
    with pytest.raises(ValueError, match="CUDA device"):
        voxelize_cuda.voxelize(*args, B, (H, W))


# ---------------------------------------------------------------------------
# K2-DEFAULT (bf16 factors) and the compact wires
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coords", ["int16", "float"])
def test_bf16_factors_match_pallas_k2_default(coords):
    """The plain bf16-factor voxelizer against K2 at DEFAULT precision in
    interpret mode: T not a multiple of K2's 8-window tile, count 0 and E,
    a degenerate dt, an unsorted timestamp, out-of-bounds coordinates."""
    args = windows(9, 11, 1024, coords)
    want = np.asarray(voxelize_pallas_windows(
        *args, B, (H, W), interpret=True,
        precision=jax.lax.Precision.DEFAULT))
    got = tvox.voxelize_windows(split(*args), B, (H, W),
                                precision="default").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the rounding happened: HIGHEST differs from DEFAULT
    assert np.abs(port_windows(*args) - got).max() > 0


def test_unsupported_precision_raises():
    bufs = split(*windows(10, 2, 64))
    for bad in ("high", jax.lax.Precision.DEFAULT, "bf16"):
        with pytest.raises(ValueError, match="not supported"):
            tvox.voxelize_windows(bufs, B, (H, W), precision=bad)
    assert tvox.voxelize_windows.supported_precisions == \
        voxelize_pallas_windows.supported_precisions


def compact_wires(xs, ys, ts, ps, count):
    """The compact (uint16 ts, uint8 coords) and compact4 (packed u32)
    buffer dicts of the same windows, as the packer writes them."""
    q = np.zeros(ts.shape, np.uint16)
    ev = np.zeros(ts.shape, np.uint32)
    for i, n in enumerate(count):
        q[i, :n] = quantize_ts(ts[i, :n], 65535.0).astype(np.uint16)
        ev[i, :n] = encode_compact4(xs[i, :n], ys[i, :n], ts[i, :n],
                                    ps[i, :n], (H, W))
    u8 = lambda a: np.where((a >= 0) & (a < 256), a, 255).astype(np.uint8)  # noqa: E731
    return {"compact": {"xs": u8(xs), "ys": u8(ys), "ts": q, "ps": ps,
                        "count": count},
            "compact4": {"ev": ev, "count": count}}


@pytest.mark.parametrize("wire", ["compact", "compact4"])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_compact_wires_match_jax_voxel_stage(wire, precision):
    """The buffer dict through ``voxelize_windows`` against the JAX
    package's voxel stage on the same buffers (its scatter voxelizer, f32
    weights; DEFAULT against K2 in interpret mode)."""
    from evreal_tpu.harness.runner import make_voxel_stage

    bufs = compact_wires(*windows(11, 9, 768))[wire]
    if precision == "highest":
        stage = make_voxel_stage(voxelize_scatter, B, (H, W), False)
        want = np.asarray(stage(bufs)).transpose(0, 3, 1, 2)
    else:
        if wire == "compact4":
            jx, jy, jt, jp = decode_compact4(bufs["ev"], (H, W))
        else:
            jx, jy, jt, jp = (bufs[k] for k in ("xs", "ys", "ts", "ps"))
        want = np.asarray(voxelize_pallas_windows(
            jx, jy, jt, jp, bufs["count"], B, (H, W), interpret=True,
            precision=jax.lax.Precision.DEFAULT))
    got = tvox.voxelize_windows({k: torch.from_numpy(v)
                                 for k, v in bufs.items()}, B, (H, W),
                                precision=precision).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)



# ---------------------------------------------------------------------------
# int64 fixed-point accumulation: the CUDA kernels' arithmetic
# ---------------------------------------------------------------------------

def every_wire(seed, t=6, e=768):
    """Buffer dicts of every wire the kernels read, with the edge cases of
    ``windows``: int16 / f32 / int8, fractional f32 coords, int32 coords
    with f32 polarity, the compact wire (uint8 / uint16) and compact4."""
    args = windows(seed, t, e)
    xs, ys, ts, ps, count = args
    fx, fy = windows(seed + 1, t, e, "float")[:2]
    return {"int16": split(*args),
            "float": split(fx, fy, ts, ps, count),
            "int32": split(xs.astype(np.int32), ys.astype(np.int32), ts,
                           ps.astype(np.float32), count),
            **{k: {n: torch.from_numpy(v) for n, v in bufs.items()}
               for k, bufs in compact_wires(*args).items()}}


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("wire", ["int16", "float", "int32", "compact",
                                  "compact4"])
def test_int64_accumulation_within_rounding_of_float64(wire, precision):
    """Each deposit rounds to 2^-32, so a cell of k deposits lies within
    k * 2^-33 of the float64 sum before the final cast; each side's cast to
    f32 adds at most half an f32 spacing, and the float64 sum of k deposits
    of magnitude <= 1 is within k * 2^-50 of exact."""
    bufs = every_wire(12)[wire]
    bf16 = precision == "default"
    i64 = tvox.voxelize_buffers_plain(bufs, B, (H, W),
                                      accum_dtype=torch.int64,
                                      bf16_factors=bf16).numpy()
    f64 = tvox.voxelize_buffers_plain(bufs, B, (H, W),
                                      accum_dtype=torch.float64,
                                      bf16_factors=bf16).numpy()
    if "ev" in bufs:
        split_bufs = tvox.decode_compact4(bufs["ev"], (H, W))
    else:
        split_bufs = [bufs[k] for k in ("xs", "ys", "ts", "ps")]
    idx, _ = tvox.event_deposits(*split_bufs, bufs["count"], B, (H, W), bf16)
    k = np.bincount(idx.numpy(), minlength=i64.size).reshape(i64.shape)
    assert k.max() >= 2  # some cells sum several deposits
    spacing = np.spacing(np.maximum(np.abs(i64), np.abs(f64)))
    assert (np.abs(i64 - f64) <= k * 2.0 ** -33 + k * 2.0 ** -50
            + spacing).all()
    assert not i64[k == 0].any()


def test_int64_accumulation_rounds_each_deposit_to_nearest_even():
    """Deposits at and between the 2^-32 steps: ties go to the even step
    (``__float2ll_rn``), and one cell sums them exactly."""
    half = 2.0 ** -33
    w = torch.tensor([half, 3 * half, -half, -3 * half, 2.0 ** -40, 1.0],
                     dtype=torch.float32)
    assert tvox.to_fixed(w).tolist() == [0, 2, 0, -2, 0, 2 ** 32]
    acc = tvox.to_fixed(w).sum().reshape(1)
    assert tvox.from_fixed(acc).item() == 1.0


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_int64_accumulation_matches_jax(precision):
    """The int64 mode against the JAX package: its scatter voxelizer (f32
    weights) and K2 in interpret mode (both precisions), within 2e-5."""
    args = windows(13, 11, 1024)
    bf16 = precision == "default"
    got = tvox.voxelize_windows_plain(*port(*args), B, (H, W),
                                      accum_dtype=torch.int64,
                                      bf16_factors=bf16).numpy()
    k2 = np.asarray(voxelize_pallas_windows(
        *args, B, (H, W), interpret=True,
        precision=(jax.lax.Precision.DEFAULT if bf16
                   else jax.lax.Precision.HIGHEST)))
    np.testing.assert_allclose(got, k2, atol=ATOL)
    if not bf16:
        np.testing.assert_allclose(got, jax_windows(*args), atol=ATOL)


# ---------------------------------------------------------------------------
# one window as a stream's push packs it (T = 1: the CUDA direct path)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("wire", ["f32", "compact", "compact4"])
def test_serve_window_matches_pallas_k1(wire, precision):
    """A window packed by ``serve._pack_window`` on each wire a stream
    takes ((1, E) buffers), through ``voxelize_windows``, against the JAX
    K1 (``voxelize`` in interpret mode) for HIGHEST and K2 at DEFAULT for
    the bf16 factors, on the same buffers (compact4 decoded by the JAX
    package)."""
    from evreal_tpu_torch import serve
    from evreal_tpu_torch.data.packing import bucket_capacity, wire_dtypes

    rng = np.random.default_rng(14)
    n = 1500
    xs = rng.integers(0, W, n).astype(np.int16)
    ys = rng.integers(0, H, n).astype(np.int16)
    ts = np.sort(rng.uniform(2.0, 2.03, n))  # absolute, as a client pushes
    ps = rng.integers(0, 2, n).astype(np.uint8)  # on-disk {0, 1}
    host = serve._pack_window(xs, ys, ts, ps, capacity=bucket_capacity(n),
                              dtypes=wire_dtypes(wire, True, (H, W)),
                              resolution=(H, W))
    assert host["count"].shape == (1,) and int(host["count"][0]) == n
    got = tvox.voxelize_windows({k: torch.from_numpy(v)
                                 for k, v in host.items()}, B, (H, W),
                                precision=precision).numpy()
    if "ev" in host:
        jx, jy, jt, jp = (np.asarray(a) for a in decode_compact4(
            host["ev"][0], (H, W)))
    else:
        jx, jy, jt, jp = (host[k][0] for k in ("xs", "ys", "ts", "ps"))
    jp = jp.astype(np.float32)
    if precision == "highest":
        want = np.asarray(vox_pallas_k1(
            jx, jy, jt, jp, np.int32(n), num_bins=B, sensor_size=(H, W),
            interpret=True))[None]
    else:
        want = np.asarray(voxelize_pallas_windows(
            jx[None], jy[None], jt[None], jp[None], host["count"], B, (H, W),
            interpret=True, precision=jax.lax.Precision.DEFAULT))
    assert got.shape == (1, B, H, W)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(want).max() > 0.5
