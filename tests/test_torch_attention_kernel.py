"""The fused attention's wrapper (``evreal_tpu_torch/kernels/
attention_cuda.py``) on the CPU: ``attention_plain`` against softmax
attention in float64 at L = 1, 47, 48 and 130, at lengths below, at and
past the kernel's 64-key tile, its two-stage ring and its 64-row block,
self- and cross-attention, flat and sharp logits; the kernel's online
softmax (``csrc/attention.cu``: tiles of 64 keys, the ragged end masked,
scores in log2 units as fmaf(s, c, -ref), the reference raised only when
a tile's max tops it by more than 8, for all 32 rows of a warp at once,
sums and outputs rescaled then) emulated in float32 against the same,
with logits far below zero too; a CPU call on views of any float dtype;
the checks that raise on a dtype, shape, stride or head width the kernel
does not take; and the launch path, reached with the device check pointed
at the CPU: a failed launch raises, never falls back, and a launch is
counted with its shape and its scratch buffer."""

import math

import numpy as np
import pytest
import torch

from evreal_tpu_torch.kernels import attention_cuda as ac

torch.set_num_threads(1)

TOL = 1e-5  # float32 against float64 over <= 200 keys of unit-scale values
LENGTHS = [(1, 1), (47, 47), (48, 48), (130, 130), (47, 130), (130, 1)]
# (Lq, Lk) below, at and past the 64-key tile (63, 64, 65), past the
# two-stage ring (129, 193: three and four tiles), past the 64-row block
# and the 32-row warp (33, 65, 129, 200)
TILE_EDGES = [(63, 63), (64, 64), (65, 65), (129, 129), (33, 193),
              (200, 65)]
TILE = 64          # keys a tile (csrc/attention.cu:kBlockK)
WARP_ROWS = 32     # rows whose reference rises together (a warp)
SLACK = 8.0        # csrc/attention.cu:kSlack
LOG2E = 1.4426950408889634


def inputs(lq, lk, sharp, n=2, h=8, dh=32, seed=0):
    """q, k, v as float32 (N, h, L, dh), unit normal, so the logits are
    about unit scale (flat); ``sharp`` makes each query three times one of
    the keys, whose logit (about 17) then stands far above the others
    (about 3): one key takes nearly all the weight."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, h, lq, dh))
    k = rng.normal(size=(n, h, lk, dh))
    v = rng.normal(size=(n, h, lk, dh))
    if sharp:
        q = 3.0 * k[:, :, rng.integers(0, lk, lq)]
    return [torch.from_numpy(a.astype(np.float32)) for a in (q, k, v)]


def attention_f64(q, k, v):
    q, k, v = (t.double() for t in (q, k, v))
    logits = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    return torch.softmax(logits, -1) @ v


def fma32(a, b, c):
    """fmaf elementwise: a * b + c rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def online_softmax(q, k, v):
    """The kernel's arithmetic in float32, a 64-key tile at a time: the
    raw scores (keys past Lk at -inf), a row's reference ``ref`` (-inf at
    first) raised to its running max times c = scale * log2(e) only when
    the tile's max tops it by more than ``SLACK``, and then for every row
    of its 32-row warp, the sum and output rescaled by ``exp2(ref_old -
    ref_new)``; ``p = exp2(fmaf(s, c, -ref))``."""
    lq, lk, dh = q.shape[-2], k.shape[-2], q.shape[-1]
    c = (torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
         * torch.tensor(LOG2E, dtype=torch.float32))
    pad = -lk % TILE
    k = torch.cat([k, k.new_zeros(k.shape[:-2] + (pad, dh))], -2)
    v = torch.cat([v, v.new_zeros(v.shape[:-2] + (pad, dh))], -2)
    acc = torch.zeros_like(q)
    ref = torch.full(q.shape[:-1], -math.inf)
    s_sum = torch.zeros(q.shape[:-1])
    rows = -lq % WARP_ROWS
    for k0 in range(0, lk, TILE):
        s = q @ k[..., k0:k0 + TILE, :].transpose(-1, -2)
        s = s.masked_fill(torch.arange(TILE) >= lk - k0, -math.inf)
        mx = s.amax(-1)
        need = fma32(mx, c, -ref) > SLACK
        warp = torch.nn.functional.pad(need, (0, rows)).unflatten(
            -1, (-1, WARP_ROWS)).any(-1)
        need = warp.repeat_interleave(WARP_ROWS, -1)[..., :lq]
        nxt = torch.where(need, torch.maximum(ref, mx * c), ref)
        alpha = torch.where(need, torch.exp2(ref - nxt), torch.ones(()))
        s_sum, acc, ref = s_sum * alpha, acc * alpha[..., None], nxt
        p = torch.exp2(fma32(s, c, -ref[..., None]))
        s_sum = s_sum + p.sum(-1)
        acc = acc + p @ v[..., k0:k0 + TILE, :]
    return acc / s_sum[..., None]


@pytest.mark.parametrize("sharp", [False, True], ids=["flat", "sharp"])
@pytest.mark.parametrize("lq,lk", LENGTHS)
def test_plain_matches_float64(lq, lk, sharp):
    q, k, v = inputs(lq, lk, sharp)
    got = ac.attention_plain(q, k, v)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.double(), attention_f64(q, k, v),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("sharp", [False, True], ids=["flat", "sharp"])
@pytest.mark.parametrize("lq,lk", LENGTHS)
def test_online_softmax_matches_float64(lq, lk, sharp):
    q, k, v = inputs(lq, lk, sharp)
    np.testing.assert_allclose(online_softmax(q, k, v).double(),
                               attention_f64(q, k, v), atol=TOL, rtol=0)


@pytest.mark.parametrize("sharp", [False, True], ids=["flat", "sharp"])
@pytest.mark.parametrize("lq,lk", TILE_EDGES)
def test_plain_matches_float64_at_tile_edges(lq, lk, sharp):
    q, k, v = inputs(lq, lk, sharp, n=1, h=4)
    np.testing.assert_allclose(ac.attention_plain(q, k, v).double(),
                               attention_f64(q, k, v), atol=TOL, rtol=0)


@pytest.mark.parametrize("sharp", [False, True], ids=["flat", "sharp"])
@pytest.mark.parametrize("lq,lk", TILE_EDGES)
def test_online_softmax_matches_float64_at_tile_edges(lq, lk, sharp):
    q, k, v = inputs(lq, lk, sharp, n=1, h=4)
    np.testing.assert_allclose(online_softmax(q, k, v).double(),
                               attention_f64(q, k, v), atol=TOL, rtol=0)


@pytest.mark.parametrize("lq,lk", [(65, 129), (33, 193)])
def test_online_softmax_with_logits_far_below_zero(lq, lk):
    """Every logit near -110, so exp2 of a scaled raw score underflows to
    0 in float32: the first tile must set each row's reference to its
    max. Scores of magnitude ~620 carry float32 rounding of ~4e-5 (as in
    ``attention_plain``), hence the wider tolerance here."""
    rng = np.random.default_rng(3)
    u = rng.normal(size=32)
    k = u + 0.1 * rng.normal(size=(1, 4, lk, 32))
    q = -20.0 * u + 0.1 * rng.normal(size=(1, 4, lq, 32))
    v = rng.normal(size=(1, 4, lk, 32))
    q, k, v = (torch.from_numpy(a.astype(np.float32)) for a in (q, k, v))
    scaled = (q @ k.transpose(-1, -2)) * (LOG2E / math.sqrt(32))
    assert float(torch.exp2(scaled).max()) == 0.0
    want = attention_f64(q, k, v)
    plain_gap = float((ac.attention_plain(q, k, v).double() - want).abs()
                      .max())
    got = online_softmax(q, k, v).double()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=max(TOL, 2 * plain_gap),
                               rtol=0)


def test_reference_rises_mid_row_with_sharp_logits():
    """Sharp logits make the running max jump past the slack after the
    first tile, so the emulation exercises the rescaling; flat ones do
    not, so their later tiles take the fast path."""
    def raised(q, k):
        c = (1.0 / math.sqrt(32)) * LOG2E
        tiles = (q @ k.transpose(-1, -2)).split(TILE, -1)
        first = tiles[0].amax(-1) * c
        return any(bool(((t.amax(-1) * c - first) > SLACK).any())
                   for t in tiles[1:])

    q, k, _ = inputs(130, 200, True)
    assert raised(q, k)
    q, k, _ = inputs(130, 200, False)
    assert not raised(q, k)


def test_sharp_logits_pick_one_key():
    q, k, v = inputs(130, 130, True)
    weights = torch.softmax(q.double() @ k.double().transpose(-1, -2)
                            / math.sqrt(32), -1)
    assert float(weights.amax(-1).median()) > 0.99


def test_cpu_call_takes_plain_and_counts(monkeypatch):
    monkeypatch.setattr(ac, "calls", 0)
    monkeypatch.setattr(ac, "launches", 0)
    monkeypatch.setattr(ac, "products", 0)
    q, k, v = inputs(47, 130, False)
    torch.testing.assert_close(ac.attention(q, k, v),
                               ac.attention_plain(q, k, v), atol=0, rtol=0)
    assert ac.counts() == (1, 0, 2 * 8 * 47 * 130)


def bad_calls():
    q, k, v = inputs(48, 48, False)
    return {
        "dtype": (q.double(), k, v),
        "bf16": (q, k.bfloat16(), v),
        "all_double": (q.double(), k.double(), v.double()),
        "rank": (q[0], k[0], v[0]),
        "stride": (q.transpose(2, 3), k, v),
        "strided_view": (q.transpose(1, 2).contiguous().transpose(1, 2), k,
                         v),
        "kv_length": (q, k, v[:, :, :47]),
        "heads": (q, k[:, :4], v[:, :4]),
        "head_width": (q, k[..., :16].contiguous(), v[..., :16].contiguous()),
        "empty": (q[:, :, :0], k, v),
    }


@pytest.mark.parametrize("case", sorted(bad_calls()))
def test_refuses_what_the_kernel_does_not_take(case, launch_path):
    lib = launch_path(FakeLib(err=0))
    with pytest.raises(ValueError):
        ac.attention(*bad_calls()[case])
    assert ac.counts() == (0, 0, 0) and lib.args is None


@pytest.mark.parametrize("case", ["bf16_views", "double_views"])
def test_cpu_call_takes_any_dtype_and_strides(case, monkeypatch):
    """A CPU call takes views in the stream's dtype, as the written-out
    version did, and computes what ``attention_plain`` does on them."""
    for name in ("calls", "launches", "products"):
        monkeypatch.setattr(ac, name, 0)
    dtype = torch.bfloat16 if case == "bf16_views" else torch.float64
    q, k, v = (t.to(dtype).transpose(1, 2).contiguous().transpose(1, 2)
               for t in inputs(47, 130, False))
    assert not q.is_contiguous()
    got = ac.attention(q, k, v)
    assert got.dtype == dtype
    torch.testing.assert_close(got, ac.attention_plain(q, k, v), atol=0,
                               rtol=0)
    assert ac.counts() == (1, 0, 2 * 8 * 47 * 130)


class FakeLib:
    """Stands in for the built library: records the launch, returns
    ``err``."""

    def __init__(self, err):
        self.err, self.args = err, None

    def evreal_attention(self, *args):
        self.args = args
        return self.err

    def evreal_attention_error_string(self, err):
        return b"an injected launch error"


@pytest.fixture
def launch_path(monkeypatch):
    """CPU tensors take the launch path (the device check pointed at the
    CPU, the stream lookup stubbed); counts from 0."""
    monkeypatch.setattr(ac, "_DEVICE_TYPE", "cpu")
    monkeypatch.setattr(ac.torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    for name in ("calls", "launches", "products"):
        monkeypatch.setattr(ac, name, 0)

    def use(lib):
        monkeypatch.setattr(ac, "_lib", lib)
        return lib

    return use


def test_failed_launch_raises_and_never_falls_back(launch_path,
                                                   monkeypatch):
    launch_path(FakeLib(err=2))
    monkeypatch.setattr(ac, "attention_plain", lambda *a: pytest.fail(
        "fell back to the plain version"))
    with pytest.raises(RuntimeError, match="injected launch error"):
        ac.attention(*inputs(48, 48, False))
    assert ac.launches == 0


def test_launch_is_counted_with_its_shape(launch_path, monkeypatch):
    lib = launch_path(FakeLib(err=0))
    monkeypatch.setattr(ac, "attention_plain", lambda *a: pytest.fail(
        "fell back to the plain version"))
    q, k, v = inputs(47, 130, False)
    out = ac.attention(q, k, v)
    assert out.shape == q.shape and out.dtype == torch.float32
    assert ac.counts() == (1, 1, 2 * 8 * 47 * 130)
    bh, lq, lk, dh, scale = lib.args[5:10]
    assert (bh, lq, lk, dh) == (16, 47, 130, 32)
    assert scale == pytest.approx(1 / math.sqrt(32))
    assert lib.args[3] == out.data_ptr()
    # the scratch for k transposed: its own buffer
    assert lib.args[4] not in (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr())


def test_head_width_other_than_32_raises_on_the_launch_path(launch_path):
    launch_path(FakeLib(err=0))
    with pytest.raises(ValueError, match="head width 16"):
        ac.attention(*inputs(48, 48, False, dh=16))
    assert ac.counts() == (0, 0, 0)


def test_multihead_attention_routes_through_the_wrapper(monkeypatch):
    """``nn/attention.py:MultiheadAttention`` hands ``attention`` the (N,
    h, L, dh) views in the stream's dtype on the CPU, contiguous f32
    tensors where the kernel runs, and rounds a bf16 stream's result back
    to bf16."""
    from evreal_tpu_torch.nn.attention import MultiheadAttention

    seen = []
    orig = ac.attention

    def spy(q, k, v):
        seen.append((q.dtype, q.shape, q.is_contiguous(), k.shape))
        return orig(q, k, v)

    monkeypatch.setattr("evreal_tpu_torch.nn.attention.attention", spy)
    mha = MultiheadAttention(256, 8).eval()
    x = torch.randn(2, 12, 256)
    mem = torch.randn(2, 20, 256)

    def run():
        with torch.no_grad():
            assert mha.float()(x, x, x).dtype == torch.float32
            assert mha(x, mem, mem).shape == (2, 12, 256)
            assert mha.bfloat16()(x.bfloat16(), x.bfloat16(),
                                  x.bfloat16()).dtype == torch.bfloat16

    run()
    assert seen == [(torch.float32, (2, 8, 12, 32), False, (2, 8, 12, 32)),
                    (torch.float32, (2, 8, 12, 32), False, (2, 8, 20, 32)),
                    (torch.bfloat16, (2, 8, 12, 32), False, (2, 8, 12, 32))]
    # the kernel's route (the device check pointed at the CPU)
    seen.clear()
    monkeypatch.setattr(ac, "_DEVICE_TYPE", "cpu")
    monkeypatch.setattr(ac.torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    monkeypatch.setattr(ac, "_lib", FakeLib(err=0))
    run()
    assert seen == [(torch.float32, (2, 8, 12, 32), True, (2, 8, 12, 32)),
                    (torch.float32, (2, 8, 12, 32), True, (2, 8, 20, 32)),
                    (torch.float32, (2, 8, 12, 32), True, (2, 8, 12, 32))]


def test_ptxas_report_is_read_per_kernel():
    """``nvcc.ptxas_usage`` (``chip_smoke.py``'s attention phase reports
    and checks it): registers, spills and static shared memory per kernel,
    under the kernel's own name, the most of its template instances."""
    from evreal_tpu_torch.kernels import nvcc

    # as nvcc names them: the length prefix after the namespace's hash
    fwd = ("_ZN45_GLOBAL__N__d9317677_12_attention_cu_dcd4a74120attention_"
           "fwd_kernelEPK6float4PKfS2_PS0_iiif")
    fwd2 = fwd.replace("iiif", "iiiif")  # another template instance
    tr = ("_ZN45_GLOBAL__N__d9317677_12_attention_cu_dcd4a74126attention_"
          "transpose_kernelEPKfPfii")
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fwd}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 220 registers, used 1 barriers, 400 bytes "
        "cmem[0]",
        f"ptxas info    : Function properties for {fwd2}",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{tr}' for 'sm_90a'",
        f"ptxas info    : Function properties for {tr}",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 26 registers, used 1 barriers, 4224 bytes smem, "
        "376 bytes cmem[0]"])
    assert nvcc.ptxas_usage(log) == {
        "attention_fwd_kernel": {"registers": 220, "spill_stores": 8,
                                 "spill_loads": 8, "stack_bytes": 0,
                                 "smem_bytes": 0},
        "attention_transpose_kernel": {"registers": 26, "spill_stores": 4,
                                       "spill_loads": 12, "stack_bytes": 8,
                                       "smem_bytes": 4224}}
    assert nvcc.ptxas_usage("") == {}
