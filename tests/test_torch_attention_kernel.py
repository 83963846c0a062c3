"""The fused attention's wrapper (``evreal_tpu_torch/kernels/
attention_cuda.py``) on the CPU: ``attention_plain`` against softmax
attention in float64 at L = 1, 47, 48 and 130, self- and cross-attention,
flat and sharp logits; the kernel's online softmax (``csrc/
attention.cu``: tiles of 64 keys zero-filled at the ragged end, 16 keys a
register tile, the running max, sum and output rescaled) emulated in
float32 against the same; a CPU call on views of any float dtype; the
checks that raise on a dtype, shape, stride or head width the kernel does
not take; and the launch path, reached with the device check pointed at
the CPU: a failed launch raises, never falls back, and a launch is
counted."""

import math

import numpy as np
import pytest
import torch

from evreal_tpu_torch.kernels import attention_cuda as ac

torch.set_num_threads(1)

TOL = 1e-5  # float32 against float64 over <= 130 keys of unit-scale values
LENGTHS = [(1, 1), (47, 47), (48, 48), (130, 130), (47, 130), (130, 1)]


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


def online_softmax(q, k, v, tile=64, sub=16):
    """The kernel's arithmetic in float32, a key tile at a time: keys past
    Lk zero-filled and given p = 0, the max of the raw scores, ``alpha =
    exp((m_old - m_new) * scale)``, ``p = exp((s - m_new) * scale)``."""
    lk, dh = k.shape[-2], q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    pad = -lk % tile
    k = torch.cat([k, k.new_zeros(k.shape[:-2] + (pad, dh))], -2)
    v = torch.cat([v, v.new_zeros(v.shape[:-2] + (pad, dh))], -2)
    acc = torch.zeros_like(q)
    m = torch.full(q.shape[:-1], -math.inf)
    s_sum = torch.zeros(q.shape[:-1])
    for k0 in range(0, lk, tile):
        nk = min(tile, lk - k0)
        for j0 in range(0, nk, sub):
            kk = k[..., k0 + j0:k0 + j0 + sub, :]
            vv = v[..., k0 + j0:k0 + j0 + sub, :]
            s = q @ kk.transpose(-1, -2)
            valid = torch.arange(sub) < nk - j0
            mx = torch.maximum(m, s.masked_fill(~valid, -math.inf).amax(-1))
            alpha = torch.exp((m - mx) * scale)
            p = torch.where(valid, torch.exp((s - mx[..., None]) * scale),
                            torch.zeros(()))
            s_sum = s_sum * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vv
            m = mx
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
    bh, lq, lk, dh, scale = lib.args[4:9]
    assert (bh, lq, lk, dh) == (16, 47, 130, 32)
    assert scale == pytest.approx(1 / math.sqrt(32))
    assert lib.args[3] == out.data_ptr()


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
