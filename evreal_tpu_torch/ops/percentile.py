"""Exact linear-interpolation percentiles (``evreal_tpu/ops/percentile.py``).

The order statistics are bit-identical to JAX's ``lax.sort`` total order
(``-inf < ... < -0.0 < +0.0 < ... < +inf``): the f32 bits map to
order-preserving int64 keys, the keys are sorted, and each requested rank
reads the element it points at. The rank weights are computed statically
in float64 (numpy-exact); an integer rank (``hw == 0``) takes the order
statistic directly, so an infinite statistic stays infinite. Any NaN in
the input makes the result NaN.
"""

import numpy as np
import torch


def rank_weights(q, n):
    """(low_rank, high_rank, low_weight, high_weight) for percentile q of
    n elements, in float64 then rounded to f32 weights."""
    rf = q / 100.0 * (n - 1)
    low = np.floor(rf)
    high = np.ceil(rf)
    hw = np.float32(rf - low)
    lw = np.float32(np.float64(1.0) - np.float64(rf - low))
    clamp = lambda r: int(min(max(r, 0.0), float(n - 1)))  # noqa: E731
    return clamp(low), clamp(high), lw, hw


def f32_keys(x):
    """Order-preserving int64 keys of f32 ``x`` (values in [0, 2^32))."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, 0xFFFFFFFF - u, u + 2 ** 31)


def order_stats(x, ks):
    """The ks[i]-th smallest elements (0-indexed) along the last axis of
    f32 ``x``, bit-exact. Returns ``x.shape[:-1] + (len(ks),)``."""
    _, order = torch.sort(f32_keys(x), dim=-1)
    pick = order[..., list(ks)]
    return torch.gather(x, -1, pick)


def _gather_plans(x, plans):
    """Order statistics of f32 ``x`` (..., n) at the plans' ranks:
    {rank: values (...)}."""
    ks = sorted({k for plan in plans for k in plan[:2]})
    vals = order_stats(x, ks)
    return {k: vals[..., i] for i, k in enumerate(ks)}


def _nan_guard(x, out):
    nan = torch.isnan(x).any(dim=-1, keepdim=True)
    return torch.where(nan, torch.full_like(out, float("nan")), out)


def percentiles(x, qs):
    """``np.percentile(x, q)`` (linear) for each q in ``qs`` along the last
    axis of f32 ``x`` (..., n) -> (..., len(qs)) f32, interpolated as
    ``lw * lo + hw * hi`` (``jnp.percentile``'s rule)."""
    x = x.to(torch.float32)
    n = x.shape[-1]
    plans = [rank_weights(q, n) for q in qs]
    stats = _gather_plans(x, plans)
    outs = []
    for k0, k1, lw, hw in plans:
        if hw == 0.0:
            outs.append(stats[k0])
        else:
            lw_t = torch.tensor(lw, dtype=torch.float32, device=x.device)
            hw_t = torch.tensor(hw, dtype=torch.float32, device=x.device)
            outs.append(stats[k0] * lw_t + stats[k1] * hw_t)
    return _nan_guard(x, torch.stack(outs, dim=-1))


def numpy_rank_plan(q, n):
    """(low_rank, high_rank, gamma) of numpy's own f32 ``np.percentile``
    (numpy 2, method "linear"): the quantile ``f32(q) / 100`` and the
    virtual index ``(n - 1) * q`` in f32, its floor and fraction, ranks
    clamped to the array."""
    qf = np.float32(q) / np.float32(100)
    virtual = np.float32(n - 1) * qf
    low = np.floor(virtual)
    gamma = np.float32(virtual - low)
    if virtual >= n - 1:
        return n - 1, n - 1, gamma
    if virtual < 0:
        return 0, 0, gamma
    return int(low), int(low) + 1, gamma


def numpy_percentiles(x, qs):
    """``np.percentile(x, q)`` of f32 ``x`` along its last axis, as numpy
    computes it for f32 input: ranks by ``numpy_rank_plan`` and numpy's
    lerp, ``lo + (hi - lo) * g`` for g < 0.5, else ``hi - (hi - lo) * (1 -
    g)``, in f32. Returns (..., len(qs)) f32."""
    x = x.to(torch.float32)
    plans = [numpy_rank_plan(q, x.shape[-1]) for q in qs]
    stats = _gather_plans(x, plans)
    outs = []
    for k0, k1, gamma in plans:
        lo, hi = stats[k0], stats[k1]
        diff = hi - lo
        if gamma < 0.5:
            g = torch.tensor(gamma, dtype=torch.float32, device=x.device)
            outs.append(lo + diff * g)
        else:
            g = torch.tensor(np.float32(1) - gamma, dtype=torch.float32,
                             device=x.device)
            outs.append(hi - diff * g)
    return _nan_guard(x, torch.stack(outs, dim=-1))
