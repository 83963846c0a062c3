"""The CUDA voxelizer's tiling (evreal_tpu_torch/kernels/voxelize_cuda.py:
tile_plan) and the indexing its three tiled kernels do (csrc/voxelize.cu),
on the CPU: the tiles cover every cell of the grid exactly once within the
shared memory budget, and a plain PyTorch emulation of count -> scatter ->
accumulate over the plan, with the records of each segment in any order,
equals the int64 fixed-point plain version bit for bit. Also the wrapper's
host side: the routing of a call by its shape, and the per-key check cache
(its checks run on CPU tensors with the kernels' device type set to
"cpu"; nothing launches)."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from evreal_tpu_torch.data.packing import compact4_layout, encode_compact4
from evreal_tpu_torch.data.packing import quantize_ts
from evreal_tpu_torch.kernels import voxelize_cuda as vc
from evreal_tpu_torch.ops import voxelize as tvox

torch.set_num_threads(1)

HW = (24, 32)
LAYOUT = compact4_layout(HW)
# ECD/HQF, MVSEC/CED and BS-ERGB sensors (tools/bs_ergb_to_npy.py:15-16)
SENSORS = [(180, 240), (260, 346), (625, 970)]


def tiles_of(plan, h, w):
    """Each tile's rectangle (y0, x0, rows, cols) as the accumulate kernel
    cuts it: tile (i, j) starts at (i * rows, j * cols), cut by the edge."""
    rows, cols = plan
    across = -(-w // cols)
    out = []
    for tile in range(vc.tile_count(plan, h, w)):
        y0, x0 = tile // across * rows, tile % across * cols
        out.append((y0, x0, min(rows, h - y0), min(cols, w - x0)))
    return out


@pytest.mark.parametrize("num_bins,h,w,budget", [
    *[(b, h, w, vc.SMEM_BUDGET) for b in (5, 15) for h, w in SENSORS],
    (5, 1, 1, vc.SMEM_BUDGET), (15, 1, 1, vc.SMEM_BUDGET),
    (5, 7, 13, vc.SMEM_BUDGET), (15, 13, 7, vc.SMEM_BUDGET),
    (5, 7, 13, 400), (5, 24, 32, 1024), (3, 1, 97, 40), (5, 97, 1, 80)])
def test_tiles_cover_every_cell_once_within_budget(num_bins, h, w, budget):
    plan = rows, cols = vc.tile_plan(num_bins, h, w, budget)
    assert num_bins * rows * cols * 8 <= budget
    if num_bins * w * 8 <= budget:
        assert cols == w  # bands of whole rows where a row fits
    cover = np.zeros((h, w), np.int32)
    tiles = tiles_of(plan, h, w)
    for y0, x0, rh, cw in tiles:
        assert rh >= 1 and cw >= 1
        cover[y0:y0 + rh, x0:x0 + cw] += 1
    assert (cover == 1).all()
    assert len(tiles) == vc.tile_count(plan, h, w) <= vc.MAX_TILES


def test_tile_plan_rejects_what_cannot_fit():
    with pytest.raises(ValueError, match="exceed"):
        vc.tile_plan(5, 4, 4, 39)
    with pytest.raises(ValueError, match="empty"):
        vc.tile_plan(5, 0, 4)


def events(seed, t, e, h, w, coords="int16"):
    """(T, E) f32-wire buffers: window 0 has count 0, window 1 count E,
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
    count[0], count[1] = 0, e
    ts[2] = 0.0
    ts[3, 5] = -ts[3, count[3] - 1]
    return xs, ys, ts, ps, count


def wire_bufs(wire, seed, t, e, h, w):
    """The buffer dict of one wire, as the packer writes it."""
    xs, ys, ts, ps, count = events(seed, t, e, h, w,
                                   "float" if wire == "float" else "int16")
    if wire == "compact":
        q = np.zeros(ts.shape, np.uint16)
        for i, n in enumerate(count):
            q[i, :n] = quantize_ts(ts[i, :n], 65535.0).astype(np.uint16)
        u8 = np.where((xs >= 0) & (xs < 256), xs, 255).astype(np.uint8)
        v8 = np.where((ys >= 0) & (ys < 256), ys, 255).astype(np.uint8)
        arrays = {"xs": u8, "ys": v8, "ts": q, "ps": ps}
    elif wire == "compact4":
        ev = np.zeros(ts.shape, np.uint32)
        for i, n in enumerate(count):
            ev[i, :n] = encode_compact4(xs[i, :n], ys[i, :n], ts[i, :n],
                                        ps[i, :n], (h, w))
        arrays = {"ev": ev}
    else:
        arrays = {"xs": xs, "ys": ys, "ts": ts, "ps": ps}
    return {k: torch.from_numpy(np.ascontiguousarray(a))
            for k, a in {**arrays, "count": count}.items()}


def tiled_voxelize(bufs, num_bins, hw, plan, order, bf16, seed=0):
    """count -> scatter -> accumulate as csrc/voxelize.cu does them, in
    PyTorch. Each valid in-bounds event is counted in its tile; its record
    (tile-local pixel << 1 | p > 0, t_norm) goes to its tile's segment of
    the window's records, in ``order`` ("reversed" or "shuffled") within
    the segment; each tile sums its records' deposits in int64 fixed point
    and writes its rectangle of every bin. The output starts as NaN, so a
    cell left unwritten shows."""
    h, w = hw
    rows, cols = plan
    across = -(-w // cols)
    n_tiles = vc.tile_count(plan, h, w)
    plane = rows * cols
    if "ev" in bufs:
        xs, ys, ts, ps = tvox.decode_compact4(bufs["ev"], hw)
    else:
        xs, ys, ts, ps = (bufs[k] for k in ("xs", "ys", "ts", "ps"))
    count = bufs["count"]
    t_n, e = xs.shape
    tn_all = tvox.t_norm(ts, count, num_bins)
    gen = torch.Generator().manual_seed(seed)
    out = torch.full((t_n, num_bins, h, w), float("nan"))
    for t in range(t_n):
        n = min(int(count[t]), e)
        x = xs[t, :n].to(torch.int32).to(torch.int64)
        y = ys[t, :n].to(torch.int32).to(torch.int64)
        keep = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        x, y = x[keep], y[keep]
        tn, p = tn_all[t, :n][keep], ps[t, :n][keep].to(torch.float32)
        # 1. count
        tile = (y // rows) * across + x // cols
        counts = torch.bincount(tile, minlength=n_tiles)
        starts = torch.cumsum(counts, 0) - counts
        # 2. scatter, in the given order within each segment
        key = (torch.arange(len(tile), 0, -1) if order == "reversed"
               else torch.randperm(len(tile), generator=gen))
        perm = torch.argsort(tile * (len(tile) + 1) + key)
        seg = tile[perm]
        rank = torch.arange(len(perm)) - starts[seg]
        word = torch.full((e,), -1, dtype=torch.int64)
        rec_tn = torch.full((e,), float("nan"))
        word[starts[seg] + rank] = (((y % rows) * cols + x % cols) << 1
                                    | (p > 0).to(torch.int64))[perm]
        rec_tn[starts[seg] + rank] = tn[perm]
        # 3. accumulate: each record's tile from the segment it lies in
        n_rec = int(counts.sum())
        rec_tile = torch.repeat_interleave(torch.arange(n_tiles), counts)
        pix = word[:n_rec] >> 1
        pol = torch.where(word[:n_rec] & 1 == 1, 1.0, -1.0)
        lo, w_lo, w_hi = tvox.deposit_weights(rec_tn[:n_rec], pol, bf16)
        acc = torch.zeros(n_tiles * num_bins * plane, dtype=torch.int64)
        for b, wgt in ((lo, w_lo), (lo + 1, w_hi)):
            ok = (b >= 0) & (b < num_bins)
            idx = (rec_tile * num_bins + b) * plane + pix
            acc.index_add_(0, idx[ok], tvox.to_fixed(wgt[ok]))
        cells = tvox.from_fixed(acc).view(n_tiles, num_bins, rows, cols)
        for k in range(n_tiles):
            y0, x0 = k // across * rows, k % across * cols
            rh, cw = min(rows, h - y0), min(cols, w - x0)
            out[t, :, y0:y0 + rh, x0:x0 + cw] = cells[k, :, :rh, :cw]
    return out


CASES = [  # (wire, num_bins, (h, w), budget, T, E)
    ("int16", 5, (24, 32), 1024, 6, 700),       # pieces of rows
    ("float", 5, (24, 32), 1024, 6, 700),
    ("compact", 5, (24, 32), 2000, 5, 600),
    ("compact4", 5, (24, 32), 2000, 5, 600),
    ("int16", 15, (7, 13), vc.SMEM_BUDGET, 4, 300),  # prime, one tile
    ("compact4", 5, (180, 240), vc.SMEM_BUDGET, 4, 4096),
    ("compact4", 15, (260, 346), vc.SMEM_BUDGET, 4, 4096),
    ("int16", 5, (625, 970), vc.SMEM_BUDGET, 4, 8192),
]


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("wire,num_bins,hw,budget,t,e", CASES)
def test_tiled_emulation_equals_int64_plain(wire, num_bins, hw, budget, t, e,
                                            precision, order):
    if wire == "compact4":
        assert compact4_layout(hw) is not None
    bufs = wire_bufs(wire, 1, t, e, *hw)
    plan = vc.tile_plan(num_bins, *hw, budget)
    bf16 = precision == "default"
    got = tiled_voxelize(bufs, num_bins, hw, plan, order, bf16)
    want = tvox.voxelize_buffers_plain(bufs, num_bins, hw,
                                       accum_dtype=torch.int64,
                                       bf16_factors=bf16)
    assert torch.equal(got, want)
    if vc.tile_count(plan, *hw) > 1:  # the windows do cross tiles
        assert len({k for k, (y0, x0, rh, cw) in
                    enumerate(tiles_of(plan, *hw))
                    if want[1, :, y0:y0 + rh, x0:x0 + cw].any()}) > 1


# ---------------------------------------------------------------------------
# the wrapper's routing and its per-key check cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,path", [
    ((1, 32768), "direct"), ((1, 0), "direct"), ((2, 32768), "tiled"),
    ((4, 1), "tiled"), ((512, 32768), "tiled"), ((0, 16), "tiled"),
    ((16,), "tiled"), ((1, 2, 3), "tiled")])
def test_route_is_a_function_of_the_shape(shape, path):
    assert vc.route(shape) == path
    assert vc.route(torch.Size(shape)) == path


def test_public_entries_route_by_shape(monkeypatch):
    """``voxelize`` and ``voxelize_compact4`` hand T = 1 to the direct path
    and any other T to the tiled one, with the same arguments."""
    calls = []
    for path in vc.PATHS:
        monkeypatch.setattr(
            vc, f"_voxelize_{path}",
            lambda events, count, *rest, path=path: calls.append(
                (path, tuple(events[0].shape), count.shape, rest)))
    split = wire_bufs("int16", 0, 4, 64, *HW)
    packed = wire_bufs("compact4", 0, 4, 64, *HW)
    for t in (1, 4):
        vc.voxelize(*(split[k][:t] for k in ("xs", "ys", "ts", "ps",
                                              "count")), 5, HW)
        vc.voxelize_compact4(packed["ev"][:t], packed["count"][:t], 5, HW,
                             list(LAYOUT), "default")
    assert calls == [
        (path, (t, 64), (t,), rest) for path, t in (("direct", 1),
                                                    ("tiled", 4))
        for rest in ((5, HW, None), (5, HW, "default", LAYOUT))]


def test_direct_plan_matches_the_c_struct():
    """``_DirectPlan`` mirrors ``csrc/voxelize.cu:DirectPlan`` field for
    field (ctypes passes it by address)."""
    src = Path(vc._SOURCE).read_text()
    body = re.search(r"struct DirectPlan \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if decl:
            kind, rest = decl.split(None, 1)
            names += [(n.strip(), kind) for n in rest.split(",")]
    assert names == [(n, "float" if t is ctypes.c_float else "int")
                     for n, t in vc._DirectPlan._fields_]




@pytest.fixture
def cpu_checks(monkeypatch):
    """The wrapper's checks on CPU tensors: the kernels' device type set to
    "cpu", an empty plan cache."""
    monkeypatch.setattr(vc, "_DEVICE_TYPE", "cpu")
    monkeypatch.setattr(vc, "_plans", {})


def strided(a):
    """``a``'s values in a tensor that is not contiguous."""
    return torch.stack([a, a], dim=-1)[..., 0]


def first_windows(wire, t):
    """The first ``t`` windows of ``wire_bufs``' edge-case windows."""
    return {k: v[:t].contiguous()
            for k, v in wire_bufs(wire, 0, 4, 64, *HW).items()}


def split_call(bufs):
    return tuple(bufs[k] for k in ("xs", "ys", "ts", "ps")), bufs["count"]


# {name: (wire, bufs -> (events, count, layout))} that the checks refuse
REFUSED = {
    "ts dtype": ("int16", lambda b: ((b["xs"], b["ys"], b["ts"].double(),
                                      b["ps"]), b["count"], None)),
    "xs, ys dtypes": ("int16", lambda b: ((b["xs"], b["ys"].int(), b["ts"],
                                           b["ps"]), b["count"], None)),
    "coord dtype": ("int16", lambda b: ((b["xs"].double(), b["ys"].double(),
                                         b["ts"], b["ps"]), b["count"],
                                        None)),
    "ps dtype": ("int16", lambda b: ((b["xs"], b["ys"], b["ts"],
                                      b["ps"].int()), b["count"], None)),
    "shape": ("int16", lambda b: ((b["xs"], b["ys"][:, 1:].contiguous(),
                                   b["ts"], b["ps"]), b["count"], None)),
    "not (T, E)": ("int16", lambda b: ((b["xs"][0], b["ys"][0], b["ts"][0],
                                        b["ps"][0]), b["count"], None)),
    "contiguous": ("int16", lambda b: ((strided(b["xs"]), b["ys"], b["ts"],
                                        b["ps"]), b["count"], None)),
    "count dtype": ("int16", lambda b: (split_call(b)[0], b["count"].long(),
                                        None)),
    "count shape": ("int16", lambda b: (split_call(b)[0],
                                        b["count"].repeat(2), None)),
    "device": ("int16", lambda b: ((b["xs"], b["ys"].to("meta"), b["ts"],
                                    b["ps"]), b["count"], None)),
    "device type": ("int16", lambda b: (
        tuple(a.to("meta") for a in split_call(b)[0]),
        b["count"].to("meta"), None)),
    "ev dtype": ("compact4", lambda b: ((b["ev"].long(),), b["count"],
                                        LAYOUT)),
    "ev contiguous": ("compact4", lambda b: ((strided(b["ev"]),),
                                             b["count"], LAYOUT)),
}


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("refused", list(REFUSED))
def test_check_cache_refuses_as_a_first_call_would(cpu_checks, refused, t):
    """A call that the checks refuse raises the same error with an empty
    cache and after the valid call of the same wire and shapes cached its
    plan; the valid call's plan is made once."""
    wire, wrong = REFUSED[refused]
    bufs = first_windows(wire, t)
    if wire == "compact4":
        good = ((bufs["ev"],), bufs["count"], LAYOUT)
    else:
        good = (*split_call(bufs), None)
    events, count, layout = wrong(bufs)
    with pytest.raises(ValueError) as first:
        vc._plan(events, count, 5, HW, None, layout)
    plan = vc._plan(good[0], good[1], 5, HW, None, good[2])
    assert vc._plan(good[0], good[1], 5, list(HW), None, good[2]) is plan
    assert plan.shape == (t, 5, *HW) and plan.direct.T == t
    with pytest.raises(ValueError) as again:
        vc._plan(events, count, 5, HW, None, layout)
    assert str(again.value) == str(first.value)
    with pytest.raises(ValueError, match="not supported"):
        vc._plan(good[0], good[1], 5, HW, "high", good[2])


def test_check_cache_keys_precision_and_type_codes(cpu_checks):
    """One plan per key: each precision and each wire has its own, with
    the type codes and the ``_DirectPlan`` the kernels take."""
    events, count = split_call(first_windows("compact", 1))
    hi = vc._plan(events, count, 5, HW, None, None)
    assert vc._plan(events, count, 5, HW, "highest", None) is hi
    lo = vc._plan(events, count, 5, HW, "default", None)
    assert lo is not hi and (hi.bf16, lo.bf16) == (False, True)
    assert hi.codes == (1, 1, 0)  # uint8 coords, uint16 ts, int8 ps
    d = lo.direct
    assert (d.T, d.E, d.B, d.H, d.W, d.compact4, d.bf16) == (1, 64, 5, *HW,
                                                              0, 1)
    assert (d.coord_type, d.ts_type, d.pol_type) == hi.codes
    assert d.u16_scale == np.float32(4 / 65535.0)
    packed = first_windows("compact4", 1)
    c4 = vc._plan((packed["ev"],), packed["count"], 5, HW, None, LAYOUT)
    assert (c4.direct.compact4, c4.direct.idx_bits, c4.direct.ts_bits) == (
        1, *LAYOUT)
    assert len(vc._plans) == 3
