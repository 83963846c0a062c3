"""The port's color path against OpenCV and the JAX package on the CPU.

* the OpenCV-free merge (``evreal_tpu_torch/utils/color.py``) against cv2
  through ``evreal_tpu.utils.color``: resize, shift, addWeighted and
  BGR->LAB bit-equal (BGR->LAB over all 2^24 colours), LAB->BGR within 2
  grey levels, at even and odd sizes;
* ``ColorRunner``'s uint8 channel and grayscale reconstructions against
  the JAX package's, random-init narrow FireNet+ and E2VID, 47 x 63;
* ``-c color`` through both command lines (``.npz`` weights, a synthetic
  sequence at an odd size): timestamps byte for byte, PNGs within 2 grey
  levels (post-norm none) or 3 (robust), metric files empty;
* color with global hist-eq writes ``_processed`` PNGs.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evreal_tpu_torch.cli import main as torch_main
from evreal_tpu_torch.convert.params import flatten, save_params
from evreal_tpu_torch.data import Sequence, pack_windows
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.harness.outputs import (
    decode_png,
    encode_png_bgr8,
    save_inferred_image,
)
from evreal_tpu_torch.models.init import init_e2vid, init_firenet
from evreal_tpu_torch.utils import color as tcolor

cv2 = pytest.importorskip("cv2")
from evreal_tpu.utils import color as jcolor  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

torch.set_num_threads(1)

# LAB->BGR is not OpenCV's exact integer rule: over all 2^24 inputs it is
# off on 4.25% of them (by 2 on 122), never by more
LAB2BGR_MAX, LAB2BGR_SHARE, LAB2BGR_OFF2 = 2, 0.0426, 122
# the merge compounds the LAB round trip: within 2, on at most 6% of pixels
MERGE_MAX, MERGE_SHARE = 2, 0.06
SIZES = [(90, 120), (23, 31), (1, 5), (2, 2)]

METHODS = {
    "E2VID": ({"class": "E2VIDRecurrent",
               "kwargs": {"num_bins": 5, "base_num_channels": 8,
                          "kernel_size": 3, "num_encoders": 2,
                          "recurrent_block_type": "convlstm",
                          "num_residual_blocks": 1, "skip_type": "sum",
                          "norm": None, "use_upsample_conv": True,
                          "final_activation": "sigmoid"}},
              lambda: init_e2vid(seed=0, base_num_channels=8, kernel_size=3,
                                 num_encoders=2, num_residual_blocks=1),
              {"event_tensor_normalization": True,
               "post_process_norm": "robust"}),
    "FireNet+": ({"class": "FireNet", "num_encoders": 0,
                  "kwargs": {"num_bins": 5, "base_num_channels": 8,
                             "kernel_size": 3}},
                 lambda: init_firenet(seed=1, base_num_channels=8),
                 {"event_tensor_normalization": False,
                  "post_process_norm": "none"}),
}
# the PNG bound of each method's post-norm: robust frames divide by their
# 1-99 percentile spread, which scales a merge difference by 255 / spread
PNG_MAX = {"FireNet+": 2, "E2VID": 3}
# narrow random E2VID outputs a near-flat frame (a spread of ~25 grey levels
# turns a 1-level difference into 10): the end-to-end run scales its head
# so that frames span most of the range, as trained models' do
HEAD_GAIN = 40.0


def contrast(tree):
    """``tree`` with E2VID's prediction head scaled by ``HEAD_GAIN``."""
    if "unetrecurrent" in tree:
        head = tree["unetrecurrent"]["pred"]["conv2d"]
        head["weight"] = head["weight"] * np.float32(HEAD_GAIN)
    return tree


def all_colours():
    """Every uint8 triple, in 16 slabs of 2^20."""
    v = np.arange(256, dtype=np.uint8)
    for a in range(0, 256, 16):
        yield np.stack(np.meshgrid(v[a:a + 16], v, v, indexing="ij"),
                       -1).reshape(-1, 1, 3)


# ---------------------------------------------------------------------------
# the merge's parts against cv2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", SIZES)
def test_resize_matches_cv2(hw):
    h, w = hw
    rng = np.random.default_rng(h * 1000 + w)
    imgs = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
    got = tcolor.resize_linear_u8(torch.from_numpy(imgs), (2 * h, 2 * w))
    for img, g in zip(imgs, got.numpy()):
        want = cv2.resize(img, dsize=None, fx=2, fy=2,
                          interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(g, want)
    # the odd-sensor stretch, on a BGR image (channels resized alike)
    bgr = rng.integers(0, 256, (2 * h, 2 * w, 3)).astype(np.uint8)
    got = tcolor.resize_linear_u8(torch.from_numpy(bgr).movedim(-1, 0),
                                  (2 * h + 1, 2 * w + 1)).movedim(0, -1)
    want = cv2.resize(bgr, dsize=(2 * w + 1, 2 * h + 1),
                      interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw", SIZES)
def test_shift_and_add_weighted_match(hw):
    """At the upsampled sizes the merge shifts (the JAX package's shift
    needs two rows)."""
    rng = np.random.default_rng(7)
    a, b = rng.integers(0, 256, (2, 2 * hw[0], 2 * hw[1])).astype(np.uint8)
    for dx, dy in ((1, 1), (1, 0), (0, 1)):
        got = tcolor.shift_image(torch.from_numpy(a), dx, dy).numpy()
        np.testing.assert_array_equal(got, jcolor.shift_image(a.copy(), dx,
                                                              dy))
    got = tcolor.add_weighted_half(torch.from_numpy(a), torch.from_numpy(b))
    want = cv2.addWeighted(src1=a, alpha=0.5, src2=b, beta=0.5, gamma=0.0,
                           dtype=cv2.CV_8U)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bgr_to_lab_matches_cv2_on_every_colour():
    for slab in all_colours():
        got = tcolor.bgr_to_lab_u8(torch.from_numpy(slab)).numpy()
        np.testing.assert_array_equal(
            got, cv2.cvtColor(slab, cv2.COLOR_BGR2LAB))


def test_lab_to_bgr_within_its_bound_on_every_colour():
    off, off2, total = 0, 0, 0
    for slab in all_colours():
        got = tcolor.lab_to_bgr_u8(torch.from_numpy(slab)).numpy()
        d = np.abs(got.astype(int) - cv2.cvtColor(
            slab, cv2.COLOR_LAB2BGR).astype(int)).max(-1)
        assert d.max() <= LAB2BGR_MAX
        off += int((d > 0).sum())
        off2 += int((d == 2).sum())
        total += d.size
    assert off / total <= LAB2BGR_SHARE and off2 <= LAB2BGR_OFF2, (off,
                                                                  off2)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("odd", [False, True])
def test_merge_matches_jax_package(hw, odd):
    """Full merges (upsample, shift, addWeighted, LAB round trip; at an
    odd sensor the stretch) against ``merge_channels_into_color_image``,
    on independent random channels: the hardest case for the LAB round
    trip."""
    h, w = hw
    big = (2 * h + odd, 2 * w + odd)
    rng = np.random.default_rng(h + w + odd)
    ch = rng.integers(0, 256, (3, 4, h, w)).astype(np.uint8)
    gray = rng.integers(0, 256, (3,) + big).astype(np.uint8)
    got = tcolor.merge_channels_into_color_image(
        torch.from_numpy(ch), torch.from_numpy(gray)).numpy()
    assert got.shape == (3,) + big + (3,) and got.dtype == np.uint8
    for t in range(3):
        want = jcolor.merge_channels_into_color_image(
            {"R": ch[t, 0], "G": ch[t, 1], "B": ch[t, 2], "W": ch[t, 3],
             "grayscale": gray[t]})
        d = np.abs(got[t].astype(int) - want.astype(int))
        assert d.max() <= MERGE_MAX
        # the share, where a frame has enough pixels to estimate it
        assert d.size < 3000 or (d > 0).mean() <= MERGE_SHARE


def test_color_png_round_trip_through_cv2(tmp_path):
    rng = np.random.default_rng(3)
    bgr = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    save_inferred_image(str(tmp_path), bgr, 4)
    path = tmp_path / "frame_0000000004.png"
    np.testing.assert_array_equal(cv2.imread(str(path)), bgr)
    np.testing.assert_array_equal(decode_png(path.read_bytes()), bgr)
    cv2.imwrite(str(tmp_path / "cv.png"), bgr)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "cv.png")),
        decode_png(encode_png_bgr8(bgr)))
    # floats quantize as round(clip(img) * 255)
    save_inferred_image(str(tmp_path), np.full((2, 3, 3), 1.5, np.float32),
                        5)
    assert (cv2.imread(str(tmp_path / "frame_0000000005.png")) == 255).all()


# ---------------------------------------------------------------------------
# ColorRunner against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", sorted(METHODS))
def test_color_runner_matches_jax(method, tmp_path):
    from evreal_tpu.harness.runner import make_voxel_stage as j_stage
    from evreal_tpu.models import build_from_meta as j_build
    from evreal_tpu.models.colornet import ColorRunner as JColorRunner
    from evreal_tpu.ops.voxelize import voxelize_scatter
    from evreal_tpu_torch.convert.params import from_jax_tree
    from evreal_tpu_torch.models import build_from_meta
    from evreal_tpu_torch.models.colornet import ColorRunner

    meta, make, flags = METHODS[method]
    h, w, n = 47, 63, 6
    make_sequence(str(tmp_path / "seq"), height=h, width=w, duration_s=0.4,
                  fps=20, events_per_frame=1500, seed=9)
    seq = Sequence(str(tmp_path / "seq"), num_bins=5)
    bufs, _ = pack_windows(seq, list(range(n)))
    tree = make()
    norm = flags["event_tensor_normalization"]

    jrun = JColorRunner(j_build(meta), tree, h, w,
                        j_stage(voxelize_scatter, 5, (h, w), norm),
                        chunk_t=n)
    _, jc, jg = jrun.run(jrun.init_state(), bufs)

    model = build_from_meta(meta)
    model.load_state_dict(from_jax_tree(tree), strict=True)
    stage = trunner.make_voxel_stage(5, (h, w), norm)
    trun = ColorRunner(model, height=h, width=w, voxel_stage=stage,
                       post_norm=flags["post_process_norm"], device="cpu")
    vox = trun.voxel_stage(trun.upload(bufs))
    _, tc, tg = trun.reconstruct(trun.init_state(), vox)
    assert tc.shape == (n, 4, h // 2, w // 2) and tg.shape == (n, h, w)
    for got, want in ((tc, jc), (tg, jg)):
        d = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
        assert d.max() <= 1, d.max()
    # the merge of the JAX package's own channels, both ways
    merged = trun.merge(torch.from_numpy(np.asarray(jc)),
                        torch.from_numpy(np.asarray(jg))).numpy()
    host = jrun.merge_host(np.asarray(jc), np.asarray(jg))
    for t in range(n):
        want = np.round(host[t] * 255).astype(int)
        assert np.abs(merged[t].astype(int) - want).max() <= MERGE_MAX


def test_color_runner_chunk_t_honours_env(monkeypatch):
    """16 windows a chunk by default; ``EVREAL_CHUNK_T`` applies, read when
    the runner is made (``evreal_tpu/models/colornet.py:48-50``)."""
    from evreal_tpu_torch.models import build_from_meta
    from evreal_tpu_torch.models.colornet import ColorRunner

    net = build_from_meta(METHODS["FireNet+"][0])
    kw = dict(height=9, width=11, voxel_stage=None, post_norm="none",
              device="cpu")
    monkeypatch.delenv("EVREAL_CHUNK_T", raising=False)
    assert ColorRunner(net, **kw).chunk_t == 16
    monkeypatch.setenv("EVREAL_CHUNK_T", "5")
    assert ColorRunner(net, **kw).chunk_t == 5


# ---------------------------------------------------------------------------
# -c color end to end, both command lines
# ---------------------------------------------------------------------------

ARGS = ["-m", "E2VID", "FireNet+", "-c", "color", "-d", "SYNC", "-qm", "mse",
        "ssim"]


def write_inputs(root):
    make_sequence(str(root / "data" / "SYNC" / "seq0"), height=41, width=57,
                  duration_s=1.7, fps=20, events_per_frame=600, seed=5)
    for group in ("method", "dataset"):
        (root / "config" / group).mkdir(parents=True)
    for name, (meta, make, flags) in METHODS.items():
        path = root / "pretrained" / name / "model.npz"
        path.parent.mkdir(parents=True)
        save_params(path, flatten(contrast(make())),
                    {**meta, "model_name": name})
        cfg = {"model_name": name, "model_path": str(path.relative_to(root)),
               **flags}
        (root / "config" / "method" / f"{name}.json").write_text(
            json.dumps(cfg))
    (root / "config" / "dataset" / "SYNC.json").write_text(json.dumps(
        {"root_path": "data/SYNC", "sequences": {"seq0": {}}}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Output trees of both command lines: {"jax": dir, "torch": dir}."""
    import evreal_tpu.utils
    from evreal_tpu.cli import eval_main
    from evreal_tpu.harness import staging

    root = tmp_path_factory.mktemp("color")
    write_inputs(root)
    cwd = os.getcwd()
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(evreal_tpu.utils, "enable_compile_cache",
                       lambda: None)
            mp.setattr(staging, "_compute_seen", False)
            mp.setattr(staging, "_staged_bytes", 0)
            mp.delenv("EVREAL_CHUNK_T", raising=False)
            for name, run in (("jax", lambda: eval_main(ARGS)),
                              ("torch", lambda: torch_main(
                                  ARGS + ["--device", "cpu"]))):
                os.chdir(root)
                run()
                out[name] = root / f"outputs_{name}"
                (root / "outputs").rename(out[name])
    finally:
        os.chdir(cwd)
    return out


def seq_dir(base, method):
    return base / "color" / "SYNC" / "seq0" / method


@pytest.mark.parametrize("method", sorted(METHODS))
def test_color_tree_matches_jax(runs, method):
    a, b = seq_dir(runs["jax"], method), seq_dir(runs["torch"], method)
    assert sorted(p.name for p in a.iterdir()) == \
        sorted(p.name for p in b.iterdir())
    for name in ("timestamps.txt", "event_rate.txt"):
        assert (a / name).read_bytes() == (b / name).read_bytes()
    for metric in ("mse", "ssim"):
        assert (b / f"{metric}.txt").read_text() == ""
    ja, jb = (json.loads((d / "done.json").read_text()) for d in (a, b))
    assert ja == jb


@pytest.mark.parametrize("method", sorted(METHODS))
def test_color_frames_match_jax(runs, method):
    """Every frame within ``PNG_MAX``, but for window 0 under the robust
    post-norm: it has no events, so its frame is nearly flat and the
    robust stretch multiplies a 1-level merge difference many times; there
    the bound holds on all but 0.1% of the pixels."""
    frames = sorted(seq_dir(runs["jax"], method).glob("frame_*.png"))
    assert len(frames) >= 30
    for i, p in enumerate(frames):
        want = cv2.imread(str(p)).astype(int)
        got = decode_png((seq_dir(runs["torch"], method) / p.name)
                         .read_bytes()).astype(int)
        assert got.shape == want.shape == (41, 57, 3)
        off = np.abs(got - want) > PNG_MAX[method]
        if i == 0 and METHODS[method][2]["post_process_norm"] == "robust":
            assert off.mean() <= 1e-3, (p.name, off.mean())
        else:
            assert not off.any(), (p.name, np.abs(got - want).max())


def test_color_histeq_writes_processed_images(tmp_path, monkeypatch):
    """Color with global hist-eq equalizes the merged frames and saves them
    under ``_processed`` (reference eval_metrics.py:260-266); clahe and
    local refuse three channels before the sequence runs."""
    make_sequence(str(tmp_path / "seq0"), height=24, width=30,
                  duration_s=0.5, fps=20, events_per_frame=500, seed=2)
    meta, make, flags = METHODS["FireNet+"]
    path = tmp_path / "w" / "model.npz"
    path.parent.mkdir()
    save_params(path, flatten(make()), {**meta, "model_name": "FireNet+"})
    method_config = {"model_name": "FireNet+", "model_path": str(path),
                     **flags}
    monkeypatch.chdir(tmp_path)
    bundle = trunner.MethodBundle("FireNet+", method_config, "cpu")
    seq = {"name": "seq0", "dataset": Sequence(str(tmp_path / "seq0"),
                                               num_bins=5),
           "start_time_s": 0.0, "end_time_s": 10.0}
    cfg = {"name": "color", "save_images": True, "histeq": "global",
           "color": True, "ts_tol_ms": 1.0}
    n, scores = trunner.eval_method_on_sequence(
        "SYN", cfg, "FireNet+", bundle, method_config, seq, ["mse"])
    assert n == 0 and scores == {"mse": -1}
    out = tmp_path / "outputs" / "color" / "SYN" / "seq0"
    frames = sorted((out / "FireNet+").glob("frame_*.png"))
    processed = sorted((out / "FireNet+_processed").glob("frame_*.png"))
    assert frames and [p.name for p in processed] == [p.name for p in frames]
    img = decode_png(processed[0].read_bytes())
    assert img.shape == (24, 30, 3)
    for mode in ("clahe", "local"):
        with pytest.raises(ValueError, match="grayscale images only"):
            trunner.eval_method_on_sequence(
                "SYN", dict(cfg, histeq=mode), "FireNet+", bundle,
                method_config, seq, ["mse"])
