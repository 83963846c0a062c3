"""The port's histogram equalization (``evreal_tpu_torch/harness/histeq.py``)
against the JAX package's and OpenCV's on the CPU: global bit-equal to
``equalize_global``; CLAHE bit-equal to ``cv2.createCLAHE(2.0, (8, 8))``
at frame sizes with and without whole tiles and under 8 px high; local
(native) bit-equal to the JAX package's and to the brute-force rank rule;
the 3-channel errors. Then hist-eq ``evaluate`` runs, single and lockstep,
against the JAX package's (score rows within 2e-5, ``_processed`` PNGs
within 1 grey level; ``ROW_TOL``), and lockstep against single."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evreal_tpu_torch.convert.params import flatten, save_params
from evreal_tpu_torch.data import Sequence
from evreal_tpu_torch.harness import batched as tbatched
from evreal_tpu_torch.harness import histeq as th
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.harness.outputs import decode_png_gray8
from evreal_tpu_torch.models.init import init_firenet

cv2 = pytest.importorskip("cv2")
from evreal_tpu.harness import histeq as jh  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

torch.set_num_threads(1)

MODES = ("global", "clahe", "local")
CLAHE_SIZES = [(180, 240), (47, 63), (64, 64), (5, 30), (1, 17), (260, 346)]


def image(kind, hw, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random(hw).astype(np.float32)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    return (0.5 + 0.45 * np.sin(yy / 9.0) * np.cos(xx / 7.0)).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("hw", [(40, 50), (3, 7)])
def test_global_bit_equal_to_jax(kind, hw):
    img = image(kind, hw)
    np.testing.assert_array_equal(th.equalize_global(img),
                                  jh.equalize_global(img))
    bgr = np.stack([img, img[::-1], img[:, ::-1]], -1)
    np.testing.assert_array_equal(th.histogram_equalization(bgr, "global"),
                                  jh.histogram_equalization(bgr, "global"))


@pytest.mark.parametrize("kind", ["random", "smooth", "flat"])
@pytest.mark.parametrize("hw", CLAHE_SIZES)
def test_clahe_bit_equal_to_cv2(kind, hw):
    """Sides that are and are not multiples of 8 (cv2 then pads both by
    reflect-101, a whole tile where the side was a multiple), and frames
    under 8 px high (the pad is longer than the side)."""
    if kind == "flat":
        u8 = np.full(hw, 77, np.uint8)
    else:
        u8 = th.img_as_ubyte(image(kind, hw, seed=hw[0]))
    got = th.clahe_u8(torch.from_numpy(u8)).numpy()
    want = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(u8)
    np.testing.assert_array_equal(got, want)
    img = u8 / np.float32(255)
    np.testing.assert_array_equal(th.equalize_clahe(img),
                                  jh.equalize_clahe(img))


def test_reflect101_handles_any_pad():
    np.testing.assert_array_equal(th.reflect101(8, 5),
                                  [0, 1, 2, 3, 4, 3, 2, 1])
    np.testing.assert_array_equal(th.reflect101(8, 2),
                                  [0, 1, 0, 1, 0, 1, 0, 1])
    np.testing.assert_array_equal(th.reflect101(8, 1), [0] * 8)


@pytest.mark.parametrize("hw", [(40, 50), (7, 120), (120, 3)])
def test_local_bit_equal_to_jax(hw):
    img = image("random", hw, seed=5)
    np.testing.assert_array_equal(th.equalize_local(img),
                                  jh.equalize_local(img))


@pytest.mark.parametrize("radius", [1, 3, 6])
def test_native_rank_equalize_matches_brute_force(radius):
    u8 = th.img_as_ubyte(image("random", (23, 31), seed=radius))
    np.testing.assert_array_equal(th.native.rank_equalize(u8, radius),
                                  th.rank_equalize_plain(u8, radius))


def test_three_channel_and_unknown_modes_raise():
    bgr = np.zeros((8, 8, 3), np.float32)
    for mode in ("clahe", "local"):
        with pytest.raises(ValueError, match="grayscale images only"):
            th.histogram_equalization(bgr, mode)
    with pytest.raises(ValueError, match="Unrecognized"):
        th.histogram_equalization(bgr[..., 0], "median")
    assert th.histogram_equalization(bgr, "none") is bgr
    with pytest.raises(ValueError, match="uint8"):
        th.clahe_u8(torch.zeros((4, 4)))


# ---------------------------------------------------------------------------
# hist-eq evaluate: single and lockstep, against the JAX package
# ---------------------------------------------------------------------------

META = {"class": "FireNet", "num_encoders": 0,
        "kwargs": {"num_bins": 5, "base_num_channels": 8, "kernel_size": 3}}
CHUNK_T = 8


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("histeq")
    seq_dirs = []
    for i, (dur, epf) in enumerate([(0.9, 900), (1.2, 700)]):
        d = root / "data" / f"seq{i}"
        make_sequence(str(d), height=48, width=64, duration_s=dur, fps=20,
                      events_per_frame=epf, seed=40 + i)
        seq_dirs.append(str(d))
    path = root / "weights" / "FireNet+.npz"
    path.parent.mkdir()
    save_params(path, flatten(init_firenet(seed=1, base_num_channels=8)),
                {**META, "model_name": "FireNet+"})
    return seq_dirs, {"model_name": "FireNet+", "model_path": str(path),
                      "event_tensor_normalization": False,
                      "post_process_norm": "none"}


def sequences(cls, seq_dirs):
    return [{"name": f"seq{i}",
             "dataset": cls(d, num_bins=5,
                            voxel_method={"method": "between_frames"}),
             "start_time_s": 0.1, "end_time_s": 10.0}
            for i, d in enumerate(seq_dirs)]


def eval_config(mode):
    return {"name": "std", "save_images": True, "histeq": mode,
            "eval_infer_all": False, "ts_tol_ms": 1.0,
            "create_video": False}


def run_port(base, mode, lockstep, seq_dirs, cfg, monkeypatch):
    base.mkdir()
    monkeypatch.chdir(base)
    bundle = trunner.MethodBundle("FireNet+", cfg, "cpu")
    seqs = sequences(Sequence, seq_dirs)
    if lockstep:
        return tbatched.eval_method_on_sequence_group(
            "SYNH", eval_config(mode), "FireNet+", bundle, cfg, seqs,
            ["mse", "ssim"])
    return [trunner.eval_method_on_sequence(
        "SYNH", eval_config(mode), "FireNet+", bundle, cfg, s,
        ["mse", "ssim"]) for s in seqs]


def run_jax(base, mode, lockstep, seq_dirs, cfg, monkeypatch):
    from evreal_tpu.data import Sequence as JSequence
    from evreal_tpu.harness import batched as jbatched
    from evreal_tpu.harness import runner as jrunner
    from evreal_tpu.harness import staging

    monkeypatch.setattr(jrunner, "DEFAULT_CHUNK_T", CHUNK_T)
    monkeypatch.setattr(jbatched, "_EVAL_MESH", None)
    monkeypatch.setattr(staging, "_compute_seen", False)
    monkeypatch.setattr(staging, "_staged_bytes", 0)
    base.mkdir()
    monkeypatch.chdir(base)
    bundle = jrunner.MethodBundle("FireNet+", cfg)
    seqs = sequences(JSequence, seq_dirs)
    if lockstep:
        return jbatched.eval_method_on_sequence_group(
            "SYNH", eval_config(mode), "FireNet+", bundle, cfg, seqs,
            ["mse", "ssim"])
    return [jrunner.eval_method_on_sequence(
        "SYNH", eval_config(mode), "FireNet+", bundle, cfg, s,
        ["mse", "ssim"]) for s in seqs]


def out_dir(base, i, suffix=""):
    return base / "outputs/std/SYNH" / f"seq{i}" / f"FireNet+{suffix}"


# Score-row bound against the JAX package. Global equalization bins the
# float frames, so a frame value that moves by an ulp can cross a bin edge;
# on the CPU the port's batched convolutions round differently at batch N
# than at 1, and in lockstep that moves a few SSIM rows by up to 3e-5.
ROW_TOL = {"global": {False: 2e-5, True: 5e-5}}


@pytest.mark.parametrize("lockstep", [False, True],
                         ids=["single", "lockstep"])
@pytest.mark.parametrize("mode", MODES)
def test_histeq_eval_matches_jax(inputs, tmp_path, monkeypatch, mode,
                                 lockstep):
    seq_dirs, cfg = inputs
    tol = ROW_TOL.get(mode, {}).get(lockstep, 2e-5)
    monkeypatch.setattr(trunner, "DEFAULT_CHUNK_T", CHUNK_T)
    res = {"torch": run_port(tmp_path / "torch", mode, lockstep, seq_dirs,
                             cfg, monkeypatch),
           "jax": run_jax(tmp_path / "jax", mode, lockstep, seq_dirs, cfg,
                          monkeypatch)}
    for i, ((nj, sj), (nt, st)) in enumerate(zip(res["jax"], res["torch"])):
        assert nj == nt > 0 and sj.keys() == st.keys()
        for k in sj:
            assert abs(sj[k] - st[k]) <= tol, (i, k)
        a, b = out_dir(tmp_path / "jax", i), out_dir(tmp_path / "torch", i)
        for metric in ("mse", "ssim"):
            rj, rt = (np.loadtxt(d / f"{metric}.txt") for d in (a, b))
            np.testing.assert_array_equal(rj[:, 0], rt[:, 0])
            np.testing.assert_allclose(rt[:, 1], rj[:, 1], atol=tol)
        assert (a / "timestamps.txt").read_bytes() == \
            (b / "timestamps.txt").read_bytes()
        pj = sorted(out_dir(tmp_path / "jax", i, "_processed").glob("*.png"))
        pt = sorted(out_dir(tmp_path / "torch", i, "_processed").glob(
            "*.png"))
        assert pj and [p.name for p in pj] == [p.name for p in pt]
        for p, q in zip(pj, pt):
            want = cv2.imread(str(p), cv2.IMREAD_UNCHANGED).astype(int)
            got = decode_png_gray8(q.read_bytes()).astype(int)
            assert np.abs(got - want).max() <= 1, p.name


@pytest.mark.parametrize("mode", MODES)
def test_histeq_lockstep_equals_single(inputs, tmp_path, monkeypatch, mode):
    """Lockstep against single on the CPU, as the JAX package's
    ``tests/test_batched_eval.py:77`` holds its own: means within 1e-5,
    MSE rows, timestamps and frames byte for byte, processed frames
    present. CLAHE and local equalize uint8 frames, so there every file is
    byte-equal; global bins float frames (``ROW_TOL``): SSIM rows within
    1e-4 and processed frames within 1 grey level."""
    seq_dirs, cfg = inputs
    monkeypatch.setattr(trunner, "DEFAULT_CHUNK_T", CHUNK_T)
    single = run_port(tmp_path / "single", mode, False, seq_dirs, cfg,
                      monkeypatch)
    lock = run_port(tmp_path / "lock", mode, True, seq_dirs, cfg,
                    monkeypatch)
    for (n0, s0), (n1, s1) in zip(single, lock):
        assert n0 == n1 > 0 and s0.keys() == s1.keys()
        for k in s0:
            assert abs(s0[k] - s1[k]) < 1e-5, k
    exact = mode != "global"
    for i in range(2):
        for suffix, pattern in (("", "*.txt"), ("", "frame_*.png"),
                                ("_processed", "frame_*.png")):
            a = sorted(out_dir(tmp_path / "single", i, suffix).glob(pattern))
            b = sorted(out_dir(tmp_path / "lock", i, suffix).glob(pattern))
            assert a and [p.name for p in a] == [p.name for p in b]
            for p, q in zip(a, b):
                if exact or (suffix == "" and p.name != "ssim.txt"):
                    assert p.read_bytes() == q.read_bytes(), (i, p.name)
                elif p.suffix == ".txt":
                    np.testing.assert_allclose(np.loadtxt(q), np.loadtxt(p),
                                               atol=1e-4)
                else:
                    d = (decode_png_gray8(p.read_bytes()).astype(int)
                         - decode_png_gray8(q.read_bytes()))
                    assert np.abs(d).max() <= 1, (i, p.name)
