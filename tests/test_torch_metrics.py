"""The port's metrics, score tracking and PNG writer against the JAX
package's (metrics/functional.py, metrics/tracker.py, harness/outputs.py)."""

import sys

import numpy as np
import pytest
import torch

from evreal_tpu.metrics.functional import mse as j_mse
from evreal_tpu.metrics.functional import ssim as j_ssim
from evreal_tpu_torch.harness.outputs import (
    decode_png_gray8,
    encode_png_gray8,
    save_inferred_image,
)
from evreal_tpu_torch.harness.runner import accumulate_mean_scores
from evreal_tpu_torch.metrics.functional import mse, ssim
from evreal_tpu_torch.metrics.registry import resolve
from evreal_tpu_torch.metrics.tracker import EvalMetricsTracker, MetricTracker

torch.set_num_threads(1)


def images(seed, n=3, h=40, w=56):
    rng = np.random.default_rng(seed)
    img = np.clip(rng.normal(0.5, 0.2, (n, h, w)), 0, 1).astype(np.float32)
    ref = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1)
    return img, ref.astype(np.float32)


@pytest.mark.parametrize("h,w", [(40, 56), (11, 13), (180, 240)])
def test_mse_ssim_match_jax(h, w):
    img, ref = images(0, h=h, w=w)
    got_mse = mse(torch.from_numpy(img), torch.from_numpy(ref)).numpy()
    got_ssim = ssim(torch.from_numpy(img), torch.from_numpy(ref)).numpy()
    for i in range(len(img)):
        assert abs(got_mse[i] - float(j_mse(img[i], ref[i]))) <= 1e-7
        assert abs(got_ssim[i] - float(j_ssim(img[i], ref[i]))) <= 2e-6


def test_ssim_identical_is_one_and_small_raises():
    img, _ = images(1)
    t = torch.from_numpy(img)
    np.testing.assert_allclose(ssim(t, t).numpy(), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="too small"):
        ssim(torch.zeros(1, 10, 40), torch.zeros(1, 10, 40))


def test_resolve_names_the_roadmap_for_unported_metrics(tmp_path,
                                                       monkeypatch, capsys):
    """As the JAX registry: a gated metric without its file and an unknown
    name are skipped with their lines, and the other names resolve."""
    monkeypatch.setenv("EVREAL_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    monkeypatch.setitem(sys.modules, "pyiqa", None)
    specs = resolve(["mse", "lpips", "ssim", "psnr"])
    assert [s.name for s in specs] == ["mse", "ssim"]
    assert specs[0].fn is mse and specs[1].fn is ssim
    assert capsys.readouterr().out == (
        "lpips weights unavailable (see tools/convert_lpips.py); skipping "
        "lpips\nUnknown metric psnr\n")


def test_png_writer_round_trip(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (37, 53)).astype(np.uint8)
    np.testing.assert_array_equal(decode_png_gray8(encode_png_gray8(img)), img)
    f = np.random.default_rng(3).uniform(0, 1, (9, 14)).astype(np.float32)
    save_inferred_image(str(tmp_path), f, 7)
    data = (tmp_path / "frame_0000000007.png").read_bytes()
    np.testing.assert_array_equal(decode_png_gray8(data),
                                  np.round(f * 255).astype(np.uint8))
    with pytest.raises(ValueError):
        encode_png_gray8(f)
    broken = bytearray(data)
    broken[20] ^= 1  # inside IHDR: the CRC check must catch it
    with pytest.raises(ValueError, match="CRC"):
        decode_png_gray8(bytes(broken))


def test_png_decodes_with_opencv(tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(4).integers(0, 256, (31, 45)).astype(np.uint8)
    save_inferred_image(str(tmp_path), img, 0)
    got = cv2.imread(str(tmp_path / "frame_0000000000.png"),
                     cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, img)


def test_tracker_formats_and_sentinel(tmp_path):
    out = tmp_path / "seq"
    tr = EvalMetricsTracker(str(out), ["mse", "ssim"],
                            quan_eval_start_time=0.1,
                            quan_eval_ts_tol_ms=1.0,
                            has_reference_frames=True)
    img = np.zeros((12, 12), np.uint8)
    tr.update(0, img, 0.05, 0.05, scores={"mse": 0.5, "ssim": 0.25})  # cut
    tr.update(1, img, 0.2, 0.2, scores={"mse": 0.123456, "ssim": np.nan})
    tr.update(2, img, 0.3, 0.31, scores={"mse": 9.0, "ssim": 9.0})  # tol
    tr.save_custom_metric(1, "event_rate", 12.5)
    tr.finalize()
    assert (out / "mse.txt").read_text() == "1 0.12346\n"
    assert (out / "ssim.txt").read_text() == ""
    assert (out / "timestamps.txt").read_text().splitlines()[1] == \
        "1 0.200000000000000"
    assert (out / "event_rate.txt").read_text() == "1 12.50000\n"
    assert sorted(p.name for p in out.glob("*.png")) == [
        f"frame_{i:010d}.png" for i in range(3)]
    assert tr.get_mean_scores() == {"mse": 0.123456, "ssim": -1}
    dataset = MetricTracker()
    accumulate_mean_scores(dataset, [(1, tr.get_mean_scores()),
                                     (3, {"mse": 0.5, "ssim": 0.5})])
    assert dataset.get_count("ssim") == 3
    assert dataset.get_average("ssim") == 0.5
    assert dataset.get_average("mse") == pytest.approx(
        (0.123456 + 3 * 0.5) / 4)
