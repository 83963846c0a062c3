"""Videos in the port (``evreal_tpu_torch/harness/video.py``): a fake
``ffmpeg`` on PATH records its arguments and writes the output file, so
the fps, the name, the encoder settings and the frame source (a numbered
pattern for contiguous frames, a glob where ``keep_ratio`` leaves gaps) are
checked without an encoder; ``create_video`` runs single and in lockstep;
without ffmpeg, ``evaluate`` raises the named error before any work."""

import json
import os
import stat
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evreal_tpu_torch.convert.params import flatten, save_params
from evreal_tpu_torch.data import Sequence
from evreal_tpu_torch.harness import batched as tbatched
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.harness import video
from evreal_tpu_torch.harness.outputs import save_inferred_image
from evreal_tpu_torch.models.init import init_firenet

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

torch.set_num_threads(1)

FAKE_FFMPEG = """#!{python}
import json, sys
with open({log!r}, "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
if {fail}:
    sys.stderr.write("encoder exploded\\n")
    sys.exit(1)
with open(sys.argv[-1], "wb") as f:
    f.write(b"video")
"""


@pytest.fixture
def ffmpeg(tmp_path, monkeypatch):
    """A fake ffmpeg first on PATH; returns a function reading the argv
    lists it was called with."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "ffmpeg_calls.jsonl"

    def install(fail=False):
        exe = bin_dir / "ffmpeg"
        exe.write_text(FAKE_FFMPEG.format(python=sys.executable, log=str(log),
                                          fail=fail))
        exe.chmod(exe.stat().st_mode | stat.S_IXUSR)

    install()
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")

    def calls():
        if not log.exists():
            return []
        return [json.loads(line) for line in log.read_text().splitlines()]

    calls.install = install
    return calls


def recon_folder(root, indices, times):
    folder = root / "recon"
    folder.mkdir()
    with open(folder / "timestamps.txt", "w", encoding="utf-8") as f:
        for i, t in zip(indices, times):
            f.write(f"{i} {t:.15f}\n")
    for i in indices:
        save_inferred_image(str(folder), np.full((4, 6), i, np.uint8), i)
    return folder


def test_contiguous_frames_make_a_numbered_pattern(tmp_path, ffmpeg):
    folder = recon_folder(tmp_path, range(3, 28), np.arange(25) / 25 + 1.0)
    path = video.create_vid_from_recon_folder(str(folder))
    # 25 frames over 0.96 s: round(26.04) = 26 fps
    assert path == str(tmp_path / "recon_26Hz.mp4")
    assert Path(path).read_bytes() == b"video"
    (argv,) = ffmpeg()
    assert argv[argv.index("-framerate") + 1] == "26"
    assert argv[argv.index("-start_number") + 1] == "3"
    assert argv[argv.index("-i") + 1] == str(folder / "frame_%010d.png")
    assert argv[-7:] == ["-crf", "11", "-preset", "slow", "-pix_fmt",
                         "yuv420p", path]
    assert "-y" in argv


def test_gapped_frames_go_by_glob(tmp_path, ffmpeg):
    """``keep_ratio`` leaves gaps in the indices: every frame in index
    order (the names are zero-padded), at the fps of the timestamps."""
    idx = [0, 2, 5, 9, 10]
    folder = recon_folder(tmp_path, idx, [0.0, 0.1, 0.2, 0.3, 0.4])
    path = video.create_vid_from_recon_folder(str(folder))
    assert path == str(tmp_path / "recon_12Hz.mp4")  # round(5 / 0.4)
    (argv,) = ffmpeg()
    assert argv[argv.index("-pattern_type") + 1] == "glob"
    assert argv[argv.index("-i") + 1] == str(folder / "frame_*.png")
    assert "-start_number" not in argv


def test_old_video_replaced_and_empty_folder_skipped(tmp_path, ffmpeg):
    folder = recon_folder(tmp_path, [0, 1], [0.0, 0.5])
    old = tmp_path / "recon_4Hz.mp4"
    old.write_bytes(b"old")
    assert video.create_vid_from_recon_folder(str(folder)) == str(old)
    assert old.read_bytes() == b"video"
    for p in folder.glob("frame_*.png"):
        p.unlink()
    assert video.create_vid_from_recon_folder(str(folder)) is None
    assert not old.exists() and len(ffmpeg()) == 1
    # a zero duration falls back to 30 fps, as the reference does
    folder.joinpath("timestamps.txt").write_text("0 1.0\n")
    assert video.video_fps(str(folder)) == 30


def test_encoder_failure_raises(tmp_path, ffmpeg):
    ffmpeg.install(fail=True)
    folder = recon_folder(tmp_path, [0, 1], [0.0, 0.5])
    with pytest.raises(RuntimeError, match="encoder exploded"):
        video.create_vid_from_recon_folder(str(folder))


# ---------------------------------------------------------------------------
# create_video through evaluate and the lockstep runner
# ---------------------------------------------------------------------------

META = {"class": "FireNet", "num_encoders": 0,
        "kwargs": {"num_bins": 5, "base_num_channels": 8, "kernel_size": 3}}


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """Two short sequences, FireNet+ weights and configs in ``tmp_path``
    (the working directory)."""
    for i in range(2):
        make_sequence(str(tmp_path / "data" / "VID" / f"seq{i}"), height=24,
                      width=32, duration_s=0.5, fps=20, events_per_frame=400,
                      seed=70 + i)
    weights = tmp_path / "w" / "FireNet+.npz"
    weights.parent.mkdir()
    save_params(weights, flatten(init_firenet(seed=1, base_num_channels=8)),
                {**META, "model_name": "FireNet+"})
    configs = {
        "method": {"FireNet+": {"model_name": "FireNet+",
                                "model_path": str(weights),
                                "event_tensor_normalization": False,
                                "post_process_norm": "none"}},
        "dataset": {"VID": {"root_path": "data/VID",
                            "sequences": {"seq0": {}, "seq1": {}}}},
        "eval": {"vid": {"dataset_kwargs": {"num_bins": 5},
                         "save_images": True, "histeq": "clahe",
                         "eval_infer_all": False, "ts_tol_ms": 1.0,
                         "create_video": True}}}
    for group, named in configs.items():
        (tmp_path / "config" / group).mkdir(parents=True)
        for name, cfg in named.items():
            (tmp_path / "config" / group / f"{name}.json").write_text(
                json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("batched", ["1", "0"], ids=["lockstep", "single"])
def test_evaluate_makes_each_sequences_videos(workdir, ffmpeg, monkeypatch,
                                              batched):
    monkeypatch.setenv("EVREAL_BATCHED", batched)
    trunner.evaluate(["FireNet+"], ["vid"], ["VID"], ["mse"], device="cpu")
    for i in range(2):
        base = workdir / "outputs" / "vid" / "VID" / f"seq{i}"
        fps = video.video_fps(str(base / "FireNet+"))
        for name in ("FireNet+", "FireNet+_processed"):
            assert (base / f"{name}_{fps}Hz.mp4").read_bytes() == b"video"
    assert len(ffmpeg()) == 4


def test_group_runner_makes_videos(workdir, ffmpeg):
    cfg = json.loads((workdir / "config/method/FireNet+.json").read_text())
    seqs = [{"name": f"seq{i}",
             "dataset": Sequence(str(workdir / "data/VID" / f"seq{i}"),
                                 num_bins=5),
             "start_time_s": 0.0, "end_time_s": 10.0} for i in range(2)]
    eval_config = dict(json.loads((workdir / "config/eval/vid.json")
                                  .read_text()), name="vid", histeq="none")
    tbatched.eval_method_on_sequence_group(
        "VID", eval_config, "FireNet+",
        trunner.MethodBundle("FireNet+", cfg, "cpu"), cfg, seqs, ["mse"])
    made = sorted(p.name for p in (workdir / "outputs/vid/VID").rglob(
        "*.mp4"))
    assert len(made) == 2 and all(m.startswith("FireNet+_") for m in made)


def test_evaluate_without_ffmpeg_fails_before_any_work(workdir, monkeypatch):
    monkeypatch.setenv("PATH", str(workdir / "nothing_here"))
    built = []
    monkeypatch.setattr(trunner.MethodBundle, "__init__",
                        lambda *a, **k: built.append(a))
    with pytest.raises(RuntimeError, match="ffmpeg"):
        trunner.evaluate(["FireNet+"], ["vid"], ["VID"], ["mse"],
                         device="cpu")
    assert built == [] and not (workdir / "outputs").exists()
    with pytest.raises(RuntimeError, match="ffmpeg"):
        video.require_ffmpeg()
