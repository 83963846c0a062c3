"""The port's background PNG writer (``evreal_tpu_torch/harness/outputs.py:
AsyncImageWriter``) and its use by the tracker and the eval loops, held
against the JAX package's (``evreal_tpu/harness/outputs.py``,
``evreal_tpu/metrics/tracker.py``) on the CPU: every frame kind decodes to
the JAX writer's pixels and keeps the synchronous encoder's bytes; a
failed write raises ``OSError`` on a later ``submit`` and in ``close()``,
and leaves no ``done.json``; a queue of 128 frames that blocks when full;
no writer thread outlives ``finalize`` (or an error in the loop), and a
run that saves no frames starts none; a lockstep ``evaluate`` of several
chunks through writers of two frames gives the JAX package's tree (score
rows within 2e-5, PNGs within 1 grey level, text files byte-equal)."""

import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from evreal_tpu_torch.convert.params import flatten, save_params
from evreal_tpu_torch.data.synthetic import make_sequence
from evreal_tpu_torch.harness import outputs as toutputs
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.harness.histeq import histogram_equalization
from evreal_tpu_torch.harness.outputs import (
    AsyncImageWriter,
    decode_png,
    save_inferred_image,
)
from evreal_tpu_torch.metrics import tracker as ttracker
from evreal_tpu_torch.metrics.tracker import EvalMetricsTracker
from evreal_tpu_torch.models.init import init_firenet

torch.set_num_threads(1)

TOL_SCORE = 2e-5  # score rows, port vs JAX (tests/test_torch_batched.py)
HW = (20, 28)


def frame_kinds():
    """{kind: image} as the eval loops hand them to the tracker: a
    quantized grey frame, a clipped float frame, its hist-eq'd copy and
    a BGR colour frame."""
    rng = np.random.default_rng(3)
    flt = rng.uniform(0, 1, HW).astype(np.float32)
    return {"gray_u8": rng.integers(0, 256, HW).astype(np.uint8),
            "float": flt,
            "histeq_float": histogram_equalization(flt, "global"),
            "bgr_u8": rng.integers(0, 256, HW + (3,)).astype(np.uint8)}


def writer_threads():
    return [t for t in threading.enumerate()
            if t.name == AsyncImageWriter.THREAD_NAME]


def jax_writer_threads():
    from evreal_tpu.harness.outputs import AsyncImageWriter as JWriter

    return [t for t in threading.enumerate() if isinstance(
        getattr(getattr(t, "_target", None), "__self__", None), JWriter)]


@pytest.mark.parametrize("kind", sorted(frame_kinds()))
def test_frame_kinds_match_jax_writer(tmp_path, kind):
    cv2 = pytest.importorskip("cv2")
    from evreal_tpu.harness.outputs import AsyncImageWriter as JWriter

    image = frame_kinds()[kind]
    dirs = {k: tmp_path / k for k in ("jax", "torch", "sync")}
    for d in dirs.values():
        d.mkdir()
    for cls, key in ((JWriter, "jax"), (AsyncImageWriter, "torch")):
        w = cls()
        for idx in (0, 7):
            w.submit(str(dirs[key]), image, idx)
        w.close()
    for idx in (0, 7):
        save_inferred_image(str(dirs["sync"]), image, idx)
    for idx in (0, 7):
        name = f"frame_{idx:010d}.png"
        got = (dirs["torch"] / name).read_bytes()
        assert got == (dirs["sync"] / name).read_bytes()
        want = cv2.imread(str(dirs["jax"] / name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(decode_png(got), want)


def jax_writer():
    from evreal_tpu.harness.outputs import AsyncImageWriter as JWriter

    return JWriter()


WRITERS = {"jax": jax_writer, "torch": AsyncImageWriter}


@pytest.mark.parametrize("package", sorted(WRITERS))
def test_failed_write_raises_on_next_submit_and_close(tmp_path, package):
    """tests/test_harness_aux.py's two writer tests, for both writers: the
    error surfaces on a later ``submit`` and again in ``close()``, which
    does not hang."""
    w = WRITERS[package]()
    img = np.zeros((8, 8), np.uint8)
    missing = str(tmp_path / "missing_dir")
    w.submit(missing, img, 0)
    with pytest.raises(OSError, match="image write"):
        for idx in range(1, 51):  # the worker thread needs a beat
            time.sleep(0.05)
            w.submit(missing, img, idx)
    done = []

    def close():
        try:
            w.close()
        except OSError as e:
            done.append(str(e))

    closer = threading.Thread(target=close)
    closer.start()
    closer.join(10)
    assert not closer.is_alive(), "close() hangs"
    assert len(done) == 1 and "image write(s) failed; first error:" in done[0]


@pytest.mark.parametrize("package", sorted(WRITERS))
def test_full_queue_blocks_submit(tmp_path, monkeypatch, package):
    """The queue is bounded (128 frames by default): ``submit`` blocks
    while it is full and goes on once the worker takes a frame."""
    if package == "jax":
        from evreal_tpu.harness import outputs as module
    else:
        module = toutputs
    release, written = threading.Event(), []
    real = module.save_inferred_image

    def slow(folder, image, idx):
        release.wait(10)
        real(folder, image, idx)
        written.append(idx)

    monkeypatch.setattr(module, "save_inferred_image", slow)
    w = WRITERS[package]()
    assert w._q.maxsize == 128
    img = np.zeros((4, 4), np.uint8)
    for idx in range(129):  # one with the worker, 128 queued
        w.submit(str(tmp_path), img, idx)
    blocked = threading.Thread(target=w.submit, args=(str(tmp_path), img,
                                                      129))
    blocked.start()
    blocked.join(0.3)
    assert blocked.is_alive(), "submit did not block on a full queue"
    release.set()
    blocked.join(10)
    assert not blocked.is_alive()
    w.close()
    assert written == list(range(130))
    assert len(list(tmp_path.glob("frame_*.png"))) == 130


def make_tracker(package, out):
    """A tracker of ``package`` saving frames and hist-eq'd copies into
    ``out`` and ``out``_processed."""
    if package == "jax":
        from evreal_tpu.metrics.tracker import EvalMetricsTracker as JTracker

        return JTracker(save_images=True, save_processed_images=True,
                        output_dir=str(out), hist_eq="global",
                        quan_eval_metric_names=["mse"],
                        has_reference_frames=True)
    return EvalMetricsTracker(str(out), ["mse"], has_reference_frames=True,
                              hist_eq="global")


def update(package, tracker, idx, img):
    processed = histogram_equalization(img.astype(np.float32) / 255,
                                       "global")
    if package == "jax":
        tracker.update(idx, img, img, 0.1 * idx, 0.1 * idx,
                       scores={"mse": 0.5}, processed_img=processed)
    else:
        tracker.update(idx, img, 0.1 * idx, 0.1 * idx, scores={"mse": 0.5},
                       processed_img=processed)


def finalize(package, tracker):
    if package == "jax":
        tracker.finalize(0)
    else:
        tracker.finalize()


@pytest.mark.parametrize("package", sorted(WRITERS))
def test_failed_write_leaves_no_done_json(tmp_path, package):
    """A hist-eq'd copy that cannot be written (its folder is gone): the
    error reaches ``finalize``, after the text files are closed and before
    ``done.json``, and the writer thread is gone; the frames of the other
    folder are written."""
    out = tmp_path / "seq"
    tracker = make_tracker(package, out)
    os.rmdir(str(out) + "_processed")
    img = np.random.default_rng(0).integers(0, 256, HW).astype(np.uint8)
    update(package, tracker, 0, img)
    handles = list(tracker._files.values())
    assert handles
    with pytest.raises(OSError, match="image write"):
        finalize(package, tracker)
    assert not (out / "done.json").exists()
    assert all(f.closed for f in handles) and tracker._files == {}
    assert (out / "frame_0000000000.png").exists()
    assert (out / "timestamps.txt").read_text().startswith("0 0.0")
    assert tracker._image_writer is None
    assert not writer_threads() and not jax_writer_threads()


@pytest.mark.parametrize("package", sorted(WRITERS))
def test_no_writer_thread_outlives_finalize(tmp_path, package):
    before = set(threading.enumerate())
    tracker = make_tracker(package, tmp_path / "seq")
    assert getattr(tracker, "_image_writer", None) is None  # lazy
    img = np.zeros(HW, np.uint8)
    for idx in range(5):
        update(package, tracker, idx, img)
    assert len(set(threading.enumerate()) - before) == 1
    finalize(package, tracker)
    assert set(threading.enumerate()) - before == set()
    assert len(list((tmp_path / "seq").glob("frame_*.png"))) == 5
    assert len(list((tmp_path / "seq_processed").glob("frame_*.png"))) == 5
    assert json.loads((tmp_path / "seq" / "done.json").read_text())[
        "metrics"] == ["mse"]


@pytest.mark.parametrize("package", sorted(WRITERS))
def test_no_images_starts_no_writer(tmp_path, package):
    before = set(threading.enumerate())
    if package == "jax":
        from evreal_tpu.metrics.tracker import EvalMetricsTracker as JTracker

        tracker = JTracker(save_images=False, output_dir=str(tmp_path),
                           quan_eval_metric_names=["mse"],
                           has_reference_frames=True)
        for idx in range(3):
            tracker.update(idx, None, None, 0.1 * idx, 0.1 * idx,
                           scores={"mse": 0.5})
        assert set(threading.enumerate()) == before
        tracker.finalize(2)
    else:
        tracker = EvalMetricsTracker(str(tmp_path), ["mse"],
                                     save_images=False,
                                     has_reference_frames=True)
        for idx in range(3):
            tracker.update(idx, None, 0.1 * idx, 0.1 * idx,
                           scores={"mse": 0.5})
        assert set(threading.enumerate()) == before
        tracker.finalize()
    assert getattr(tracker, "_image_writer", None) is None
    assert set(threading.enumerate()) == before
    assert not list(tmp_path.glob("*.png"))
    assert (tmp_path / "done.json").exists()


def test_abandon_drops_queued_frames(tmp_path, monkeypatch):
    """``abandon`` joins the thread without writing what is still queued
    and raises no write error."""
    release = threading.Event()
    real = toutputs.save_inferred_image

    def slow(folder, image, idx):
        release.wait(10)
        real(folder, image, idx)

    monkeypatch.setattr(toutputs, "save_inferred_image", slow)
    w = AsyncImageWriter()
    img = np.zeros((4, 4), np.uint8)
    w.submit(str(tmp_path / "missing"), img, 0)  # fails when released
    for idx in range(1, 6):
        w.submit(str(tmp_path), img, idx)
    threading.Timer(0.2, release.set).start()
    w.abandon()
    assert not w._t.is_alive()
    assert not list(tmp_path.glob("frame_*.png"))


def test_many_writers_count_every_failure(tmp_path):
    """More writers than cores, the interpreter switching threads at
    every chance: each writer writes every good frame it took and counts
    every failed one, and a submit that sees an error reports at least
    one failure."""
    import sys

    n_writers, n_frames = 2 * os.cpu_count() + 2, 40
    img = np.zeros((4, 4), np.uint8)
    taken = [{"good": 0, "bad": 0} for _ in range(n_writers)]
    seen, errors = [], {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        writers = [AsyncImageWriter(maxsize=4) for _ in range(n_writers)]
        for k in range(n_writers):
            (tmp_path / f"w{k}").mkdir()
        for idx in range(n_frames):
            for k, w in enumerate(writers):
                kind = "bad" if idx % 7 == 3 else "good"
                folder = tmp_path / ("missing" if kind == "bad" else f"w{k}")
                try:
                    w.submit(str(folder), img, idx)
                except OSError as e:
                    seen.append(str(e))
                else:
                    taken[k][kind] += 1
        for k, w in enumerate(writers):
            try:
                w.close()
            except OSError as e:
                errors[k] = str(e)
    finally:
        sys.setswitchinterval(interval)
    assert seen and not any(e.startswith("0 ") for e in seen)
    for k, w in enumerate(writers):
        assert not w._t.is_alive()
        assert w._n_failed == taken[k]["bad"] > 0
        assert errors[k].startswith(f"{taken[k]['bad']} image write(s) "
                                    f"failed; first error:")
        assert len(list((tmp_path / f"w{k}").iterdir())) == taken[k]["good"]


# ---------------------------------------------------------------------------
# the eval loops
# ---------------------------------------------------------------------------

CHUNK_T = 4  # chunks of 4 windows: 5 and 7 chunks, above PIPELINE_DEPTH
EVAL_METHOD = ("FireNet+", {"class": "FireNet", "num_encoders": 0,
                            "kwargs": {"num_bins": 5, "base_num_channels": 8,
                                       "kernel_size": 3}},
               {"event_tensor_normalization": False,
                "post_process_norm": "none"})


def write_eval_inputs(root):
    """Two sequences of one resolution (one lockstep group), a narrow
    FireNet+ and the configs naming them."""
    for i, dur in enumerate((1.0, 1.4)):
        make_sequence(str(root / "data" / "SYNW" / f"seq{i}"), height=32,
                      width=40, duration_s=dur, fps=20, events_per_frame=500,
                      seed=40 + i)
    name, meta, flags = EVAL_METHOD
    path = root / "pretrained" / name / "model.npz"
    path.parent.mkdir(parents=True)
    save_params(path, flatten(init_firenet(seed=1, base_num_channels=8)),
                {**meta, "model_name": name})
    for group in ("method", "dataset"):
        (root / "config" / group).mkdir(parents=True)
    (root / "config" / "method" / f"{name}.json").write_text(json.dumps(
        {"model_name": name, "model_path": str(path), **flags}))
    (root / "config" / "dataset" / "SYNW.json").write_text(json.dumps(
        {"root_path": "data/SYNW", "sequences": {"seq0": {}, "seq1": {}}}))


def small_writer(monkeypatch):
    """Trackers' writers with a queue of two frames (backpressure on every
    chunk); returns the list of writers made."""
    made = []

    def make():
        w = AsyncImageWriter(maxsize=2)
        made.append(w)
        return w

    monkeypatch.setattr(ttracker, "AsyncImageWriter", make)
    return made


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """Output trees of a lockstep ``evaluate`` of both packages (chunks of
    4 windows, the port's writers holding two frames), and the writers
    the port made: {"jax": dir, "torch": dir, "writers": [...]}."""
    import evreal_tpu.utils
    from evreal_tpu.harness import batched as jbatched
    from evreal_tpu.harness import runner as jrunner
    from evreal_tpu.harness import staging
    from evreal_tpu_torch.harness import batched as tbatched

    root = tmp_path_factory.mktemp("writer_eval")
    write_eval_inputs(root)
    cwd = os.getcwd()
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(evreal_tpu.utils, "enable_compile_cache",
                       lambda: None)
            mp.setattr(staging, "_compute_seen", False)
            mp.setattr(staging, "_staged_bytes", 0)
            mp.setattr(jbatched, "_EVAL_MESH", None)
            mp.setattr(jrunner, "DEFAULT_CHUNK_T", CHUNK_T)
            mp.setattr(trunner, "DEFAULT_CHUNK_T", CHUNK_T)
            out["writers"] = small_writer(mp)
            out["groups"] = []
            real_group = tbatched.eval_method_on_sequence_group

            def group(*args, **kwargs):
                out["groups"].append(len(args[5]))
                return real_group(*args, **kwargs)

            mp.setattr(tbatched, "eval_method_on_sequence_group", group)
            before = set(threading.enumerate())
            for name, run in (
                    ("jax", lambda: jrunner.evaluate(
                        ["FireNet+"], ["std"], ["SYNW"], ["mse", "ssim"])),
                    ("torch", lambda: trunner.evaluate(
                        ["FireNet+"], ["std"], ["SYNW"], ["mse", "ssim"],
                        device="cpu"))):
                os.chdir(root)
                run()
                out[name] = root / f"outputs_{name}"
                (root / "outputs").rename(out[name])
                if name == "torch":
                    out["threads_after"] = [
                        t for t in set(threading.enumerate()) - before
                        if t.name == AsyncImageWriter.THREAD_NAME]
    finally:
        os.chdir(cwd)
    return out


def seq_out(base, i):
    return Path(base) / "std" / "SYNW" / f"seq{i}" / "FireNet+"


@pytest.mark.parametrize("seq", [0, 1])
def test_lockstep_evaluate_tree_matches_jax(eval_runs, seq):
    cv2 = pytest.importorskip("cv2")
    a, b = seq_out(eval_runs["jax"], seq), seq_out(eval_runs["torch"], seq)
    assert sorted(p.name for p in a.iterdir()) == \
        sorted(p.name for p in b.iterdir())
    for name in ("timestamps.txt", "event_rate.txt"):
        assert (a / name).read_bytes() == (b / name).read_bytes()
    for metric in ("mse", "ssim"):
        ra, rb = (np.loadtxt(d / f"{metric}.txt") for d in (a, b))
        np.testing.assert_array_equal(ra[:, 0], rb[:, 0])
        np.testing.assert_allclose(rb[:, 1], ra[:, 1], atol=TOL_SCORE)
    ja, jb = (json.loads((d / "done.json").read_text()) for d in (a, b))
    assert ja["num_evaluated"] == jb["num_evaluated"] > 0
    assert ja["metrics"] == jb["metrics"] == ["mse", "ssim"]
    frames = sorted(a.glob("frame_*.png"))
    n_windows = len((a / "timestamps.txt").read_text().splitlines())
    assert len(frames) == n_windows > 4 * CHUNK_T
    for p in frames:
        want = cv2.imread(str(p), cv2.IMREAD_UNCHANGED).astype(int)
        got = decode_png((b / p.name).read_bytes()).astype(int)
        assert np.abs(got - want).max() <= 1, p.name


def test_lockstep_evaluate_writers_closed(eval_runs):
    """One writer per lane, each of two frames, each joined by
    ``finalize``."""
    writers = eval_runs["writers"]
    assert eval_runs["groups"] == [2]  # both sequences in one group
    assert len(writers) == 2
    assert all(w._q.maxsize == 2 and not w._t.is_alive() for w in writers)
    assert eval_runs["threads_after"] == []


def test_host_frames_hold_their_tensor():
    """The frames the loops queue are numpy views of ``to_host``'s
    tensors: each view holds a tensor on the same storage, so the block
    stays allocated until the frame is dropped."""
    clipped = torch.rand(3, 5, 6)
    host, events = trunner.to_host({"images": trunner.quantize_u8(clipped)})
    frames = trunner.from_host(host, events)["images"]
    ptr = host["images"].untyped_storage().data_ptr()
    frame = frames[1]
    del host, frames
    base = frame
    while not isinstance(base, torch.Tensor):
        base = base.base
    assert base.untyped_storage().data_ptr() == ptr
    np.testing.assert_array_equal(
        frame, trunner.quantize_u8(clipped)[1].numpy())


@pytest.mark.parametrize("path", ["single", "lockstep"])
def test_loop_error_stops_writers(tmp_path, monkeypatch, path):
    """An error in the eval loop (here the third recorded window) stops
    every writer without writing its queued frames and leaves no
    ``done.json``."""
    from evreal_tpu_torch.data import Sequence
    from evreal_tpu_torch.harness import batched as tbatched

    write_eval_inputs(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trunner, "DEFAULT_CHUNK_T", CHUNK_T)
    calls = []
    real = trunner.record_window

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("loop error")
        return real(*args, **kwargs)

    monkeypatch.setattr(trunner, "record_window", failing)
    monkeypatch.setattr(tbatched, "record_window", failing)
    name, _, _ = EVAL_METHOD
    cfg = trunner.get_method_config(name)
    bundle = trunner.MethodBundle(name, cfg, "cpu")
    eval_config = {"name": "std", "save_images": True, "histeq": "none",
                   "eval_infer_all": False, "ts_tol_ms": 1.0,
                   "create_video": False}
    seqs = [{"name": f"seq{i}",
             "dataset": Sequence(str(tmp_path / "data" / "SYNW" / f"seq{i}"),
                                 num_bins=5),
             "start_time_s": 0.0, "end_time_s": 10.0} for i in range(2)]
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="loop error"):
        if path == "single":
            trunner.eval_method_on_sequence("SYNW", eval_config, name,
                                            bundle, cfg, seqs[0], ["mse"])
        else:
            tbatched.eval_method_on_sequence_group(
                "SYNW", eval_config, name, bundle, cfg, seqs, ["mse"])
    assert set(threading.enumerate()) - before == set()
    for i in range(2):
        assert not (tmp_path / "outputs/std/SYNW" / f"seq{i}" / name /
                    "done.json").exists()
