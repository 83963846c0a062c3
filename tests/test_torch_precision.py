"""``EVREAL_PRECISION`` and ``EVREAL_PROFILE`` in the port, on the CPU.

``utils.matmul_precision_ctx`` parses the variable as the JAX package's
``evreal_tpu.harness.runner.matmul_precision_ctx`` does (the same accepted
values, the same error text), turns TF32 on for "high" and "default" only
inside the context and restores the flags after it (an exception's exit
and a nested context too), and is a ``nullcontext`` for bf16. A malformed
value surfaces in ``evaluate`` where the JAX package's does: f32 runs fail
the dataset in its containment, bf16 runs drop their metrics at runtime;
the printed lines and the output trees are the JAX package's.
``EVREAL_PROFILE=<dir>`` writes a Chrome trace of the whole run, a failed
one too; unset, no profiler runs."""

import contextlib
import io
import json
import os
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from evreal_tpu.harness.runner import matmul_precision_ctx as jax_ctx
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.utils import (
    CONV_SEARCH_LIMIT,
    allow_tf32,
    cudnn_benchmark,
    f32_parity,
    matmul_precision_ctx,
)

from .test_torch_native_packer import META

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

torch.set_num_threads(1)

VALUES = [None, "highest", "high", "default", "fastest", "", "HIGH",
          "tf32"]


def flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def restore_flags():
    saved = flags()
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def set_precision(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("EVREAL_PRECISION", raising=False)
    else:
        monkeypatch.setenv("EVREAL_PRECISION", value)


def outcome(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return "ok"


@pytest.mark.parametrize("value", VALUES)
def test_parse_and_error_match_jax(monkeypatch, value):
    set_precision(monkeypatch, value)
    got = outcome(lambda: matmul_precision_ctx(torch.float32))
    assert got == outcome(lambda: jax_ctx(jnp.float32))
    assert (got == "ok") == (value in (None, "highest", "high", "default"))
    # bf16 stages never read it, in either package
    assert isinstance(matmul_precision_ctx(torch.bfloat16),
                      contextlib.nullcontext)
    assert isinstance(jax_ctx(jnp.bfloat16), contextlib.nullcontext)


@pytest.mark.parametrize("value", [None, "highest", "high", "default"])
@pytest.mark.parametrize("before", [(True, False), (False, True)])
def test_tf32_only_inside_and_restored(monkeypatch, restore_flags, value,
                                       before):
    set_precision(monkeypatch, value)
    tf32 = value in ("high", "default")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = before
    with matmul_precision_ctx():
        assert flags() == (tf32, tf32)
        # a nested f32 stage under another setting restores the outer one's
        with monkeypatch.context() as mp:
            set_precision(mp, "highest" if tf32 else "high")
            with matmul_precision_ctx():
                assert flags() == (not tf32, not tf32)
        assert flags() == (tf32, tf32)
        with matmul_precision_ctx(torch.bfloat16):
            assert flags() == (tf32, tf32)
    assert flags() == before
    with pytest.raises(RuntimeError, match="inside"):
        with matmul_precision_ctx():
            raise RuntimeError("inside")
    assert flags() == before
    with f32_parity():
        assert flags() == (False, False)
    assert flags() == before


def test_model_stage_runs_under_the_knob(monkeypatch, restore_flags):
    """The runner's model stage reads the knob at each chunk: TF32 inside
    the model's forward under "high", off under "highest", the flags as
    they were after."""
    from evreal_tpu_torch.models import build_model

    model = build_model(META["class"], META["kwargs"])
    runner = trunner.MethodRunner(model, event_norm=True, post_norm="robust",
                                  height=24, width=32, num_bins=5,
                                  device="cpu", chunk_t=2)
    seen = []
    model = runner.model
    model.register_forward_hook(lambda *_: seen.append(flags()))
    before = flags()
    vox = torch.rand(2, 5, 24, 32)
    for value, want in (("high", (True, True)), ("highest", (False, False)),
                        ("default", (True, True))):
        monkeypatch.setenv("EVREAL_PRECISION", value)
        seen.clear()
        runner.reconstruct(runner.init_state(), vox)
        assert seen == [want, want]
        assert flags() == before


@pytest.fixture
def restore_cudnn():
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.benchmark_limit, cudnn.deterministic)
    yield
    cudnn.benchmark, cudnn.benchmark_limit, cudnn.deterministic = saved


def search():
    return (torch.backends.cudnn.benchmark,
            torch.backends.cudnn.benchmark_limit)


@pytest.mark.parametrize("before", [(False, 10), (True, 0)])
def test_cudnn_benchmark_only_inside_and_restored(restore_flags,
                                                  restore_cudnn, before):
    """``cudnn_benchmark`` turns cuDNN's benchmark mode on inside, with
    ``CONV_SEARCH_LIMIT`` candidates, and restores both on exit, an
    exception's exit and a nested context's too; the TF32 flags stay as
    they were, on or off."""
    cudnn = torch.backends.cudnn
    cudnn.benchmark, cudnn.benchmark_limit = before
    inside = (True, CONV_SEARCH_LIMIT)
    for tf32 in (False, True):
        with allow_tf32(tf32):
            with cudnn_benchmark():
                assert search() == inside and flags() == (tf32, tf32)
                with cudnn_benchmark():
                    assert search() == inside
                assert search() == inside and flags() == (tf32, tf32)
            assert search() == before and flags() == (tf32, tf32)
    with pytest.raises(RuntimeError, match="inside"):
        with cudnn_benchmark():
            raise RuntimeError("inside")
    assert search() == before


def test_training_keeps_deterministic_cudnn_without_search(restore_cudnn):
    """``train.training_precision`` runs deterministic cuDNN with no
    search, inside an eval's ``cudnn_benchmark`` too, and gives the outer
    settings back."""
    from evreal_tpu_torch import train

    cudnn = torch.backends.cudnn
    cudnn.benchmark, cudnn.deterministic = False, False
    with train.training_precision():
        assert cudnn.deterministic and not cudnn.benchmark
    with cudnn_benchmark():
        with train.training_precision():
            assert cudnn.deterministic and not cudnn.benchmark
        assert cudnn.benchmark and not cudnn.deterministic
    assert (cudnn.benchmark, cudnn.deterministic) == (False, False)


def test_model_stage_searches_conv_algorithms(restore_cudnn):
    """The runner's model stage runs its steps in cuDNN's benchmark mode,
    the metrics outside it, and leaves the flag as it was."""
    from evreal_tpu_torch.models import build_model

    model = build_model(META["class"], META["kwargs"])
    runner = trunner.MethodRunner(model, event_norm=True, post_norm="robust",
                                  height=24, width=32, num_bins=5,
                                  device="cpu", chunk_t=2)
    seen = []
    runner.model.register_forward_hook(
        lambda *_: seen.append(torch.backends.cudnn.benchmark))
    torch.backends.cudnn.benchmark = False
    imgs = runner.reconstruct(runner.init_state(), torch.rand(2, 5, 24,
                                                               32))[1]
    assert seen == [True, True]
    assert not torch.backends.cudnn.benchmark

    def score(frames):
        seen.append(torch.backends.cudnn.benchmark)
        return frames.mean((-2, -1))

    probe = types.SimpleNamespace(name="probe", no_ref=True, host=False,
                                  serial=False, score=score)
    runner.metric_scores([probe], runner.post(imgs)[1])
    assert seen == [True, True, False]


# ---------------------------------------------------------------------------
# evaluate with a malformed value, against the JAX package
# ---------------------------------------------------------------------------

ARGS = ["-m", "E2VID", "-c", "std", "-d", "SYN", "-qm", "mse", "ssim"]


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    from evreal_tpu_torch.convert.params import flatten, save_params
    from evreal_tpu_torch.models.init import init_e2vid

    root = tmp_path_factory.mktemp("precision_eval")
    for i, (dur, epf) in enumerate([(0.9, 500), (0.7, 400)]):
        make_sequence(str(root / "data" / "SYN" / f"seq{i}"), height=32,
                      width=40, duration_s=dur, fps=20, events_per_frame=epf,
                      seed=11 + i)
    for group in ("method", "dataset"):
        (root / "config" / group).mkdir(parents=True)
    path = root / "pretrained" / "E2VID" / "model.npz"
    path.parent.mkdir(parents=True)
    save_params(path, flatten(init_e2vid(
        seed=0, base_num_channels=8, kernel_size=3, num_encoders=2,
        num_residual_blocks=1)), {**META, "model_name": "E2VID"})
    (root / "config" / "method" / "E2VID.json").write_text(json.dumps(
        {"model_name": "E2VID", "model_path": str(path.relative_to(root)),
         "event_tensor_normalization": True,
         "post_process_norm": "robust"}))
    (root / "config" / "dataset" / "SYN.json").write_text(json.dumps(
        {"root_path": "data/SYN", "sequences": {"seq0": {}, "seq1": {}}}))
    return root


def run_both(root, monkeypatch, tag):
    """{pkg: (stdout, output dir)} of the JAX and the port's CLI."""
    import evreal_tpu.utils
    from evreal_tpu.cli import eval_main
    from evreal_tpu.harness import staging

    from evreal_tpu_torch.cli import main as torch_main

    monkeypatch.setattr(evreal_tpu.utils, "enable_compile_cache",
                        lambda: None)
    monkeypatch.setattr(staging, "_compute_seen", False)
    monkeypatch.setattr(staging, "_staged_bytes", 0)
    monkeypatch.chdir(root)
    out = {}
    for pkg, run in (("jax", lambda: eval_main(ARGS)),
                     ("torch", lambda: torch_main(ARGS + ["--device",
                                                          "cpu"]))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        dst = root / f"out_{tag}_{pkg}"
        (root / "outputs").rename(dst)
        out[pkg] = buf.getvalue(), dst
    return out


def containment_lines(stdout):
    return [line for line in stdout.splitlines()
            if "Exception while evaluating" in line
            or "failed at runtime" in line
            or line.strip("\x1b[0123456789;m").startswith("EVREAL_PRECISION")]


def tree_without_frames(base):
    """{path: bytes} of the tree's files, PNG frames by name only."""
    return {str(p.relative_to(base)): (b"" if p.suffix == ".png"
                                       else p.read_bytes())
            for p in sorted(base.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", ["0", "1"])
def test_fastest_contained_as_jax(eval_root, monkeypatch, dtype, batched):
    monkeypatch.setenv("EVREAL_PRECISION", "fastest")
    monkeypatch.setenv("EVREAL_DTYPE", dtype)
    monkeypatch.setenv("EVREAL_BATCHED", batched)
    got = run_both(eval_root, monkeypatch, f"{dtype}_{batched}")
    lines = {pkg: containment_lines(stdout)
             for pkg, (stdout, _) in got.items()}
    assert lines["torch"] == lines["jax"]
    msg = "EVREAL_PRECISION='fastest': expected highest|high|default"
    if dtype == "float32":  # the model stage: the dataset fails
        assert "Exception while evaluating method E2VID on SYN dataset:" \
            in lines["jax"][0] and msg in lines["jax"][1]
    else:  # the metric stage: each metric dropped, frames written
        scope = "sequence" if batched == "0" else "group"
        assert lines["jax"][0] == (f"Metric mse failed at runtime; dropping "
                                   f"it for the rest of this {scope} "
                                   f"({msg})")
    trees = {pkg: tree_without_frames(d) for pkg, (_, d) in got.items()}
    assert trees["torch"] == trees["jax"]
    assert any(p.endswith(".png") for p in trees["jax"]) == \
        (dtype == "bfloat16")


# ---------------------------------------------------------------------------
# EVREAL_PROFILE
# ---------------------------------------------------------------------------

def traces(base):
    return sorted(Path(base).rglob("*.pt.trace.json"))


def test_profile_writes_a_trace_of_the_run(eval_root, monkeypatch,
                                           tmp_path):
    monkeypatch.chdir(eval_root)
    monkeypatch.setenv("EVREAL_PROFILE", str(tmp_path / "prof" / "run"))
    trunner.evaluate(["E2VID"], ["std"], ["SYN"], ["mse"], device="cpu")
    (path,) = traces(tmp_path / "prof" / "run")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert len(events) > 100 and "aten::conv2d" in names


def test_profile_written_when_evaluate_raises(eval_root, monkeypatch,
                                              tmp_path):
    monkeypatch.chdir(eval_root)
    monkeypatch.setenv("EVREAL_PROFILE", str(tmp_path / "p"))
    monkeypatch.setenv("EVREAL_WIRE", "f64")
    with pytest.raises(ValueError, match="EVREAL_WIRE"):
        trunner.evaluate(["E2VID"], ["std"], ["SYN"], ["mse"], device="cpu")
    (path,) = traces(tmp_path / "p")
    assert json.loads(path.read_text())["traceEvents"]


def test_no_profiler_when_unset(eval_root, monkeypatch):
    monkeypatch.chdir(eval_root)
    monkeypatch.delenv("EVREAL_PROFILE", raising=False)
    assert isinstance(trunner.profile_ctx(torch.device("cpu")),
                      contextlib.nullcontext)
    monkeypatch.setenv("EVREAL_PROFILE", "")
    assert isinstance(trunner.profile_ctx(torch.device("cpu")),
                      contextlib.nullcontext)

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler was made")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    before = set(os.listdir(eval_root))
    trunner.evaluate(["E2VID"], ["std"], ["SYN"], ["mse"], device="cpu")
    assert not traces(eval_root)
    assert set(os.listdir(eval_root)) - before <= {"outputs"}
