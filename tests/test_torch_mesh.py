"""The port's device mesh (evreal_tpu_torch/parallel/mesh.py) and the
sharded lockstep eval and serve groups, on the CPU: the factorization
against the JAX package's ``make_mesh``; a group sharded over a mesh of 8
CPU entries (the CPU is one torch device, so the entries repeat it)
against the port's unsharded run (``mse.txt`` byte-equal, means within
1e-5: tests/test_mesh_eval.py:39-47) and against the JAX package's run on
its 8-device CPU mesh (rows within 2e-5, PNGs within 1 grey level); a
ragged group whose padding lanes never reach the host; bf16 and a
mixed-reference LPIPS group sharded; ``EVREAL_MESH``; serve groups on a
2-entry mesh; and the repairs that a mesh needs (a runner never moves
the model it is given, ``DeviceTimer`` fences every device)."""

import io

import jax
import numpy as np
import pytest
import torch

from evreal_tpu.parallel.mesh import make_mesh as j_make_mesh
from evreal_tpu_torch.data import Sequence
from evreal_tpu_torch.harness import batched as tbatched
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.harness import timers
from evreal_tpu_torch.harness.outputs import decode_png_gray8
from evreal_tpu_torch.parallel import mesh as tmesh
from evreal_tpu_torch.serve import ReconEngine

from .test_torch_batched import (  # noqa: F401
    CHUNK_T,
    EVAL_CONFIG,
    chunk_t,
    inputs,
    make_sequence,
    sequences,
)

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
TOL_MEAN = 1e-5   # sharded vs unsharded means (tests/test_mesh_eval.py:44)
TOL_JAX = 2e-5    # the port's standing rows bound against the JAX package
BF16_MEAN, BF16_MAX = 0.02, 0.2  # tests/test_torch_bf16.py


def cpu_mesh(n):
    return tmesh.make_mesh(n, axes=("dp",), devices=["cpu"] * n)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [("dp",), ("dp", "sp"), ("dp", "sp", "tp")])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_factorization_matches_jax(n, axes):
    """tests/test_train_parallel.py:89-99's rule, for every count and axis
    tuple: the port's shape equals the JAX package's."""
    want = dict(j_make_mesh(n, axes, jax.devices("cpu")).shape)
    got = tmesh.make_mesh(n, axes, CPU8)
    assert got.shape == want
    assert got.axis_names == axes and got.size == n
    assert all(d == torch.device("cpu") for d in got.devices.flat)


def test_factorization_cases():
    """The cases tests/test_train_parallel.py:89-99 spells out."""
    def shape(n, axes):
        return tmesh.make_mesh(n, axes, CPU8).shape

    assert shape(8, ("dp", "sp", "tp")) == {"dp": 2, "sp": 2, "tp": 2}
    assert shape(4, ("dp", "sp")) == {"dp": 2, "sp": 2}
    assert shape(1, ("dp", "sp")) == {"dp": 1, "sp": 1}
    assert shape(2, ("dp", "sp", "tp")) == {"dp": 2, "sp": 1, "tp": 1}
    assert shape(4, ("dp", "sp", "tp")) == {"dp": 2, "sp": 2, "tp": 1}
    assert tmesh.make_mesh(16, ("dp", "sp", "tp"),
                           ["cpu"] * 16).shape == {"dp": 4, "sp": 2, "tp": 2}


def test_mesh_refuses_absent_devices():
    """A device named but absent raises; nothing narrows the mesh."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda:0 exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(2, ("dp",), ["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(ValueError, match="3 devices asked for, 2 given"):
        tmesh.make_mesh(3, ("dp",), ["cpu", "cpu"])
    with pytest.raises(ValueError, match="dp only"):
        tmesh.dp_devices(tmesh.make_mesh(4, ("dp", "sp"), ["cpu"] * 4))
    assert tmesh.dp_devices(tmesh.make_mesh(2, ("dp", "sp", "tp"),
                                            ["cpu"] * 2)) == \
        [torch.device("cpu")] * 2


def test_lane_helpers():
    assert [tmesh.pad_lanes(n, 4) for n in (1, 4, 5, 8)] == [4, 4, 8, 8]
    assert tmesh.pad_lanes(3, 2) == 4 and tmesh.pad_lanes(2, 1) == 2
    assert tmesh.lane_blocks(6, 3) == [slice(0, 2), slice(2, 4), slice(4, 6)]
    with pytest.raises(ValueError, match="do not split"):
        tmesh.lane_blocks(5, 2)
    a = np.arange(24).reshape(4, 6)
    parts = tmesh.split_lanes({"x": a, "t": torch.from_numpy(a)}, 2)
    assert all(np.shares_memory(p["x"], a) for p in parts)
    np.testing.assert_array_equal(parts[1]["x"], a[2:])
    assert torch.equal(parts[0]["t"], torch.from_numpy(a[:2]))
    assert [len(b) for b in tmesh.split_lanes(a, 4)] == [1, 1, 1, 1]


def small_model():
    from evreal_tpu_torch.convert.params import from_jax_tree
    from evreal_tpu_torch.models import build_model
    from evreal_tpu_torch.models.init import init_firenet

    model = build_model("FireNet", {"num_bins": 5, "base_num_channels": 8,
                                    "kernel_size": 3})
    model.load_state_dict(from_jax_tree(init_firenet(seed=1,
                                                     base_num_channels=8)))
    return model


def test_replicas_never_move_the_source():
    """``replica_on`` hands back the module itself where it already lies
    (eval and serve share it, through ``MethodBundle.model_for`` and the
    engine's cache), else a copy; ``copy_module`` always copies (the
    training step's replicas). The source stays where it was, unchanged."""
    model = small_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert tmesh.replica_on(model, "cpu") is model
    assert tmesh.replica_on(model, "cpu", torch.float32) is model
    own = [tmesh.copy_module(model, torch.device("cpu")) for _ in range(2)]
    assert own[0] is not own[1] and model not in own
    for r in own:
        for (k, v), (_, p) in zip(r.state_dict().items(),
                                  model.state_dict().items()):
            assert torch.equal(v, p) and v.data_ptr() != p.data_ptr(), k
    bf16 = tmesh.replica_on(model, "cpu", torch.bfloat16)
    assert bf16 is not model
    assert all(p.dtype == torch.bfloat16 for p in bf16.parameters())
    meta = tmesh.replica_on(model, "meta")
    assert all(p.is_meta for p in meta.parameters())
    for k, v in model.state_dict().items():
        assert v.device.type == "cpu" and v.dtype == torch.float32, k
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# the repairs a mesh needs
# ---------------------------------------------------------------------------

def test_runner_never_moves_the_model_it_is_given():
    """A runner on another device (or dtype) than its model's runs a
    replica: before the repair ``MethodRunner`` moved the model in place
    (``cast_model(model).to(device)``), so a second runner on another card
    pulled the first runner's weights away."""
    model = small_model()
    meta = trunner.MethodRunner(model, event_norm=False, post_norm="none",
                                height=16, width=24, num_bins=5,
                                device="meta")
    assert all(p.is_meta for p in meta.model.parameters())
    assert all(p.device.type == "cpu" for p in model.parameters())
    cpu = trunner.MethodRunner(model, event_norm=False, post_norm="none",
                               height=16, width=24, num_bins=5, device="cpu")
    assert cpu.model is model


def test_bundle_makes_one_replica_per_device_and_dtype(inputs, monkeypatch):
    cfg = inputs["method_configs"]["FireNet+"]
    bundle = trunner.MethodBundle("FireNet+", cfg, "cpu")
    assert bundle.model_for("cpu", torch.float32) is bundle.model
    monkeypatch.setenv("EVREAL_DTYPE", "bfloat16")
    sharded = bundle.batched_runner_for((48, 64), cfg, 5, 4, cpu_mesh(2))
    assert isinstance(sharded, tbatched.ShardedRunner)
    models = {id(r.model) for r, _ in sharded.parts()}
    assert models == {id(bundle.model_for("cpu", torch.bfloat16))}
    assert next(bundle.model.parameters()).dtype == torch.float32
    # the mesh is part of the runner's cache key
    assert bundle.batched_runner_for((48, 64), cfg, 5, 4, cpu_mesh(4)) \
        is not sharded
    assert bundle.batched_runner_for((48, 64), cfg, 5, 4, cpu_mesh(2)) \
        is sharded
    with pytest.raises(ValueError, match="do not split"):
        bundle.batched_runner_for((48, 64), cfg, 5, 3, cpu_mesh(2))


def test_device_timer_fences_every_device(monkeypatch):
    """Before the repair ``DeviceTimer`` fenced one device, so a mesh's
    ms/frame measured the first card only."""
    fenced = []
    monkeypatch.setattr(torch.cuda, "synchronize", fenced.append)
    log = timers.TimingLog()
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with timers.DeviceTimer(log, "m", 10, devices) as timer:
        timer.exclude_warmup(4)
    assert fenced == devices * 3
    assert log.samples["m"][0][1] == 6
    fenced.clear()
    with timers.DeviceTimer(log, "m", 1, "cpu"):
        pass
    assert fenced == []


def test_eval_mesh_switch(monkeypatch):
    """Automatic on ``("dp",)`` when more than one card is visible;
    ``EVREAL_MESH=0`` turns it off; made once per process."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tbatched, "_EVAL_MESH", "unset")
    monkeypatch.setenv("EVREAL_MESH", "0")
    assert tbatched.get_eval_mesh() is None
    monkeypatch.setattr(tbatched, "_EVAL_MESH", "unset")
    monkeypatch.delenv("EVREAL_MESH")
    mesh = tbatched.get_eval_mesh()
    assert mesh.shape == {"dp": 2}
    assert list(mesh.devices.flat) == [torch.device("cuda", 0),
                                       torch.device("cuda", 1)]
    assert tbatched.get_eval_mesh() is mesh
    monkeypatch.setattr(tbatched, "_EVAL_MESH", "unset")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tbatched.get_eval_mesh() is None


def test_cpu_runs_stay_on_the_cpu_beside_several_cards(inputs, tmp_path,
                                                       monkeypatch, chunk_t):
    """On a host with two cards the automatic eval mesh names them, and a
    CUDA run shards over it; a CPU evaluation and a CPU engine's group
    still run one plain ``BatchedRunner`` on the CPU (a CPU reference run
    beside the cards must not run on them)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tbatched, "_EVAL_MESH", "unset")
    cards = tbatched.get_eval_mesh()
    assert cards.shape == {"dp": 2}
    assert tbatched.eval_mesh_for("cuda") is cards
    assert tbatched.eval_mesh_for("cpu") is None
    cfg = inputs["method_configs"]["FireNet+"]
    bundle = trunner.MethodBundle("FireNet+", cfg, "cpu")
    made = []
    runner_for = bundle.batched_runner_for

    def spy(*args, **kwargs):
        made.append(runner_for(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(bundle, "batched_runner_for", spy)
    monkeypatch.chdir(tmp_path)
    res = tbatched.eval_method_on_sequence_group(
        "SYNS", EVAL_CONFIG, "FireNet+", bundle, cfg,
        sequences(Sequence, inputs["seq_dirs"]), ["mse"])
    assert [type(r) for r in made] == [tbatched.BatchedRunner]
    assert made[0].lanes == 2 and made[0].device.type == "cpu"
    assert all(n > 0 for n, _ in res)
    engine = ReconEngine(small_model(), num_bins=5, device="cpu")
    gid = engine.open_group(4, 32, 48)
    runner = engine._groups[gid].runner
    assert type(runner) is tbatched.BatchedRunner
    assert runner.device.type == "cpu"
    assert engine.push_group(gid, serve_windows(4, 1, (32, 48))[0]).shape \
        == (4, 32, 48)


def test_single_sequence_runs_without_the_mesh(inputs, tmp_path,
                                               monkeypatch, chunk_t):
    """One sequence is a group of one lane with no mesh: on a 2-entry mesh
    ``eval_method_on_sequence`` builds one plain one-lane
    ``BatchedRunner`` (no ``ShardedRunner``, no padding lane) and writes
    the rows it writes under ``EVREAL_MESH=0``."""
    cfg = inputs["method_configs"]["FireNet+"]
    made = []
    real_make = trunner.MethodBundle.batched_runner_for

    def record(self, *args):
        made.append(real_make(self, *args))
        return made[-1]

    monkeypatch.setattr(trunner.MethodBundle, "batched_runner_for", record)
    monkeypatch.setenv("EVREAL_MESH", "0")
    out = {}
    for label, mesh in (("unsharded", "unset"), ("sharded", cpu_mesh(2))):
        monkeypatch.setattr(tbatched, "_EVAL_MESH", mesh)
        d = tmp_path / label
        d.mkdir()
        monkeypatch.chdir(d)
        out[label] = trunner.eval_method_on_sequence(
            "SYNS", EVAL_CONFIG, "FireNet+",
            trunner.MethodBundle("FireNet+", cfg, "cpu"), cfg,
            sequences(Sequence, inputs["seq_dirs"])[0], ["mse", "ssim"])
    assert tbatched.get_eval_mesh() is not None
    assert [type(r) for r in made] == [tbatched.BatchedRunner] * 2
    assert [r.lanes for r in made] == [1, 1]
    assert out["sharded"] == out["unsharded"]
    assert_same_as_unsharded(tmp_path, [out["unsharded"]], [out["sharded"]],
                             "FireNet+", 1,
                             ("mse", "ssim", "timestamps", "event_rate"))


# ---------------------------------------------------------------------------
# sharded lockstep eval
# ---------------------------------------------------------------------------

def run_group(tmp_path, monkeypatch, label, cfg, seqs, mesh, metrics,
              method, eval_config=EVAL_CONFIG):
    monkeypatch.setattr(tbatched, "_EVAL_MESH", mesh)
    d = tmp_path / label
    d.mkdir()
    monkeypatch.chdir(d)
    return tbatched.eval_method_on_sequence_group(
        "SYNS", eval_config, method,
        trunner.MethodBundle(method, cfg, "cpu"), cfg, seqs, metrics)


def seq_dir(base, i, method):
    return base / "outputs/std/SYNS" / f"seq{i}" / method


def assert_same_as_unsharded(tmp_path, base, sharded, method, n,
                             metrics=("mse",)):
    for i, ((n0, s0), (n1, s1)) in enumerate(zip(base, sharded)):
        assert n0 == n1 > 0, i
        assert s0.keys() == s1.keys()
        for k in s0:
            assert abs(s0[k] - s1[k]) < TOL_MEAN, (i, k)
        for metric in metrics:
            assert (seq_dir(tmp_path / "unsharded", i, method) /
                    f"{metric}.txt").read_text() == \
                (seq_dir(tmp_path / "sharded", i, method) /
                 f"{metric}.txt").read_text(), (i, metric)
    assert len(base) == len(sharded) == n


@pytest.mark.parametrize("method", ["FireNet+", "E2VID"])
def test_sharded_group_matches_unsharded_and_jax(inputs, tmp_path,
                                                 monkeypatch, chunk_t,
                                                 method):
    """2 sequences of different lengths over a mesh of 8 CPU entries
    (padded to 8 lanes): against the port's unsharded run and against
    the JAX package's run on its 8-device CPU mesh."""
    from evreal_tpu.data import Sequence as JSequence
    from evreal_tpu.harness import batched as jbatched
    from evreal_tpu.harness import runner as jrunner
    from evreal_tpu.harness import staging

    cv2 = pytest.importorskip("cv2")
    cfg = inputs["method_configs"][method]
    metrics = ["mse", "ssim"]
    base = run_group(tmp_path, monkeypatch, "unsharded", cfg,
                     sequences(Sequence, inputs["seq_dirs"]), None, metrics,
                     method)
    sharded = run_group(tmp_path, monkeypatch, "sharded", cfg,
                        sequences(Sequence, inputs["seq_dirs"]),
                        cpu_mesh(8), metrics, method)
    assert_same_as_unsharded(tmp_path, base, sharded, method, 2,
                             ("mse", "ssim", "timestamps"))

    monkeypatch.setattr(jrunner, "DEFAULT_CHUNK_T", chunk_t)
    monkeypatch.setattr(jbatched, "_EVAL_MESH",
                        j_make_mesh(8, ("dp",), jax.devices("cpu")))
    monkeypatch.setattr(staging, "_compute_seen", False)
    monkeypatch.setattr(staging, "_staged_bytes", 0)
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jres = jbatched.eval_method_on_sequence_group(
        "SYNS", EVAL_CONFIG, method, jrunner.MethodBundle(method, cfg), cfg,
        sequences(JSequence, inputs["seq_dirs"]), metrics)
    for i, ((nj, sj), (nt, st)) in enumerate(zip(jres, sharded)):
        assert nj == nt > 0
        for k in sj:
            assert abs(sj[k] - st[k]) <= TOL_JAX, (i, k)
        jdir, tdir = (seq_dir(tmp_path / k, i, method)
                      for k in ("jax", "sharded"))
        for metric in metrics:
            a = np.loadtxt(jdir / f"{metric}.txt")
            b = np.loadtxt(tdir / f"{metric}.txt")
            np.testing.assert_array_equal(a[:, 0], b[:, 0])
            np.testing.assert_allclose(b[:, 1], a[:, 1], atol=TOL_JAX)
        frames = sorted(jdir.glob("frame_*.png"))
        assert len(frames) >= nj
        assert [p.name for p in frames] == \
            sorted(p.name for p in tdir.glob("frame_*.png"))
        for p in frames:
            want = cv2.imread(str(p), cv2.IMREAD_UNCHANGED).astype(int)
            got = decode_png_gray8((tdir / p.name).read_bytes())
            assert np.abs(got.astype(int) - want).max() <= 1


@pytest.fixture(scope="module")
def three_dirs(tmp_path_factory):
    """Three sequences of different lengths at 48 x 64."""
    root = tmp_path_factory.mktemp("three")
    dirs = []
    for i, (dur, epf) in enumerate([(0.7, 800), (1.1, 600), (0.9, 700)]):
        d = root / f"seq{i}"
        make_sequence(str(d), height=48, width=64, duration_s=dur, fps=20,
                      events_per_frame=epf, seed=50 + i)
        dirs.append(str(d))
    return dirs


def test_ragged_group_never_fetches_padding_lanes(inputs, three_dirs,
                                                  tmp_path, monkeypatch,
                                                  chunk_t):
    """3 lanes over dp = 2 run as 4: the padding lane voxelizes empty
    windows, its outputs never come to the host and reach no file; the
    real lanes match the unsharded run."""
    cfg = inputs["method_configs"]["FireNet+"]
    fetched = []
    real_to_host = tbatched.to_host

    def spy(tensors):
        fetched.append({k: tuple(v.shape) for k, v in tensors.items()})
        return real_to_host(tensors)

    base = run_group(tmp_path, monkeypatch, "unsharded", cfg,
                     sequences(Sequence, three_dirs), None, ["mse", "ssim"],
                     "FireNet+")
    monkeypatch.setattr(tbatched, "to_host", spy)
    bundle_runs = []
    real_make = trunner.MethodBundle.batched_runner_for

    def record(self, *args):
        runner = real_make(self, *args)
        bundle_runs.append(runner)
        return runner

    monkeypatch.setattr(trunner.MethodBundle, "batched_runner_for", record)
    sharded = run_group(tmp_path, monkeypatch, "sharded", cfg,
                        sequences(Sequence, three_dirs), cpu_mesh(2),
                        ["mse", "ssim"], "FireNet+")
    assert_same_as_unsharded(tmp_path, base, sharded, "FireNet+", 3,
                             ("mse", "ssim", "timestamps", "event_rate"))
    (runner,) = bundle_runs
    assert runner.lanes == 4
    assert [b for _, b in runner.parts()] == [slice(0, 2), slice(2, 4)]
    assert fetched
    for out in fetched:
        assert {k[0] for k in out} == {0, 1}
        for (part, _), shape in out.items():
            assert shape[0] == (2 if part == 0 else 1)
    outs = tmp_path / "sharded/outputs/std/SYNS"
    assert sorted(p.name for p in outs.iterdir()) == ["seq0", "seq1", "seq2"]
    for i in range(3):
        assert sorted(p.name for p in seq_dir(outs.parents[2], i,
                                              "FireNet+").iterdir()) == \
            sorted(p.name for p in seq_dir(tmp_path / "unsharded", i,
                                           "FireNet+").iterdir())


@pytest.mark.parametrize("layout", ["mesh", "equal"])
def test_padded_and_equal_groups_never_narrow(inputs, three_dirs, tmp_path,
                                              monkeypatch, chunk_t, layout):
    """A group over a mesh keeps its padded, dp-divisible lanes to the
    end: 3 lanes of different lengths over dp = 2 compute 4 lanes times
    the sum of the chunks' ``valid_t`` (the longest lane's windows), and
    none is dropped; nor is any lane of a group of equal lengths."""
    cfg = inputs["method_configs"]["FireNet+"]
    mesh, dirs, n_pad = ((cpu_mesh(2), three_dirs, 4) if layout == "mesh"
                         else (None, [three_dirs[1]] * 3, 3))
    monkeypatch.setattr(tbatched, "_EVAL_MESH", mesh)
    monkeypatch.chdir(tmp_path)
    log = timers.TimingLog()
    res = tbatched.eval_method_on_sequence_group(
        "SYNS", EVAL_CONFIG, "FireNet+",
        trunner.MethodBundle("FireNet+", cfg, "cpu"), cfg,
        sequences(Sequence, dirs), ["mse"], log)
    written = [len((seq_dir(tmp_path, i, "FireNet+") / "timestamps.txt")
                   .read_text().splitlines()) for i in range(3)]
    assert all(n > 0 for n, _ in res)
    assert len(set(written)) == (3 if layout == "mesh" else 1)
    ends = {(w - 1) // chunk_t for w in written}
    assert len(ends) == (2 if layout == "mesh" else 1)
    assert log.counts["lane_windows.real"] == sum(written)
    assert log.counts["lane_windows.computed"] == n_pad * max(written)
    assert log.counts["lockstep.narrowed"] == 0


def test_bf16_sharded_group_within_bf16_bounds(inputs, tmp_path,
                                               monkeypatch, chunk_t):
    """A bf16 group on compact4 sharded over 2 entries against the same
    group unsharded: raw frames within the bf16 bounds (they are equal
    but for the batch size's effect on the convolutions)."""
    monkeypatch.setenv("EVREAL_DTYPE", "bfloat16")
    monkeypatch.setenv("EVREAL_WIRE", "compact4")
    cfg = inputs["method_configs"]["E2VID"]
    res = {}
    for label, mesh in (("unsharded", None), ("sharded", cpu_mesh(2))):
        res[label] = run_group(tmp_path, monkeypatch, label, cfg,
                               sequences(Sequence, inputs["seq_dirs"]),
                               mesh, ["mse"], "E2VID")
    for i in range(2):
        frames = sorted(p.name for p in seq_dir(tmp_path / "unsharded", i,
                                                "E2VID").glob("frame_*.png"))
        assert frames
        a, b = (np.stack([decode_png_gray8(
            (seq_dir(tmp_path / k, i, "E2VID") / f).read_bytes())
            for f in frames]).astype(np.float32) / 255
            for k in ("unsharded", "sharded"))
        assert np.abs(a - b).mean() <= BF16_MEAN
        assert np.abs(a - b).max() <= BF16_MAX
        (n0, s0), (n1, s1) = res["unsharded"][i], res["sharded"][i]
        assert n0 == n1 and abs(s0["mse"] - s1["mse"]) <= BF16_MEAN


def test_mixed_reference_lpips_group_sharded(inputs, tmp_path, monkeypatch,
                                             chunk_t):
    """A group of two sequences with reference frames and one without,
    ``-qm mse ssim lpips``, over dp = 3 (a shard without references): the
    LPIPS weights resolve on each shard's device and every row matches
    the unsharded run."""
    import json

    from .test_torch_lpips import jax_layout_weights

    np.savez(tmp_path / "lpips.npz", **jax_layout_weights(5))
    monkeypatch.setenv("EVREAL_LPIPS_WEIGHTS", str(tmp_path / "lpips.npz"))
    d = tmp_path / "events_only"
    d.mkdir()
    rng = np.random.default_rng(7)
    n_ev = 6000
    np.save(d / "events_ts.npy", np.sort(rng.uniform(0.0, 1.0, n_ev)))
    np.save(d / "events_xy.npy", np.stack(
        [rng.integers(0, 64, n_ev), rng.integers(0, 48, n_ev)],
        1).astype(np.int16))
    np.save(d / "events_p.npy", rng.integers(0, 2, n_ev).astype(np.uint8))
    (d / "metadata.json").write_text(json.dumps(
        {"sensor_resolution": [48, 64]}))
    vm = {"method": "t_seconds", "t": 0.05, "sliding_window_t": 0}

    def group():
        return [{"name": f"seq{i}", "dataset": Sequence(p, num_bins=5,
                                                        voxel_method=dict(vm)),
                 "start_time_s": 0.0, "end_time_s": 10.0}
                for i, p in enumerate(inputs["seq_dirs"] + [str(d)])]

    cfg = inputs["method_configs"]["FireNet+"]
    config = dict(EVAL_CONFIG, ts_tol_ms=1e9)
    metrics = ["mse", "ssim", "lpips"]
    base = run_group(tmp_path, monkeypatch, "unsharded", cfg, group(), None,
                     metrics, "FireNet+", config)
    sharded = run_group(tmp_path, monkeypatch, "sharded", cfg, group(),
                        cpu_mesh(3), metrics, "FireNet+", config)
    assert [set(s) for _, s in base] == [set(metrics)] * 2 + [set()]
    assert_same_as_unsharded(tmp_path, base[:2], sharded[:2], "FireNet+", 2,
                             metrics)
    assert base[2] == sharded[2]


@pytest.mark.parametrize("mode", ["global", "clahe", "local"])
def test_histeq_group_sharded(inputs, tmp_path, monkeypatch, chunk_t, mode):
    """Hist-eq in a group sharded over 2 entries (the clipped frames of
    every shard come to the host, the equalized pairs are scored on the
    first shard's device) against the unsharded group, on the contract of
    tests/test_torch_histeq.py's lockstep test: means within 1e-5, MSE
    rows, timestamps and frames byte for byte; CLAHE and local byte-equal
    everywhere; global SSIM rows within 1e-4 and processed frames within
    1 grey level."""
    cfg = inputs["method_configs"]["FireNet+"]
    config = dict(EVAL_CONFIG, histeq=mode)
    res = {label: run_group(tmp_path, monkeypatch, label, cfg,
                            sequences(Sequence, inputs["seq_dirs"]), mesh,
                            ["mse", "ssim"], "FireNet+", config)
           for label, mesh in (("unsharded", None), ("sharded", cpu_mesh(2)))}
    for (n0, s0), (n1, s1) in zip(res["unsharded"], res["sharded"]):
        assert n0 == n1 > 0 and s0.keys() == s1.keys() == {"mse", "ssim"}
        for k in s0:
            assert abs(s0[k] - s1[k]) < TOL_MEAN, k
    for i in range(2):
        for suffix, pattern in (("", "*.txt"), ("", "frame_*.png"),
                                ("_processed", "frame_*.png")):
            a, b = (sorted((seq_dir(tmp_path / k, i, "FireNet+").parent /
                            f"FireNet+{suffix}").glob(pattern))
                    for k in ("unsharded", "sharded"))
            assert a and [p.name for p in a] == [p.name for p in b]
            for p, q in zip(a, b):
                if mode != "global" or (suffix == "" and
                                        p.name != "ssim.txt"):
                    assert p.read_bytes() == q.read_bytes(), (i, p.name)
                elif p.suffix == ".txt":
                    np.testing.assert_allclose(np.loadtxt(q), np.loadtxt(p),
                                               atol=1e-4)
                else:
                    d = (decode_png_gray8(p.read_bytes()).astype(int)
                         - decode_png_gray8(q.read_bytes()))
                    assert np.abs(d).max() <= 1, (i, p.name)


def test_resume_under_a_mesh(inputs, three_dirs, tmp_path, monkeypatch,
                             chunk_t, capsys):
    """``EVREAL_RESUME`` in a sharded group: finished lanes are skipped
    and the rest run as a smaller group (here one lane, which runs
    without the mesh); the rerun lane agrees with the first run on the
    sharded contract (its batch size changed): means within 1e-5, MSE rows,
    timestamps and event rates byte for byte, SSIM rows within 1e-5."""
    cfg = inputs["method_configs"]["FireNet+"]
    first = run_group(tmp_path, monkeypatch, "sharded", cfg,
                      sequences(Sequence, three_dirs), cpu_mesh(2),
                      ["mse", "ssim"], "FireNet+")
    lane = seq_dir(tmp_path / "sharded", 1, "FireNet+")
    rows = {p.name: p.read_bytes() for p in lane.glob("*.txt")}
    monkeypatch.setenv("EVREAL_RESUME", "1")
    capsys.readouterr()
    bundle = trunner.MethodBundle("FireNet+", cfg, "cpu")
    assert tbatched.eval_method_on_sequence_group(
        "SYNS", EVAL_CONFIG, "FireNet+", bundle, cfg,
        sequences(Sequence, three_dirs), ["mse", "ssim"]) == first
    assert capsys.readouterr().out.count("Skipping finished") == 3
    (lane / "done.json").unlink()
    again = tbatched.eval_method_on_sequence_group(
        "SYNS", EVAL_CONFIG, "FireNet+", bundle, cfg,
        sequences(Sequence, three_dirs), ["mse", "ssim"])
    assert capsys.readouterr().out.count("Skipping finished") == 2
    assert again[0] == first[0] and again[2] == first[2]
    (n0, s0), (n1, s1) = first[1], again[1]
    assert n0 == n1 > 0 and s0.keys() == s1.keys()
    assert all(abs(s0[k] - s1[k]) < TOL_MEAN for k in s0)
    now = {p.name: p.read_bytes() for p in lane.glob("*.txt")}
    assert now.keys() == rows.keys()
    for name in rows:
        if name == "ssim.txt":
            np.testing.assert_allclose(np.loadtxt(lane / name),
                                       np.loadtxt(io.BytesIO(rows[name])),
                                       rtol=0, atol=1e-5)
        else:
            assert now[name] == rows[name], name


# ---------------------------------------------------------------------------
# serve groups
# ---------------------------------------------------------------------------

def serve_windows(n_lanes, pushes, hw, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(pushes):
        lanes = []
        for _ in range(n_lanes):
            k = int(rng.integers(200, 900))
            ts = np.sort(rng.uniform(0.0, 0.05, k))
            lanes.append((rng.integers(0, hw[1], k).astype(np.int16),
                          rng.integers(0, hw[0], k).astype(np.int16), ts,
                          rng.integers(0, 2, k).astype(np.uint8)))
        out.append(lanes)
    return out


@pytest.mark.parametrize("u8", [False, True])
def test_serve_groups_shard_when_lanes_divide(monkeypatch, u8):
    """On a 2-entry mesh a 4-lane group shards and a 3-lane one does not;
    ``push_group`` frames match the unsharded engine's within 1e-5."""
    hw = (32, 48)
    model = small_model()
    frames = {}
    for label, mesh in (("unsharded", None), ("sharded", cpu_mesh(2))):
        monkeypatch.setattr(tbatched, "_EVAL_MESH", mesh)
        engine = ReconEngine(model, num_bins=5, device="cpu")
        g4 = engine.open_group(4, *hw)
        g3 = engine.open_group(3, *hw)
        runners = {n: engine._groups[g].runner for n, g in ((4, g4), (3, g3))}
        if mesh is None:
            assert all(isinstance(r, tbatched.BatchedRunner)
                       for r in runners.values())
        else:
            assert isinstance(runners[4], tbatched.ShardedRunner)
            assert [r.lanes for r, _ in runners[4].parts()] == [2, 2]
            assert isinstance(runners[3], tbatched.BatchedRunner)
        wins = serve_windows(4, 3, hw)
        frames[label] = [engine.push_group(g4, w, u8=u8) for w in wins] + \
            [engine.push_group(g3, w[:2] + [None], u8=u8) for w in wins]
        engine.reset_group(g4)
        frames[label].append(engine.push_group(g4, wins[0], u8=u8))
        assert engine.stats()["frames"] == 3 * 4 + 3 * 2 + 4
    assert all(p.device.type == "cpu" for p in model.parameters())
    for a, b in zip(frames["unsharded"], frames["sharded"]):
        assert a.shape == b.shape and a.dtype == b.dtype
        if u8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
