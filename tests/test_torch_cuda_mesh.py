"""The device mesh on the card (evreal_tpu_torch/parallel/mesh.py): a
lockstep group, a serve group and a training step sharded over a
``[cuda:0, cuda:0]`` mesh against the unsharded ones, and ``to_host``'s
events recorded on each tensor's own device. Where more than one card is
visible, the same over the real mesh of every card. These tests need an
NVIDIA GPU and skip without one; the file imports nothing of JAX, so on
the card they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mesh.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from evreal_tpu_torch import train
from evreal_tpu_torch.convert.params import flatten, from_jax_tree, \
    save_params
from evreal_tpu_torch.data import Sequence
from evreal_tpu_torch.harness import batched as tbatched
from evreal_tpu_torch.harness import runner as trunner
from evreal_tpu_torch.kernels import voxelize_cuda
from evreal_tpu_torch.models import build_model
from evreal_tpu_torch.models.init import init_e2vid
from evreal_tpu_torch.parallel import mesh as tmesh
from evreal_tpu_torch.serve import ReconEngine

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "tools"))
from make_synthetic_sequence import make_sequence  # noqa: E402

pytestmark = pytest.mark.cuda

H, W = 48, 64
TOL_LOCKSTEP = 1e-4   # f32 lockstep rows on the card (TF32 off)
TOL_LOSS = 1e-5       # relative
TOL_PARAM = 3e-4      # tests/test_train_parallel.py:69
TOL_GRAD = 1e-4       # the reduced gradient, x max|g| of the tensor
E2VID_KW = dict(num_bins=5, base_num_channels=8, kernel_size=3,
                num_encoders=2, recurrent_block_type="convlstm",
                num_residual_blocks=1, skip_type="sum", norm=None,
                use_upsample_conv=True, final_activation="sigmoid")
EVAL_CONFIG = {"name": "std", "save_images": True, "histeq": "none",
               "eval_infer_all": False, "ts_tol_ms": 1.0,
               "create_video": False}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda_mesh.py)")
    return torch.device("cuda", 0)


def meshes():
    """The one-card mesh that repeats cuda:0, and the real mesh of every
    card where there is more than one."""
    out = {"cuda0x2": tmesh.make_mesh(2, ("dp",), ["cuda:0", "cuda:0"])}
    if torch.cuda.device_count() > 1:
        out["cards"] = tmesh.make_mesh(axes=("dp",))
    return out


def tree():
    return init_e2vid(seed=0, base_num_channels=8, kernel_size=3,
                      num_encoders=2, num_residual_blocks=1)


@pytest.fixture
def group_inputs(tmp_path):
    dirs = []
    for i, (dur, epf) in enumerate([(0.9, 900), (1.3, 700), (1.1, 800)]):
        d = tmp_path / "data" / f"seq{i}"
        make_sequence(str(d), height=H, width=W, duration_s=dur, fps=20,
                      events_per_frame=epf, seed=40 + i)
        dirs.append(str(d))
    path = tmp_path / "E2VID.npz"
    save_params(path, flatten(tree()), {"class": "E2VIDRecurrent",
                                        "kwargs": E2VID_KW,
                                        "model_name": "E2VID"})
    cfg = {"model_name": "E2VID", "model_path": str(path),
           "event_tensor_normalization": True, "post_process_norm": "robust"}
    return dirs, cfg


def run_group(tmp_path, monkeypatch, label, dirs, cfg, mesh):
    monkeypatch.setattr(tbatched, "_EVAL_MESH", mesh)
    monkeypatch.setattr(trunner, "DEFAULT_CHUNK_T", 8)
    (tmp_path / label).mkdir()
    monkeypatch.chdir(tmp_path / label)
    seqs = [{"name": f"seq{i}",
             "dataset": Sequence(d, num_bins=5,
                                 voxel_method={"method": "between_frames"}),
             "start_time_s": 0.1, "end_time_s": 10.0}
            for i, d in enumerate(dirs)]
    return tbatched.eval_method_on_sequence_group(
        "SYN", EVAL_CONFIG, "E2VID",
        trunner.MethodBundle("E2VID", cfg, "cuda"), cfg, seqs,
        ["mse", "ssim"])


def test_sharded_group_matches_unsharded(cuda_device, group_inputs,
                                         tmp_path, monkeypatch):
    """3 sequences (padded to the mesh's dp): every row within the f32
    lockstep bound of the unsharded group's; each shard launches the
    voxelizer once a chunk."""
    dirs, cfg = group_inputs
    base = run_group(tmp_path, monkeypatch, "unsharded", dirs, cfg, None)
    for label, mesh in meshes().items():
        dp = mesh.shape["dp"]
        before = voxelize_cuda.launch_count()
        got = run_group(tmp_path, monkeypatch, label, dirs, cfg, mesh)
        windows = [len(Sequence(d)) for d in dirs]
        chunks = -(-max(windows) // 8)
        assert voxelize_cuda.launch_count() - before == chunks * dp
        for i, ((n0, s0), (n1, s1)) in enumerate(zip(base, got)):
            assert n0 == n1 > 0
            for k in s0:
                assert abs(s0[k] - s1[k]) <= TOL_LOCKSTEP, (label, i, k)
            for metric in ("mse", "ssim"):
                a, b = (np.loadtxt(tmp_path / k / "outputs/std/SYN" /
                                   f"seq{i}" / "E2VID" / f"{metric}.txt")
                        for k in ("unsharded", label))
                np.testing.assert_array_equal(a[:, 0], b[:, 0])
                np.testing.assert_allclose(b[:, 1], a[:, 1], rtol=0,
                                           atol=TOL_LOCKSTEP)


def test_sharded_serve_group_matches_unsharded(cuda_device, monkeypatch):
    """A 4-lane f32 group's frames, sharded and not, within the f32
    lockstep bound (the batch size may change cuDNN's algorithm)."""
    model = build_model("E2VIDRecurrent", E2VID_KW)
    model.load_state_dict(from_jax_tree(tree()))
    rng = np.random.default_rng(0)
    pushes = []
    for _ in range(3):
        lanes = []
        for _ in range(4):
            k = int(rng.integers(500, 2000))
            lanes.append((rng.integers(0, W, k).astype(np.int16),
                          rng.integers(0, H, k).astype(np.int16),
                          np.sort(rng.uniform(0, 0.05, k)),
                          rng.integers(0, 2, k).astype(np.uint8)))
        pushes.append(lanes)
    frames = {}
    for label, mesh in {"unsharded": None, **meshes()}.items():
        if mesh is not None and 4 % mesh.shape["dp"]:
            continue
        monkeypatch.setattr(tbatched, "_EVAL_MESH", mesh)
        engine = ReconEngine(model, num_bins=5, event_norm=True,
                             post_norm="robust", device="cuda")
        gid = engine.open_group(4, H, W)
        runner = engine._groups[gid].runner
        assert isinstance(runner, tbatched.ShardedRunner) == (mesh is not None)
        frames[label] = [engine.push_group(gid, p) for p in pushes]
    for label, got in frames.items():
        for a, b in zip(frames["unsharded"], got):
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL_LOCKSTEP,
                                       err_msg=label)


def test_sharded_training_step_matches_meshless(cuda_device):
    rng = np.random.default_rng(1)
    vox = torch.from_numpy(rng.normal(size=(4, 2, 5, 16, 32)).astype(
        np.float32)).cuda()
    frames = torch.from_numpy(rng.uniform(size=(4, 2, 16, 32)).astype(
        np.float32)).cuda()
    mask = torch.tensor([[1, 0], [0, 0], [1, 1], [1, 1]],
                        dtype=torch.float32, device="cuda")
    batch = {"voxels": vox, "frames": frames, "mask": mask}

    def step(mesh):
        model = build_model("E2VIDRecurrent", E2VID_KW)
        model.load_state_dict(from_jax_tree(tree()))
        model.cuda()
        fn, _ = train.make_train_step(model, train.build_optimizer(1e-3),
                                      mesh=mesh, remat=False)
        return float(fn(batch)), model, fn

    loss0, model0, _ = step(None)
    for label, mesh in meshes().items():
        if 4 % mesh.shape["dp"]:
            continue
        loss1, model1, fn = step(mesh)
        assert loss1 == pytest.approx(loss0, rel=TOL_LOSS), label
        for (k, a), b in zip(model0.state_dict().items(),
                             model1.state_dict().values()):
            assert (a - b).abs().max().item() <= TOL_PARAM, (label, k)
        # the first replica's reduced gradient (Adam is invariant to a
        # uniform scale of it, so the parameters cannot tell a sum from a
        # mean)
        for (k, a), b in zip(model0.named_parameters(), model1.parameters()):
            err = ((a.grad - b.grad).abs().max()
                   / a.grad.abs().max().clamp(min=1e-30))
            assert err.item() <= TOL_GRAD, (label, k, err.item())
        for r in fn.replicas[1:]:
            for a, b in zip(r.parameters(), model1.parameters()):
                assert torch.equal(a.to(b.device), b), label


def test_to_host_records_an_event_per_device(cuda_device):
    """Before the repair ``to_host`` recorded one event on the current
    device's stream: for tensors on another card its wait did not wait
    for their copies and the host read stale pinned memory."""
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    tensors = {}
    for i, d in enumerate(devices):
        # enough work on each card that a copy not waited for reads zeros
        with torch.cuda.device(d):
            x = torch.randn(2048, 2048, device=d)
            for _ in range(20):
                x = torch.tanh(x @ x / 2048)
            tensors[f"t{i}"] = x + 3.0
    host, events = trunner.to_host(tensors)
    assert isinstance(events, list) and len(events) == len(devices)
    got = trunner.from_host(host, events)
    for k, v in tensors.items():
        np.testing.assert_array_equal(got[k], v.cpu().numpy(), err_msg=k)
        assert got[k].min() > 1.0
    cpu_host, cpu_events = trunner.to_host({"c": torch.ones(3)})
    assert cpu_events == [] and trunner.from_host(
        cpu_host, cpu_events)["c"].tolist() == [1.0, 1.0, 1.0]
