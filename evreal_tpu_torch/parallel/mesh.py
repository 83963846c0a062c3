"""Device meshes for data-parallel execution (``evreal_tpu/parallel/mesh.py``).

The workload's free parallel axis is the batch: the sequences of a
lockstep group, the lanes of a serve group, the samples of a training
batch. The JAX package runs one process that spans every device through
GSPMD; the port does the same with one host thread as the only
controller. Each device of the mesh holds its own model replica and its
own contiguous block of lanes, and the host enqueues every shard's work
in turn (PyTorch's launches are asynchronous, so the cards run together).
Gradients cross cards through NCCL outside any kernel
(``torch.cuda.comm``, ``train.py``).

A ``Mesh`` is the devices in the mesh's shape (a numpy object array of
``torch.device``) with its axis names. ``make_mesh`` factors a device list
over the axes by the JAX package's rule, so the shapes agree. The port
shards over ``dp`` alone (``dp_devices``): GSPMD's width sharding with halo
exchange (``sp``) and output-channel sharding (``tp``) buy nothing at
180 x 240 and would need hand-written collectives, so a mesh whose other
axes are wider than 1 raises where the port would have to run them.

A mesh may name one device more than once: each entry is still a shard
of its own. That is how the CPU tests (the CPU is one torch device) and a
one-card machine exercise the split, the per-shard dispatch, the gather
and the gradient reduction.
"""

import copy

import numpy as np
import torch


def canonical_device(device):
    """``torch.device`` with its index filled in (``cuda`` -> the current
    card), so that two names of one device compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _check_present(device):
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {device}: no CUDA device is "
                               f"available")
        device = canonical_device(device)
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh device {device}: only "
                               f"{torch.cuda.device_count()} CUDA device(s) "
                               f"are visible")
    return device


class Mesh:
    """Devices laid out over named axes (JAX's ``Mesh``): ``devices`` a
    numpy object array of ``torch.device`` in the mesh's shape,
    ``axis_names`` one name per dimension, ``shape`` {name: extent}."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def key(self):
        """A hashable identity: the axis names, the shape and the devices."""
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices=None, axes=("dp", "sp"), devices=None):
    """A ``Mesh`` over the first ``n_devices`` of ``devices`` (default:
    every visible card, ``cuda:0 .. device_count - 1``) with the axis names
    ``axes``. The dp axis takes the largest factor; each further axis gets
    one factor of 2 while dp keeps at least an equal share: 2 devices ->
    (2, 1, 1), 4 -> (2, 2, 1), 8 -> (2, 2, 2), 16 -> (4, 2, 2). A device
    named but absent raises; so does asking for more devices than given."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "pass devices= to build a mesh of others")
    devices = [_check_present(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(devices)} given")
        devices = devices[:n_devices]
    n = len(devices)
    if len(axes) == 1:
        shape = (n,)
    else:
        shape = [1] * len(axes)
        m = n
        for i in range(1, len(axes)):
            if m % 2 == 0 and m // 2 >= 2:
                shape[i] = 2
                m //= 2
        shape[0] = m
        shape = tuple(shape)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)


def dp_devices(mesh):
    """The mesh's devices along ``dp``, one per shard. The port runs dp
    only: a mesh whose other axes are wider than 1 raises."""
    wide = {k: v for k, v in mesh.shape.items() if k != "dp" and v > 1}
    if wide:
        raise ValueError(f"the port shards over dp only; mesh axes {wide} "
                         f"are wider than 1")
    return list(mesh.devices.reshape(-1))


# ---------------------------------------------------------------------------
# lanes
# ---------------------------------------------------------------------------

def pad_lanes(n, dp):
    """``n`` lanes rounded up to a multiple of ``dp``."""
    return -(-n // dp) * dp


def lane_blocks(n, dp):
    """``dp`` contiguous slices of ``n`` lanes (``n % dp == 0``), one per
    shard, in lane order."""
    if n % dp:
        raise ValueError(f"{n} lanes do not split over dp = {dp}")
    per = n // dp
    return [slice(i * per, (i + 1) * per) for i in range(dp)]


def split_lanes(batch, dp):
    """A host or device batch (an array or tensor, or a dict of them, lanes
    on the leading axis) in ``dp`` contiguous blocks: views, no copy."""
    if isinstance(batch, dict):
        n = len(next(iter(batch.values())))
        return [{k: v[s] for k, v in batch.items()}
                for s in lane_blocks(n, dp)]
    return [batch[s] for s in lane_blocks(len(batch), dp)]


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------

def copy_module(module, device, dtype=None):
    """A deep copy of ``module`` whose parameters and buffers are made
    directly on ``device`` (floating ones in ``dtype`` when given), with
    the same strides; the source is neither moved nor copied to its own
    device first. On the ``meta`` device the copy holds no data."""
    def moved(t):
        dt = dtype if dtype is not None and t.is_floating_point() else t.dtype
        if torch.device(device).type == "meta":
            return torch.empty_like(t, device="meta", dtype=dt)
        return t.detach().to(device=device, dtype=dt, copy=True)

    memo = {}
    for t in module.parameters():
        memo[id(t)] = torch.nn.Parameter(moved(t),
                                         requires_grad=t.requires_grad)
    for t in module.buffers():
        memo[id(t)] = moved(t)
    return copy.deepcopy(module, memo)


def replica_on(module, device, dtype=None):
    """``module`` itself when each of its floating parameters and buffers
    already lies on ``device`` (and is ``dtype``, when given); else a copy
    there (``copy_module``). The source is never moved."""
    device = canonical_device(device)
    tensors = [t for t in (*module.parameters(), *module.buffers())
               if t.is_floating_point()]
    if all(t.device == device and (dtype is None or t.dtype == dtype)
           for t in tensors):
        return module
    return copy_module(module, device, dtype)

