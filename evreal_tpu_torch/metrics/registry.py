"""Metric registry (``evreal_tpu/metrics/registry.py``; the reference's
pyiqa factory, utils/eval_metrics.py:100-159): any registered name is
usable through ``-qm <name>``.

A metric scores a batch of 2-D frames in [0, 1]:

    full-reference:  fn(imgs, refs) -> (N,)    imgs, refs (N, H, W)
    no-reference:    fn(imgs) -> (N,)          (no_ref=True)

as f32 tensors on the runner's device, or as numpy arrays on the host
(``host=True``: the runner copies a chunk's frames to the host once for all
such metrics). ``serial=True`` hands the fn one frame at a time (N = 1),
which bounds the peak memory of a heavy metric (MANIQA's 20-crop ViT-B/8).
``params`` is a zero-arg callable returning {name: numpy array or number};
the fn then takes the weights first, ``fn(params, imgs[, refs])``, as
tensors on the runner's device, moved there once per process
(``MetricSpec.loaded``). Register with::

    from evreal_tpu_torch.metrics.registry import register
    register("mymetric", my_fn, no_ref=False)

Built-ins: mse and ssim; lpips, niqe, brisque and maniqa when their files
exist, each path read at resolve time from its environment variable, else
``weights/``. Any other name goes to the pyiqa bridge when pyiqa imports.
"""

import dataclasses
import importlib
import os

import numpy as np
import torch


@dataclasses.dataclass(eq=False)
class MetricSpec:
    name: str
    fn: object
    no_ref: bool = False
    serial: bool = False
    params: object = None
    host: bool = False
    _loaded: dict = dataclasses.field(default_factory=dict, repr=False)

    def loaded(self, device):
        """The weights as tensors on ``device``, loaded once per process
        and device (numbers stay Python numbers)."""
        key = str(torch.device(device))
        if key not in self._loaded:
            self._loaded[key] = {
                k: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    if isinstance(v, np.ndarray) else v)
                for k, v in self.params().items()}
        return self._loaded[key]

    def score(self, *frames):
        """``fn`` on (N, H, W) frames [and references] -> (N,), with the
        weights bound."""
        if self.params is None:
            return self.fn(*frames)
        return self.fn(self.loaded(frames[0].device), *frames)


_REGISTRY = {}
# weight-gated built-ins: name -> module with params_path() / make_spec(path)
_GATED = {name: f"evreal_tpu_torch.metrics.{name}"
          for name in ("lpips", "maniqa", "niqe", "brisque")}
_GATED_SPECS = {}  # (name, path, mtime) -> spec, so weights load once


def register(name, fn, no_ref=False, serial=False, params=None, host=False):
    _REGISTRY[name.lower()] = MetricSpec(name.lower(), fn, no_ref, serial,
                                         params, host)


def make_host_nr_metric(name, score_fn, min_side=None):
    """A host no-reference metric over (N, H, W) numpy frames from a
    one-frame ``score_fn`` (niqe, brisque). A frame that fails scores NaN,
    which the tracker drops (reference eval_metrics.py:51), with one
    message per metric: a ragged tail or an all-NaN frame must not cost the
    metric the whole sequence. ``min_side`` turns a systematic failure
    (every frame too small for the metric's patch) into an error raised
    before any frame is scored, which the runner's validation reports."""
    warned = []

    def fn(imgs):
        if min_side is not None and min(imgs.shape[-2:]) < min_side:
            raise ValueError(
                f"{name} needs frames >= {min_side} px per side, got "
                f"{tuple(imgs.shape[-2:])} — every frame of this sequence "
                f"would fail")
        out = np.empty(len(imgs), np.float32)
        for i, im in enumerate(imgs):
            try:
                out[i] = np.float32(score_fn(np.asarray(im)))
            except Exception as exc:  # noqa: BLE001 — one frame scores NaN
                if not warned:
                    warned.append(True)
                    print(f"{name} failed on a frame ({exc}); scoring NaN")
                out[i] = np.float32("nan")
        return out

    return fn


def _builtins():
    if "mse" not in _REGISTRY:
        from evreal_tpu_torch.metrics import functional

        register("mse", functional.mse)
        register("ssim", functional.ssim)


def names():
    """Registered names and the gated built-ins whose files exist."""
    _builtins()
    have = set(_REGISTRY)
    for key, module in _GATED.items():
        try:
            if os.path.exists(importlib.import_module(module).params_path()):
                have.add(key)
        except ImportError:  # scipy missing: niqe / brisque unavailable
            pass
    return sorted(have)


def resolve(metric_names):
    """Map requested names to specs, printing the JAX package's line for a
    gated metric whose file is absent and for an unknown name; returns the
    usable specs in order."""
    _builtins()
    specs = []
    for m in metric_names:
        key = m.lower()
        spec = _REGISTRY.get(key)
        if spec is None and key in _GATED:
            spec = _gated_spec(key)
            if spec is None:
                continue
        if spec is None:
            spec = _try_pyiqa(key)
        if spec is None:
            print(f"Unknown metric {m}")
            continue
        specs.append(spec)
    return specs


def _gated_spec(key):
    """The built-in's spec when its file exists (printing the skip line
    otherwise). The spec is kept per file, so its weights load once."""
    try:
        module = importlib.import_module(_GATED[key])
    except ImportError as e:  # only niqe / brisque: scipy
        print(f"{key} unavailable: {e} (scipy is required); skipping {key}")
        return None
    path = module.params_path()
    if not os.path.exists(path):
        print(f"{key} weights unavailable (see tools/convert_{key}.py); "
              f"skipping {key}")
        return None
    cache_key = (key, os.path.abspath(path), os.stat(path).st_mtime_ns)
    if cache_key not in _GATED_SPECS:
        _GATED_SPECS[cache_key] = module.make_spec(path)
    return _GATED_SPECS[cache_key]


def _try_pyiqa(key):
    """The pyiqa escape hatch (reference eval_metrics.py:100-159): any
    ``pyiqa.list_models()`` name becomes a host metric when pyiqa imports.
    The spec is registered, so later resolves reuse the instance."""
    from evreal_tpu_torch.metrics.pyiqa_bridge import make_pyiqa_spec

    made = make_pyiqa_spec(key)
    if made is None:
        return None
    fn, no_ref = made
    register(key, fn, no_ref=no_ref, host=True)
    return _REGISTRY[key]
