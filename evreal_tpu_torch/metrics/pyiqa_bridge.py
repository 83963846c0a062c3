"""The escape hatch for any pyiqa metric (``evreal_tpu/metrics/
pyiqa_bridge.py``; reference utils/eval_metrics.py:100-159,
PyIqaMetricFactory): when ``import pyiqa`` succeeds, a ``-qm`` name in
``pyiqa.list_models()`` becomes a host metric. The runner hands it a
chunk's (N, H, W) frames as numpy arrays; they go to pyiqa in batches of 4
(the reference's queue), gray repeated to three channels as the
reference's ``cv2torch(img, num_ch=3)`` does, and ``metric_mode`` says
whether it takes references. pyiqa is never a dependency: without it
``make_pyiqa_spec`` returns None and the name stays unknown.
"""

import warnings

import numpy as np
import torch

BATCH = 4


def _host_batch_fn(metric, no_ref):
    def fn(imgs, refs=None):
        imgs = np.asarray(imgs, np.float32)
        outs = []
        with torch.no_grad():
            for i in range(0, len(imgs), BATCH):
                args = [torch.from_numpy(np.repeat(a[i:i + BATCH, None], 3,
                                                   axis=1))
                        for a in ((imgs,) if no_ref else
                                  (imgs, np.asarray(refs, np.float32)))]
                outs.append(np.asarray(metric(*args).detach().cpu(),
                                       np.float32).reshape(-1))
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    return fn


def make_pyiqa_spec(name):
    """(fn, no_ref) of pyiqa's metric ``name``, or None when pyiqa is
    absent, does not know the name, or cannot build it (printed: one
    broken metric must not stop the evaluation)."""
    try:
        import pyiqa
    except ImportError:
        return None
    if name not in pyiqa.list_models():
        return None
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", category=UserWarning)
            metric = pyiqa.create_metric(name)
    except Exception as e:  # noqa: BLE001 — e.g. an offline weight download
        print(f"[metrics] pyiqa metric {name!r} failed to construct "
              f"({type(e).__name__}: {e}); skipping")
        return None
    no_ref = getattr(metric, "metric_mode", "FR") == "NR"
    return _host_batch_fn(metric, no_ref), no_ref
