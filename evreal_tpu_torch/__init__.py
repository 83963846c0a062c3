"""PyTorch/CUDA port of ``evreal_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; module names mirror it
so each counterpart is easy to find. This package imports ``torch`` and
numpy, never ``jax`` or ``evreal_tpu``. Tensors are NCHW with OIHW conv
weights. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (``--device cpu``); without a card they raise.

Run the single-sequence grayscale eval with
``python -m evreal_tpu_torch -m E2VID -c std -d ECD -qm mse ssim``.
"""
