"""The plain reference that decides ``correct``: plain PyTorch and NumPy
only. It imports nothing of ``evreal_tpu_torch``, ``evreal_tpu`` or JAX,
and takes nothing the program made: it cuts the windows, bins the events,
runs the recurrent models, normalizes, quantizes and scores on its own."""
