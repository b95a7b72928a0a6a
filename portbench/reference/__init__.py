"""Plain reference of the benchmarked step: NumPy and plain PyTorch only.

Nothing here imports ``jax``, ``auxpm_tpu`` or ``auxpm_tpu_torch``.  The
pieces that must agree with the program bit for bit (the stand-in data and
the threefry draws) are frozen copies, each naming what it was copied from.
"""
