"""The benchmark of ``auxpm_tpu_torch`` on one NVIDIA H100 (``run.py``)."""
