"""The benchmark of ``remfx_tpu_torch`` on NVIDIA GPUs (``run.py``)."""
