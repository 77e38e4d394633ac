"""The benchmark of ``tpu_sage_torch`` on an NVIDIA card: ``python3 -m benchmark.run``."""
