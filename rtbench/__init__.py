"""rtbench: the benchmark of chess2rt_tpu_torch, the PyTorch and CUDA port
(see harness.py and PERF.md)."""
