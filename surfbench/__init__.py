"""The benchmark of surf_tpu_torch, the PyTorch and CUDA port of SuRF
(``python -m surfbench.run``; BENCHMARK.json names its cells)."""
