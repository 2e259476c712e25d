"""The benchmark of qgcm_torch, the PyTorch and CUDA port: one cell of
BENCHMARK.json a run (python -m portbench.run). See README.md."""
