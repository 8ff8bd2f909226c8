"""Benchmark of the PyTorch and CUDA port (pathtracer_tpu_torch)."""
