"""Hand-written CUDA kernels (sources under ``repro_torch/csrc``), their
plain PyTorch versions, and the build/device runtime."""
