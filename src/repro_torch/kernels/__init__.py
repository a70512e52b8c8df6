"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (sources under ``csrc/``, built by ``build.py`` at first use)."""
