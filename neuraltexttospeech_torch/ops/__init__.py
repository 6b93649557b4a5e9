"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each beside
its plain PyTorch twin. Importing these modules builds nothing: a kernel is
compiled at its first launch."""
