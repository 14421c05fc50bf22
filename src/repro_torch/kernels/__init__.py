"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the dispatch layer that routes between them by device."""
