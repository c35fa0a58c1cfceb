"""Plain PyTorch tensor ops (the CPU engine and the kernels' oracles)."""
