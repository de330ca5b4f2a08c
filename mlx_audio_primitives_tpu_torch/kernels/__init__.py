"""CUDA kernels of the PyTorch port, each beside its plain PyTorch twin."""
