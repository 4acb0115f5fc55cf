"""Device ops: the attention kernels (CUDA, with plain PyTorch versions) and
sampling."""
