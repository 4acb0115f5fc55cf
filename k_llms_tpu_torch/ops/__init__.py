"""Device ops: the attention kernels (CUDA, with plain PyTorch versions) and
sampling."""

from .sampling import sample_logits

__all__ = ["sample_logits"]
