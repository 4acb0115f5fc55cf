"""k_llms_tpu_torch: the PyTorch/CUDA port of k_llms_tpu.

Same user surface — ``KLLMs(...).chat.completions.create/parse`` with ``n``
samples, consensus in ``choices[0]`` and ``likelihoods`` — served by a
PyTorch engine whose attention runs in hand-written CUDA kernels for Hopper
(``csrc/``). Imports neither JAX nor the JAX package.
"""

from .client import AsyncKLLMs, KLLMs

__all__ = ["AsyncKLLMs", "KLLMs"]
