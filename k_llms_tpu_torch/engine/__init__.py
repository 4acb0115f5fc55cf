"""Local inference engine: tokenizer, paged KV pool, batched decode."""

from .engine import GenerationResult, LocalEngine
from .tokenizer import ByteTokenizer, HFTokenizer, get_tokenizer

__all__ = ["ByteTokenizer", "HFTokenizer", "get_tokenizer", "GenerationResult", "LocalEngine"]
