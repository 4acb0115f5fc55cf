from .completions import AsyncCompletions, Completions

__all__ = ["Completions", "AsyncCompletions"]
