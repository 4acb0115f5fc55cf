from .completions import AsyncCompletions, Completions
