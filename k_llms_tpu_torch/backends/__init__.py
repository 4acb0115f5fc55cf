"""Model backends. ``cuda`` runs the local PyTorch engine (on a card, or on
the CPU with ``device="cpu"``); ``fake`` answers with scripted completions
for hermetic tests; ``openai`` is the HTTP passthrough to the OpenAI API
(it needs the ``openai`` package); ``replicas`` serves a ReplicaSet of
them."""

from typing import Any

from .base import Backend, ChatRequest, UnknownBackendError, resolve_backend
from .fake import FakeBackend

__all__ = [
    "Backend",
    "ChatRequest",
    "FakeBackend",
    "ReplicaSet",
    "UnknownBackendError",
    "resolve_backend",
]


def __getattr__(name: str) -> Any:
    # Lazy: replicas.py imports this package (via backends.base), so a
    # top-level import here would be circular.
    if name == "ReplicaSet":
        from ..reliability.replicas import ReplicaSet

        return ReplicaSet
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
