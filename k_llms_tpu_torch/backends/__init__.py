"""Model backends. ``cuda`` runs the local PyTorch engine (on a card, or on
the CPU with ``device="cpu"``); ``fake`` answers with scripted completions
for hermetic tests; ``replicas`` serves a ReplicaSet of them."""

from .base import Backend, ChatRequest, UnknownBackendError, resolve_backend
from .fake import FakeBackend

__all__ = ["Backend", "ChatRequest", "FakeBackend", "UnknownBackendError", "resolve_backend"]
