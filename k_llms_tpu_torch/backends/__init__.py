"""Model backends. ``cuda`` runs the local PyTorch engine (on a card, or on
the CPU with ``device="cpu"``); ``replicas`` serves a ReplicaSet of them."""

from .base import Backend, ChatRequest, UnknownBackendError, resolve_backend

__all__ = ["Backend", "ChatRequest", "UnknownBackendError", "resolve_backend"]
