"""Client facade: KLLMs / AsyncKLLMs.

Counterpart of ``k_llms_tpu/client.py``.
``KLLMs(backend="cuda", model="llama-3-8b")`` runs everything locally on the
CUDA card; ``device="cpu"`` runs the same path with the kernels' plain
PyTorch versions. ``backend="openai"`` is the HTTP passthrough to the
OpenAI API (it needs the ``openai`` package). A Backend instance is passed
through unchanged.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

from .backends.base import Backend, resolve_backend
from .resources.completions import AsyncCompletions, Completions

# Embedding model caps and pricing, kept bit-identical to the reference
# (`client.py:12-13`). "local" is the on-device path: same 8191 crop cap so the
# degradation behavior matches, zero price.
MAX_TOKENS_PER_MODEL = {
    "local": 8191,
    "text-embedding-3-small": 8191,
    "text-embedding-3-large": 8191,
}
PRICING = {"local": 0.0, "text-embedding-3-small": 0.020, "text-embedding-3-large": 0.13}


def _progress_range(stop: int, step: int, verbose: bool):
    if verbose:
        try:
            import tqdm

            return tqdm.trange(0, stop, step)
        except ImportError:  # pragma: no cover
            pass
    return range(0, stop, step)


def _resolve_embedding_model(backend: Backend, model: str) -> str:
    """Map the sentinel "local" to whatever model the backend actually embeds
    with, so crop caps and pricing follow the model that gets hit. A model the
    USER names must be known (reference `client.py:95-96`); a backend default
    outside the table is allowed — it falls back to the default cap and $0."""
    if model != "local":
        if model not in MAX_TOKENS_PER_MODEL:
            raise ValueError(
                f"Model {model} not supported. Available models: "
                f"{list(MAX_TOKENS_PER_MODEL.keys())}"
            )
        return model
    effective = getattr(backend, "embedding_model_name", "local")
    if effective not in PRICING and getattr(backend, "bills_usage", False):
        # A PAID backend defaulting to a model we can't price must fail loudly
        # rather than silently billing $0; free/local custom embedders pass.
        raise ValueError(
            f"Model {effective} not supported. Available models: "
            f"{list(MAX_TOKENS_PER_MODEL.keys())}"
        )
    return effective


def _embed_batches(
    backend: Backend,
    processed: List[str],
    model: str,
    batch_size: int,
    verbose: bool,
    embeddings: List[List[float]],
    price_acc: List[float],
) -> None:
    """Shared batching/pricing loop (reference `client.py:108-117`): extends
    ``embeddings`` and ``price_acc[0]`` in place per batch, so a retry after a
    partial failure keeps billing what the failed attempt already spent."""
    for idx in _progress_range(len(processed), batch_size, verbose):
        batch = processed[idx : idx + batch_size]
        vectors, prompt_tokens = backend.embeddings_with_usage(batch, model=model)
        price_acc[0] += prompt_tokens * PRICING.get(model, 0.0) / 1000000.0
        embeddings.extend(vectors)


class _BaseKLLMs:
    def __init__(
        self,
        backend: Union[str, Backend, None] = None,
        model: Optional[str] = None,
        timeout: Optional[float] = None,
        **backend_kwargs: Any,
    ):
        # When WE construct the backend from a name, the client-level model
        # must reach it: a local backend loads that model's weights at
        # construction. (Silently building the default model and labeling its
        # outputs with the requested name would serve the wrong weights.)
        if not isinstance(backend, Backend) and model is not None:
            backend_kwargs.setdefault("model", model)
        self._backend = resolve_backend(backend, **backend_kwargs)
        # Default request label follows the weights actually loaded — with no
        # explicit model, a local backend's own default must not be relabeled.
        self.default_model = (
            model or getattr(self._backend, "model_name", None) or "llama-3-8b"
        )
        # Client-level deadline default in seconds (the OpenAI client's
        # ``timeout=`` constructor knob); per-call ``timeout=`` overrides it.
        # None = unbounded, matching the reference's behavior of leaving
        # timeouts entirely to the SDK default.
        self.default_timeout = timeout

    @property
    def backend(self) -> Backend:
        return self._backend

    @property
    def client(self) -> Backend:
        """The underlying engine (the reference exposes its OpenAI client here)."""
        return self._backend

    # -- lifecycle --------------------------------------------------------
    def health(self) -> Any:
        """Serving-health snapshot from the backend: scheduler lifecycle
        state (including RECOVERING while the supervisor rebuilds a hung or
        poisoned engine), queue depth/weight, shed/OOM counters, breaker
        state, supervisor stats (epoch, hung launches, rebuilds, replay
        count), quarantine counters, and the loader's param summary (total
        bytes, dtype histogram, checksum) when a checkpoint is loaded."""
        return self._backend.health()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Gracefully stop serving: admission closes (new requests get a
        typed 503 ``ServerDrainingError``), in-flight and queued work
        finishes, the worker joins. Returns True when everything completed
        within ``timeout`` (None = the backend's configured default)."""
        if timeout is None:
            return self._backend.drain()
        return self._backend.drain(timeout=timeout)

    def close(self) -> None:
        """Drain and release the backend. Idempotent; also runs on
        context-manager exit."""
        self._backend.close()

    def get_embeddings(
        self,
        texts: List[str],
        model: str = "local",
        batch_size: int = 2048,
        verbose: bool = False,
    ) -> List[List[float]]:
        """Batched embeddings helper (reference `client.py:75-122`): validate the
        model, crop every text to the model's token cap, chunk by ``batch_size``,
        accumulate the billed price, report progress when ``verbose``."""
        model = _resolve_embedding_model(self._backend, model)
        max_tokens = MAX_TOKENS_PER_MODEL.get(model, MAX_TOKENS_PER_MODEL["local"])
        processed = self._backend.crop_texts(texts, max_tokens, model=model)

        embeddings: List[List[float]] = []
        price_acc = [0.0]
        _embed_batches(
            self._backend, processed, model, batch_size, verbose, embeddings, price_acc
        )
        if verbose:
            print(f"TOTAL PRICE: ${price_acc[0]:.6f}")
        return embeddings


class KLLMs(_BaseKLLMs):
    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        self.chat = Chat(self)

    def __enter__(self) -> "KLLMs":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class AsyncKLLMs(_BaseKLLMs):
    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        self.chat = AsyncChat(self)

    async def __aenter__(self) -> "AsyncKLLMs":
        return self

    async def __aexit__(self, exc_type, exc, tb) -> None:
        import asyncio

        # drain() blocks on in-flight decodes; keep the event loop free.
        await asyncio.to_thread(self.close)

    async def async_get_embeddings(
        self,
        texts: List[str],
        model: str = "local",
        batch_size: int = 2048,
        verbose: bool = False,
    ) -> List[List[float]]:
        """Async embeddings with the reference's two-stage crop ladder
        (`client.py:125-196`): selectively crop only texts long enough to
        plausibly exceed the cap (cheap heuristic, off-thread), then on ANY
        failure re-crop everything and retry once."""
        import asyncio

        model = _resolve_embedding_model(self._backend, model)
        max_tokens = MAX_TOKENS_PER_MODEL.get(model, MAX_TOKENS_PER_MODEL["local"])
        backend = self._backend

        def selective_crop() -> List[str]:
            # ~3 chars/token lower bound: short strings can't exceed the cap.
            long_idx = [i for i, t in enumerate(texts) if len(t) * 3 > max_tokens]
            if not long_idx:
                return list(texts)
            cropped = backend.crop_texts([texts[i] for i in long_idx], max_tokens, model=model)
            out = list(texts)
            for i, c in zip(long_idx, cropped):
                out[i] = c
            return out

        def crop_all() -> List[str]:
            return backend.crop_texts(list(texts), max_tokens, model=model)

        price_acc = [0.0]
        embeddings: List[List[float]] = []

        def run_batches(processed: List[str]) -> List[List[float]]:
            embeddings.clear()
            _embed_batches(
                backend, processed, model, batch_size, verbose, embeddings, price_acc
            )
            return embeddings

        processed = await asyncio.to_thread(selective_crop)
        try:
            result = await asyncio.to_thread(run_batches, processed)
        except Exception as e:
            if verbose:
                print(f"Embedding request failed with error: {e}. Retrying with all strings cropped.")
            processed = await asyncio.to_thread(crop_all)
            result = await asyncio.to_thread(run_batches, processed)
        if verbose:
            print(f"TOTAL PRICE: ${price_acc[0]:.6f}")
        return result

    # Short alias kept for earlier adopters of this package.
    aget_embeddings = async_get_embeddings


class Chat:
    def __init__(self, wrapper: KLLMs):
        self._wrapper = wrapper
        self.completions = Completions(wrapper)


class AsyncChat:
    def __init__(self, wrapper: AsyncKLLMs):
        self._wrapper = wrapper
        self.completions = AsyncCompletions(wrapper)
