"""Deterministic fake backend for hermetic tests.

The reference's (missing) test suite runs integration-first against the live
OpenAI API (`k-LLMs README_TESTS.md:9-15,224-229`); this backend is the
deterministic substitute SURVEY.md §4 calls for: scripted completions, hash-based
embeddings, majority-vote llm-consensus — all with zero I/O.
"""

from __future__ import annotations

import hashlib
import itertools
import time
from collections import Counter
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from ..types import ChatCompletion
from .base import Backend, ChatRequest

ResponderFn = Callable[[ChatRequest], List[str]]


def deterministic_embedding(text: str, dim: int = 64) -> List[float]:
    """Stable pseudo-embedding: seeded by the text's hash, biased so that
    near-identical texts get near-identical vectors (prefix character histogram)."""
    h = hashlib.sha256(text.encode("utf-8")).digest()
    rng = np.random.default_rng(int.from_bytes(h[:8], "little"))
    noise = rng.standard_normal(dim)
    hist = np.zeros(dim)
    for i, ch in enumerate(text[:256]):
        hist[(ord(ch) + i) % dim] += 1.0
    vec = hist / (np.linalg.norm(hist) + 1e-9) + 0.05 * noise
    return [float(x) for x in vec]


class FakeBackend(Backend):
    """Scripted completions: pass a list of content strings (cycled per request),
    a list-of-lists (one inner list per call), or a responder callable."""

    def __init__(
        self,
        responses: Optional[Union[Sequence[str], Sequence[Sequence[str]], ResponderFn]] = None,
        **_: Any,
    ):
        self._responder: Optional[ResponderFn] = None
        self._scripted: Optional[List[List[str]]] = None
        self._flat_cycle: Optional[itertools.cycle] = None
        self._call_idx = 0
        if callable(responses):
            self._responder = responses
        elif responses is not None and len(responses) > 0:
            if isinstance(responses[0], (list, tuple)):
                self._scripted = [list(r) for r in responses]  # type: ignore[arg-type]
            else:
                self._flat_cycle = itertools.cycle(list(responses))  # type: ignore[arg-type]

    def _contents_for(self, request: ChatRequest) -> List[str]:
        n = max(1, request.n)
        if self._responder is not None:
            return list(self._responder(request))
        if self._scripted is not None:
            contents = self._scripted[self._call_idx % len(self._scripted)]
            self._call_idx += 1
            return list(contents)
        if self._flat_cycle is not None:
            return [next(self._flat_cycle) for _ in range(n)]
        # Default: echo the last user message n times.
        last_user = next(
            (m.get("content", "") for m in reversed(request.messages) if m.get("role") == "user"),
            "",
        )
        return [str(last_user) for _ in range(n)]

    supports_streaming = True

    def chat_completion_stream(
        self, request: ChatRequest, emit: Callable[[int, str], None]
    ) -> ChatCompletion:
        """Deterministic streaming: build the full completion, then replay each
        sample's content as word-sized deltas (whitespace kept) so SSE tests
        see multiple chunks per sample without any timing dependence."""
        completion = self.chat_completion(request)
        for i, choice in enumerate(completion.choices):
            content = choice.message.content or ""
            # Always at least one delta per sample, even for empty content —
            # the wire contract tests pin ">=1 delta before the final event".
            for delta in re.findall(r"\S+\s*|\s+", content) or [""]:
                if request.budget is not None:
                    request.budget.check("stream")
                emit(i, delta)
        return completion

    def chat_completion(self, request: ChatRequest) -> ChatCompletion:
        contents = self._contents_for(request)
        choices: List[Dict[str, Any]] = [
            {
                "finish_reason": "stop",
                "index": i,
                "message": {"role": "assistant", "content": content},
                "logprobs": None,
            }
            for i, content in enumerate(contents)
        ]
        prompt_tokens = sum(len(str(m.get("content", "")).split()) for m in request.messages)
        completion_tokens = sum(len(c.split()) for c in contents)
        return ChatCompletion.model_validate(
            {
                "id": f"chatcmpl-fake-{hashlib.md5(str(request.messages).encode()).hexdigest()[:12]}",
                "choices": choices,
                "created": int(time.time()),
                "model": request.model,
                "object": "chat.completion",
                "usage": {
                    "prompt_tokens": prompt_tokens,
                    "completion_tokens": completion_tokens,
                    "total_tokens": prompt_tokens + completion_tokens,
                },
            }
        )

    def embeddings(self, texts: List[str]) -> List[List[float]]:
        return [deterministic_embedding(t) for t in texts]

    def llm_consensus(self, values: List[str]) -> str:
        assert len(values) > 0, "Cannot build consensus string from empty list"
        counts = Counter(values)
        return counts.most_common(1)[0][0]
