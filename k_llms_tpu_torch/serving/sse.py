"""Server-sent-events wire framing (the OpenAI streaming transport).

One event per line-block: ``data: <json>\n\n``; the stream terminates with the
literal ``data: [DONE]\n\n`` sentinel, exactly as the OpenAI API does — openai
client libraries pointed at this server parse the stream unmodified.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, Tuple

DONE = b"data: [DONE]\n\n"

# Keep-alive comment frame: SSE spec section 7 — lines starting with ``:``
# are ignored by conforming clients (openai libraries included), so this
# heartbeat keeps idle-timeout proxies from severing a stream that is
# waiting in the admission queue or mid-prefill without polluting the
# event sequence.
PING = b": ping\n\n"

HEADERS = [
    (b"content-type", b"text/event-stream; charset=utf-8"),
    (b"cache-control", b"no-cache"),
    (b"x-accel-buffering", b"no"),
]


def format_event(data: Dict[str, Any]) -> bytes:
    """One SSE frame. Compact separators match the reference wire bytes."""
    return b"data: " + json.dumps(data, separators=(",", ":")).encode() + b"\n\n"


def parse_stream(payload: bytes) -> Iterator[Tuple[str, Any]]:
    """Inverse of format_event for tests/bench: yields ("data", obj) per JSON
    event and ("done", None) for the sentinel."""
    for block in payload.split(b"\n\n"):
        block = block.strip()
        if not block.startswith(b"data:"):
            continue
        body = block[len(b"data:"):].strip()
        if body == b"[DONE]":
            yield ("done", None)
        else:
            yield ("data", json.loads(body))
