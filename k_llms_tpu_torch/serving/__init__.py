"""OpenAI-wire HTTP front door.

``app.py`` is a framework-free ASGI application (the container images bake in
no fastapi/starlette/uvicorn — plain ``async def app(scope, receive, send)``
runs under any ASGI server AND under httpx.ASGITransport in-process for
hermetic wire tests). ``server.py`` is the stdlib-asyncio HTTP/1.1 runner for
real sockets; ``python -m k_llms_tpu_torch.serving`` starts it.
"""

from .app import ServingApp, create_app
from .batch import BatchLane
from .server import HttpServer, ServerThread

__all__ = ["ServingApp", "create_app", "BatchLane", "HttpServer", "ServerThread"]
