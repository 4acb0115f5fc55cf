"""``python -m k_llms_tpu_torch.serving`` — run the OpenAI-wire front door.

Example::

    python -m k_llms_tpu_torch.serving --backend cuda --model tiny --port 8000 \
        --continuous-batching

SIGINT/SIGTERM trigger graceful shutdown: the socket closes, the backend
drains (in-flight decodes finish; late arrivals get typed 503s), then exit.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import logging
import signal

from .app import create_app
from .server import HttpServer


def _parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m k_llms_tpu_torch.serving")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--backend", default="cuda", choices=["cuda", "fake"])
    p.add_argument(
        "--device", default=None,
        help="where the cuda backend runs: the CUDA card by default (the server "
             "fails to start without one); 'cpu' runs the plain PyTorch versions",
    )
    p.add_argument("--model", default="tiny")
    p.add_argument("--checkpoint-path", default=None)
    p.add_argument("--tokenizer-path", default=None)
    p.add_argument("--max-new-tokens", type=int, default=None)
    p.add_argument(
        "--continuous-batching", action="store_true",
        help="serve decodes through the in-flight slot loop (streaming-"
             "friendly admission; see engine/continuous.py)",
    )
    p.add_argument("--continuous-width", type=int, default=None)
    p.add_argument(
        "--batch-dir", default=None,
        help="durable root for the offline batch lane's job store "
             "(journal + outputs). Unfinished jobs found here resume at "
             "startup; without it the lane uses an ephemeral tempdir.",
    )
    p.add_argument("--log-level", default="info")
    return p.parse_args(argv)


async def _amain(args: argparse.Namespace) -> None:
    kwargs = {"backend": args.backend, "model": args.model}
    for flag, key in (
        ("checkpoint_path", "checkpoint_path"),
        ("tokenizer_path", "tokenizer_path"),
        ("max_new_tokens", "max_new_tokens"),
        ("continuous_width", "continuous_width"),
        ("device", "device"),
    ):
        val = getattr(args, flag)
        if val is not None:
            kwargs[key] = val
    if args.continuous_batching:
        kwargs["continuous_batching"] = True
    app = create_app(batch_dir=args.batch_dir, **kwargs)
    # Restart recovery before the socket opens: journaled batch jobs resume
    # whether or not the runner speaks the ASGI lifespan protocol.
    await asyncio.to_thread(app.startup)
    server = HttpServer(app, host=args.host, port=args.port)
    await server.start()

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):  # pragma: no cover
            loop.add_signal_handler(sig, stop.set)

    serve_task = asyncio.ensure_future(server.serve_forever())
    await stop.wait()
    serve_task.cancel()
    with contextlib.suppress(asyncio.CancelledError):
        await serve_task
    await server.stop()


def main(argv=None) -> None:
    args = _parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()
