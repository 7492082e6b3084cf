"""A lean aiohttp front end for the port: ``POST /kubectl-command`` and
``GET /health``.

The request pipeline lives in ``server/service.py``; this module only
validates the JSON body (the ``Query`` schema: 400 on a bad body) and
maps the service's (status, body) onto a response. ``/health`` is
readiness-gated like the JAX service's: 200 once the engine has started,
503 before, with the device count read from torch.

The stream, execute, debug, admin and metrics routes and the
middleware stack (rate limit, auth, QoS, overload) wait for a later
slice of the port.
"""

from __future__ import annotations

from aiohttp import web
from pydantic import ValidationError

from ..device import device_count
from .schemas import HealthResponse, Query
from .service import CommandService, error_body


async def handle_kubectl_command(request: web.Request) -> web.Response:
    svc: CommandService = request.app["service"]
    try:
        q = Query.model_validate(await request.json())
    except (ValidationError, ValueError) as e:
        return web.json_response(error_body(f"Invalid input query: {e}"),
                                 status=400)
    status, body = await svc.command(q.query)
    return web.json_response(body, status=status)


async def handle_health(request: web.Request) -> web.Response:
    svc: CommandService = request.app["service"]
    engine = svc.engine
    ready = bool(getattr(engine, "ready", False))
    kv_pool = None
    kph = getattr(engine, "kv_pool_health", None)
    if callable(kph):
        kv_pool = kph() or None
    body = HealthResponse(
        status="healthy" if ready else "degraded",
        engine=getattr(engine, "name", "unknown"),
        engine_ready=ready,
        model=svc.cfg.model_name,
        devices=device_count(getattr(engine, "device", None)),
        kv_pool=kv_pool,
    )
    return web.json_response(body.model_dump(), status=200 if ready else 503)


def create_app(cfg, engine) -> web.Application:
    """The app; its startup starts the engine, its cleanup stops it."""
    app = web.Application()
    app["service"] = CommandService(cfg, engine)
    app.router.add_post("/kubectl-command", handle_kubectl_command)
    app.router.add_get("/health", handle_health)

    async def _start_engine(app: web.Application) -> None:
        await app["service"].engine.start()

    async def _stop_engine(app: web.Application) -> None:
        await app["service"].engine.stop(drain_secs=cfg.drain_timeout_secs)

    app.on_startup.append(_start_engine)
    app.on_cleanup.append(_stop_engine)
    return app
