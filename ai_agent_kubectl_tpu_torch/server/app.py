"""The port's HTTP API on aiohttp: the JAX package's ``server/app.py``
contract for the routes and middleware the port serves.

Routes (the JAX statuses):

- ``POST /kubectl-command`` — query → validated kubectl command;
  200/400/401/410/422/429/500/503/504.
- ``POST /kubectl-command/stream`` — the same through the engine's
  ``generate_stream`` as server-sent events, ending in ``event: done``
  (or ``error``, or ``degraded`` then ``done``); it shares the response
  cache and single flight with the non-streaming route.
- ``POST /execute`` — run a validated kubectl command;
  200/400/401/429/500, execution errors as structured 200s.
- ``GET /health`` — readiness-gated, with the breaker's state, the
  engine's last containment reset and its cause (``last_reset``,
  ``last_reset_cause``), the engine's ``fleet``, ``qos``, ``kv_pool``,
  ``slo``, ``steptime``, ``grammar`` and ``spec`` sections, the
  rollout controller's ``rollout`` section and the incident ring's
  ``incidents`` summary.
- ``GET /metrics`` — Prometheus text; ``/openapi.json`` and ``/docs``.
- ``/debug/*``, behind ``X-Debug-Token`` when ``DEBUG_TOKEN`` is set
  (403 otherwise): ``POST /debug/profile?seconds=N`` (alias
  ``/debug/trace``; a ``torch.profiler`` capture on the engine's thread,
  one at a time, 409 while one runs), ``GET /debug/requests[/{id}]``
  (the flight recorder), ``/debug/chunks`` (the scheduler's chunk
  events and pipeline counters), ``/debug/ledger`` (the goodput ledger
  with its hashed-tenant table; 404 on an engine without one, such as
  the single-sequence engine) and ``/debug/incidents[/{id}]``.
- ``/admin/rollout`` behind the same token: ``POST`` ``{"checkpoint":
  path}`` starts a zero-downtime weight rollout (202; 409 while one runs
  or when the fleet already serves that version), ``GET`` its status,
  ``POST /admin/rollout/abort`` rolls it back (409 with nothing to
  abort); 404 when the engine cannot swap its weights.

Middleware, outermost first, in the JAX order: observability (request
ID, trace, HTTP metrics, ``Server-Timing``, flight recorder), overload
(``MAX_INFLIGHT_REQUESTS``: a fast 503 with ``Retry-After``), rate
limit (``RATE_LIMIT`` per client: 429 with the ``X-RateLimit-*``
headers), auth (``X-API-Key`` when ``API_AUTH_KEY`` is set: 401), QoS
(tenant and lane on a contextvar for the engine's fair-share queue;
``X-Priority`` clamped by ``TENANT_TIERS``, ``X-Session-ID``; the
grammar headers ``X-Grammar-Profile`` and ``X-Allowed-Verbs`` validated
against the request's clamped profile under ``GRAMMAR_DECODE``, a 400
otherwise).
An engine shed answers 429 for a tenant over its queue cap and 503 for a
full queue, with the engine's ``Retry-After``. A background task runs
the incident triggers every ``SENTINEL_EVAL_SECS`` and attaches an
``INCIDENT_PROFILE_SECS`` capture to a new bundle. While a rollout
holds the only capacity (the ``FLEET_SIZE=1`` in-place swap) an engine
503 carries a ``Retry-After`` priced from the swap. Every response
echoes the fleet's stable weights version as ``X-Model-Version``. The
pipeline itself lives in ``server/service.py``.
"""

from __future__ import annotations

import asyncio
import hmac
import logging
import time
from contextlib import suppress
from typing import Optional

from aiohttp import web
from pydantic import ValidationError

from ..constrain import GrammarContext, use_grammar, validate_restriction
from ..device import device_count
from ..engine.prompts import render_prompt
from ..engine.protocol import (EngineOverloaded, EngineResult,
                               EngineUnavailable, GenerationTimeout,
                               RequestQuarantined, TenantOverloaded)
from ..engine.qos import classify, use_qos
from ..engine.rollout import RolloutError
from ..obs import (PHASES, Trace, current_trace, new_request_id,
                   sanitize_request_id, use_trace)
from ..obs import profiler as obs_profiler
from .breaker import STATE_CODES
from .executor import CommandExecutor, build_metadata, utcnow_iso
from .metrics import Metrics
from .openapi import register as register_openapi
from .output_parser import UnsafeCommandError, parse_llm_output
from .ratelimit import ceil_seconds, client_key
from .safety import unsafe_reason
from .sanitize import sanitize_query
from .schemas import (CommandResponse, EngineMetadata, ExecuteRequest,
                      ExecutionMetadata, HealthResponse, Query)
from .service import Service, shed_answer, span

logger = logging.getLogger(__name__)

RATE_LIMITED_ROUTES = {"/kubectl-command", "/kubectl-command/stream",
                       "/execute"}
AUTH_ROUTES = RATE_LIMITED_ROUTES
#: routes the MAX_INFLIGHT_REQUESTS gate covers (they occupy the engine)
GENERATE_ROUTES = {"/kubectl-command", "/kubectl-command/stream"}
#: paths the flight recorder skips: probes and scrapes would flush every
#: real request out of the ring.
UNRECORDED_PATHS = ("/health", "/metrics", "/openapi.json", "/docs")


#: Retry-After of the HTTP-layer sheds and of an unready /health, the
#: JAX default of one second (an engine shed carries the engine's own
#: estimate, ``retry_after_hint``).
SHED_RETRY_SECS = 1.0


def _retry_after_header(seconds: float) -> dict:
    return {"Retry-After": str(max(1, ceil_seconds(seconds)))}


def _json_error(status: int, detail: str,
                headers: Optional[dict] = None) -> web.Response:
    return web.json_response({"detail": detail}, status=status,
                             headers=headers or {})


def _client_key(request: web.Request) -> str:
    svc: Service = request.app["service"]
    return client_key(request.remote,
                      request.headers.get("X-Forwarded-For"),
                      svc.cfg.trust_proxy_headers)


def _finalize_trace(svc: Service, trace: Trace, status: int,
                    canonical_path: str) -> None:
    """Close out a request's trace for every request, rejections
    included: status, phase histograms, and the flight recorder (probe,
    scrape and unmatched paths stay out of the ring)."""
    trace.finish(status=status)
    for phase, ms in trace.phase_durations().items():
        if phase in PHASES:
            svc.metrics.request_phase.labels(phase).observe(ms / 1000.0)
    if (canonical_path != "unmatched"
            and not canonical_path.startswith(UNRECORDED_PATHS)):
        svc.recorder.record(trace)


@web.middleware
async def observability_middleware(request: web.Request, handler):
    """Outermost: request ID (a safe client X-Request-ID is echoed),
    trace scope, HTTP metrics labelled by the matched route, and
    Server-Timing; wraps the other middleware so their rejections carry
    an X-Request-ID and land in the recorder."""
    svc: Service = request.app["service"]
    resource = getattr(request.match_info.route, "resource", None)
    path = resource.canonical if resource is not None else "unmatched"
    rid = (sanitize_request_id(request.headers.get("X-Request-ID"))
           or new_request_id())
    trace = Trace(rid, request.method, request.path)
    request["trace"] = trace
    status = 500
    try:
        with use_trace(trace):
            response = await handler(request)
        status = response.status
        if not getattr(response, "prepared", False):
            # Streaming responses sent their headers at prepare() time;
            # the SSE handler stamps X-Request-ID itself.
            response.headers["X-Request-ID"] = rid
            timing = trace.server_timing()
            if timing:
                response.headers["Server-Timing"] = timing
            ver = getattr(svc.engine, "weights_version", "")
            if ver:
                response.headers.setdefault("X-Model-Version", str(ver))
        return response
    except web.HTTPException as e:
        status = e.status
        e.headers["X-Request-ID"] = rid
        trace.error = type(e).__name__
        raise
    except Exception as e:
        trace.error = f"{type(e).__name__}: {e}"
        raise
    finally:
        elapsed = time.monotonic() - trace.t0
        svc.metrics.http_requests.labels(request.method, path,
                                         str(status)).inc()
        svc.metrics.http_latency.labels(request.method, path).observe(
            elapsed)
        _finalize_trace(svc, trace, status, path)


@web.middleware
async def overload_middleware(request: web.Request, handler):
    """HTTP-layer load shedding: generation requests beyond
    MAX_INFLIGHT_REQUESTS (<= 0: unlimited) get a fast 503 with
    Retry-After before any work is done."""
    svc: Service = request.app["service"]
    cap = svc.cfg.max_inflight_requests
    if cap <= 0 or request.path not in GENERATE_ROUTES:
        return await handler(request)
    if svc.inflight_requests >= cap:
        svc.metrics.queue_rejections.labels("http").inc()
        trace = current_trace()
        if trace is not None:
            trace.shed = True
            trace.event(f"overload: inflight cap reached "
                        f"({svc.inflight_requests}/{cap}); shedding")
        return _json_error(
            503,
            f"Server overloaded: {svc.inflight_requests} generation "
            f"requests in flight (cap {cap})",
            headers=_retry_after_header(SHED_RETRY_SECS),
        )
    svc.inflight_requests += 1
    try:
        return await handler(request)
    finally:
        svc.inflight_requests -= 1


@web.middleware
async def ratelimit_middleware(request: web.Request, handler):
    svc: Service = request.app["service"]
    if request.path in RATE_LIMITED_ROUTES:
        allowed, remaining, retry_after = svc.limiter.check(
            _client_key(request))
        if not allowed:
            svc.metrics.rate_limited.inc()
            trace = current_trace()
            if trace is not None:
                trace.shed = True
                trace.event("ratelimit: client over quota; rejecting")
            return _json_error(
                429,
                f"Rate limit exceeded: {svc.cfg.rate_limit}",
                headers=svc.limiter.headers(remaining, retry_after),
            )
    return await handler(request)


@web.middleware
async def auth_middleware(request: web.Request, handler):
    """X-API-Key auth on the serving routes and, by prefix, ``/debug/*``
    and ``/admin/*``; off when API_AUTH_KEY is unset."""
    svc: Service = request.app["service"]
    if svc.cfg.auth_enabled and (request.path in AUTH_ROUTES
                                 or request.path.startswith("/debug/")
                                 or request.path.startswith("/admin/")):
        key = request.headers.get("X-API-Key")
        if not key:
            logger.warning("Missing X-API-Key header.")
            return _json_error(401, "Missing X-API-Key header")
        if key != svc.cfg.api_auth_key:
            logger.warning("Invalid API Key received.")
            return _json_error(401, "Invalid API Key")
    return await handler(request)


@web.middleware
async def qos_middleware(request: web.Request, handler):
    """QoS classification of every generation request, innermost (only
    authenticated traffic is classified): a tenant key — the API key
    when TENANT_TIERS registers it, else the client key the rate limiter
    uses, so a flooder cannot mint a tenant per request — and a lane,
    X-Priority clamped by the tenant's tier, carried to the engine on a
    contextvar with the X-Session-ID session. A request may lower itself
    to the readonly grammar (X-Grammar-Profile) and narrow the verb set
    (X-Allowed-Verbs, comma-separated), validated here against its
    clamped profile (constrain.validate_restriction, the rule the engine
    runs too) and carried on its own contextvar: an unknown profile or
    verb, a verb outside the clamped profile, any verb restriction under
    the permissive profile, and either header with GRAMMAR_DECODE off
    answer 400, since a restriction the engine cannot enforce must not
    be dropped."""
    svc: Service = request.app["service"]
    if request.path not in GENERATE_ROUTES:
        return await handler(request)
    api_key = request.headers.get("X-API-Key")
    if api_key not in svc.tenant_tiers:
        api_key = None
    ctx = classify(
        api_key,
        _client_key(request),
        request.headers.get("X-Priority"),
        svc.tenant_tiers,
        svc.cfg.qos_default_lane,
        session=request.headers.get("X-Session-ID"),
    )
    trace = current_trace()
    if trace is not None:
        # The lane is safe to log; the tenant key may be an API key.
        trace.event(f"qos: lane={ctx.lane} "
                    f"(tenant={'tier-key' if api_key else 'client-ip'})")
    g_profile = request.headers.get("X-Grammar-Profile")
    g_verbs = request.headers.get("X-Allowed-Verbs")
    gctx = None
    if g_profile is not None or g_verbs is not None:
        if not svc.cfg.grammar_decode:
            return _json_error(
                400, "grammar restrictions require GRAMMAR_DECODE=true")
        verbs = None
        if g_verbs is not None:
            verbs = frozenset(v.strip().lower() for v in g_verbs.split(",")
                              if v.strip())
        gctx = GrammarContext(
            profile=(g_profile or "").strip().lower() or None,
            allowed_verbs=verbs)
        err = validate_restriction(svc.cfg.grammar_profile, ctx.lane, gctx)
        if err is not None:
            return _json_error(400, err)
        if trace is not None:
            trace.event(
                f"grammar: request profile={gctx.profile or 'base'}"
                + (f", {len(verbs)} allowed verbs" if verbs else ""))
    with use_qos(ctx):
        if gctx is not None:
            with use_grammar(gctx):
                return await handler(request)
        return await handler(request)


def _record_engine_spans(trace: Optional[Trace], t_block0: float,
                         t_block1: float, er: EngineResult) -> None:
    """Lay the engine block's queue, prefill and decode spans back to
    back from the EngineResult's timings, the remainder of the block as
    ``detokenize``, so the spans sum to the block's wall time."""
    if trace is None:
        return
    k = 1000.0
    t_q = t_block0 + er.queue_ms / k
    t_p = t_q + er.prefill_ms / k
    t_d = t_p + er.decode_ms / k
    t_q, t_p, t_d = (min(t, t_block1) for t in (t_q, t_p, t_d))
    trace.add_span("queue_wait", t_block0, t_q)
    trace.add_span("prefill", t_q, t_p)
    trace.add_span("decode", t_p, t_d)
    meta = {"detok_host_ms": round(er.detok_ms, 3)} if er.detok_ms else {}
    trace.add_span("detokenize", t_d, t_block1, **meta)


async def handle_kubectl_command(request: web.Request) -> web.Response:
    svc: Service = request.app["service"]
    trace: Optional[Trace] = request.get("trace")
    start_iso = utcnow_iso()
    t0 = time.monotonic()
    try:
        with span("validate"):
            q = Query.model_validate(await request.json())
    except (ValidationError, ValueError) as e:
        return _json_error(400, f"Invalid input query: {e}")

    logger.info("Received query: '%s'", q.query)
    sanitized_query = sanitize_query(q.query)
    if len(sanitized_query) < 3:
        return _json_error(400,
                           "Invalid input query: too short after sanitation")

    t_block0 = time.monotonic()
    try:
        command, from_cache, engine_result, degraded = \
            await svc.generate_command(sanitized_query)
    except EngineOverloaded as e:
        status, detail = shed_answer(e)
        return _json_error(status, detail,
                           headers=_retry_after_header(e.retry_after))
    except RequestQuarantined as e:
        logger.error("Request quarantined for query '%s': %s",
                     sanitized_query, e)
        return _json_error(410, f"Request quarantined: {e}")
    except EngineUnavailable as e:
        headers = None
        if svc.rollout is not None and svc.rollout.active:
            # While a swap holds the only capacity (the FLEET_SIZE=1
            # in-place swap has no fleet facade to price the shed), tell
            # the load balancer when to offer again.
            hint = float(getattr(svc.engine, "swap_hint", 0.0) or 0.0)
            headers = _retry_after_header(
                hint or max(2.0, svc.rollout.drain_secs / 2.0))
        return _json_error(503, f"Engine not available: {e}",
                           headers=headers)
    except (GenerationTimeout, asyncio.TimeoutError):
        logger.error("Engine timed out after %ss for query: %s",
                     svc.cfg.llm_timeout, sanitized_query)
        return _json_error(504, "LLM request timed out")
    except UnsafeCommandError as e:
        logger.error("Engine generated unsafe command: %s", e)
        svc.metrics.unsafe_commands.labels("llm").inc()
        return _json_error(422, f"LLM generated unsafe command: {e}")
    except Exception:
        logger.exception("Unexpected error processing query '%s'",
                         sanitized_query)
        return _json_error(500, "Internal server error processing request")

    t_block1 = time.monotonic()
    duration_ms = (t_block1 - t0) * 1000.0
    engine_md = None
    if engine_result is not None:
        # Degraded rule answers stay out of the engine latency and
        # throughput series (degraded_responses_total counts them).
        if not degraded:
            svc.metrics.ttft.observe(engine_result.ttft_ms / 1000.0)
            svc.metrics.gen_latency.observe(duration_ms / 1000.0)
            svc.metrics.tokens_generated.inc(
                max(engine_result.completion_tokens, 0))
            svc.token_rate.add(engine_result.completion_tokens)
            if engine_result.prefix_cache_hit:
                svc.metrics.prefix_cache_hits.inc()
            if not from_cache:
                _record_engine_spans(trace, t_block0, t_block1,
                                     engine_result)
        engine_md = EngineMetadata(
            queue_ms=engine_result.queue_ms,
            prefill_ms=engine_result.prefill_ms,
            decode_ms=engine_result.decode_ms,
            detok_ms=engine_result.detok_ms,
            ttft_ms=engine_result.ttft_ms,
            prompt_tokens=engine_result.prompt_tokens,
            completion_tokens=engine_result.completion_tokens,
            tokens_per_sec=engine_result.tokens_per_sec,
            prefix_cache_hit=engine_result.prefix_cache_hit,
            engine=engine_result.engine,
        )
    if trace is not None:
        trace.from_cache = from_cache
        if from_cache:
            trace.add_span("cache", t_block0, t_block1)
    with span("respond"):
        timings = trace.phase_durations() if trace is not None else None
        body = CommandResponse(
            kubectl_command=command,
            execution_result=None,
            execution_error=None,
            from_cache=from_cache,
            metadata=ExecutionMetadata(**build_metadata(start_iso, t0, True)),
            engine_metadata=engine_md,
            # Degraded: a rule answer, or an engine-side truncation.
            degraded=degraded or (engine_result is not None
                                  and engine_result.degraded),
            timings=timings,
        )
        payload = body.model_dump()
    return web.json_response(payload)


def _sse(payload: str, event: Optional[str] = None) -> bytes:
    """One SSE frame; every payload line gets its own ``data:`` field."""
    lines = payload.split("\n") or [""]
    frame = (f"event: {event}\n" if event else "") + "".join(
        f"data: {line}\n" for line in lines) + "\n"
    return frame.encode()


async def handle_kubectl_command_stream(request: web.Request
                                        ) -> web.StreamResponse:
    """SSE token stream through the same cache and single flight as the
    non-streaming route: the flight's initiator streams its tokens live;
    cache hits and coalesced waiters replay the final command as one
    event. A client that disconnects does not cancel the shared
    generation."""
    svc: Service = request.app["service"]
    try:
        q = Query.model_validate(await request.json())
    except (ValidationError, ValueError) as e:
        return _json_error(400, f"Invalid input query: {e}")
    sanitized_query = sanitize_query(q.query)
    if len(sanitized_query) < 3:
        return _json_error(400,
                           "Invalid input query: too short after sanitation")

    trace: Optional[Trace] = request.get("trace")
    resp = web.StreamResponse(
        status=200,
        headers={"Content-Type": "text/event-stream",
                 "Cache-Control": "no-cache"},
    )
    if trace is not None:
        resp.headers["X-Request-ID"] = trace.request_id
    ver = getattr(svc.engine, "weights_version", "")
    if ver:
        resp.headers["X-Model-Version"] = str(ver)
    await resp.prepare(request)

    write_ok = True

    async def write_safe(frame: bytes) -> None:
        nonlocal write_ok
        if not write_ok:
            return
        try:
            await resp.write(frame)
        except ConnectionError:
            write_ok = False  # client went away mid-stream; stop writing

    # The supplier hands tokens to this handler through a queue and never
    # touches the socket: a slow reader stalls only its own drain loop,
    # never the shared flight coalesced waiters are blocked on.
    done = object()
    token_q: asyncio.Queue = asyncio.Queue()

    async def supplier() -> str:
        async def run() -> str:
            pieces = []
            stream = svc.engine.generate_stream(
                render_prompt(sanitized_query),
                max_tokens=svc.cfg.max_new_tokens,
                temperature=svc.cfg.temperature,
                timeout=svc.cfg.llm_timeout,
            )
            async for piece in stream:
                pieces.append(piece)
                token_q.put_nowait(piece)
            return "".join(pieces)

        try:
            text = await svc.run_engine(run)
            with span("safety"):
                return parse_llm_output(text)
        finally:
            token_q.put_nowait(done)

    try:
        flight = asyncio.ensure_future(
            svc.cache.get_or_create(svc.cache_key(sanitized_query),
                                    supplier))
        getter: Optional[asyncio.Future] = None
        try:
            while True:
                getter = asyncio.ensure_future(token_q.get())
                await asyncio.wait({getter, flight},
                                   return_when=asyncio.FIRST_COMPLETED)
                if getter.done():
                    piece = getter.result()
                    if piece is done:
                        break
                    await write_safe(_sse(piece))
                else:
                    break  # flight finished without our supplier running
        finally:
            if getter is not None and not getter.done():
                getter.cancel()
        command, from_cache = await flight
        if trace is not None:
            trace.from_cache = from_cache
        if from_cache:
            svc.metrics.cache_hits.inc()
            await write_safe(_sse(command))
        else:
            svc.metrics.cache_misses.inc()
        await write_safe(_sse(command, event="done"))
    except UnsafeCommandError as e:
        svc.metrics.unsafe_commands.labels("llm").inc()
        await write_safe(_sse(str(e), event="error"))
    except TenantOverloaded as e:
        # The in-band 429: this tenant is over its queue quota.
        await write_safe(_sse(f"tenant over queue quota: {e}",
                              event="error"))
    except EngineOverloaded as e:
        # Shedding stays an error with the fallback on: back off.
        await write_safe(_sse(f"engine overloaded: {e}", event="error"))
    except RequestQuarantined as e:
        await write_safe(_sse(f"request quarantined: {e}", event="error"))
    except (EngineUnavailable, GenerationTimeout, asyncio.TimeoutError) as e:
        if svc.fallback is not None:
            try:
                command, _ = await svc.degraded_command(sanitized_query, e)
            except UnsafeCommandError as ue:
                svc.metrics.unsafe_commands.labels("llm").inc()
                await write_safe(_sse(str(ue), event="error"))
            else:
                await write_safe(_sse(command, event="degraded"))
                await write_safe(_sse(command, event="done"))
        elif isinstance(e, EngineUnavailable):
            await write_safe(_sse(f"engine unavailable: {e}", event="error"))
        else:
            await write_safe(_sse("LLM request timed out", event="error"))
    except Exception:
        # The 200 is on the wire: a structured error event rather than a
        # silently truncated stream.
        logger.exception("Stream generation failed for query '%s'",
                         sanitized_query)
        await write_safe(_sse("internal error during generation",
                              event="error"))
    try:
        await resp.write_eof()
    except ConnectionError:
        pass  # client already gone; the stream is finished either way
    return resp


async def handle_execute(request: web.Request) -> web.Response:
    svc: Service = request.app["service"]
    trace: Optional[Trace] = request.get("trace")
    try:
        with span("validate"):
            req = ExecuteRequest.model_validate(await request.json())
    except (ValidationError, ValueError) as e:
        return _json_error(400, f"Invalid request: {e}")

    logger.info("Received execute request for command: '%s'", req.execute)
    with span("safety"):
        reason = unsafe_reason(req.execute)
    if reason is not None:
        svc.metrics.unsafe_commands.labels("user").inc()
        return _json_error(400, f"Command failed safety checks: {reason}")

    with span("execute"):
        execution_data = await svc.executor.execute(req.execute)
    md = execution_data["metadata"]
    outcome = "success" if md["success"] else (md.get("error_type")
                                               or "error")
    svc.metrics.executions.labels(outcome).inc()

    with span("respond"):
        body = CommandResponse(
            kubectl_command=req.execute,
            execution_result=execution_data.get("execution_result"),
            execution_error=execution_data.get("execution_error"),
            from_cache=False,
            metadata=ExecutionMetadata(**md),
            timings=trace.phase_durations() if trace is not None else None,
        )
        payload = body.model_dump()
    return web.json_response(payload)


def _engine_view(engine, name: str) -> Optional[dict]:
    """What an engine's view method returns (``kv_pool_health``,
    ``qos_health``, ``stats``), or None for an engine without it."""
    fn = getattr(engine, name, None)
    return (fn() or None) if callable(fn) else None


async def handle_health(request: web.Request) -> web.Response:
    """Readiness-gated: 200 once the engine has started, else 503 with
    Retry-After. ``status`` is "healthy" only with the breaker closed."""
    svc: Service = request.app["service"]
    ready = bool(getattr(svc.engine, "ready", False))
    breaker = svc.breaker.state
    # When the engine last reset its decode state, and why: read off the
    # supervisor (not stats(), which drains samples owed to /metrics).
    last_reset = last_cause = None
    sup = getattr(svc.engine, "supervisor", None)
    if sup is not None and sup.last_reset_wall:
        last_reset = (time.strftime("%Y-%m-%dT%H:%M:%S",
                                    time.gmtime(sup.last_reset_wall)) + "Z")
        last_cause = sup.last_reset_cause
    # A fleet: the per-replica section (state, breaker, occupancy,
    # version, last reset) and its counters; its most recent reset
    # backfills the top-level fields.
    fleet = _engine_view(svc.engine, "fleet_health")
    if fleet is not None and last_reset is None:
        last_reset = fleet.get("last_reset")
        last_cause = fleet.get("last_reset_cause")
    body = HealthResponse(
        status="healthy" if ready and breaker == "closed" else "degraded",
        engine=getattr(svc.engine, "name", "unknown"),
        engine_ready=ready,
        model=svc.cfg.model_name,
        # A fleet's replicas share one configuration: the first's device.
        devices=device_count(getattr(svc._replica_engines()[0][1], "device",
                                     None)),
        breaker=breaker,
        degraded_fallback=svc.fallback is not None,
        last_reset=last_reset,
        last_reset_cause=last_cause,
        fleet=fleet,
        qos=_engine_view(svc.engine, "qos_health"),
        slo=_engine_view(svc.engine, "slo_health"),
        kv_pool=_engine_view(svc.engine, "kv_pool_health"),
        sharding=_engine_view(svc.engine, "sharding_health"),
        steptime=_engine_view(svc.engine, "steptime_health"),
        grammar=_engine_view(svc.engine, "grammar_health"),
        spec=_engine_view(svc.engine, "spec_health"),
        rollout=(svc.rollout.health() if svc.rollout is not None
                 else None),
        incidents=svc.incidents.snapshot(),
    )
    if ready:
        return web.json_response(body.model_dump(), status=200)
    return web.json_response(
        body.model_dump(), status=503,
        headers=_retry_after_header(SHED_RETRY_SECS))


def _debug_forbidden(request: web.Request) -> Optional[web.Response]:
    """Token gate for /debug/*: when DEBUG_TOKEN is configured, require a
    matching X-Debug-Token header on top of the API-key auth. Compared
    as bytes: a header may carry non-ASCII bytes, which must 403, not
    500."""
    token = request.app["service"].cfg.debug_token
    if not token:
        return None
    supplied = request.headers.get("X-Debug-Token", "")
    if not hmac.compare_digest(
            supplied.encode("utf-8", "surrogateescape"), token.encode()):
        return _json_error(403, "Invalid or missing X-Debug-Token")
    return None


async def handle_debug_profile(request: web.Request) -> web.Response:
    """POST /debug/profile?seconds=N — a torch.profiler capture while
    live traffic runs, on the engine's own thread (obs/profiler.py):
    ``{"trace_dir", "seconds"}``. One capture at a time (409); a capture
    the engine's device cannot take answers 500."""
    denied = _debug_forbidden(request)
    if denied is not None:
        return denied
    try:
        seconds = obs_profiler.clamp_seconds(
            float(request.query.get("seconds", 2.0)))
    except ValueError:
        return _json_error(400, "seconds must be a number")
    if request.app.get("_tracing"):
        return _json_error(409, "a trace is already in progress")
    request.app["_tracing"] = True
    try:
        result = await obs_profiler.capture(
            seconds, request.app["service"].engine)
    except Exception as e:
        logger.exception("trace capture failed")
        return _json_error(500, f"trace capture failed: {e}")
    finally:
        request.app["_tracing"] = False
    return web.json_response(result)


async def handle_debug_requests(request: web.Request) -> web.Response:
    """GET /debug/requests — the flight recorder's newest-first index."""
    denied = _debug_forbidden(request)
    if denied is not None:
        return denied
    svc: Service = request.app["service"]
    try:
        limit = int(request.query.get("limit", 50))
    except ValueError:
        return _json_error(400, "limit must be an integer")
    return web.json_response({
        "size": svc.recorder.size,
        "recorded": svc.recorder.recorded,
        "requests": svc.recorder.list(limit=limit),
    })


async def handle_debug_request_detail(request: web.Request) -> web.Response:
    """GET /debug/requests/{id} — one request's full span timeline."""
    denied = _debug_forbidden(request)
    if denied is not None:
        return denied
    svc: Service = request.app["service"]
    rid = request.match_info["id"]
    entry = svc.recorder.get(rid)
    if entry is None:
        return _json_error(
            404,
            f"request {rid!r} not in the flight recorder (keeps the last "
            f"{svc.recorder.size}; is FLIGHT_RECORDER_SIZE large enough?)",
        )
    return web.json_response(entry)


async def handle_debug_chunks(request: web.Request) -> web.Response:
    """GET /debug/chunks — the last N chunk dispatch/consume/prune
    events off the scheduler's ring, and the live pipeline counters.
    The ring copy retries on a concurrent-mutation RuntimeError."""
    denied = _debug_forbidden(request)
    if denied is not None:
        return denied
    svc: Service = request.app["service"]
    try:
        limit = int(request.query.get("limit", 100))
    except ValueError:
        return _json_error(400, "limit must be an integer")
    log = getattr(svc.engine, "_chunk_log", ())
    events: list = []
    for _ in range(5):
        try:
            events = list(log)
            break
        except RuntimeError:
            continue
    stats = _engine_view(svc.engine, "stats") or {}
    if stats:
        # stats() drains the fetch-latency samples: forward them to the
        # histogram rather than dropping them.
        svc.metrics.observe_pipeline(stats)
    keys = ("pipe_depth", "pipe_inflight", "device_active_slots",
            "device_termination", "wasted_decode_steps",
            "chunks_dispatched", "chunks_consumed", "chunks_pruned")
    return web.json_response({
        "events": events[-limit:] if limit > 0 else [],
        "pipeline": {k: stats[k] for k in keys if k in stats},
    })


async def handle_debug_ledger(request: web.Request) -> web.Response:
    """GET /debug/ledger — the goodput ledger per lane and per hashed
    tenant, with the conservation check; 404 on an engine without one."""
    denied = _debug_forbidden(request)
    if denied is not None:
        return denied
    svc: Service = request.app["service"]
    snap = _engine_view(svc.engine, "ledger_snapshot")
    if not snap:
        return _json_error(
            404, "engine exposes no goodput ledger (telemetry plane is "
                 "wired into the chunked schedulers and the fleet)")
    return web.json_response(snap)


async def _attach_incident_profiles(app: web.Application, svc: Service,
                                    bundles: list) -> None:
    """Attach an INCIDENT_PROFILE_SECS capture to the first new bundle
    (0 = off), serialized against operator captures by the same flag and
    bounded by the trigger cooldowns that bounded the bundles."""
    secs = svc.cfg.incident_profile_secs
    if secs <= 0 or not bundles or not callable(
            getattr(svc.engine, "profile", None)):
        return
    if app.get("_tracing"):
        bundles[0]["profile"] = {"skipped": "capture already running"}
        return
    app["_tracing"] = True
    try:
        bundles[0]["profile"] = await obs_profiler.capture(secs, svc.engine)
    except Exception as e:
        bundles[0]["profile"] = {"error": str(e)}
    finally:
        app["_tracing"] = False


async def handle_debug_incidents(request: web.Request) -> web.Response:
    """GET /debug/incidents — the incident ring's newest-first index,
    after one trigger evaluation (a freshly tripped sentinel files its
    bundle on the request that comes looking for it)."""
    denied = _debug_forbidden(request)
    if denied is not None:
        return denied
    svc: Service = request.app["service"]
    try:
        new = svc.check_incidents()
        await _attach_incident_profiles(request.app, svc, new)
    except Exception:   # pragma: no cover - defensive
        logger.exception("incident evaluation failed")
    return web.json_response({
        **svc.incidents.snapshot(),
        "incidents": svc.incidents.list(),
    })


async def handle_debug_incident_detail(request: web.Request
                                       ) -> web.Response:
    """GET /debug/incidents/{id} — one incident's full evidence bundle."""
    denied = _debug_forbidden(request)
    if denied is not None:
        return denied
    svc: Service = request.app["service"]
    iid = request.match_info["id"]
    bundle = svc.incidents.get(iid)
    if bundle is None:
        return _json_error(
            404,
            f"incident {iid!r} not in the ring (keeps the newest "
            f"{svc.incidents.ring_size}; is INCIDENT_RING large "
            f"enough?)")
    return web.json_response(bundle)


def _rollout_unavailable(svc: Service) -> Optional[web.Response]:
    if svc.rollout is None:
        return _json_error(
            404, "engine has no weight-rollout support (rollouts are "
                 "wired into the fleet and the swap-capable engines)")
    return None


async def handle_admin_rollout_post(request: web.Request) -> web.Response:
    """POST /admin/rollout {"checkpoint": path} — begin a zero-downtime
    weight rollout: drain one canary replica, swap it to the versioned
    checkpoint, observe it under a bounded traffic share, then promote
    the rest or roll back on its own. Token-gated like /debug/*."""
    denied = _debug_forbidden(request)
    if denied is not None:
        return denied
    svc: Service = request.app["service"]
    unavailable = _rollout_unavailable(svc)
    if unavailable is not None:
        return unavailable
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "body must be JSON")
    checkpoint = (body or {}).get("checkpoint")
    if not isinstance(checkpoint, str) or not checkpoint.strip():
        return _json_error(400, "body needs a 'checkpoint' path string")
    try:
        status = await svc.rollout.start_rollout(checkpoint.strip())
    except RolloutError as e:
        return _json_error(409, str(e))
    return web.json_response(status, status=202)


async def handle_admin_rollout_get(request: web.Request) -> web.Response:
    """GET /admin/rollout — the rollout state machine's full status:
    state, target and stable versions, canary and share, gate verdicts,
    the drain→swap→rejoin→promote timeline and the rollback history."""
    denied = _debug_forbidden(request)
    if denied is not None:
        return denied
    svc: Service = request.app["service"]
    unavailable = _rollout_unavailable(svc)
    if unavailable is not None:
        return unavailable
    return web.json_response(svc.rollout.status())


async def handle_admin_rollout_abort(request: web.Request) -> web.Response:
    """POST /admin/rollout/abort — roll the rollout in flight back (cause
    ``aborted``); 409 when nothing is in flight."""
    denied = _debug_forbidden(request)
    if denied is not None:
        return denied
    svc: Service = request.app["service"]
    unavailable = _rollout_unavailable(svc)
    if unavailable is not None:
        return unavailable
    try:
        status = await svc.rollout.abort()
    except RolloutError as e:
        return _json_error(409, str(e))
    return web.json_response(status)


async def handle_metrics(request: web.Request) -> web.Response:
    svc: Service = request.app["service"]
    pool = _engine_view(svc.engine, "kv_pool_health")
    if pool:
        svc.metrics.observe_kv_pool(pool)
    # The engine's stats(), sampled at scrape time: the engine gauges,
    # the decode pipeline, the QoS section, the ledger's lane table, the
    # SLO burn rates and the step-time digests.
    stats = _engine_view(svc.engine, "stats") or {}
    if stats:
        svc.metrics.batch_occupancy.set(stats.get("batch_occupancy", 0))
        svc.metrics.queue_depth.set(stats.get("queue_depth", 0))
        svc.metrics.kv_pool_used.set(stats.get("kv_pages_used", 0))
        svc.metrics.kv_pool_total.set(stats.get("kv_pages_total", 0))
        svc.metrics.observe_pipeline(stats)
        svc.metrics.observe_containment(stats)
    if stats.get("fleet"):
        svc.metrics.observe_fleet(stats["fleet"])
    if stats.get("qos"):
        svc.metrics.observe_qos(stats["qos"])
    if stats.get("ledger"):
        svc.metrics.observe_ledger(stats["ledger"])
    if stats.get("slo"):
        svc.metrics.observe_slo(stats["slo"])
    if stats.get("steptime"):
        svc.metrics.observe_steptime(stats["steptime"])
    if stats.get("grammar"):
        svc.metrics.observe_grammar(stats["grammar"])
    if stats.get("spec"):
        svc.metrics.observe_spec(stats["spec"])
    if stats.get("sharding"):
        svc.metrics.observe_sharding(stats["sharding"])
    # A scrape is also a trigger-evaluation round (cooldowns make the
    # redundant evaluation free).
    try:
        svc.check_incidents()
    except Exception:   # pragma: no cover - defensive
        logger.exception("incident evaluation failed at scrape")
    svc.metrics.observe_incidents(svc.incidents.snapshot())
    if svc.rollout is not None:
        svc.metrics.observe_rollout(svc.rollout.health())
    svc.metrics.tokens_per_sec.set(svc.token_rate.rate())
    svc.metrics.breaker_state.set(STATE_CODES[svc.breaker.state])
    return web.Response(body=svc.metrics.render(), content_type="text/plain")


def create_app(cfg, engine, executor: Optional[CommandExecutor] = None,
               metrics: Optional[Metrics] = None) -> web.Application:
    """The app; its startup starts the engine, its cleanup stops it."""
    app = web.Application(middlewares=[
        observability_middleware, overload_middleware,
        ratelimit_middleware, auth_middleware, qos_middleware])
    app["service"] = Service(cfg, engine, executor=executor,
                             metrics=metrics)
    app.router.add_post("/kubectl-command", handle_kubectl_command)
    app.router.add_post("/kubectl-command/stream",
                        handle_kubectl_command_stream)
    app.router.add_post("/execute", handle_execute)
    app.router.add_post("/debug/profile", handle_debug_profile)
    app.router.add_post("/debug/trace", handle_debug_profile)  # alias
    app.router.add_get("/debug/requests", handle_debug_requests)
    app.router.add_get("/debug/requests/{id}", handle_debug_request_detail)
    app.router.add_get("/debug/chunks", handle_debug_chunks)
    app.router.add_get("/debug/ledger", handle_debug_ledger)
    app.router.add_get("/debug/incidents", handle_debug_incidents)
    app.router.add_get("/debug/incidents/{id}",
                       handle_debug_incident_detail)
    app.router.add_post("/admin/rollout", handle_admin_rollout_post)
    app.router.add_get("/admin/rollout", handle_admin_rollout_get)
    app.router.add_post("/admin/rollout/abort", handle_admin_rollout_abort)
    app.router.add_get("/health", handle_health)
    app.router.add_get("/metrics", handle_metrics)
    register_openapi(app)

    async def _start_engine(app: web.Application) -> None:
        await app["service"].engine.start()

    async def _stop_engine(app: web.Application) -> None:
        await app["service"].engine.stop(drain_secs=cfg.drain_timeout_secs)

    async def _start_sentinel_watcher(app: web.Application) -> None:
        # The incident watcher: a background evaluation loop, so triggers
        # fire even when nothing scrapes /metrics (0 disables it).
        svc: Service = app["service"]
        period = svc.cfg.sentinel_eval_secs
        if period <= 0:
            return

        async def watch() -> None:
            while True:
                await asyncio.sleep(period)
                try:
                    new = svc.check_incidents()
                    await _attach_incident_profiles(app, svc, new)
                except asyncio.CancelledError:   # teardown
                    raise
                except Exception:   # pragma: no cover - defensive
                    logger.exception("sentinel watcher failed")

        app["_sentinel_task"] = asyncio.create_task(watch())

    async def _stop_sentinel_watcher(app: web.Application) -> None:
        task = app.get("_sentinel_task")
        if task is not None:
            task.cancel()
            with suppress(asyncio.CancelledError):
                await task
            app["_sentinel_task"] = None

    app.on_startup.append(_start_engine)
    app.on_startup.append(_start_sentinel_watcher)
    app.on_cleanup.append(_stop_sentinel_watcher)
    app.on_cleanup.append(_stop_engine)
    return app
