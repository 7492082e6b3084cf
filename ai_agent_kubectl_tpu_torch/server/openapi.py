"""Machine-readable API docs: /openapi.json + a minimal /docs page.

The JAX package's ``server/openapi.py`` for every route the port's app
serves: ``/kubectl-command``, ``/kubectl-command/stream``, ``/execute``,
``/health``, ``/metrics``, the ``/debug/*`` routes and
``/admin/rollout``, with the same methods, parameters, request bodies
and status-code catalogs and the schemas generated from the same
pydantic models (``server/schemas.py``). The document is built once
when the app is created and served as a cached JSON blob; both routes
are unauthenticated, like the reference's FastAPI docs.
"""

from __future__ import annotations

import json
from typing import Dict

from aiohttp import web

from .schemas import (CommandResponse, ExecuteRequest, HealthResponse,
                      Query)

_TITLE = "Kubectl NLP Service"
_VERSION = "1.0.0"

#: error body shape every non-2xx handler returns ({"detail": ...}).
_ERROR_SCHEMA = {
    "type": "object",
    "properties": {"detail": {}},
    "required": ["detail"],
}


def _err(desc: str) -> dict:
    return {
        "description": desc,
        "content": {"application/json": {
            "schema": {"$ref": "#/components/schemas/ErrorResponse"}}},
    }


def _resp(model: str, desc: str) -> dict:
    return {
        "description": desc,
        "content": {"application/json": {
            "schema": {"$ref": f"#/components/schemas/{model}"}}},
    }


def _body(model: str) -> dict:
    return {
        "required": True,
        "content": {"application/json": {
            "schema": {"$ref": f"#/components/schemas/{model}"}}},
    }


def build_openapi() -> Dict:
    """OpenAPI 3.1 document for the port's wire contract."""
    defs: Dict[str, dict] = {}

    def schema_of(model) -> None:
        s = model.model_json_schema(
            ref_template="#/components/schemas/{model}")
        defs.update(s.pop("$defs", {}))
        defs[model.__name__] = s

    for m in (Query, ExecuteRequest, CommandResponse, HealthResponse):
        schema_of(m)
    defs["ErrorResponse"] = _ERROR_SCHEMA

    auth_err = _err("Invalid or missing X-API-Key (only when API_AUTH_KEY "
                    "is configured)")
    rate_err = _err("Rate limit exceeded (Retry-After header set)")
    token_err = _err("Invalid or missing X-Debug-Token (only when "
                     "DEBUG_TOKEN is configured)")
    no_rollout = _err("Engine has no weight-rollout support")

    paths = {
        "/kubectl-command": {"post": {
            "summary": "Translate a natural-language query into one "
                       "kubectl command",
            "description": "Generation only — execution stays on "
                           "/execute. Served from the response cache on "
                           "repeat queries (from_cache=true). With "
                           "DEGRADED_FALLBACK=true, engine failures "
                           "degrade to deterministic rule-based responses "
                           "(degraded=true, engine_metadata.engine="
                           "\"fallback-rules\") instead of 503.",
            "requestBody": _body("Query"),
            "responses": {
                "200": _resp("CommandResponse", "Generated command with "
                             "generation-phase metadata"),
                "400": _err("Invalid input query (pydantic validation, "
                            "or too short after sanitation), or a grammar "
                            "restriction the engine cannot enforce: "
                            "X-Grammar-Profile outside the known profiles, "
                            "X-Allowed-Verbs outside the request's clamped "
                            "profile, or either header with "
                            "GRAMMAR_DECODE=false"),
                "401": auth_err,
                "410": _err("Request quarantined: its decode steps went "
                            "bad (NaN/Inf logits or an out-of-range "
                            "token id). Terminal — do not retry"),
                "422": _err("Generated command failed safety validation"),
                "429": rate_err,
                "500": _err("Internal error"),
                "503": _err("Engine unavailable (degraded start, "
                            "draining, open circuit breaker) or "
                            "overloaded — overload sheds (bounded "
                            "admission queue / MAX_INFLIGHT_REQUESTS) "
                            "carry a Retry-After header"),
                "504": _err("Generation exceeded LLM_TIMEOUT"),
            },
        }},
        "/kubectl-command/stream": {"post": {
            "summary": "Stream the generated command as SSE tokens",
            "description": "text/event-stream of token events, "
                           "terminated by 'event: done' carrying the "
                           "full validated command. The SSE response "
                           "commits to HTTP 200 before generation runs, "
                           "so engine failures arrive IN-BAND as an "
                           "'event: error' frame — never as an HTTP "
                           "error status.",
            "requestBody": _body("Query"),
            "responses": {
                "200": {"description": "SSE stream (text/event-stream): "
                                       "token events, then 'event: done' "
                                       "— or 'event: error' with the "
                                       "failure mapped in-band. With "
                                       "DEGRADED_FALLBACK=true an engine "
                                       "failure emits 'event: degraded' "
                                       "carrying the rule-based command, "
                                       "then 'event: done'",
                        "content": {"text/event-stream": {
                            "schema": {"type": "string"}}}},
                "400": _err("Invalid input query"),
                "401": auth_err,
                "429": rate_err,
            },
        }},
        "/execute": {"post": {
            "summary": "Execute a validated kubectl command",
            "description": "Safety-validated argv execution; execution "
                           "failures are structured 200s with "
                           "execution_error set.",
            "requestBody": _body("ExecuteRequest"),
            "responses": {
                "200": _resp("CommandResponse", "Execution result (table/"
                             "raw parsed stdout) or structured "
                             "execution_error"),
                "400": _err("Command failed safety validation"),
                "401": auth_err,
                "429": rate_err,
                "500": _err("Internal error"),
            },
        }},
        "/health": {"get": {
            "summary": "Readiness-gated health",
            "responses": {
                "200": _resp("HealthResponse", "Engine ready"),
                "503": _resp("HealthResponse", "Degraded / starting / "
                             "draining"),
            },
        }},
        "/metrics": {"get": {
            "summary": "Prometheus metrics",
            "responses": {"200": {
                "description": "Prometheus text exposition format",
                "content": {"text/plain": {"schema": {"type": "string"}}},
            }},
        }},
        "/debug/profile": {"post": {
            "summary": "Capture a torch.profiler trace from the live "
                       "server",
            "description": "POST /debug/profile?seconds=N (clamped to "
                           "[0.1, 30]) records a torch.profiler capture "
                           "on the engine's own thread while traffic "
                           "keeps serving, and returns the directory of "
                           "its Chrome-trace JSON. One capture at a time "
                           "(409 otherwise); the newest few captures are "
                           "kept. Behind API-key auth and, when "
                           "DEBUG_TOKEN is set, an X-Debug-Token header.",
            "responses": {
                "200": {"description": "Capture summary JSON "
                                       "(trace_dir, seconds)"},
                "400": _err("seconds is not a number"),
                "401": auth_err,
                "403": token_err,
                "409": _err("A capture is already in progress"),
                "500": _err("The engine's device cannot be traced"),
            },
        }},
        "/debug/trace": {"post": {
            "summary": "Another name of /debug/profile",
            "responses": {
                "200": {"description": "Capture summary JSON"},
                "401": auth_err,
            },
        }},
        "/debug/requests": {"get": {
            "summary": "The flight recorder's index: the newest requests' "
                       "summaries first",
            "description": "Every request of the serving path, shed 503s, "
                           "rate-limited 429s, degraded answers and errors "
                           "included, is kept with its span timeline in a "
                           "ring of FLIGHT_RECORDER_SIZE. A response's "
                           "X-Request-ID names its timeline at "
                           "/debug/requests/{id}. Gated as /debug/profile.",
            "responses": {
                "200": {"description": "{size, recorded, requests: "
                                       "[summaries]}"},
                "401": auth_err,
                "403": token_err,
            },
        }},
        "/debug/requests/{id}": {"get": {
            "summary": "One request's span timeline and event log",
            "parameters": [{
                "name": "id", "in": "path", "required": True,
                "schema": {"type": "string"},
                "description": "The request's X-Request-ID",
            }],
            "responses": {
                "200": {"description": "The timeline: spans [{phase, "
                                       "start_ms, end_ms, duration_ms}], "
                                       "events, status, flags"},
                "401": auth_err,
                "403": token_err,
                "404": _err("The request ID is not (or no longer) in the "
                            "ring"),
            },
        }},
        "/debug/chunks": {"get": {
            "summary": "The decode pipeline's record: recent chunk "
                       "dispatch, consume and prune events and its live "
                       "stats",
            "description": "The batched engine's ring of chunk events "
                           "(times, KV bucket, the device's live-slot "
                           "count, the read's latency) and the pipeline's "
                           "stats: depth and chunks in flight, where "
                           "termination runs, wasted decode steps, chunk "
                           "totals. Gated as /debug/profile.",
            "parameters": [{
                "name": "limit", "in": "query", "required": False,
                "schema": {"type": "integer", "default": 100},
                "description": "Newest events to return (<= 0 for none)",
            }],
            "responses": {
                "200": {"description": "{events: [...], pipeline: "
                                       "{pipe_depth, pipe_inflight, "
                                       "device_active_slots, "
                                       "wasted_decode_steps, ...}}"},
                "401": auth_err,
                "403": token_err,
            },
        }},
        "/debug/ledger": {"get": {
            "summary": "The goodput ledger: the engine's decode steps as "
                       "delivered or waste, per lane and hashed tenant",
            "description": "Every decode step the engine ran, classed "
                           "delivered | replayed | preempted | "
                           "hedge_loser | wasted_masked | quarantine_burn "
                           "| draft_rejected, with each lane's goodput "
                           "share, the tenant table (its keys are sha256 "
                           "hashes: a tenant key may be an API key) and "
                           "the conservation check (delivered plus every "
                           "waste class equals the steps accounted). "
                           "Gated as /debug/profile.",
            "responses": {
                "200": {"description": "{classes, lanes, tenants, "
                                       "total_steps, goodput_pct, "
                                       "conservation: {balanced, ...}}"},
                "401": auth_err,
                "403": token_err,
                "404": _err("The engine keeps no goodput ledger (the "
                            "single-sequence engine)"),
            },
        }},
        "/debug/incidents": {"get": {
            "summary": "The incident ring: evidence bundles filed on an "
                       "anomaly, the newest first",
            "description": "Bundles the sentinel filed by itself: a "
                           "step-time p99 breach, an SLO fast-burn spike, "
                           "a quarantine or grammar dead-end spike, a KV "
                           "pool that ran out, host-tier thrash or the "
                           "breaker opening each assemble one bounded "
                           "bundle (flight recorder, chunk rings, the "
                           "ledger, SLO, pool and spec sections, the "
                           "config's fingerprint, the weights version), "
                           "at most one per trigger and cooldown "
                           "(INCIDENT_COOLDOWN_SECS). A read runs one "
                           "evaluation of the triggers first. Gated as "
                           "/debug/profile.",
            "responses": {
                "200": {"description": "{ring, captured_total, "
                                       "suppressed_total, "
                                       "last_incident_id, incidents: "
                                       "[{id, trigger, at, detail}]}"},
                "401": auth_err,
                "403": token_err,
            },
        }},
        "/debug/incidents/{id}": {"get": {
            "summary": "One incident's whole evidence bundle",
            "parameters": [{
                "name": "id", "in": "path", "required": True,
                "schema": {"type": "string"},
                "description": "An incident id from the index route",
            }],
            "responses": {
                "200": {"description": "The bundle: trigger, detail, "
                                       "flight_recorder, chunks, ledger, "
                                       "slo, qos, kv_pool, spec, grammar, "
                                       "steptime, config_fingerprint, "
                                       "weights_version"},
                "401": auth_err,
                "403": token_err,
                "404": _err("The incident is not (or no longer) in the "
                            "ring"),
            },
        }},
        "/admin/rollout": {
            "post": {
                "summary": "Start a weight rollout: a canary, its gate, "
                           "then promote or roll back",
                "description": "Drains one canary replica, swaps it to "
                               "the checkpoint (its content fingerprint "
                               "is the version), rejoins it, sends it "
                               "ROLLOUT_CANARY_SHARE of fresh traffic for "
                               "ROLLOUT_OBSERVE_SECS, then promotes the "
                               "other replicas or rolls back by itself "
                               "when the SLO burn, goodput or counter "
                               "gate is breached. Gated as "
                               "/debug/profile.",
                "requestBody": {"required": True, "content": {
                    "application/json": {"schema": {
                        "type": "object",
                        "required": ["checkpoint"],
                        "properties": {"checkpoint": {
                            "type": "string",
                            "description": "The checkpoint to roll to",
                        }},
                    }}}},
                "responses": {
                    "202": {"description": "Rollout started; the body is "
                                           "its first status"},
                    "400": _err("Missing or invalid checkpoint"),
                    "401": auth_err,
                    "403": token_err,
                    "404": no_rollout,
                    "409": _err("A rollout is in progress, or the fleet "
                                "already serves that version"),
                },
            },
            "get": {
                "summary": "The rollout's status: its state, versions, "
                           "gate verdicts, timeline and rollback history",
                "responses": {
                    "200": {"description": "{state, target_version, "
                                           "stable_version, "
                                           "canary_replica, last_gate, "
                                           "events, history, ...}"},
                    "401": auth_err,
                    "403": token_err,
                    "404": no_rollout,
                },
            },
        },
        "/admin/rollout/abort": {"post": {
            "summary": "Abort the rollout in flight (it rolls back with "
                       "cause 'aborted')",
            "responses": {
                "200": {"description": "Rolled back; the body is the "
                                       "final status"},
                "401": auth_err,
                "403": token_err,
                "404": no_rollout,
                "409": _err("No rollout in progress"),
            },
        }},
    }

    return {
        "openapi": "3.1.0",
        "info": {
            "title": _TITLE,
            "version": _VERSION,
            "description": "Natural-language → kubectl translation "
                           "service backed by an in-process PyTorch "
                           "inference engine on a CUDA GPU.",
        },
        "paths": paths,
        "components": {
            "schemas": defs,
            "securitySchemes": {
                "ApiKeyAuth": {"type": "apiKey", "in": "header",
                               "name": "X-API-Key"},
            },
        },
        "security": [{"ApiKeyAuth": []}],
    }


_DOCS_HTML = """<!DOCTYPE html>
<html>
<head><title>{title} — API docs</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem auto;
        max-width: 56rem; line-height: 1.5; color: #1a1a1a; }}
 code, pre {{ background: #f4f4f4; padding: .15em .35em;
             border-radius: 4px; }}
 h2 {{ border-bottom: 1px solid #ddd; padding-bottom: .3em; }}
 .method {{ font-weight: 700; color: #0b5fff; }}
</style></head>
<body>
<h1>{title} <small>v{version}</small></h1>
<p>The machine-readable contract is at <a href="/openapi.json">
<code>/openapi.json</code></a> (OpenAPI 3.1).</p>
{sections}
</body></html>"""


def _docs_page(doc: Dict) -> str:
    sections = []
    for path, methods in doc["paths"].items():
        for method, op in methods.items():
            codes = ", ".join(sorted(op.get("responses", {})))
            sections.append(
                f"<h2><span class='method'>{method.upper()}</span> "
                f"<code>{path}</code></h2>"
                f"<p>{op.get('summary', '')}</p>"
                f"<p><small>Status codes: {codes}</small></p>"
            )
    return _DOCS_HTML.format(title=doc["info"]["title"],
                             version=doc["info"]["version"],
                             sections="\n".join(sections))


def register(app: web.Application) -> None:
    doc = build_openapi()
    blob = json.dumps(doc).encode()
    page = _docs_page(doc)

    async def handle_openapi(request: web.Request) -> web.Response:
        return web.Response(body=blob, content_type="application/json")

    async def handle_docs(request: web.Request) -> web.Response:
        return web.Response(text=page, content_type="text/html")

    app.router.add_get("/openapi.json", handle_openapi)
    app.router.add_get("/docs", handle_docs)
