"""Machine-readable API docs: /openapi.json + a minimal /docs page.

The JAX package's ``server/openapi.py`` for the routes the port serves:
``/kubectl-command``, ``/kubectl-command/stream``, ``/execute``,
``/health`` and ``/metrics``, with the same status-code catalogs and the
schemas generated from the same pydantic models (``server/schemas.py``).
The document is built once when the app is created and served as a
cached JSON blob; both routes are unauthenticated, like the reference's
FastAPI docs.
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
                            "or too short after sanitation)"),
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
