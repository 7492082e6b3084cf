"""The request pipeline of ``POST /kubectl-command``, free of any web
framework.

The counterpart of the JAX package's ``server/app.py::
handle_kubectl_command`` and ``Service.generate_command``: sanitise the
query, render the prompt, ``engine.generate``, parse and validate the
model's text, and build a response body of the ``CommandResponse``
shape — or an error status with a ``{"detail": ...}`` body. The status
mapping is the JAX service's: 400 for a query too short after sanitation,
422 for an unsafe or unparseable command, 503 for an unavailable or
overloaded engine, 410 for a quarantined request, 504 for a timeout, 500
for anything else.

The response cache, breaker and degraded fallback, rate limit, auth and
metrics wait for a later slice of the port.
"""

from __future__ import annotations

import asyncio
import datetime
import logging
import time
from typing import Any, Dict, Tuple

from ..engine.prompts import render_prompt
from ..engine.protocol import (EngineOverloaded, EngineUnavailable,
                               GenerationTimeout, RequestQuarantined)
from .output_parser import UnsafeCommandError, parse_llm_output
from .sanitize import sanitize_query

logger = logging.getLogger(__name__)


def utcnow_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def error_body(detail: str) -> Dict[str, Any]:
    return {"detail": detail}


def status_for_text(text: str) -> int:
    """The status the service answers for the model text ``text``: 200
    when it parses into a safe single-line kubectl command, else 422."""
    try:
        parse_llm_output(text)
    except UnsafeCommandError:
        return 422
    return 200


class CommandService:
    """Sanitise -> render_prompt -> engine.generate -> parse -> body."""

    def __init__(self, cfg, engine):
        self.cfg = cfg
        self.engine = engine

    async def command(self, query: str) -> Tuple[int, Dict[str, Any]]:
        """(HTTP status, JSON body) for one natural-language query."""
        start_iso = utcnow_iso()
        t0 = time.monotonic()
        sanitized = sanitize_query(query)
        if len(sanitized) < 3:
            return 400, error_body(
                "Invalid input query: too short after sanitation")
        try:
            result = await self.engine.generate(
                render_prompt(sanitized),
                max_tokens=self.cfg.max_new_tokens,
                temperature=self.cfg.temperature,
                timeout=self.cfg.llm_timeout,
            )
            command = parse_llm_output(result.text)
        except EngineOverloaded as e:
            return 503, error_body(f"Server overloaded: {e}")
        except RequestQuarantined as e:
            return 410, error_body(f"Request quarantined: {e}")
        except EngineUnavailable as e:
            return 503, error_body(f"Engine not available: {e}")
        except (GenerationTimeout, asyncio.TimeoutError):
            return 504, error_body("LLM request timed out")
        except UnsafeCommandError as e:
            logger.error("Engine generated unsafe command: %s", e)
            return 422, error_body(f"LLM generated unsafe command: {e}")
        except Exception:
            logger.exception("Unexpected error processing query %r",
                             sanitized)
            return 500, error_body(
                "Internal server error processing request")
        return 200, {
            "kubectl_command": command,
            "execution_result": None,
            "execution_error": None,
            "from_cache": False,
            "metadata": {
                "start_time": start_iso,
                "end_time": utcnow_iso(),
                "duration_ms": (time.monotonic() - t0) * 1000.0,
                "success": True,
                "error_type": None,
                "error_code": None,
            },
            "engine_metadata": {
                "queue_ms": result.queue_ms,
                "prefill_ms": result.prefill_ms,
                "decode_ms": result.decode_ms,
                "detok_ms": result.detok_ms,
                "ttft_ms": result.ttft_ms,
                "prompt_tokens": result.prompt_tokens,
                "completion_tokens": result.completion_tokens,
                "tokens_per_sec": result.tokens_per_sec,
                "prefix_cache_hit": result.prefix_cache_hit,
                "engine": result.engine,
            },
            "degraded": result.degraded,
            "timings": None,
        }
