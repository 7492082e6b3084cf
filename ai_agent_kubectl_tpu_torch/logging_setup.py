"""Logging configuration and the structured JSON mode (a copy of the
JAX package's ``logging_setup.py``).

``LOG_FORMAT=text`` (default) keeps the human format. ``LOG_FORMAT=json``
emits one JSON object per line — timestamp, level, logger, message, and
the active request ID from the trace context (obs/trace.py), the hashed
tenant and lane of the request's QoS context, and the open incident's
id — so a slow request found in the flight recorder, its ledger row and
its log lines meet on the same keys. The request-ID filter is installed
in BOTH modes (text lines append a ``[rid]`` suffix when a trace is
active).
"""

from __future__ import annotations

import datetime
import json
import logging

from .engine.qos import current_qos
from .obs.incidents import current_incident_id
from .obs.ledger import hash_tenant
from .obs.trace import current_trace


class RequestIdFilter(logging.Filter):
    """Stamp every record with the active request's ID (or None), plus
    its QoS classification: the lane verbatim (a closed three-value
    set) and the tenant HASHED (obs/ledger.py hash_tenant — the raw key
    may be an API key, and the hash is the same form the goodput
    ledger's /debug/ledger tenant table uses, so a log grep and a
    ledger row join on one opaque key).

    A Filter rather than a Formatter concern so ``record.request_id``
    exists even for records a third-party formatter renders."""

    def filter(self, record: logging.LogRecord) -> bool:
        trace = current_trace()
        record.request_id = trace.request_id if trace is not None else None
        qctx = current_qos()
        record.tenant = hash_tenant(qctx.tenant) if qctx is not None \
            else None
        record.lane = qctx.lane if qctx is not None else None
        # Incident join: while an incident's stamp window is
        # open, every line carries its id — the same join pattern as
        # the hashed tenant, so a /debug/incidents bundle and a log
        # grep meet on one key post-hoc.
        record.incident_id = current_incident_id()
        return True


class JsonFormatter(logging.Formatter):
    """One JSON object per line; stdlib only."""

    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": datetime.datetime.fromtimestamp(
                record.created, tz=datetime.timezone.utc
            ).isoformat(),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
            "request_id": getattr(record, "request_id", None),
            # QoS classification: hashed tenant + lane, so log
            # lines join against the goodput ledger's tenant table.
            "tenant": getattr(record, "tenant", None),
            "lane": getattr(record, "lane", None),
            # Incident join: non-None while an incident's
            # stamp window is open — grep for it to collect the lines
            # around a /debug/incidents bundle.
            "incident_id": getattr(record, "incident_id", None),
        }
        if record.exc_info:
            entry["exc_info"] = self.formatException(record.exc_info)
        # default=repr: a bad interpolation argument must never take the
        # logging pipeline down with a serialization error.
        return json.dumps(entry, default=repr)


class TextFormatter(logging.Formatter):
    """The human format, plus a ``[rid]`` suffix when a trace is active."""

    def __init__(self) -> None:
        super().__init__("%(asctime)s - %(name)s - %(levelname)s - %(message)s")

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        rid = getattr(record, "request_id", None)
        return f"{line} [{rid}]" if rid else line


def setup_logging(level: str = "INFO", fmt: str = "text") -> logging.Logger:
    handler = logging.StreamHandler()
    handler.addFilter(RequestIdFilter())
    handler.setFormatter(JsonFormatter() if fmt == "json" else TextFormatter())
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        handlers=[handler],
        force=True,
    )
    return logging.getLogger("ai_agent_kubectl_tpu_torch")


def startup_warnings(cfg) -> None:
    """Key-presence warnings at startup, as the JAX package logs them."""
    logger = logging.getLogger("ai_agent_kubectl_tpu_torch")
    if not cfg.api_auth_key:
        logger.warning(
            "API_AUTH_KEY environment variable not set. API authentication is disabled."
        )
    if cfg.engine == "openai" and not cfg.openai_api_key:
        logger.error(
            "ENGINE=openai but OPENAI_API_KEY not set; engine will run degraded (503)."
        )
    if not cfg.debug_token:
        logger.info(
            "DEBUG_TOKEN not set: /debug/* endpoints are guarded only by "
            "API-key auth (when enabled)."
        )
