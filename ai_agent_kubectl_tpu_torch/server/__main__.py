"""Server entry point: ``python -m ai_agent_kubectl_tpu_torch.server``.

Reads the environment (``ServiceConfig.from_env``), builds the engine
and serves until interrupted. ``TORCH_DEVICE=cpu`` runs on the CPU;
by default the engine runs on the CUDA card and refuses to start without
one.
"""

from __future__ import annotations

from aiohttp import web

from ..config import ServiceConfig
from ..logging_setup import setup_logging, startup_warnings
from .app import create_app
from .factory import build_engine


def main() -> None:
    cfg = ServiceConfig.from_env()
    # LOG_FORMAT=json: one JSON object per line, stamped with the
    # request ID, hashed tenant, lane and open incident.
    logger = setup_logging(cfg.log_level, cfg.log_format)
    startup_warnings(cfg)
    engine = build_engine(cfg)
    logger.info("Starting server on %s:%s (engine=%s, device=%s)",
                cfg.host, cfg.port, getattr(engine, "name", "?"),
                cfg.torch_device)
    web.run_app(create_app(cfg, engine), host=cfg.host, port=cfg.port,
                access_log=None)


if __name__ == "__main__":
    main()
