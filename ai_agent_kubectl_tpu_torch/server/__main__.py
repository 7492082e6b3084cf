"""Server entry point: ``python -m ai_agent_kubectl_tpu_torch.server``.

Reads the environment (``ServiceConfig.from_env``), builds the engine
and serves until interrupted. ``TORCH_DEVICE=cpu`` runs on the CPU;
by default the engine runs on the CUDA card and refuses to start without
one.
"""

from __future__ import annotations

import logging

from aiohttp import web

from ..config import ServiceConfig
from .app import create_app
from .factory import build_engine


def main() -> None:
    cfg = ServiceConfig.from_env()
    logging.basicConfig(
        level=cfg.log_level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    logger = logging.getLogger("ai_agent_kubectl_tpu_torch.server")
    engine = build_engine(cfg)
    logger.info("Starting server on %s:%s (engine=%s, device=%s)",
                cfg.host, cfg.port, getattr(engine, "name", "?"),
                cfg.torch_device)
    web.run_app(create_app(cfg, engine), host=cfg.host, port=cfg.port,
                access_log=None)


if __name__ == "__main__":
    main()
