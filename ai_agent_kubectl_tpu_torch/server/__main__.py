"""Server entry point: ``python -m ai_agent_kubectl_tpu_torch.server``.

Reads the environment (``ServiceConfig.from_env``), builds the engine
and serves until interrupted. ``TORCH_DEVICE=cpu`` runs on the CPU;
by default the engine runs on the CUDA card and refuses to start without
one.

With ``COORDINATOR_ADDRESS`` (or ``DISTRIBUTED_INIT=true``) the process
first joins the process group (``parallel/distributed.py::
init_distributed``, as the JAX entry point does before any engine
touches a device; explicit ranks only when ``NUM_PROCESSES`` > 1). Rank
0 then serves HTTP; every other rank builds its engine's shards, binds
no port, follows rank 0's calls (``serve_follower``) until rank 0 stops,
and exits 0. Each rank prints its report last (one JSON line: rank,
calls, seconds posting them, kernel launches while serving and during
the engine's start).

``--devices cpu,cpu`` names this process's mesh devices, one per shard
(a device may repeat: ``cuda:0,cuda:0`` runs two shards on one card);
without it the mesh takes the distinct devices of the serving type.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from aiohttp import web

from ..config import ServiceConfig
from ..logging_setup import setup_logging, startup_warnings
from ..parallel import distributed
from .app import create_app
from .factory import _build_inner, build_engine


def join_group(cfg: ServiceConfig) -> bool:
    """The process group, before any engine touches a device, as the JAX
    entry point joins it: explicit ranks only when ``NUM_PROCESSES`` >
    1. Returns whether a group is up."""
    if not (cfg.distributed_init or cfg.coordinator_address):
        return False
    explicit = cfg.num_processes > 1
    return distributed.init_distributed(
        cfg.coordinator_address,
        cfg.num_processes if explicit else None,
        cfg.process_id if explicit else None,
        require=cfg.distributed_init)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m ai_agent_kubectl_tpu_torch"
                                 ".server")
    ap.add_argument("--devices", default="",
                    help="this process's mesh devices, comma-separated, "
                    "one per shard (may repeat); default: the distinct "
                    "devices of TORCH_DEVICE's type")
    args = ap.parse_args(argv)
    devices = [d.strip() for d in args.devices.split(",") if d.strip()] \
        or None
    cfg = ServiceConfig.from_env()
    # LOG_FORMAT=json: one JSON object per line, stamped with the
    # request ID, hashed tenant, lane and open incident.
    logger = setup_logging(cfg.log_level, cfg.log_format)
    startup_warnings(cfg)
    join_group(cfg)
    if not distributed.is_primary():
        # A follower: its shards and rank 0's calls, no HTTP. A failure
        # here ends the process (no degraded engine to answer for it).
        report = distributed.serve_follower(
            _build_inner(cfg, None, devices))
        print(json.dumps(report), flush=True)
        distributed.shutdown()
        return
    engine = build_engine(cfg, devices)
    logger.info("Starting server on %s:%s (engine=%s, device=%s)",
                cfg.host, cfg.port, getattr(engine, "name", "?"),
                cfg.torch_device)
    web.run_app(create_app(cfg, engine), host=cfg.host, port=cfg.port,
                access_log=None)
    if distributed.world_size() > 1:
        distributed.HANDS.stop()
        print(json.dumps(distributed.report()), flush=True)
        distributed.shutdown()


if __name__ == "__main__":
    main()
