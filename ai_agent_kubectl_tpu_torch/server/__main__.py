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

Rank 0 stops as the JAX entry point does (``_serve``): on SIGTERM or
SIGINT the listening socket stays open while the engine drains for up
to ``DRAIN_TIMEOUT_SECS`` (``/health`` answers 503: the engine is not
ready), a second signal cuts the drain short (``engine.stop(0)``), and
only then is the site torn down.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
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
    asyncio.run(_serve(cfg, create_app(cfg, engine), logger))
    if distributed.world_size() > 1:
        distributed.HANDS.stop()
        print(json.dumps(distributed.report()), flush=True)
        distributed.shutdown()


async def _serve(cfg: ServiceConfig, app: web.Application, logger) -> None:
    """Serve ``app`` until SIGTERM or SIGINT, then drain with the socket
    open: ``engine.stop(drain_secs=DRAIN_TIMEOUT_SECS)`` lets in-flight
    requests finish while ``/health`` answers 503, so a load balancer
    takes this process out of rotation instead of meeting a refused
    connection (``web.run_app`` closes the socket before any shutdown
    hook runs). A second signal stops the engine at once. The runner's
    cleanup comes last; its engine stop is a no-op by then."""
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()

    stop_ev = asyncio.Event()
    force_ev = asyncio.Event()
    loop = asyncio.get_running_loop()

    def on_signal() -> None:
        # The first signal starts the drain, the second cuts it short.
        (force_ev if stop_ev.is_set() else stop_ev).set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, on_signal)
    await stop_ev.wait()
    logger.info("Shutdown signal: draining (up to %.0fs) while still "
                "answering health checks; signal again to skip the drain",
                cfg.drain_timeout_secs)
    engine = app["service"].engine
    drain = asyncio.ensure_future(
        engine.stop(drain_secs=cfg.drain_timeout_secs))
    force = asyncio.ensure_future(force_ev.wait())
    done, _ = await asyncio.wait({drain, force},
                                 return_when=asyncio.FIRST_COMPLETED)
    if drain not in done:
        logger.warning("Second signal: aborting drain, stopping now")
        try:
            # stop(0) ends what is still in flight, so the draining
            # stop() returns promptly too.
            await engine.stop(drain_secs=0.0)
        except Exception:
            logger.exception("force stop failed; awaiting original drain")
    force.cancel()
    try:
        # The drain's outcome is always read: a failing stop() is
        # logged, and the teardown goes on.
        await drain
    except Exception:
        logger.exception("engine drain/stop failed during shutdown")
    await runner.cleanup()


if __name__ == "__main__":
    main()
