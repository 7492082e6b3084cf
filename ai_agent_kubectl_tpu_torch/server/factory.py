"""Engine selection from config.

``ENGINE=torch`` serves through the continuous-batching engine when
``DECODE_BATCH_SIZE`` > 1 (the default) and through the single-sequence
engine (``engine/torch_engine.py::TorchEngine``: dense cache, flash
prefill) at 1 — the JAX factory's rule; ``ENGINE=torch-batched`` always
batches. Both take ``QUANT``, ``KV_QUANT`` and ``MOE_IMPL``
(``engine_kwargs``).

On a construction failure the service starts degraded and answers 503
(as the JAX factory does): a misconfiguration keeps ``/health`` up and
explains itself instead of taking the process down.
"""

from __future__ import annotations

import logging

from ..engine.protocol import EngineResult, EngineUnavailable

logger = logging.getLogger(__name__)


class DegradedEngine:
    """Placeholder engine when construction failed: 503 on every call."""

    name = "degraded"
    ready = False
    device = None

    def __init__(self, reason: str):
        self.reason = reason

    async def start(self) -> None:
        logger.error("Engine degraded: %s", self.reason)

    async def stop(self, drain_secs: float = 0.0) -> None:
        pass

    async def generate(self, prompt, **kw) -> EngineResult:
        raise EngineUnavailable(self.reason)


def build_engine(cfg):
    try:
        if cfg.engine == "torch-batched" or cfg.decode_batch_size > 1:
            from ..engine.batcher import BatchedTorchEngine

            return BatchedTorchEngine.from_config(cfg)
        from ..engine.torch_engine import TorchEngine

        return TorchEngine.from_config(cfg)
    except Exception as e:
        logger.exception("Failed to initialize engine; starting degraded.")
        return DegradedEngine(f"engine init failed: {e}")
