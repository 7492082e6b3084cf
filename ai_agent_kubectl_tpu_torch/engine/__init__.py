"""Inference engine layer: the ``Engine`` protocol (``protocol.py``) and
its PyTorch implementations — ``torch_engine.TorchEngine``, one request at
a time over a dense cache with flash prefill (``DECODE_BATCH_SIZE=1``),
and ``batcher.BatchedTorchEngine``, continuous batching over the
block-paged KV pool and the ragged attention kernel, built on it."""

from .protocol import Engine, EngineResult, EngineUnavailable, GenerationTimeout  # noqa: F401
