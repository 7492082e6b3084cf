"""Inference engine layer: the ``Engine`` protocol (``protocol.py``) and
its PyTorch implementation — ``batcher.BatchedTorchEngine``, continuous
batching over the block-paged KV pool and the ragged attention kernel,
built on ``torch_engine.TorchEngine`` (tokenizer, weights, lifecycle)."""

from .protocol import Engine, EngineResult, EngineUnavailable, GenerationTimeout  # noqa: F401
