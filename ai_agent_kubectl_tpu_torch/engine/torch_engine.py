"""TorchEngine — the local GPU inference engine behind the service seam.

The counterpart of the JAX package's ``engine/jax_engine.py``: it holds
what every engine of the port shares — the constructor's knobs, the
tokenizer and the weights (``_load``: random init from ``seed``), the
``start``/``stop`` lifecycle and the ``Engine`` protocol surface. The
continuous-batching engine (``engine/batcher.py::BatchedTorchEngine``)
builds on it and is what serves.

The single-sequence generation path (``DECODE_BATCH_SIZE=1``: a dense
per-request cache with flash prefill) belongs to a later slice of the
port; asking this class to generate raises ``NotImplementedError``.

Everything runs on ``device`` — ``cuda`` unless the caller asks for the
CPU, as the tests do. A CUDA request with no card raises
(``device.resolve_device``); nothing moves to the CPU on its own.
"""

from __future__ import annotations

import asyncio
import logging
from typing import AsyncIterator, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig
from ..models.transformer import Params, init_params
from .protocol import EngineResult
from .tokenizer import Tokenizer, load_tokenizer

logger = logging.getLogger(__name__)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


class TorchEngine:
    name = "torch"

    def __init__(
        self,
        model_cfg: ModelConfig,
        *,
        tokenizer: Optional[Tokenizer] = None,
        params: Optional[Params] = None,
        model_path: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        dtype: str = "bfloat16",
        max_seq_len: int = 1024,
        prefill_buckets: tuple = (64, 128, 256, 512, 1024),
        top_k: int = 0,
        top_p: float = 1.0,
        prefix_cache: bool = True,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        if model_cfg.is_moe:
            raise NotImplementedError(
                "MoE models wait for a later slice of the port")
        if model_path:
            raise NotImplementedError(
                "loading a checkpoint (MODEL_PATH) waits for a later slice "
                "of the port; leave it unset to serve random weights")
        if dtype not in DTYPES:
            raise ValueError(f"DTYPE must be one of {sorted(DTYPES)}, got "
                             f"{dtype!r}")
        if top_k < 0 or not (0.0 < top_p <= 1.0):
            raise ValueError(
                f"TOP_K must be >= 0 and TOP_P in (0, 1], got "
                f"{top_k}/{top_p}")
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        self.tokenizer_path = tokenizer_path
        self.dtype = DTYPES[dtype]
        self.max_seq_len = min(max_seq_len, model_cfg.max_seq_len)
        self.prefill_buckets = tuple(
            b for b in sorted(prefill_buckets) if b <= self.max_seq_len
        ) or (self.max_seq_len,)
        self.top_k = top_k
        self.top_p = top_p
        self.use_prefix_cache = prefix_cache
        self.seed = seed
        self.tokenizer = tokenizer
        self.params = params
        self.weights_version = ""
        self._ready = False

    # ------------------------------------------------------------ startup

    @property
    def ready(self) -> bool:
        return self._ready

    async def start(self) -> None:
        await asyncio.to_thread(self._start_blocking)
        self._ready = True

    def _start_blocking(self) -> None:
        self._load()
        raise NotImplementedError(
            "the single-sequence engine (DECODE_BATCH_SIZE=1: dense cache "
            "and flash prefill) waits for a later slice of the port; serve "
            "with DECODE_BATCH_SIZE > 1")

    def _load(self) -> None:
        """Tokenizer and weights: the caller's parameters, else a random
        init drawn from a ``torch.Generator`` seeded with ``seed`` on the
        serving device."""
        if self.tokenizer is None:
            self.tokenizer = load_tokenizer(self.model_cfg,
                                            self.tokenizer_path)
        if self.params is None:
            logger.warning("No MODEL_PATH; random-initializing %s on %s "
                           "(seed %d)", self.model_cfg.name, self.device,
                           self.seed)
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.params = init_params(gen, self.model_cfg, dtype=self.dtype,
                                      device=self.device)
            self.weights_version = (f"dev:{self.model_cfg.name}:"
                                    f"seed={self.seed}")

    async def stop(self, drain_secs: float = 0.0) -> None:
        self._ready = False

    # ------------------------------------------------------------ serving

    async def generate(self, prompt: str, *, max_tokens: int = 128,
                       temperature: float = 0.0,
                       timeout: Optional[float] = None,
                       seed: Optional[int] = None) -> EngineResult:
        result: Optional[EngineResult] = None
        async for event, payload in self._stream_events(
                prompt, max_tokens=max_tokens, temperature=temperature,
                timeout=timeout, seed=seed):
            if event == "done":
                result = payload
        assert result is not None
        return result

    async def generate_stream(self, prompt: str, *, max_tokens: int = 128,
                              temperature: float = 0.0,
                              timeout: Optional[float] = None,
                              seed: Optional[int] = None
                              ) -> AsyncIterator[str]:
        async for event, payload in self._stream_events(
                prompt, max_tokens=max_tokens, temperature=temperature,
                timeout=timeout, seed=seed):
            if event == "token":
                yield payload

    async def _stream_events(self, prompt: str, *, max_tokens: int,
                             temperature: float, timeout: Optional[float],
                             seed: Optional[int] = None):
        raise NotImplementedError(
            "the single-sequence engine waits for a later slice of the "
            "port")
        yield  # pragma: no cover - makes this an async generator


def engine_kwargs(cfg) -> dict:
    """Constructor keywords every engine of the port takes, from the
    service config."""
    return dict(
        model_path=cfg.model_path,
        tokenizer_path=cfg.tokenizer_path,
        dtype=cfg.dtype,
        max_seq_len=cfg.max_seq_len,
        prefill_buckets=cfg.prefill_bucket_list,
        top_k=cfg.top_k,
        top_p=cfg.top_p,
        prefix_cache=cfg.hbm_prefix_cache,
        device=cfg.torch_device,
    )
