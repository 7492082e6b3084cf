"""Typed environment-variable configuration for the port.

The knobs this slice reads, under the JAX package's environment variable
names and with its defaults, plus ``TORCH_DEVICE`` — the counterpart of
``JAX_PLATFORMS``: the server runs on ``cuda`` unless it is set to
``cpu``. The JAX package's knobs for features the port does not serve
yet are refused when set to anything but their default
(``UNSERVED_KNOBS``), so a deployment never silently gets less than it
asked for; the rest of them (QoS, SLOs, middleware) are not read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple


#: JAX-package knobs whose features wait for a later slice, with the
#: default that means "off".
UNSERVED_KNOBS = {
    "KV_QUANT": "", "SPEC_DECODE": "false",
    "GRAMMAR_DECODE": "false", "MESH_SHAPE": "", "DCN_MESH_SHAPE": "",
    "FLEET_SIZE": "1", "HOST_KV_BLOCKS": "0",
}


def _env_str(name: str, default: Optional[str]) -> Optional[str]:
    v = os.getenv(name)
    return v if v not in (None, "") else default


def _env_int(name: str, default: int) -> int:
    v = os.getenv(name)
    return int(v) if v not in (None, "") else default


def _env_float(name: str, default: float) -> float:
    v = os.getenv(name)
    return float(v) if v not in (None, "") else default


def _env_bool(name: str, default: bool) -> bool:
    v = os.getenv(name)
    if v in (None, ""):
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclass(frozen=True)
class ServiceConfig:
    """What the port's server and engine read."""

    log_level: str = "INFO"                 # LOG_LEVEL
    host: str = "0.0.0.0"                   # HOST
    port: int = 8000                        # PORT
    llm_timeout: float = 60.0               # LLM_TIMEOUT seconds

    # ENGINE: torch | torch-batched. "torch" serves through the
    # continuous-batching scheduler when DECODE_BATCH_SIZE > 1.
    engine: str = "torch"
    torch_device: str = "cuda"              # TORCH_DEVICE: cuda | cpu
    model_name: str = "toy-8m"              # MODEL_NAME (registry key)
    model_path: Optional[str] = None        # MODEL_PATH (not served yet)
    tokenizer_path: Optional[str] = None    # TOKENIZER_PATH
    dtype: str = "bfloat16"                 # DTYPE
    quant: str = ""                         # QUANT: "" | int8 | int4
    max_seq_len: int = 1024                 # MAX_SEQ_LEN
    max_new_tokens: int = 128               # MAX_NEW_TOKENS
    decode_batch_size: int = 8              # DECODE_BATCH_SIZE
    chunk_len: int = 16                     # CHUNK_LEN
    prefill_buckets: str = "64,128,256,512,1024"  # PREFILL_BUCKETS
    temperature: float = 0.0                # TEMPERATURE (0 = greedy)
    top_k: int = 0                          # TOP_K
    top_p: float = 1.0                      # TOP_P
    # Prefill attention of the single-sequence engine: auto = flash on
    # cuda, dense on the CPU.
    attn_impl: str = "auto"                 # ATTN_IMPL: auto | dense | flash
    # Decode attention of the batched engine: auto = paged for a GQA model
    # on cuda (the page raised to >= 64), dense otherwise.
    decode_attn: str = "auto"               # DECODE_ATTN: auto | dense | paged
    kv_page_size: int = 16                  # KV_PAGE_SIZE (dense KV ladder)
    # Ragged attention over the pool: auto = on in this port (the JAX
    # package turns it on only on its accelerator); off = the legacy
    # prefill ladder and the DECODE_ATTN decode over the pool.
    ragged_attention: str = "auto"          # RAGGED_ATTENTION: auto | on | off
    kv_pool: bool = True                    # KV_POOL (false = dense KV ladder)
    kv_pool_page: int = 16                  # KV_POOL_PAGE
    kv_pool_blocks: int = 0                 # KV_POOL_BLOCKS (0 = auto)
    radix_cache: bool = True                # RADIX_CACHE
    radix_lru_blocks: int = 0               # RADIX_LRU_BLOCKS (0 = auto)
    hbm_prefix_cache: bool = True           # HBM_PREFIX_CACHE
    max_queue_depth: int = 64               # MAX_QUEUE_DEPTH
    slot_health_check: bool = True          # SLOT_HEALTH_CHECK
    drain_timeout_secs: float = 10.0        # DRAIN_TIMEOUT_SECS

    def __post_init__(self):
        if self.engine not in ("torch", "torch-batched"):
            raise ValueError(f"ENGINE must be torch|torch-batched, got "
                             f"{self.engine!r}")
        if self.torch_device not in ("cuda", "cpu"):
            raise ValueError(f"TORCH_DEVICE must be cuda|cpu, got "
                             f"{self.torch_device!r}")
        if self.quant not in ("", "int8", "int4"):
            raise ValueError(f"QUANT must be ''|int8|int4, got "
                             f"{self.quant!r}")
        if self.attn_impl not in ("auto", "dense", "flash"):
            raise ValueError(f"ATTN_IMPL must be auto|dense|flash, got "
                             f"{self.attn_impl!r}")
        if self.decode_attn not in ("auto", "dense", "paged"):
            raise ValueError(f"DECODE_ATTN must be auto|dense|paged, got "
                             f"{self.decode_attn!r}")
        if self.kv_page_size < 1:
            raise ValueError(f"KV_PAGE_SIZE must be >= 1, got "
                             f"{self.kv_page_size}")
        if self.ragged_attention not in ("auto", "on", "off"):
            raise ValueError(f"RAGGED_ATTENTION must be auto|on|off, got "
                             f"{self.ragged_attention!r}")
        if self.ragged_attention == "on" and not self.kv_pool:
            raise ValueError(
                "RAGGED_ATTENTION=on requires KV_POOL=true (the ragged "
                "kernel reads per-slot block tables over the shared pool; "
                "the dense ladder has no ragged variant)")
        if self.kv_pool_page < 1 or 128 % self.kv_pool_page:
            raise ValueError(
                f"KV_POOL_PAGE must divide the 128-token tile "
                f"(8|16|32|64|128), got {self.kv_pool_page}")
        if self.kv_pool_blocks < 0 or self.radix_lru_blocks < 0:
            raise ValueError("KV_POOL_BLOCKS and RADIX_LRU_BLOCKS must be "
                             ">= 0 (0 = auto)")
        if self.decode_batch_size < 1 or self.chunk_len < 1:
            raise ValueError("DECODE_BATCH_SIZE and CHUNK_LEN must be >= 1")
        if self.top_k < 0 or not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"TOP_K must be >= 0 and TOP_P in (0, 1], got "
                             f"{self.top_k}/{self.top_p}")

    @property
    def prefill_bucket_list(self) -> Tuple[int, ...]:
        return tuple(sorted(int(b) for b in self.prefill_buckets.split(",")
                            if b.strip()))

    @classmethod
    def from_env(cls) -> "ServiceConfig":
        for name, off in UNSERVED_KNOBS.items():
            val = (os.getenv(name) or off).strip().lower()
            if val not in (off, "0", "false", "no", "off"):
                raise ValueError(f"{name}={os.getenv(name)!r} is not served "
                                 f"by the PyTorch port yet (ROADMAP.md, "
                                 f"queue A)")
        return cls(
            log_level=(_env_str("LOG_LEVEL", "INFO") or "INFO").upper(),
            host=_env_str("HOST", "0.0.0.0"),
            port=_env_int("PORT", 8000),
            llm_timeout=_env_float("LLM_TIMEOUT", 60.0),
            engine=(_env_str("ENGINE", "torch") or "torch").lower(),
            torch_device=(_env_str("TORCH_DEVICE", "cuda") or "cuda").lower(),
            model_name=_env_str("MODEL_NAME", "toy-8m"),
            model_path=_env_str("MODEL_PATH", None),
            tokenizer_path=_env_str("TOKENIZER_PATH", None),
            dtype=_env_str("DTYPE", "bfloat16"),
            quant=(_env_str("QUANT", "") or "").lower(),
            max_seq_len=_env_int("MAX_SEQ_LEN", 1024),
            max_new_tokens=_env_int("MAX_NEW_TOKENS", 128),
            decode_batch_size=_env_int("DECODE_BATCH_SIZE", 8),
            chunk_len=_env_int("CHUNK_LEN", 16),
            prefill_buckets=_env_str("PREFILL_BUCKETS",
                                     "64,128,256,512,1024"),
            temperature=_env_float("TEMPERATURE", 0.0),
            top_k=_env_int("TOP_K", 0),
            top_p=_env_float("TOP_P", 1.0),
            attn_impl=(_env_str("ATTN_IMPL", "auto") or "auto").lower(),
            decode_attn=(_env_str("DECODE_ATTN", "auto") or "auto").lower(),
            kv_page_size=_env_int("KV_PAGE_SIZE", 16),
            ragged_attention=(_env_str("RAGGED_ATTENTION", "auto")
                              or "auto").lower(),
            kv_pool=_env_bool("KV_POOL", True),
            kv_pool_page=_env_int("KV_POOL_PAGE", 16),
            kv_pool_blocks=_env_int("KV_POOL_BLOCKS", 0),
            radix_cache=_env_bool("RADIX_CACHE", True),
            radix_lru_blocks=_env_int("RADIX_LRU_BLOCKS", 0),
            hbm_prefix_cache=_env_bool("HBM_PREFIX_CACHE", True),
            max_queue_depth=_env_int("MAX_QUEUE_DEPTH", 64),
            slot_health_check=_env_bool("SLOT_HEALTH_CHECK", True),
            drain_timeout_secs=_env_float("DRAIN_TIMEOUT_SECS", 10.0),
        )
