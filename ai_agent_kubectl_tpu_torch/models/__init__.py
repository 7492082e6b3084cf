"""Model families: one parameterized decoder-only transformer (RMSNorm +
RoPE + GQA + gated MLP) covering Gemma and Llama geometries, over the
block-paged KV pool or a dense per-request cache."""

from .config import ModelConfig, get_config, list_configs  # noqa: F401
