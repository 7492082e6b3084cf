"""Device-resident prefix-KV cache for the shared system prompt.

The counterpart of the JAX package's ``engine/prefix_cache.py``: the KV
states of the shared system prompt (``engine/prompts.py::SYSTEM_PROMPT``,
which begins every request's prompt) are prefilled once at engine start;
each single-sequence request then

1. copies the cached prefix K/V into its fresh cache's slots ``[0:P)``
   (no model FLOPs), and
2. prefills only its own suffix at absolute positions ``P..`` — correct
   by construction, because RoPE and the causal mask take absolute
   positions.

Hit condition: the tokenized prompt strictly starts with the cached
prefix ids (token ids, not strings: a tokenizer may merge across the
boundary, and then the prompt simply misses).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import torch

from ..ops.quant import QuantKV


@dataclasses.dataclass
class PrefixKV:
    """Precomputed KV state of a token prefix.

    k, v: [n_layers, 1, P, n_kv_heads, head_dim] — trimmed to the true
    prefix length P (no padding garbage; a splice copies exactly P slots).
    Under ``KV_QUANT=int8`` each is a ``QuantKV`` (int8 payload of that
    shape, f32 scales [n_layers, 1, P, n_kv_heads]).
    """

    ids: List[int]
    k: Union[torch.Tensor, QuantKV]
    v: Union[torch.Tensor, QuantKV]

    @property
    def n(self) -> int:
        return len(self.ids)

    def matches(self, prompt_ids: Sequence[int]) -> bool:
        """True when ``prompt_ids`` strictly extends the cached prefix."""
        n = self.n
        return len(prompt_ids) > n and list(prompt_ids[:n]) == self.ids


def round_kv_limit(needed: int, max_seq: int,
                   tile: int = 128) -> Optional[int]:
    """Smallest multiple of ``tile`` >= needed, capped at max_seq; None if
    the needed span exceeds the cache. Rounding keeps a suffix prefill's
    span flash-tileable (the extra slots are never attended)."""
    if needed > max_seq:
        return None
    rounded = -(-needed // tile) * tile
    return min(rounded, max_seq)
