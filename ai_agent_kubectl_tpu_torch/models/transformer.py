"""Decoder-only transformer over the block-paged KV pool, in PyTorch.

The counterpart of the JAX package's ``models/transformer.py``, pool
path only:

- Parameters are a plain dict of tensors with the JAX tree's keys and
  shapes (per-layer weights stacked on a leading ``n_layers`` axis), so
  ``models/convert.py::params_from_jax`` maps one onto the other.
- ``forward`` loops over the layers in Python where the JAX version runs
  ``lax.scan``.
- The KV pool is updated IN PLACE (the JAX version returns a new pool);
  ``forward`` returns the same ``KVCache`` object it was given.
- Attention is ``ops/ragged_attention.py::ragged_attention_pool``: the
  Hopper kernel for CUDA tensors, its plain version for CPU tensors.

The dense per-slot cache, MoE, quantized weights and KV, and the mesh and
pipeline paths belong to later slices: asking for them raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.norms import rms_norm
from ..ops.ragged_attention import ragged_attention_pool
from ..ops.rope import rope_tables, rotate
from .config import ModelConfig

Params = Dict[str, object]


@dataclasses.dataclass
class KVCache:
    """Block-paged KV pool.

    k, v: [n_layers, n_blocks + 1, page, n_kv_heads, head_dim]. The last
          block is a trash block that nothing reads: writes of masked rows
          and of unmapped (sentinel) pages land there, so the scatter never
          needs a host-side filter. ``n_blocks`` counts only the real
          blocks. Per-slot lengths are host truth in the scheduler, so
          the pool carries none (the JAX cache's ``lengths`` leaf is
          structural only in pool mode).
    """

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def pool(cls, cfg: ModelConfig, n_blocks: int, page: int, *,
             dtype=torch.bfloat16, device=None) -> "KVCache":
        """A zeroed pool (the JAX pool starts zeroed too)."""
        shape = (cfg.n_layers, n_blocks + 1, page, cfg.n_kv_heads,
                 cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def n_blocks(self) -> int:
        return self.k.shape[1] - 1

    @property
    def page(self) -> int:
        return self.k.shape[2]


# ----------------------------------------------------------------- init

def init_params(generator: torch.Generator, cfg: ModelConfig,
                dtype=torch.bfloat16, device=None) -> Params:
    """Random init (scaled normal, drawn in float32 from ``generator``)
    with the JAX tree's keys and shapes. The draws differ from
    ``jax.random``'s; parity tests map one tree onto the other with
    ``params_from_jax`` instead."""
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE models wait for a later slice of the port")

    def dense(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * scale
        return w.to(dtype)

    def norm(shape):
        fill = torch.zeros if cfg.rms_offset else torch.ones
        return fill(shape, dtype=dtype, device=device)

    d, hd, H, KV, F_, L = (cfg.dim, cfg.head_dim, cfg.n_heads,
                           cfg.n_kv_heads, cfg.mlp_hidden, cfg.n_layers)
    s_in = d ** -0.5
    layers = {
        "attn_norm": norm((L, d)),
        "wq": dense((L, d, H * hd), s_in),
        "wk": dense((L, d, KV * hd), s_in),
        "wv": dense((L, d, KV * hd), s_in),
        "wo": dense((L, H * hd, d), (H * hd) ** -0.5),
        "mlp_norm": norm((L, d)),
        "w_gate": dense((L, d, F_), s_in),
        "w_up": dense((L, d, F_), s_in),
        "w_down": dense((L, F_, d), F_ ** -0.5),
    }
    params: Params = {
        "embed": dense((cfg.vocab_size, d), 1.0),
        "layers": layers,
        "final_norm": norm((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size), s_in)
    return params


# ----------------------------------------------------- block-paged pool

def _pool_flat_pos(tables: torch.Tensor, positions: torch.Tensor,
                   page: int, n_blocks: int,
                   write_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, S] flat pool-row index per token. Unmapped pages (sentinel
    entries, or a position past the table) and masked rows point at the
    trash block's first row (``n_blocks * page``)."""
    pos = positions.long()
    pg = pos // page
    max_pages = tables.shape[1]
    # torch.gather raises on an out-of-range index where JAX clamps:
    # clamp, then send the row to the trash block.
    blk = torch.gather(tables.long(), 1, pg.clamp(0, max_pages - 1))
    trash = n_blocks * page
    flat = blk * page + pos % page
    dead = (blk >= n_blocks) | (blk < 0) | (pg >= max_pages)
    if write_mask is not None:
        wm = write_mask if write_mask.dim() == 2 else write_mask[:, None]
        dead = dead | ~wm
    return torch.where(dead, torch.full_like(flat, trash), flat)


def _pool_scatter(leaf: torch.Tensor, flat: torch.Tensor,
                  updates: torch.Tensor) -> None:
    """Write [B, S, KV, hd] updates into one layer's pool
    [n_blocks + 1, page, KV, hd] at flat rows, in place."""
    nb1, page = leaf.shape[0], leaf.shape[1]
    f = leaf.view(nb1 * page, *leaf.shape[2:])
    f.index_copy_(0, flat.reshape(-1),
                  updates.reshape(-1, *leaf.shape[2:]).to(leaf.dtype))


# -------------------------------------------------------------- blocks

def _activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _dense_mlp(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    gate = _activation(cfg, x @ lp["w_gate"])
    return (gate * (x @ lp["w_up"])) @ lp["w_down"]


def _layer(cfg: ModelConfig, h: torch.Tensor, lp: Dict[str, torch.Tensor],
           layer_k: torch.Tensor, layer_v: torch.Tensor, rope: tuple,
           flat: torch.Tensor, pos0: torch.Tensor, block_tables: torch.Tensor,
           q_lens: torch.Tensor) -> torch.Tensor:
    """One transformer block over the pool: the window's K/V are written
    through the block table first (at the flat pool rows ``flat``), then
    the ragged kernel reads context and window together through the same
    table."""
    B, S, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = rms_norm(h, lp["attn_norm"], cfg.rms_eps, cfg.rms_offset)
    q = rotate((x @ lp["wq"]).view(B, S, H, hd), *rope)
    k = rotate((x @ lp["wk"]).view(B, S, KV, hd), *rope)
    v = (x @ lp["wv"]).view(B, S, KV, hd)
    _pool_scatter(layer_k, flat, k)
    _pool_scatter(layer_v, flat, v)
    n_blocks = layer_k.shape[0] - 1
    attn = ragged_attention_pool(
        q.contiguous(), layer_k[:n_blocks], layer_v[:n_blocks], q_lens,
        pos0, block_tables, page_size=layer_k.shape[1])
    h = h + attn.reshape(B, S, H * hd) @ lp["wo"]
    x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps, cfg.rms_offset)
    return h + _dense_mlp(cfg, lp, x)


# -------------------------------------------------------------- forward

def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,               # [B, S] int
    positions: torch.Tensor,            # [B, S] int absolute positions
    cache: KVCache,
    *,
    attn_impl: str = "ragged",
    logits_at: Optional[torch.Tensor] = None,   # [B]: logits at one column
    write_mask: Optional[torch.Tensor] = None,  # [B] or [B, S] bool
    block_tables: Optional[torch.Tensor] = None,  # [B, max_pages] int32
    q_lens: Optional[torch.Tensor] = None,      # [B] int32 valid columns
) -> Tuple[torch.Tensor, KVCache]:
    """Run the model over a token window through the pool. Returns
    (logits [B, S or 1, vocab] float32, cache) with the pool updated in
    place.

    ``q_lens`` (default: all S columns) is each row's valid prefix: 1 for
    decode, a span for prefill, 0 freezes the row. ``write_mask`` gates
    the KV writes per row or per token. ``logits_at`` gathers each row's
    hidden state at one column BEFORE the LM head, returning
    [B, 1, vocab]."""
    if block_tables is None:
        raise NotImplementedError(
            "the dense per-slot KV cache waits for a later slice of the "
            "port; pass block_tables (block-paged pool)")
    if attn_impl != "ragged":
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} waits for a later slice of the "
            f"port; the pool path runs 'ragged'")
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE models wait for a later slice of the port")
    B, S = tokens.shape
    if q_lens is None:
        q_lens = torch.full((B,), S, dtype=torch.int32,
                            device=tokens.device)
    q_lens = q_lens.to(torch.int32).contiguous()
    tables = block_tables.to(torch.int32).contiguous()

    h = params["embed"][tokens.long()].to(params["final_norm"].dtype)
    if cfg.embed_scale:
        # The scale rounds to the activation dtype before it multiplies,
        # as in the JAX forward (a host-side scalar: no device copy).
        h = h * torch.tensor(cfg.dim ** 0.5, dtype=h.dtype).item()
    # Layer-invariant inputs, computed once: the rotary tables, the flat
    # pool row of every window token, each row's first position.
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    flat = _pool_flat_pos(tables, positions, cache.page, cache.n_blocks,
                          write_mask)
    pos0 = positions[:, 0].to(torch.int32).contiguous()
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        h = _layer(cfg, h, lp, cache.k[i], cache.v[i], rope, flat, pos0,
                   tables, q_lens)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps, cfg.rms_offset)
    if logits_at is not None:
        h = h[torch.arange(B, device=h.device), logits_at.long()][:, None]
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(h.dtype).T
    else:
        logits = h @ params["lm_head"]
    return logits.float(), cache
