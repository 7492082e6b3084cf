"""Decoder-only transformer, in PyTorch.

The counterpart of the JAX package's ``models/transformer.py`` on its two
single-device KV layouts:

- **The block-paged pool** (``block_tables`` given): one shared pool
  [L, n_blocks + 1, page, KV, hd] read and written through per-slot block
  tables (the continuous-batching engine). Attention by ``attn_impl``:
  "ragged" (the default) is ``ops/ragged_attention.py::
  ragged_attention_pool`` for every window shape; "paged" with one query
  column is ``ops/paged_attention.py::paged_decode_attention_pool``;
  otherwise (the gather path) each slot's first ``kv_limit // page``
  pages are gathered into a contiguous view and read by flash (a
  prefill window under "flash") or the dense reference.
- **The dense per-slot cache** (``KVCache.zeros``): [L, B, max_seq + 1,
  KV, hd]; K/V are written at their absolute positions. "paged" with one
  query column is ``ops/paged_attention.py::paged_decode_attention``
  over ``cache[:, :max_seq]``; otherwise attention reads
  ``cache[:, :kv_limit]`` — ``ops/flash_attention.py::
  flash_attention_cached`` for a prefill window (``attn_impl="flash"``,
  S > 1), the dense reference otherwise (the single-sequence engine and
  the batched engine's dense KV ladder).

Shared by both:

- Parameters are a plain dict with the JAX tree's keys and shapes
  (per-layer weights stacked on a leading ``n_layers`` axis), so
  ``models/convert.py::params_from_jax`` maps one onto the other.
  Projection leaves may be plain tensors, ``QuantInt8`` or packed
  ``QuantInt4`` (``ops/quant.py::qmatmul`` dispatches per leaf; int4
  runs the Hopper kernel), the embedding plain or per-row int8.
- ``forward`` loops over the layers in Python where the JAX version runs
  ``lax.scan``, and updates the cache IN PLACE (the JAX version returns a
  new one); it returns the same ``KVCache`` object it was given.
- Each layout keeps one spare place that nothing reads (the pool's last
  block, the dense cache's last row): writes the JAX version drops (a
  masked row, an unmapped page, a position past the cache) land there,
  so the scatter never needs a host-side filter.
- A mixture-of-experts model (``cfg.is_moe``: Mixtral, ``toy-moe``)
  runs its MLP through ``parallel/moe.py::dense_moe`` in every regime
  of both layouts; ``moe_impl="ep"`` needs an expert mesh and raises.
- An int8 KV cache (``kv_quant="int8"``: ``ops/quant.py::QuantKV``
  leaves, scales starting at 1) is written through the same rows, the
  window's K/V quantized first (``kv_quantize``), and read by
  ``ops/attention.py::dense_attention_quant``: on the pool through the
  gather path, on the dense cache over ``cache[:, :kv_limit]``. None of
  the attention kernels reads int8 KV (nor does the JAX package's), so
  an int8 cache asked to attend through one of them raises.

- Under a ``model`` mesh of more than one shard (``mesh=``, the JAX
  forward's mesh on that axis) the forward runs tensor-parallel over
  per-shard weights and caches (``_forward_tp``): Megatron column/row
  splits, the f≈1 residual split, attention per shard on its own heads —
  the two pool kernels through their sharded wrappers.

Ring attention and the data, expert, pipe and seq axes belong to later
slices (ROADMAP.md A8): ``attn_impl="ring"`` raises
``NotImplementedError``, and an MoE model or ``moe_impl="ep"`` on a mesh
raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..obs.profiler import scope
from ..ops.attention import dense_attention, dense_attention_quant
from ..ops.flash_attention import flash_attention_cached
from ..ops.norms import rms_norm
from ..ops.paged_attention import (_pool_gather, paged_decode_attention,
                                   paged_decode_attention_pool)
from ..ops.paged_attention import paged_decode_attention_pool_sharded
from ..ops.quant import (QuantKV, ShardedKV, embed_lookup, kv_map,
                         kv_quantize, qmatmul, tied_head)
from ..ops.ragged_attention import (check_heads_divide,
                                    ragged_attention_pool,
                                    ragged_attention_pool_sharded)
from ..ops.rope import rope_tables, rotate
from ..parallel.collectives import all_gather, all_reduce, reduce_scatter
from ..parallel.moe import dense_moe
from ..parallel.sharding import head_layout, replicate, residual_split_dim
from .config import ModelConfig

Params = Dict[str, object]


@dataclasses.dataclass
class KVCache:
    """KV cache, in one of two layouts.

    Pool: k, v [n_layers, n_blocks + 1, page, n_kv_heads, head_dim]. The
          last block is a trash block that nothing reads: writes of
          masked rows and of unmapped (sentinel) pages land there.
          ``n_blocks`` counts only the real blocks. Per-slot lengths are
          host truth in the scheduler, so the pool carries none.
    Dense: k, v [n_layers, batch, max_seq + 1, n_kv_heads, head_dim].
          The last row of each slot is a trash row that nothing reads:
          writes at positions past ``max_seq`` (which the JAX cache
          drops) and masked rows land there. The engine keeps each
          slot's length on the host.

    Under ``kv_quant="int8"`` each of k and v is a ``QuantKV``: an int8
    payload of that shape and f32 scales without the head_dim axis, all
    1 at the start (as in the JAX package), trash block and rows
    included.
    """

    k: object
    v: object

    @staticmethod
    def _leaf(shape, dtype, device, kv_quant: str):
        if kv_quant == "int8":
            return QuantKV(q=torch.zeros(shape, dtype=torch.int8,
                                         device=device),
                           s=torch.ones(shape[:-1], dtype=torch.float32,
                                        device=device))
        if kv_quant:
            raise ValueError(f"KV_QUANT must be '' or 'int8', got "
                             f"{kv_quant!r}")
        return torch.zeros(shape, dtype=dtype, device=device)

    @classmethod
    def _kv(cls, cfg: ModelConfig, shape: tuple, dtype, device,
            kv_quant: str, mesh):
        """One zeroed K or V leaf: a tensor, or on a ``model`` mesh of
        more than one shard a ``ShardedKV`` of per-shard leaves (KV heads
        split where ``head_layout`` splits them, else a whole copy per
        shard), each allocated on its shard's device."""
        if mesh is None or mesh.tp <= 1:
            return cls._leaf(shape, dtype, device, kv_quant)
        split = head_layout(cfg, mesh.tp)[1]
        local = shape[:3] + ((shape[3] // mesh.tp if split else shape[3]),
                             shape[4])
        return ShardedKV(shards=[cls._leaf(local, dtype, d, kv_quant)
                                 for d in mesh.devices], heads_split=split)

    @classmethod
    def pool(cls, cfg: ModelConfig, n_blocks: int, page: int, *,
             dtype=torch.bfloat16, device=None,
             kv_quant: str = "", mesh=None) -> "KVCache":
        """A zeroed pool (the JAX pool starts zeroed too), split over
        ``mesh``'s shards when it has more than one."""
        shape = (cfg.n_layers, n_blocks + 1, page, cfg.n_kv_heads,
                 cfg.head_dim)
        return cls(k=cls._kv(cfg, shape, dtype, device, kv_quant, mesh),
                   v=cls._kv(cfg, shape, dtype, device, kv_quant, mesh))

    @classmethod
    def zeros(cls, cfg: ModelConfig, batch: int, max_seq: int, *,
              dtype=torch.bfloat16, device=None,
              kv_quant: str = "", mesh=None) -> "KVCache":
        """A zeroed dense per-slot cache of ``max_seq`` positions, split
        over ``mesh``'s shards when it has more than one."""
        shape = (cfg.n_layers, batch, max_seq + 1, cfg.n_kv_heads,
                 cfg.head_dim)
        return cls(k=cls._kv(cfg, shape, dtype, device, kv_quant, mesh),
                   v=cls._kv(cfg, shape, dtype, device, kv_quant, mesh))

    @property
    def sharded(self) -> bool:
        return isinstance(self.k, ShardedKV)

    def shard(self, i: int) -> "KVCache":
        """Shard ``i``'s own cache (the cache itself when unsharded)."""
        if not self.sharded:
            return self
        return KVCache(k=self.k.shards[i], v=self.v.shards[i])

    @property
    def quantized(self) -> bool:
        if self.sharded:
            return self.k.quantized
        return isinstance(self.k, QuantKV)

    @property
    def nbytes(self) -> int:
        """Bytes of both leaves (payload and scales, every shard)."""
        return self.k.nbytes + self.v.nbytes

    @property
    def n_blocks(self) -> int:
        return self.k.shape[1] - 1

    @property
    def page(self) -> int:
        return self.k.shape[2]

    @property
    def max_seq(self) -> int:
        """Positions of a dense cache (its trash row excluded)."""
        return self.k.shape[2] - 1


# ----------------------------------------------------------------- init

def init_params(generator: torch.Generator, cfg: ModelConfig,
                dtype=torch.bfloat16, device=None) -> Params:
    """Random init (scaled normal, drawn in float32 from ``generator``)
    with the JAX tree's keys and shapes, MoE leaves included (``router``
    [L, D, E], ``w_gate``/``w_up`` [L, E, D, F], ``w_down`` [L, E, F,
    D]). The draws differ from ``jax.random``'s; parity tests map one
    tree onto the other with ``params_from_jax`` instead."""

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
    }
    if cfg.is_moe:
        E = cfg.n_experts
        layers["router"] = dense((L, d, E), s_in)
        layers["w_gate"] = dense((L, E, d, F_), s_in)
        layers["w_up"] = dense((L, E, d, F_), s_in)
        layers["w_down"] = dense((L, E, F_, d), F_ ** -0.5)
    else:
        layers["w_gate"] = dense((L, d, F_), s_in)
        layers["w_up"] = dense((L, d, F_), s_in)
        layers["w_down"] = dense((L, F_, d), F_ ** -0.5)
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


def _scatter_rows(leaf: torch.Tensor, flat: torch.Tensor,
                  updates: torch.Tensor) -> torch.Tensor:
    """Write [B, S, ...] updates into one layer's cache leaf, viewed as
    rows [leaf.shape[0] * leaf.shape[1], ...], at flat row indices, in
    place (the pool's and the dense cache's scatter alike; a ``QuantKV``
    scale leaf is served as it is, one axis shorter)."""
    f = leaf.view(leaf.shape[0] * leaf.shape[1], *leaf.shape[2:])
    f.index_copy_(0, flat.reshape(-1),
                  updates.reshape(-1, *leaf.shape[2:]).to(leaf.dtype))
    return leaf


def _write_kv(layer, flat: torch.Tensor, x: torch.Tensor) -> None:
    """The window's K or V [B, S, KV, hd] into one layer's cache at flat
    rows: quantized first when the layer is a ``QuantKV``."""
    if isinstance(layer, QuantKV):
        x = kv_quantize(x)
    kv_map(lambda leaf, upd: _scatter_rows(leaf, flat, upd), layer, x)


def _attend_read(q, k_ctx, v_ctx, mask) -> torch.Tensor:
    """The dense read over a contiguous context: the int8 span through
    ``dense_attention_quant``, a plain one through ``dense_attention``."""
    if isinstance(k_ctx, QuantKV):
        return dense_attention_quant(q, k_ctx.q, k_ctx.s, v_ctx.q, v_ctx.s,
                                     mask)
    return dense_attention(q, k_ctx, v_ctx, mask)


# ---------------------------------------------------- dense per-slot KV

def _dense_flat_pos(positions: torch.Tensor, max_seq: int,
                    write_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, S] flat row index into a layer's [B * (max_seq + 1)] rows:
    the absolute position in the slot's region, or the slot's trash row
    (``max_seq``) for positions outside the cache and masked rows."""
    pos = positions.long()
    dead = (pos < 0) | (pos >= max_seq)
    if write_mask is not None:
        wm = write_mask if write_mask.dim() == 2 else write_mask[:, None]
        dead = dead | ~wm
    rows = torch.where(dead, torch.full_like(pos, max_seq), pos)
    base = torch.arange(pos.shape[0], device=pos.device)[:, None]
    return base * (max_seq + 1) + rows


# -------------------------------------------------------------- blocks

def _activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _dense_mlp(cfg: ModelConfig, lp: Dict[str, object],
               x: torch.Tensor) -> torch.Tensor:
    gate = _activation(cfg, qmatmul(x, lp["w_gate"]))
    return qmatmul(gate * qmatmul(x, lp["w_up"]), lp["w_down"])


def _moe_mlp(cfg: ModelConfig, lp: Dict[str, object], x: torch.Tensor,
             moe_impl: str) -> torch.Tensor:
    """The MoE MLP (the JAX ``_moe_mlp`` on one device, where no mesh is
    in scope): ``auto`` and ``dense`` evaluate every expert
    (``dense_moe``); ``ep``, the expert-parallel dispatch, needs a mesh
    and raises with the JAX message."""
    if moe_impl == "ep":
        raise ValueError(
            "MOE_IMPL=ep needs a mesh with an expert axis whose size "
            "divides tokens and experts (the port has no mesh yet: "
            "ROADMAP.md A8)")
    return dense_moe(cfg, lp, x)


#: (q, k, v, layer_k, layer_v) -> attention output [B, S, H, hd]; writes
#: the window's K/V into the layer's cache first.
Attend = Callable[..., torch.Tensor]


def _layer(cfg: ModelConfig, h: torch.Tensor, lp: Dict[str, object],
           layer_k: torch.Tensor, layer_v: torch.Tensor, rope: tuple,
           attend: Attend, moe_impl: str = "auto") -> torch.Tensor:
    """One transformer block: every projection through ``qmatmul``, the
    KV write and attention through ``attend`` (pool or dense), the MLP
    dense or mixture of experts."""
    B, S, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    with scope("attn_norm"):
        x = rms_norm(h, lp["attn_norm"], cfg.rms_eps, cfg.rms_offset)
    with scope("qkv_proj"):
        q = qmatmul(x, lp["wq"]).view(B, S, H, hd)
        k = qmatmul(x, lp["wk"]).view(B, S, KV, hd)
        v = qmatmul(x, lp["wv"]).view(B, S, KV, hd)
    with scope("rope"):
        q = rotate(q, *rope)
        k = rotate(k, *rope)
    attn = attend(q, k, v, layer_k, layer_v)
    with scope("o_proj"):
        h = h + qmatmul(attn.reshape(B, S, H * hd), lp["wo"])
    with scope("mlp"):
        x = rms_norm(h, lp["mlp_norm"], cfg.rms_eps, cfg.rms_offset)
        mlp = (_moe_mlp(cfg, lp, x, moe_impl) if cfg.is_moe
               else _dense_mlp(cfg, lp, x))
    return h + mlp


def _pool_attend(tokens: torch.Tensor, positions: torch.Tensor,
                 cache: KVCache, write_mask, block_tables, q_lens,
                 kv_limit: Optional[int], attn_impl: str) -> Attend:
    """The pool's K/V write and read for one forward: the window's K/V
    go through the block table first (at flat pool rows computed once),
    then attention reads context and window together through the same
    table — the ragged kernel, the paged decode kernel, or the gather
    path over the table's first ``kv_limit // page`` pages."""
    with scope("kv_write"):
        tables = block_tables.to(torch.int32).contiguous()
        flat = _pool_flat_pos(tables, positions, cache.page, cache.n_blocks,
                              write_mask)
    with scope("attention"):
        read = _pool_read(tokens, positions, cache, tables, q_lens,
                          kv_limit, attn_impl)

    def attend(q, k, v, layer_k, layer_v):
        with scope("kv_write"):
            _write_kv(layer_k, flat, k)
            _write_kv(layer_v, flat, v)
        with scope("attention"):
            return read(q, layer_k, layer_v)

    return attend


def _pool_read(tokens, positions, cache: KVCache, tables, q_lens,
               kv_limit: Optional[int], attn_impl: str):
    """The pool read's per-forward setup and its per-layer closure
    ``read(q, layer_k, layer_v)``."""
    B, S = tokens.shape
    pos0 = positions[:, 0].to(torch.int32).contiguous()
    if attn_impl == "ragged":
        if q_lens is None:
            q_lens = torch.full((B,), S, dtype=torch.int32,
                                device=tokens.device)
        q_lens = q_lens.to(torch.int32).contiguous()
    elif not (attn_impl == "paged" and S == 1):
        page = cache.page
        if kv_limit is None:
            kv_limit = tables.shape[1] * page
        if kv_limit % page or kv_limit > tables.shape[1] * page:
            raise ValueError(f"pool kv_limit {kv_limit} not a multiple of "
                             f"page {page} within the table's "
                             f"{tables.shape[1]} pages")
        n_pages = kv_limit // page
        mask = (torch.arange(kv_limit, device=positions.device)[None, None]
                <= positions.long()[:, :, None])
        pos32 = positions.to(torch.int32).contiguous()
        use_flash = attn_impl == "flash" and S > 1

    def read(q, layer_k, layer_v):
        n_blocks, page = layer_k.shape[0] - 1, layer_k.shape[1]
        if attn_impl == "ragged":
            return ragged_attention_pool(
                q.contiguous(), layer_k[:n_blocks], layer_v[:n_blocks],
                q_lens, pos0, tables, page_size=page)
        if attn_impl == "paged" and S == 1:
            return paged_decode_attention_pool(
                q[:, 0].contiguous(), layer_k[:n_blocks], layer_v[:n_blocks],
                pos0, tables, page_size=page)[:, None]
        k_ctx, v_ctx = (
            kv_map(lambda a: _pool_gather(a[:n_blocks], tables, n_pages), x)
            for x in (layer_k, layer_v))
        if use_flash:
            return flash_attention_cached(q, k_ctx, v_ctx, pos32)
        return _attend_read(q, k_ctx, v_ctx, mask)

    return read


def _dense_attend(tokens: torch.Tensor, positions: torch.Tensor,
                  cache: KVCache, write_mask, kv_limit: int,
                  attn_impl: str, page_size: int) -> Attend:
    """The dense cache's K/V write (at absolute positions) and read
    (``_dense_read``)."""
    with scope("kv_write"):
        flat = _dense_flat_pos(positions, cache.max_seq, write_mask)
    read = _dense_read(tokens, positions, kv_limit, attn_impl, page_size)

    def attend(q, k, v, layer_k, layer_v):
        with scope("kv_write"):
            _write_kv(layer_k, flat, k)
            _write_kv(layer_v, flat, v)
        with scope("attention"):
            return read(q, layer_k, layer_v)

    return attend


def _dense_read(tokens: torch.Tensor, positions: torch.Tensor,
                kv_limit: int, attn_impl: str, page_size: int):
    """The dense cache's per-forward read setup and its per-layer
    closure ``read(q, layer_k, layer_v)``: the paged decode kernel over
    ``cache[:, :max_seq]`` for a one-column window under "paged", else
    ``cache[:, :kv_limit]`` through flash for a prefill window or the
    dense reference."""
    S = tokens.shape[1]
    paged = attn_impl == "paged" and S == 1
    use_flash = attn_impl == "flash" and S > 1
    with scope("attention"):
        pos32 = positions.to(torch.int32).contiguous()
        if paged:
            pos0 = pos32[:, 0].contiguous()
        else:
            kv_pos = torch.arange(kv_limit, device=positions.device)
            mask = kv_pos[None, None, :] <= positions.long()[:, :, None]

    def read(q, layer_k, layer_v):
        if paged:
            S_alloc = layer_k.shape[1] - 1      # the trash row excluded
            return paged_decode_attention(
                q[:, 0].contiguous(), layer_k[:, :S_alloc],
                layer_v[:, :S_alloc], pos0, page_size=page_size)[:, None]
        k_ctx = layer_k[:, :kv_limit]
        v_ctx = layer_v[:, :kv_limit]
        if use_flash:
            return flash_attention_cached(q, k_ctx, v_ctx, pos32)
        return _attend_read(q, k_ctx, v_ctx, mask)

    return read


# ------------------------------------------------ tensor parallelism

def _tp_pool_reads(cfg: ModelConfig, tokens, positions, cache: KVCache,
                   tables, q_lens, kv_limit, attn_impl: str, mesh):
    """The pool's per-layer read over every shard: ``read(qs, lks, lvs)``
    -> per-shard outputs [B, S, H/tp, hd]. The two kernel paths go
    through the sharded wrappers (one launch per shard); the gather
    path runs ``_pool_read`` on each shard's own pool."""
    S = tokens.shape[1]
    if attn_impl == "ragged" or (attn_impl == "paged" and S == 1):
        check_heads_divide("ragged pool kernel" if attn_impl == "ragged"
                           else "pool paged kernel", cfg.n_heads,
                           cfg.n_kv_heads, mesh.tp)
    if attn_impl == "ragged":
        B = tokens.shape[0]
        ql = (torch.full((B,), S, dtype=torch.int32, device=tokens.device)
              if q_lens is None else q_lens.to(torch.int32).contiguous())
        pos0 = replicate(positions[:, 0].to(torch.int32).contiguous(), mesh)
        ql, tbl = replicate(ql, mesh), replicate(tables, mesh)

        def read(qs, lks, lvs):
            n_blocks, page = lks[0].shape[0] - 1, lks[0].shape[1]
            return ragged_attention_pool_sharded(
                [q.contiguous() for q in qs], [k[:n_blocks] for k in lks],
                [v[:n_blocks] for v in lvs], ql, pos0, tbl, mesh,
                page_size=page)
        return read
    if attn_impl == "paged" and S == 1:
        pos0 = replicate(positions[:, 0].to(torch.int32).contiguous(), mesh)
        tbl = replicate(tables, mesh)

        def read(qs, lks, lvs):
            n_blocks, page = lks[0].shape[0] - 1, lks[0].shape[1]
            outs = paged_decode_attention_pool_sharded(
                [q[:, 0].contiguous() for q in qs],
                [k[:n_blocks] for k in lks], [v[:n_blocks] for v in lvs],
                pos0, tbl, mesh, page_size=page)
            return [o[:, None] for o in outs]
        return read
    toks, poss, tbls = (replicate(t, mesh)
                        for t in (tokens, positions, tables))
    reads = [_pool_read(toks[i], poss[i], cache.shard(i), tbls[i], q_lens,
                        kv_limit, attn_impl) for i in range(mesh.tp)]
    return lambda qs, lks, lvs: [r(q, k, v) for r, q, k, v in
                                 zip(reads, qs, lks, lvs)]


def _tp_combine(partials, whole: bool, split_dim: Optional[int]):
    """A row-parallel product's per-shard partial sums joined into the
    residual's layout: reduce-scattered over the residual's split
    dimension, or all-reduced when the residual is replicated. A
    weight that did not split (``whole``) already gives every shard the
    full product: it is only cut to the residual's block."""
    if whole:
        if split_dim is None:
            return partials
        tp = len(partials)
        return [p.chunk(tp, dim=split_dim)[i].contiguous()
                for i, p in enumerate(partials)]
    if split_dim is None:
        return all_reduce(partials)
    return reduce_scatter(partials, split_dim)


def _forward_tp(params, cfg: ModelConfig, tokens, positions,
                cache: KVCache, *, mesh, kv_limit, attn_impl, page_size,
                logits_at, write_mask, block_tables, q_lens):
    """``forward`` over a ``model`` mesh of more than one shard (the JAX
    forward under a mesh, one controller over per-shard tensors):

    - ``params`` is ``parallel/sharding.py::shard_params``'s per-shard
      trees, ``cache`` a ``KVCache`` of ``ShardedKV`` leaves;
    - wq/wk/wv and w_gate/w_up run column-parallel on each shard, wo and
      w_down row-parallel, their partial sums joined by the collectives
      of ``parallel/collectives.py``;
    - the residual follows the f≈1 policy (``residual_spec``): split
      over the batch rows (decode) or the sequence (prefill) — a
      reduce-scatter after each row-parallel product, an all-gather
      before each column-parallel one — else replicated;
    - attention runs per shard on the shard's heads (``head_layout``):
      the pool kernels through the sharded wrappers, every other read
      on each shard's own cache;
    - the vocab-sharded embedding looks up each shard's rows and sums
      them; the head's logits gather over the vocab on the first
      shard's device, where the logits are returned.
    """
    tp = mesh.tp
    B, S = tokens.shape
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dim
    q_split, kv_split = head_layout(cfg, tp)
    H_l = H // tp if q_split else H
    KV_l = KV // tp if kv_split else KV
    split = residual_split_dim(mesh, (B, S, d))

    if block_tables is not None:
        tables = block_tables.to(torch.int32).contiguous()
        with scope("kv_write"):
            flat = _pool_flat_pos(tables, positions, cache.page,
                                  cache.n_blocks, write_mask)
        with scope("attention"):
            read = _tp_pool_reads(cfg, tokens, positions, cache, tables,
                                  q_lens, kv_limit, attn_impl, mesh)
    else:
        with scope("kv_write"):
            flat = _dense_flat_pos(positions, cache.max_seq, write_mask)
        toks, poss = replicate(tokens, mesh), replicate(positions, mesh)
        with scope("attention"):
            reads = [_dense_read(toks[i], poss[i], kv_limit, attn_impl,
                                 page_size) for i in range(tp)]

        def read(qs, lks, lvs):
            return [r(q, k, v) for r, q, k, v in zip(reads, qs, lks, lvs)]
    flats = replicate(flat, mesh)

    with scope("embed"):
        dt = params[0]["final_norm"].dtype
        emb = [p["embed"] for p in params]
        V_l = emb[0].shape[0]
        toks = replicate(tokens, mesh)
        if V_l != cfg.vocab_size:       # vocab rows split over the shards
            parts = []
            for i in range(tp):
                local = toks[i].long() - i * V_l
                inside = (local >= 0) & (local < V_l)
                e = embed_lookup(emb[i], local.clamp(0, V_l - 1), dtype=dt)
                parts.append(torch.where(inside[..., None], e,
                                         torch.zeros((), dtype=dt,
                                                     device=e.device)))
            h = _tp_combine(parts, False, split)
        else:
            h = _tp_combine([embed_lookup(emb[i], toks[i], dtype=dt)
                             for i in range(tp)], True, split)
        if cfg.embed_scale:
            c = torch.tensor(cfg.dim ** 0.5, dtype=dt).item()
            h = [x * c for x in h]
    with scope("rope"):
        rope = replicate(torch.stack(rope_tables(positions, hd,
                                                 cfg.rope_theta)), mesh)

    def gather(xs):
        return xs if split is None else all_gather(xs, split)

    layers = [p["layers"] for p in params]
    wo_whole = layers[0]["wo"].shape[1] == H * hd
    down_whole = layers[0]["w_down"].shape[1] == cfg.mlp_hidden
    for li in range(cfg.n_layers):
        lps = [{n: w[li] for n, w in lay.items()} for lay in layers]
        with scope("attn_norm"):
            xs = gather([rms_norm(x, lp["attn_norm"], cfg.rms_eps,
                                  cfg.rms_offset) for x, lp in zip(h, lps)])
        with scope("qkv_proj"):
            qs = [qmatmul(x, lp["wq"]).view(B, S, H_l, hd)
                  for x, lp in zip(xs, lps)]
            ks = [qmatmul(x, lp["wk"]).view(B, S, KV_l, hd)
                  for x, lp in zip(xs, lps)]
            vs = [qmatmul(x, lp["wv"]).view(B, S, KV_l, hd)
                  for x, lp in zip(xs, lps)]
        with scope("rope"):
            qs = [rotate(q, r[0], r[1]) for q, r in zip(qs, rope)]
            ks = [rotate(k, r[0], r[1]) for k, r in zip(ks, rope)]
        lks = [c.k[li] for c in (cache.shard(i) for i in range(tp))]
        lvs = [c.v[li] for c in (cache.shard(i) for i in range(tp))]
        with scope("kv_write"):
            for i in range(tp):
                _write_kv(lks[i], flats[i], ks[i])
                _write_kv(lvs[i], flats[i], vs[i])
        with scope("attention"):
            attn = read(qs, lks, lvs)
        with scope("o_proj"):
            outs = []
            for i, (a, lp) in enumerate(zip(attn, lps)):
                a = a.reshape(B, S, H_l * hd)
                rows = lp["wo"].shape[0]
                if not q_split and not wo_whole:
                    a = a[..., i * rows:(i + 1) * rows]
                outs.append(qmatmul(a, lp["wo"]))
            h = [x + o for x, o in zip(h, _tp_combine(outs, wo_whole,
                                                       split))]
        with scope("mlp"):
            xs = gather([rms_norm(x, lp["mlp_norm"], cfg.rms_eps,
                                  cfg.rms_offset) for x, lp in zip(h, lps)])
            outs = [_dense_mlp(cfg, lp, x) for x, lp in zip(xs, lps)]
            h = [x + o for x, o in zip(h, _tp_combine(outs, down_whole,
                                                       split))]
    h = gather(h)
    head = params[0].get("lm_head", emb[0])
    vocab_split = (head.shape[-1] if "lm_head" in params[0]
                   else head.shape[0]) != cfg.vocab_size
    shards = range(tp) if vocab_split else range(1)
    logits = []
    for i in shards:
        with scope("final_norm"):
            x = rms_norm(h[i], params[i]["final_norm"], cfg.rms_eps,
                         cfg.rms_offset)
        if logits_at is not None:
            x = x[torch.arange(B, device=x.device),
                  logits_at.to(x.device).long()][:, None]
        with scope("lm_head"):
            logits.append(tied_head(x, params[i]["embed"])
                          if cfg.tie_embeddings
                          else qmatmul(x, params[i]["lm_head"]))
    if vocab_split:
        logits = all_gather(logits, -1)
    return logits[0].to(mesh.devices[0]).float(), cache


# -------------------------------------------------------------- forward

def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,               # [B, S] int
    positions: torch.Tensor,            # [B, S] int absolute positions
    cache: KVCache,
    *,
    kv_limit: Optional[int] = None,     # attend over kv_limit positions
    attn_impl: Optional[str] = None,    # default: ragged (pool), dense
    token_mask: Optional[torch.Tensor] = None,  # [B, S]; 0 = padding
    page_size: int = 128,               # dense cache: page under "paged"
    moe_impl: str = "auto",             # MoE MLP: auto | dense (ep raises)
    logits_at: Optional[torch.Tensor] = None,   # [B]: logits at one column
    write_mask: Optional[torch.Tensor] = None,  # [B] or [B, S] bool
    block_tables: Optional[torch.Tensor] = None,  # [B, max_pages] int32
    q_lens: Optional[torch.Tensor] = None,      # [B] int32 valid columns
    mesh=None,                          # parallel/mesh.py::Mesh
) -> Tuple[torch.Tensor, KVCache]:
    """Run the model over a token window. Returns (logits [B, S or 1,
    vocab] float32, cache) with the cache updated in place.

    Pool mode (``block_tables``): ``attn_impl`` "ragged" (the default)
    reads through the ragged kernel, where ``q_lens`` (default: all S
    columns) is each row's valid prefix — 1 for decode, a span for
    prefill, 0 freezes the row; "paged" with S == 1 reads through the
    paged decode kernel; "dense" or "flash" (and "paged" with S > 1)
    gather the table's first ``kv_limit // page`` pages (default: every
    page). Dense mode (``attn_impl`` "dense", the default there,
    "flash" or "paged"): "paged" with S == 1 reads each slot's live
    pages of ``page_size`` from the whole cache; otherwise attention
    reads ``cache[:, :kv_limit]`` (default: the whole cache) under
    ``kv <= position``. ``write_mask`` gates the KV writes per row or per
    token in both. An MoE model runs ``dense_moe`` under ``moe_impl``
    "auto" or "dense" ("ep" raises). ``token_mask`` marks padding, as in
    the JAX signature, where only the expert-parallel dispatch reads it
    (to keep padding out of the experts' capacity); the dense
    evaluation, the port's only one, ignores it. ``logits_at`` gathers
    each row's hidden state at one column BEFORE the LM head, returning
    [B, 1, vocab]. An int8 cache (``QuantKV`` leaves) reads through the
    gather path or the dense read only: ``attn_impl`` "ragged", "paged"
    with one column and "flash" with several raise, their kernels
    reading bf16 KV."""
    del token_mask
    tp = mesh is not None and mesh.tp > 1
    if tp and cfg.is_moe:
        raise ValueError(
            "a mixture-of-experts model on a mesh is not served by the "
            "PyTorch port yet (ROADMAP.md A8)")
    if block_tables is not None:
        attn_impl = attn_impl or "ragged"
        if attn_impl not in ("ragged", "paged", "dense", "flash"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r} over the pool waits for a later "
                f"slice of the port (ragged, paged, dense and flash are "
                f"served)")
        if not tp:
            attend = _pool_attend(tokens, positions, cache, write_mask,
                                  block_tables, q_lens, kv_limit, attn_impl)
    else:
        attn_impl = attn_impl or "dense"
        if attn_impl not in ("dense", "flash", "paged"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r} over the dense cache waits for a "
                f"later slice of the port (dense, flash and paged are "
                f"served)")
        if kv_limit is None:
            kv_limit = cache.max_seq
        if not 0 < kv_limit <= cache.max_seq:
            raise ValueError(f"kv_limit {kv_limit} outside the cache's "
                             f"{cache.max_seq} positions")
        if not tp:
            attend = _dense_attend(tokens, positions, cache, write_mask,
                                   kv_limit, attn_impl, page_size)
    B, S = tokens.shape
    if cache.quantized and (attn_impl == "ragged"
                            or (attn_impl == "paged" and S == 1)
                            or (attn_impl == "flash" and S > 1)):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} does not read int8 KV (its kernel "
            f"reads bf16); the engines resolve KV_QUANT=int8 to the gather "
            f"path on the pool and the dense read on the dense cache")

    if tp:
        return _forward_tp(params, cfg, tokens, positions, cache,
                           mesh=mesh, kv_limit=kv_limit,
                           attn_impl=attn_impl, page_size=page_size,
                           logits_at=logits_at, write_mask=write_mask,
                           block_tables=block_tables, q_lens=q_lens)
    # final_norm is always a plain tensor in the model dtype: it anchors
    # the activation dtype when the embedding is stored int8.
    with scope("embed"):
        h = embed_lookup(params["embed"], tokens,
                         dtype=params["final_norm"].dtype)
        if cfg.embed_scale:
            # The scale rounds to the activation dtype before it
            # multiplies, as in the JAX forward (a host-side scalar: no
            # device copy).
            h = h * torch.tensor(cfg.dim ** 0.5, dtype=h.dtype).item()
    # The rotary tables are layer-invariant: computed once per forward.
    with scope("rope"):
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        h = _layer(cfg, h, lp, cache.k[i], cache.v[i], rope, attend,
                   moe_impl)
    with scope("final_norm"):
        h = rms_norm(h, params["final_norm"], cfg.rms_eps, cfg.rms_offset)
    if logits_at is not None:
        h = h[torch.arange(B, device=h.device), logits_at.long()][:, None]
    with scope("lm_head"):
        if cfg.tie_embeddings:
            logits = tied_head(h, params["embed"])
        else:
            logits = qmatmul(h, params["lm_head"])
        return logits.float(), cache
