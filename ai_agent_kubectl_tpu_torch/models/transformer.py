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
  of both layouts, or through ``expert_parallel_moe`` on an expert mesh
  (``_moe_path``, the JAX ``_moe_mlp``'s rule).
- An int8 KV cache (``kv_quant="int8"``: ``ops/quant.py::QuantKV``
  leaves, scales starting at 1) is written through the same rows, the
  window's K/V quantized first (``kv_quantize``), and read by
  ``ops/attention.py::dense_attention_quant``: on the pool through the
  gather path, on the dense cache over ``cache[:, :kv_limit]``. None of
  the attention kernels reads int8 KV (nor does the JAX package's), so
  an int8 cache asked to attend through one of them raises.

- Under a mesh of more than one shard (``mesh=``, the JAX forward's
  mesh) the forward runs over per-shard weights and caches
  (``_forward_tp``, one ``_MeshPass``): Megatron column/row splits, the
  f≈1 residual split, attention per shard on its own heads — the two
  pool kernels through their sharded wrappers, the dense ladder's paged
  decode and flash prefill per (data, model) shard —, the dense cache's
  slots over ``data``, and MoE layers dense under tp or dispatched over
  ``expert``.
- ``attn_impl="ring"`` (the dense cache, S > 1): the window attends over
  its own fresh K/V (``parallel/ring_attention.py``), the K/V write
  still landing every position, int8 caches included. On a ``seq``
  axis > 1 the window splits into one block per seq row
  (``_forward_ring``); every other forward on such a mesh runs on the
  seq-0 row, which holds the cache. Over a block table it raises, as
  the JAX package has no such path.
- On a ``pipe`` axis > 1 the layer stack runs in stages
  (``parallel/pipeline.py::pipeline_forward``), attention dense and MoE
  dense in each; a block table raises with the JAX message.
- On a mesh that spans processes (``DCN_MESH_SHAPE``) each process runs
  the same forward over its own shards (every per-shard list holds None
  for another process's shard), the collectives join them across
  processes, and the logits land on rank 0 alone (None elsewhere):
  only rank 0 samples.
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
from ..parallel.collectives import (all_gather, all_reduce, gather_home,
                                    reduce_scatter, transfer)
from ..parallel.moe import (dense_moe, dense_moe_partial,
                            expert_parallel_moe)
from ..parallel.ring_attention import ring_attention_shards
from ..parallel.sharding import (head_layout, replicate, residual_split_dim,
                                  rows_split)
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
            kv_quant: str, mesh, split_rows: bool = False):
        """One zeroed K or V leaf: a tensor, or over a mesh's cache row
        (``Mesh.cache_row``: the seq-0 row) of more than one shard a
        ``ShardedKV`` of per-shard leaves (layers split over ``pipe``,
        KV heads where ``head_layout`` splits them, slots over ``data``
        under ``split_rows`` where that divides, else a whole copy per
        shard), each allocated on its shard's device (this process's
        shards only: another process's is None here, so a process that
        holds no shard of the cache row, the seq-0 row of a DCN seq axis,
        holds no cache at all)."""
        if mesh is None or mesh.size <= 1:
            return cls._leaf(shape, dtype, device, kv_quant)
        mesh = mesh.cache_row()[0]
        if mesh.size == 1 and mesh.is_local(0):
            return cls._leaf(shape, dtype, mesh.devices[0], kv_quant)
        heads = head_layout(cfg, mesh.tp)[1]
        rows = split_rows and rows_split(mesh, shape[1])
        local = (shape[0] // mesh.pp, shape[1] // mesh.dp if rows
                 else shape[1], shape[2],
                 shape[3] // mesh.tp if heads else shape[3], shape[4])
        return ShardedKV(shards=[cls._leaf(local, dtype, d, kv_quant)
                                 if mesh.is_local(i) else None
                                 for i, d in enumerate(mesh.devices)],
                         heads_split=heads, row_groups=mesh.dp if rows else 1)

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
              kv_quant: str = "", mesh=None,
              split_rows: bool = False) -> "KVCache":
        """A zeroed dense per-slot cache of ``max_seq`` positions, split
        over ``mesh``'s shards when it has more than one: with
        ``split_rows`` (a serving cache's slots, ``cache_specs``) its
        slots over ``data`` where that divides."""
        shape = (cfg.n_layers, batch, max_seq + 1, cfg.n_kv_heads,
                 cfg.head_dim)
        return cls(k=cls._kv(cfg, shape, dtype, device, kv_quant, mesh,
                             split_rows),
                   v=cls._kv(cfg, shape, dtype, device, kv_quant, mesh,
                             split_rows))

    @property
    def sharded(self) -> bool:
        return isinstance(self.k, ShardedKV)

    def shard(self, i: int) -> Optional["KVCache"]:
        """Shard ``i``'s own cache (the cache itself when unsharded; None
        for another process's shard)."""
        if not self.sharded:
            return self
        if self.k.shards[i] is None:
            return None
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
    rows (copied to the cache's device first where it lies elsewhere):
    quantized first when the layer is a ``QuantKV``."""
    dev = _leaf_device(layer)
    if x.device != dev:
        x = x.to(dev)
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


def _moe_path(cfg: ModelConfig, moe_impl: str, mesh, tokens: int) -> str:
    """The JAX ``_moe_mlp``'s choice for a window of ``tokens`` (B * S,
    the whole batch): "ep", the expert-parallel dispatch, whenever a mesh
    is in scope whose expert axis is > 1 (under ``auto``) or any size
    (under ``ep``) and divides the tokens and the experts; else "dense",
    the all-experts evaluation, which ``ep`` refuses with the JAX
    message."""
    if moe_impl == "dense":
        return "dense"
    if mesh is not None:
        ep = mesh.shape["expert"]
        if ((moe_impl == "ep" or ep > 1) and tokens % ep == 0
                and cfg.n_experts % ep == 0):
            return "ep"
    if moe_impl == "ep":
        raise ValueError(
            "MOE_IMPL=ep needs a mesh with an expert axis whose size "
            "divides tokens and experts")
    return "dense"


def _ep_capacity(tokens: int, S: int, ep: int) -> Optional[int]:
    """The JAX decode capacity: every local token (S == 1: drops
    impossible), else the dispatch's default."""
    return tokens // ep if S == 1 else None


def _moe_mlp(cfg: ModelConfig, lp: Dict[str, object], x: torch.Tensor,
             moe_impl: str, mesh=None, token_mask=None) -> torch.Tensor:
    """The MoE MLP on one device (the JAX ``_moe_mlp``): the dispatch
    over a one-device expert mesh (``MOE_IMPL=ep`` on one card) or the
    dense evaluation (``_moe_path``)."""
    B, S, _ = x.shape
    if _moe_path(cfg, moe_impl, mesh, B * S) == "ep":
        return expert_parallel_moe(
            cfg, [lp], [x], mesh, token_mask=token_mask,
            capacity=_ep_capacity(B * S, S, mesh.shape["expert"]))[0]
    return dense_moe(cfg, lp, x)


#: (q, k, v, layer_k, layer_v) -> attention output [B, S, H, hd]; writes
#: the window's K/V into the layer's cache first.
Attend = Callable[..., torch.Tensor]


def _layer(cfg: ModelConfig, h: torch.Tensor, lp: Dict[str, object],
           layer_k: torch.Tensor, layer_v: torch.Tensor, rope: tuple,
           attend: Attend, moe_impl: str = "auto", mesh=None,
           token_mask=None) -> torch.Tensor:
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
        mlp = (_moe_mlp(cfg, lp, x, moe_impl, mesh, token_mask)
               if cfg.is_moe else _dense_mlp(cfg, lp, x))
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
    ring = attn_impl == "ring" and tokens.shape[1] > 1
    if not ring:
        read = _dense_read(tokens, positions, kv_limit, attn_impl, page_size)

    def attend(q, k, v, layer_k, layer_v):
        with scope("kv_write"):
            _write_kv(layer_k, flat, k)
            _write_kv(layer_v, flat, v)
        with scope("attention"):
            if ring:        # a ring of one: the window's own fresh K/V
                return ring_attention_shards([q], [k], [v], [positions])[0]
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


# ------------------------------------------------ the mesh forward

def _tp_pool_reads(cfg: ModelConfig, tokens, positions, caches: list,
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
            n_blocks, page = _first(lks).shape[0] - 1, _first(lks).shape[1]
            return ragged_attention_pool_sharded(
                _each(torch.Tensor.contiguous, qs),
                _each(lambda k: k[:n_blocks], lks),
                _each(lambda v: v[:n_blocks], lvs), ql, pos0, tbl, mesh,
                page_size=page)
        return read
    if attn_impl == "paged" and S == 1:
        pos0 = replicate(positions[:, 0].to(torch.int32).contiguous(), mesh)
        tbl = replicate(tables, mesh)

        def read(qs, lks, lvs):
            n_blocks, page = _first(lks).shape[0] - 1, _first(lks).shape[1]
            outs = paged_decode_attention_pool_sharded(
                _each(lambda q: q[:, 0].contiguous(), qs),
                _each(lambda k: k[:n_blocks], lks),
                _each(lambda v: v[:n_blocks], lvs),
                pos0, tbl, mesh, page_size=page)
            return _each(lambda o: o[:, None], outs)
        return read
    toks, poss, tbls = (replicate(t, mesh)
                        for t in (tokens, positions, tables))
    reads = _each(lambda t, p, c, b: _pool_read(t, p, c, b, q_lens, kv_limit,
                                                attn_impl),
                  toks, poss, caches, tbls)
    return lambda qs, lks, lvs: _each(lambda r, q, k, v: r(q, k, v), reads,
                                      qs, lks, lvs)


def _each(fn, *per_shard) -> list:
    """``fn`` over each shard's arguments (the lists zipped), None where
    the first list holds None (another process's shard)."""
    return [None if a[0] is None else fn(*a) for a in zip(*per_shard)]


def _first(per_shard):
    """The first of this process's entries of a per-shard list."""
    return next(x for x in per_shard if x is not None)


def _layer_trees(params, li: int) -> list:
    """Each shard's tree of layer ``li`` (None for another process's)."""
    return [None if p is None else {name: w[li] for name, w in
                                    p["layers"].items()} for p in params]


def _tp_combine(partials, whole: bool, split_dim: Optional[int], groups,
                mesh=None):
    """A row-parallel product's per-shard partial sums joined over each
    model group into the residual's layout: reduce-scattered over the
    residual's split dimension, or all-reduced when the residual is
    replicated. A weight that did not split (``whole``) already gives
    every shard the full product: it is only cut to the residual's
    block."""
    if whole:
        if split_dim is None:
            return partials
        out = list(partials)
        for g in groups:
            for r, i in enumerate(g):
                if partials[i] is not None:
                    out[i] = partials[i].chunk(len(g), dim=split_dim)[r]\
                        .contiguous()
        return out
    if split_dim is None:
        return all_reduce(partials, groups, mesh)
    return reduce_scatter(partials, split_dim, groups, mesh)


def _tp_moe(cfg: ModelConfig, lps, xs, mesh, *, moe_impl: str,
            token_mask, data_split: bool, split: Optional[int], groups):
    """The MoE MLP over the shards, each input its data group's whole
    rows: the expert-parallel dispatch (``_moe_path``) over the whole
    batch, gathered over ``data`` first where the rows are split, each
    shard keeping its rows of the result; else each shard's experts
    (its ``expert`` block, or all) evaluated densely on its slice of F,
    the float32 partials summed over the expert group and then joined
    over the model group as ``w_down``'s are. Returns the outputs in the
    residual's layout."""
    B_l, S, _ = _first(xs).shape
    B = B_l * (mesh.dp if data_split else 1)
    if _moe_path(cfg, moe_impl, mesh, B * S) == "ep":
        full = (all_gather(xs, 0, mesh.groups("data"), mesh) if data_split
                else xs)
        ys = expert_parallel_moe(
            cfg, lps, full, mesh, token_mask=token_mask,
            capacity=_ep_capacity(B * S, S, mesh.ep))
        if data_split:
            ys = [None if y is None else y[mesh.coord(i, "data") * B_l:][:B_l]
                  for i, y in enumerate(ys)]
        return _tp_combine(ys, True, split, groups, mesh)
    lp0 = _first(lps)
    E_l = lp0["w_gate"].shape[0]
    experts_split = E_l != cfg.n_experts
    parts = [None if lp is None else
             dense_moe_partial(cfg, lp, x, mesh.coord(i, "expert") * E_l
                               if experts_split else 0)
             for i, (lp, x) in enumerate(zip(lps, xs))]
    if experts_split:
        parts = all_reduce(parts, mesh.groups("expert"), mesh)
    whole = lp0["w_down"].shape[1] == cfg.mlp_hidden
    return _each(lambda p, x: p.to(x.dtype),
                 _tp_combine(parts, whole, split, groups, mesh), xs)


def _forward_tp(params, cfg: ModelConfig, tokens, positions,
                cache: KVCache, *, mesh, kv_limit, attn_impl, page_size,
                logits_at, write_mask, block_tables, q_lens, token_mask,
                moe_impl):
    """``forward`` over a mesh of more than one shard with no seq or pipe
    split in it (the JAX forward under a mesh, one controller over
    per-shard tensors): one ``_MeshPass`` over every shard's layers.

    - ``params`` is ``parallel/sharding.py::shard_params``'s per-shard
      trees, ``cache`` a ``KVCache`` of ``ShardedKV`` leaves;
    - wq/wk/wv and w_gate/w_up run column-parallel on each shard, wo and
      w_down row-parallel, their partial sums joined over each model
      group (the shards of one (data, expert) row) by the collectives of
      ``parallel/collectives.py``;
    - the residual follows the f≈1 policy (``residual_spec``): split
      over the batch rows (decode) or the sequence (prefill) — a
      reduce-scatter after each row-parallel product, an all-gather
      before each column-parallel one — else replicated (always on an
      expert mesh);
    - a dense cache whose slots split over ``data`` (``row_groups``)
      gives each data group its slots' rows of the window: each group
      runs its model shards on them, and the logits join in data order;
    - every expert row runs the non-MoE part of a layer on its own copy
      of its data group's cache (the JAX layout replicates the residual
      and the cache over ``expert``); an MoE layer runs ``_tp_moe``;
    - attention runs per shard on the shard's heads (``head_layout``):
      the pool kernels through the sharded wrappers, every other read
      (the dense ladder's paged decode and flash prefill among them) on
      each shard's own cache;
    - the vocab-sharded embedding looks up each shard's rows and sums
      them; the head's logits gather over the vocab on the first
      shard's device, where the logits are returned.
    """
    run = _MeshPass(cfg, mesh, tokens, positions, _shard_caches(cache, mesh),
                    row_groups=_row_groups(cache), kv_limit=kv_limit,
                    attn_impl=attn_impl, page_size=page_size,
                    write_mask=write_mask, block_tables=block_tables,
                    q_lens=q_lens, token_mask=token_mask, moe_impl=moe_impl)
    h = run.embed(params)
    for li in range(cfg.n_layers):
        h = run.layer(_layer_trees(params, li), h, li)
    return run.head(params, run.gather(h), logits_at), cache


def _shard_caches(cache: KVCache, mesh) -> list:
    """Each shard's own cache of a mesh (the cache itself on every shard
    of a one-shard mesh; None for another process's shard)."""
    if not cache.sharded:
        return [cache] * mesh.size
    return [cache.shard(i) for i in range(mesh.size)]


def _holds_cache(cache: KVCache) -> bool:
    """Whether a shard of the cache is this process's."""
    return not cache.sharded or any(s is not None for s in cache.k.shards)


def _row_groups(cache: KVCache) -> int:
    return cache.k.row_groups if cache.sharded else 1


class _MeshPass:
    """One forward's per-shard state over a mesh every shard of which runs
    every layer it holds: the ``data``, ``expert`` and ``model`` axes (a
    whole mesh without seq or pipe, one seq row of a ring prefill, or one
    pipeline stage). ``embed``, ``layer`` (or ``qkv``, ``write`` and
    ``finish``, between which a ring prefill runs its ring) and ``head``
    are the forward's three parts (see ``_forward_tp``).

    ``caches``: each shard's own ``KVCache`` (plain or ``QuantKV``
    leaves), which may lie on another device than the shard (a ring
    prefill's seq rows all write the seq-0 row's cache); ``row_groups``:
    the data groups the caches' slots split over. ``rows``: the global
    batch rows ``[a, b)`` this pass runs (a pipeline microbatch; default
    all), each data group taking its slots among them (possibly none).
    ``tokens`` may be None for a pass that only runs layers;
    ``residual=False`` keeps the residual replicated (a pipeline stage,
    where the JAX policy is off).

    On a mesh that spans processes every per-shard list holds None for
    another process's shard: each part runs this process's shards
    (``self.local``; none in a pipeline stage held elsewhere), and the
    collectives join the rest."""

    def __init__(self, cfg: ModelConfig, mesh, tokens, positions,
                 caches: list, *, row_groups: int = 1, kv_limit=None,
                 attn_impl: str = "dense", page_size: int = 128,
                 write_mask=None, block_tables=None, q_lens=None,
                 token_mask=None, moe_impl: str = "auto", rows=None,
                 residual: bool = True):
        self.cfg, self.mesh, self.caches = cfg, mesh, caches
        self.kv_limit, self.attn_impl, self.page_size = (kv_limit, attn_impl,
                                                         page_size)
        self.write_mask, self.block_tables, self.q_lens = (
            write_mask, block_tables, q_lens)
        self.token_mask, self.moe_impl = token_mask, moe_impl
        n, tp = mesh.size, mesh.tp
        self.local = mesh.local_shards
        B, S = positions.shape
        self.S = S
        q_split, kv_split = head_layout(cfg, tp)
        self.q_split = q_split
        self.H_l = cfg.n_heads // tp if q_split else cfg.n_heads
        self.KV_l = cfg.n_kv_heads // tp if kv_split else cfg.n_kv_heads
        self.models = mesh.groups("model")
        self.mcoord = [mesh.coord(i, "model") for i in range(n)]
        self.dp_rows = row_groups
        self.per = n // row_groups
        B_l = B // row_groups
        a, b = rows if rows is not None else (0, B)
        # Each data group's global rows [lo, hi) among [a, b), and its
        # local (slot) rows within the group's B_l.
        self.spans = []
        for g in range(row_groups):
            lo, hi = max(a, g * B_l), min(b, (g + 1) * B_l)
            hi = max(lo, hi)
            self.spans.append((lo, hi, lo - g * B_l, hi - g * B_l))
        self.cut = rows is not None
        self.split = (residual_split_dim(mesh, (b - a, S, cfg.dim))
                      if residual else None)
        self.tokens, self.positions = tokens, positions
        self.toks = self.spread(self.blocks(tokens))
        self.poss = self.spread(self.blocks(positions))
        self.rope = None
        self._reads = None
        self._prepared = False

    # ------------------------------------------------------- layout

    def blocks(self, t):
        """Each data group's rows of a [B, ...] tensor (None stays)."""
        if t is None:
            return [None] * self.dp_rows
        return [t[lo:hi] for lo, hi, _, _ in self.spans]

    def spread(self, bs):
        """Per-group values onto each shard of the group's device (None
        for another process's shard)."""
        return [None if bs[i // self.per] is None
                or not self.mesh.is_local(i)
                else bs[i // self.per].to(dev)
                for i, dev in enumerate(self.mesh.devices)]

    def take(self, xs) -> list:
        """Each shard's rows of this pass out of per-shard tensors over
        its group's whole slots (a pipeline microbatch's rows)."""
        if not self.cut:
            return list(xs)
        return [None if x is None else
                x[self.spans[i // self.per][2]:self.spans[i // self.per][3]]
                for i, x in enumerate(xs)]

    def layer_cache(self, i: int, li: int) -> tuple:
        """Shard ``i``'s K and V of layer ``li``, cut to its group's
        slots of this pass."""
        c = self.caches[i]
        lk, lv = c.k[li], c.v[li]
        if self.cut:
            _, _, lo, hi = self.spans[i // self.per]
            lk, lv = (kv_map(lambda a: a[lo:hi], x) for x in (lk, lv))
        return lk, lv

    def gather(self, xs):
        """The residual whole on every shard (a no-op when replicated)."""
        if self.split is None:
            return xs
        return all_gather(xs, self.split, self.models, self.mesh)

    def _prepare(self) -> None:
        """The per-forward setup of the K/V writes (flat rows, on each
        cache's device) and of the reads."""
        self._prepared = True
        cfg, mesh, n = self.cfg, self.mesh, self.mesh.size
        tokens, positions = self.tokens, self.positions
        cdev = [None if c is None else _leaf_device(c.k)
                for c in self.caches]
        if all(d is None for d in cdev):
            # No cache here: a ring prefill's row in another process than
            # the seq-0 row writes nothing in this one.
            self.flats = [None] * n
            return
        if self.block_tables is not None:
            c0 = _first(self.caches)
            tables = self.block_tables.to(torch.int32).contiguous()
            with scope("kv_write"):
                flat = _pool_flat_pos(tables, positions, c0.page,
                                      c0.n_blocks, self.write_mask)
                self.flats = _each(flat.to, cdev)
            with scope("attention"):
                self._reads = _tp_pool_reads(
                    cfg, tokens, positions, self.caches, tables, self.q_lens,
                    self.kv_limit, self.attn_impl, mesh)
            return
        max_seq = _first(self.caches).max_seq
        with scope("kv_write"):
            flats = [_dense_flat_pos(p, max_seq, w) for p, w in
                     zip(self.blocks(positions), self.blocks(self.write_mask))]
            self.flats = [None if cdev[i] is None
                          else flats[i // self.per].to(cdev[i])
                          for i in range(n)]
        if self.attn_impl == "ring" and self.S > 1:
            return
        with scope("attention"):
            reads = _each(lambda p: _dense_read(p, p, self.kv_limit,
                                                self.attn_impl,
                                                self.page_size), self.poss)

        def read(qs, lks, lvs):
            return _each(lambda r, q, k, v: r(q, k, v), reads, qs, lks, lvs)
        self._reads = read

    # ------------------------------------------------------- parts

    def embed(self, params) -> list:
        """The vocab-sharded embedding: each shard's rows looked up and
        summed over the model group (``embed_scale`` applied)."""
        cfg, n = self.cfg, self.mesh.size
        toks, mcoord = self.toks, self.mcoord
        if not self.local:
            return [None] * n
        with scope("embed"):
            dt = _first(params)["final_norm"].dtype
            emb = [None if p is None else p["embed"] for p in params]
            V_l = _first(emb).shape[0]
            if V_l != cfg.vocab_size:       # vocab rows split over shards
                parts = []
                for i in range(n):
                    if emb[i] is None:
                        parts.append(None)
                        continue
                    lo = toks[i].long() - mcoord[i] * V_l
                    inside = (lo >= 0) & (lo < V_l)
                    e = embed_lookup(emb[i], lo.clamp(0, V_l - 1), dtype=dt)
                    parts.append(torch.where(
                        inside[..., None], e,
                        torch.zeros((), dtype=dt, device=e.device)))
                h = _tp_combine(parts, False, self.split, self.models,
                                self.mesh)
            else:
                h = _tp_combine(_each(lambda e, t: embed_lookup(e, t,
                                                                dtype=dt),
                                      emb, toks), True, self.split,
                                self.models)
            if cfg.embed_scale:
                c = torch.tensor(cfg.dim ** 0.5, dtype=dt).item()
                h = _each(lambda x: x * c, h)
        return h

    def qkv(self, lps, h) -> tuple:
        """The layer's attention inputs per shard: q [rows, S, H_l, hd],
        k and v [rows, S, KV_l, hd], rotated."""
        cfg, S, hd = self.cfg, self.S, self.cfg.head_dim
        if not self.local:
            return ([None] * self.mesh.size,) * 3
        if self.rope is None:
            with scope("rope"):
                self.rope = self.spread([
                    torch.stack(rope_tables(p, hd, cfg.rope_theta))
                    for p in self.blocks(self.positions)])
        with scope("attn_norm"):
            xs = self.gather(_each(lambda x, lp: rms_norm(
                x, lp["attn_norm"], cfg.rms_eps, cfg.rms_offset), h, lps))
        with scope("qkv_proj"):
            qs, ks, vs = (_each(lambda x, lp: qmatmul(x, lp[w]).view(
                x.shape[0], S, heads, hd), xs, lps)
                for w, heads in (("wq", self.H_l), ("wk", self.KV_l),
                                 ("wv", self.KV_l)))
        with scope("rope"):
            qs = _each(lambda q, r: rotate(q, r[0], r[1]), qs, self.rope)
            ks = _each(lambda k, r: rotate(k, r[0], r[1]), ks, self.rope)
        return qs, ks, vs

    def write(self, li: int, ks, vs) -> tuple:
        """The window's K/V into each shard's cache of layer ``li`` (on
        the cache's device), where both are in this process: a ring
        prefill's row hands its K/V to the seq-0 row's process first
        (``_forward_ring``). Returns the layer's leaves per shard."""
        if not self._prepared:
            self._prepare()
        lks, lvs = zip(*(self.layer_cache(i, li) if c is not None
                         else (None, None)
                         for i, c in enumerate(self.caches)))
        with scope("kv_write"):
            for i, (k, v) in enumerate(zip(ks, vs)):
                if k is not None and lks[i] is not None:
                    _write_kv(lks[i], self.flats[i], k)
                    _write_kv(lvs[i], self.flats[i], v)
        return list(lks), list(lvs)

    def finish(self, lps, h, attn) -> list:
        """The layer after attention: wo, the residual, the MLP."""
        cfg, S, hd = self.cfg, self.S, self.cfg.head_dim
        if not self.local:
            return h
        lp0 = _first(lps)
        wo_whole = lp0["wo"].shape[0] == cfg.n_heads * hd
        down_whole = lp0["w_down"].shape[-2] == cfg.mlp_hidden
        with scope("o_proj"):
            outs = []
            for i, (a, lp) in enumerate(zip(attn, lps)):
                if a is None:
                    outs.append(None)
                    continue
                a = a.reshape(a.shape[0], S, self.H_l * hd)
                rows = lp["wo"].shape[0]
                if not self.q_split and not wo_whole:
                    a = a[..., self.mcoord[i] * rows:
                          (self.mcoord[i] + 1) * rows]
                outs.append(qmatmul(a, lp["wo"]))
            h = _each(torch.add, h, _tp_combine(
                outs, wo_whole, self.split, self.models, self.mesh))
        with scope("mlp"):
            xs = self.gather(_each(lambda x, lp: rms_norm(
                x, lp["mlp_norm"], cfg.rms_eps, cfg.rms_offset), h, lps))
            if cfg.is_moe:
                outs = _tp_moe(cfg, lps, xs, self.mesh,
                               moe_impl=self.moe_impl,
                               token_mask=self.token_mask,
                               data_split=self.dp_rows > 1, split=self.split,
                               groups=self.models)
            else:
                outs = _tp_combine(_each(lambda x, lp: _dense_mlp(cfg, lp, x),
                                         xs, lps),
                                   down_whole, self.split, self.models,
                                   self.mesh)
            h = _each(torch.add, h, outs)
        return h

    def layer(self, lps, h, li: int) -> list:
        """One whole layer on every shard: K/V written, then read (a ring
        of one over the window's own K/V under ``attn_impl="ring"``).
        Nothing runs where no shard of the pass is this process's."""
        if not self.local:
            return h
        qs, ks, vs = self.qkv(lps, h)
        lks, lvs = self.write(li, ks, vs)
        with scope("attention"):
            if self.attn_impl == "ring" and self.S > 1:
                attn = _each(lambda q, k, v, p: ring_attention_shards(
                    [q], [k], [v], [p])[0], qs, ks, vs, self.poss)
            else:
                attn = self._reads(qs, lks, lvs)
        return self.finish(lps, h, attn)

    def head(self, params, h, logits_at, dest=None
             ) -> Optional[torch.Tensor]:
        """Final norm and head over ``h`` (whole on every shard): one
        model group per data group of rows (expert row 0's) makes the
        logits (the others hold the same), gathered over the vocab and
        joined in data order on ``dest`` (default: the mesh's first
        device). Across processes the logits land on rank 0 alone, on
        ``dest`` or its first device of the mesh, and every other
        process returns None (``gather_home``)."""
        cfg, mesh = self.cfg, self.mesh
        if dest is None:
            dest = mesh.devices[0] if not mesh.hybrid else mesh.home
        vocab_split = False
        if self.local:
            p0 = _first(params)
            head_w = p0.get("lm_head", p0["embed"])
            vocab_split = (head_w.shape[-1] if "lm_head" in p0
                           else head_w.shape[0]) != cfg.vocab_size
        ats = self.spread(self.blocks(logits_at))
        rows = []
        for g in (self.models[r * mesh.ep] for r in range(self.dp_rows)):
            logits = [None] * mesh.size
            for i in (g if vocab_split else g[:1]):
                if not mesh.is_local(i):
                    continue
                with scope("final_norm"):
                    x = rms_norm(h[i], params[i]["final_norm"], cfg.rms_eps,
                                 cfg.rms_offset)
                if ats[i] is not None:
                    x = x[torch.arange(x.shape[0], device=x.device),
                          ats[i].long()][:, None]
                with scope("lm_head"):
                    logits[i] = (tied_head(x, params[i]["embed"])
                                 if cfg.tie_embeddings
                                 else qmatmul(x, params[i]["lm_head"]))
            rows.append(gather_home(logits, -1, g if vocab_split else g[:1],
                                    mesh, dest))
        if rows[0] is None:
            return None
        out = rows[0] if len(rows) == 1 else torch.cat(rows)
        return out.float()


def _leaf_device(leaf) -> torch.device:
    return (leaf.q if isinstance(leaf, QuantKV) else leaf).device


def _forward_ring(params, cfg: ModelConfig, tokens, positions,
                  cache: KVCache, *, mesh, logits_at, write_mask,
                  token_mask, moe_impl):
    """A ring prefill over a mesh with a seq axis > 1 (the JAX forward's
    ``attn_impl="ring"``): the window cut into ``sp`` contiguous blocks,
    block ``r`` run by seq row ``r`` (``Mesh.select``) on its own
    devices with its own copy of the weights, each layer's K/V of every
    block written into the one cache of the seq-0 row, and each shard's
    queries attending over the window's own fresh K/V by the ring among
    the shards of its seq group (each model shard over its own heads).
    The rows' final hidden states join on the seq-0 row, which runs the
    head.

    On a mesh over processes (a seq axis with a DCN factor) each process
    runs its own rows' shards and the rings of every seq group it holds
    a shard of. Row ``r``'s fresh K/V and its final hidden state cross
    to the process of the seq-0 row's shard of the same group
    (``collectives.transfer``, one call a layer for the K/V); a row in
    another process than its cache never touches ``caches``. The logits
    reach rank 0 alone (``gather_home``); every other process returns
    None. ``_forward_ring.calls`` counts the ring prefills this process
    took part in."""
    _forward_ring.calls += 1
    sp = mesh.sp
    B, S = tokens.shape
    if S % sp:
        raise ValueError(
            f"seq len {S} not divisible by seq axis size {sp}")
    row0, idx0 = mesh.cache_row()
    caches = _shard_caches(cache, row0)
    # Where each seq-0 shard's cache lies (None: another process's).
    cdev = [None if c is None else _leaf_device(c.k) for c in caches]
    S_l = S // sp
    subs = [mesh.select("seq", r) for r in range(sp)]
    rows = [idx for _, idx in subs]
    runs, prm = [], []
    for r, (sub, idx) in enumerate(subs):
        cols = slice(r * S_l, (r + 1) * S_l)
        runs.append(_MeshPass(
            cfg, sub, tokens[:, cols], positions[:, cols], caches,
            row_groups=_row_groups(cache), attn_impl="ring",
            write_mask=(write_mask[:, cols] if write_mask is not None
                        and write_mask.dim() == 2 else write_mask),
            token_mask=(token_mask[:, cols] if token_mask is not None
                        else None), moe_impl=moe_impl))
        prm.append([params[i] for i in idx])
    n_row = row0.size
    # One ring per seq group (the shards at one place of every row) that
    # has a shard here, in group order in every process.
    rings = [k for k in range(n_row)
             if any(mesh.is_local(idx[k]) for idx in rows)]
    h = [run.embed(p) for run, p in zip(runs, prm)]
    for li in range(cfg.n_layers):
        lps = [_layer_trees(ps, li) for ps in prm]
        parts = [run.qkv(lp, x) for run, lp, x in zip(runs, lps, h)]
        fresh = _to_cache_row(mesh, rows, idx0, cdev,
                              [p[1:] for p in parts[1:]])
        for r, run in enumerate(runs):
            run.write(li, *(parts[0][1:] if r == 0 else fresh[r - 1]))
        attn = [[None] * n_row for _ in range(sp)]
        with scope("attention"):
            for k in rings:
                outs = ring_attention_shards(
                    [parts[r][0][k] for r in range(sp)],
                    [parts[r][1][k] for r in range(sp)],
                    [parts[r][2][k] for r in range(sp)],
                    [runs[r].poss[k] for r in range(sp)],
                    mesh=mesh, shards=[idx[k] for idx in rows])
                for r in range(sp):
                    attn[r][k] = outs[r]
        h = [run.finish(lp, x, a)
             for run, lp, x, a in zip(runs, lps, h, attn)]
    h = [run.gather(x) for run, x in zip(runs, h)]
    got = transfer([(h[r][k], rows[r][k], idx0[k], row0.devices[k])
                    for k in range(n_row) for r in range(sp)], mesh)
    whole = [torch.cat(got[k * sp:(k + 1) * sp], dim=1)
             if row0.is_local(k) else None for k in range(n_row)]
    head = _MeshPass(cfg, row0, tokens, positions, caches,
                     row_groups=_row_groups(cache))
    return head.head(prm[0], whole, logits_at), cache


_forward_ring.calls = 0


def _to_cache_row(mesh, rows, idx0, cdev, kvs) -> list:
    """Rows ``1..sp-1``'s fresh (ks, vs) per shard handed to the seq-0
    row's shard of the same group, on its cache's device, in one
    ``transfer``: each row's (ks, vs) there, None where that cache is
    another process's."""
    n_row = len(idx0)
    moves = [(t[k], rows[r][k], idx0[k], cdev[k])
             for r, kv in enumerate(kvs, start=1) for t in kv
             for k in range(n_row)]
    got = transfer(moves, mesh)
    return [(got[2 * n_row * j:2 * n_row * j + n_row],
             got[2 * n_row * j + n_row:2 * n_row * (j + 1)])
            for j in range(len(kvs))]


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
    moe_impl: str = "auto",             # MoE MLP: auto | ep | dense
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
    token in both. An MoE model's MLP runs as the JAX ``_moe_mlp``
    chooses (``_moe_path``): the expert-parallel dispatch
    (``parallel/moe.py::expert_parallel_moe``) on a mesh whose expert
    axis is > 1 (``auto``) or any size (``ep``, on one card a one-device
    expert mesh) and divides the tokens and experts, else ``dense_moe``
    (``ep`` refuses that). ``token_mask`` marks padding and dead slots,
    which the dispatch keeps out of the experts' capacity (the dense
    evaluation ignores it). Under a ``mesh`` of more than one shard the
    forward runs ``_forward_tp`` over per-shard weights and caches: the
    ``model`` axis tensor-parallel, slots over ``data`` where the dense
    cache splits them, experts over ``expert``; a ``pipe`` axis runs the
    layers in stages (``pipeline_forward``, attention dense); on a
    ``seq`` axis ``attn_impl="ring"`` runs ``_forward_ring`` and every
    other forward the seq-0 row; on a mesh over processes one that holds
    no shard of that row (the seq-0 row of a DCN seq axis is rank 0's)
    runs its rows of a ring prefill and returns ``(None, cache)`` from
    any other forward. ``attn_impl="ring"`` over the dense
    cache attends over the window's own K/V (the JAX ring prefill; dense
    for a one-column window, as in JAX). ``logits_at`` gathers
    each row's hidden state at one column BEFORE the LM head, returning
    [B, 1, vocab]. An int8 cache (``QuantKV`` leaves) reads through the
    gather path or the dense read only: ``attn_impl`` "ragged", "paged"
    with one column and "flash" with several raise, their kernels
    reading bf16 KV."""
    B, S = tokens.shape
    multi = mesh is not None and mesh.size > 1
    if multi and mesh.hybrid and not _holds_cache(cache):
        # No shard of the cache row is this process's (the seq-0 row of a
        # DCN seq axis is rank 0's): it runs a ring prefill's rows and no
        # other forward. Rank 0, which holds the cache, checked the call.
        if attn_impl == "ring" and S > 1 and mesh.sp > 1 and mesh.pp == 1:
            return _forward_ring(params, cfg, tokens, positions, cache,
                                 mesh=mesh, logits_at=logits_at,
                                 write_mask=write_mask,
                                 token_mask=token_mask, moe_impl=moe_impl)
        return None, cache
    if block_tables is not None:
        attn_impl = attn_impl or "ragged"
        if multi and mesh.pp > 1:
            raise NotImplementedError(
                "block-paged KV does not compose with a pipe mesh axis "
                "(no table plumbing in the stage body); use the dense "
                "KV ladder")
        if attn_impl not in ("ragged", "paged", "dense", "flash"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r} is not served over the pool "
                f"(ragged, paged, dense and flash are; a ring prefill "
                f"runs on the dense cache, as in the JAX package)")
    else:
        attn_impl = attn_impl or "dense"
        if attn_impl not in ("dense", "flash", "paged", "ring"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r} over the dense cache: dense, "
                f"flash, paged and ring are served")
        if kv_limit is None:
            kv_limit = cache.max_seq
        if not 0 < kv_limit <= cache.max_seq:
            raise ValueError(f"kv_limit {kv_limit} outside the cache's "
                             f"{cache.max_seq} positions")
    if cache.quantized and (attn_impl == "ragged"
                            or (attn_impl == "paged" and S == 1)
                            or (attn_impl == "flash" and S > 1)):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} does not read int8 KV (its kernel "
            f"reads bf16); the engines resolve KV_QUANT=int8 to the gather "
            f"path on the pool and the dense read on the dense cache")

    if multi and mesh.sp > 1:
        if attn_impl == "ring" and S > 1 and mesh.pp == 1:
            return _forward_ring(params, cfg, tokens, positions, cache,
                                 mesh=mesh, logits_at=logits_at,
                                 write_mask=write_mask,
                                 token_mask=token_mask, moe_impl=moe_impl)
        # Every other forward runs on the seq-0 row, which holds the cache
        # (a pipe axis beside it runs even a ring prefill dense, as JAX).
        mesh, idx = mesh.cache_row()
        params = [params[i] for i in idx] if mesh.size > 1 else params[idx[0]]
        multi = mesh.size > 1
    if multi and mesh.pp > 1:
        from ..parallel.pipeline import pipeline_forward

        return pipeline_forward(params, cfg, tokens, positions, cache, mesh,
                                kv_limit=kv_limit, logits_at=logits_at,
                                write_mask=write_mask)
    if multi:
        return _forward_tp(params, cfg, tokens, positions, cache,
                           mesh=mesh, kv_limit=kv_limit,
                           attn_impl=attn_impl, page_size=page_size,
                           logits_at=logits_at, write_mask=write_mask,
                           block_tables=block_tables, q_lens=q_lens,
                           token_mask=token_mask, moe_impl=moe_impl)
    if block_tables is not None:
        attend = _pool_attend(tokens, positions, cache, write_mask,
                              block_tables, q_lens, kv_limit, attn_impl)
    else:
        attend = _dense_attend(tokens, positions, cache, write_mask,
                               kv_limit, attn_impl, page_size)
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
                   moe_impl, mesh, token_mask)
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
