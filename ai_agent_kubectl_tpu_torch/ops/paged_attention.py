"""Paged single-query decode attention: the Hopper kernel's two entry
points, their plain PyTorch versions, and the wrappers that pick between
them.

Replaces the Pallas TPU kernels of ``ai_agent_kubectl_tpu/ops/
paged_attention.py``:

- ``paged_decode_attention`` (body ``_paged_kernel``) reads contiguous
  per-slot caches ``k``/``v`` [N, S, KV, hd] — the dense KV ladder's
  cache (``KV_POOL=false``);
- ``paged_decode_attention_pool`` (body ``_paged_pool_kernel``) reads the
  shared pool ``k``/``v`` [n_blocks, page, KV, hd] through
  ``block_tables`` [N, max_pages] int32 — the pool when ragged attention
  is off. Table entries are clamped to ``[0, n_blocks - 1]``: a sentinel
  only ever addresses a page past the slot's live span.

Both take ``q`` [N, H, hd] (one decode query per slot) and ``positions``
[N] int32 and return [N, H, hd] in q's dtype: query head h of slot n, at
position ``positions[n]``, attends keys ``kv <= positions[n]`` of KV head
``h // (H / KV)``; a slot with no visible key (a negative position) gets
zeros. Only the live pages ``0 .. positions[n] // page`` are read.

The kernel (``csrc/paged_attention.cu``, CUDA C++ for sm_90a) runs for
CUDA tensors; its source note gives its design and what bounds it. The
plain versions run for CPU tensors only. A CUDA tensor launches the
kernel or raises — nothing falls back to a plain version. Each wrapper's
``.launches`` counts its kernel launches, one a call.

Per call the wrapper adds little host work: the chunk rule
(``split_plan``) is cached per shape, each K/V leaf's TMA map is encoded
once per (pointer, shape, slot stride), the merge's counters and partials
are allocated once per (device, stream) and the entry points are typed
once.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import OrderedDict
from typing import Dict, Optional

import torch

from .flash_attention import flash_attention_cached_plain
from .ragged_attention import (HEAD_DIMS, check_heads_divide, global_heads,
                               on_shards, split_heads)


def paged_supported(page_size: int, head_dim: int, n_pages: int,
                    dtype: torch.dtype = torch.bfloat16) -> bool:
    """The CUDA kernel's own limits: head_dim 64/128/256 (a template
    parameter), a page that divides the 128-token tile (the pool's and
    the KV ladder's granularity), at least one page, bf16 q/k/v."""
    return (head_dim in HEAD_DIMS and page_size >= 1
            and 128 % page_size == 0 and n_pages >= 1
            and dtype == torch.bfloat16)


def _live_plain(q, k_ctx, v_ctx, positions, scale):
    """Masked dense softmax over per-slot views [N, S, KV, hd]: rows past
    each slot's position are selected away (never multiplied by zero, so
    a stale or NaN row stays out), then the flash plain version's
    numerics — f32 scores, probabilities rounded to v's dtype before P.V,
    the normaliser summing the unrounded ones, zeros for a slot with no
    visible key."""
    S = k_ctx.shape[1]
    pos = positions.long()[:, None]                           # [N, 1]
    live = (torch.arange(S, device=q.device)[None, :] <= pos)[:, :, None,
                                                              None]
    k_ctx = torch.where(live, k_ctx, 0.0)
    v_ctx = torch.where(live, v_ctx, 0.0)
    out = flash_attention_cached_plain(q[:, None], k_ctx, v_ctx, pos,
                                       scale=scale)
    return out[:, 0]


def paged_decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, positions: torch.Tensor,
                                 *, page_size: int = 128,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """The plain version over contiguous per-slot caches (see the module
    docstring)."""
    if k.shape[1] % page_size:
        raise ValueError(f"cache span {k.shape[1]} not divisible by page "
                         f"{page_size}")
    return _live_plain(q, k, v, positions, scale)


def _pool_gather(leaf: torch.Tensor, tables: torch.Tensor,
                 n_pages: int) -> torch.Tensor:
    """Each slot's first ``n_pages`` pages of a [n_blocks, page, ...]
    pool leaf as a contiguous [N, n_pages * page, ...] view. Table
    entries clamp to a real block (the JAX ``_pool_gather``): a sentinel
    only addresses positions past the slot's live span."""
    idx = tables[:, :n_pages].long().clamp(0, leaf.shape[0] - 1)
    g = leaf[idx]
    return g.reshape(idx.shape[0], n_pages * leaf.shape[1], *leaf.shape[2:])


def paged_decode_attention_pool_plain(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor,
                                      positions: torch.Tensor,
                                      block_tables: torch.Tensor, *,
                                      page_size: int = 128,
                                      scale: Optional[float] = None
                                      ) -> torch.Tensor:
    """The plain version over the pool: the gathered per-slot view (every
    table page), then the contiguous version's masked softmax."""
    if k.shape[1] != page_size:
        raise ValueError(f"pool page {k.shape[1]} != page_size {page_size}")
    n_pages = block_tables.shape[1]
    return _live_plain(q, _pool_gather(k, block_tables, n_pages),
                       _pool_gather(v, block_tables, n_pages), positions,
                       scale)


def _check_cuda_args(q, k, v, positions, page_size: int,
                     block_tables=None) -> None:
    tensors = {"q": q, "k": k, "v": v, "positions": positions}
    if block_tables is not None:
        tensors["block_tables"] = block_tables
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name in ("q", "k", "v"):
        if tensors[name].dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got "
                            f"{tensors[name].dtype}")
    for name in ("positions", "block_tables"):
        t = tensors.get(name)
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [N, H, hd] and k/v 4-D of one shape; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    N, H, hd = q.shape
    KV, khd = k.shape[2], k.shape[3]
    if hd not in HEAD_DIMS or khd != hd:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS} for q and "
                         f"k/v, got {hd} and {khd}")
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if positions.shape != (N,):
        raise ValueError("positions must be [N]")
    if not q.is_contiguous() or not positions.is_contiguous():
        raise ValueError("q and positions must be contiguous")
    if block_tables is not None:
        if k.shape[1] != page_size:
            raise ValueError(f"pool page {k.shape[1]} != page_size "
                             f"{page_size}")
        if block_tables.dim() != 2 or block_tables.shape[0] != N:
            raise ValueError("block_tables must be [N, max_pages]")
        for name in ("k", "v", "block_tables"):
            if not tensors[name].is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        return
    if k.shape[0] != N:
        raise ValueError(f"k/v hold {k.shape[0]} slots, q {N}")
    if k.shape[1] % page_size:
        raise ValueError(f"cache span {k.shape[1]} not divisible by page "
                         f"{page_size}")
    for name, t in (("k", k), ("v", v)):
        # [N, S, KV, hd] with a dense inner [S, KV, hd]; the slot stride is
        # free (the model's cache[:, :S] view).
        if t.stride()[1:] != (KV * hd, hd, 1):
            raise ValueError(f"{name}'s inner [S, KV, hd] must be dense")
        if t.data_ptr() % 16 or t.stride(0) % 8:
            raise ValueError(f"{name} must be 16-byte aligned per slot")


#: the kernel's chunk rule (``plan`` in ``csrc/paged_attention.cu``; its
#: source note gives the reasons): chunks are a multiple of CHUNK_KEYS keys,
#: aim at TARGET_ITEMS items when every slot sits at the span's end, carry
#: at least MIN_ITEM_BYTES of K/V rows and at most the span; a row tile is
#: ROW_TILE query heads; a call takes at most MAX_SLOTS slots.
CHUNK_KEYS, TARGET_ITEMS, MIN_ITEM_BYTES, ROW_TILE, MAX_SLOTS = (
    64, 198, 131072, 16, 2048)


@functools.lru_cache(maxsize=512)
def split_plan(N: int, H: int, KV: int, head_dim: int, span: int) -> tuple:
    """``(max_chunks, chunk, row_tiles)`` for a call over a span of
    ``span`` keys (the dense cache's S, or the pool's ``max_pages *
    page``): each row tile (slot, KV head, 16 query heads) cuts its live
    keys into chunks of ``chunk`` keys, ``max_chunks`` of them at the
    span's end. A function of the shapes only, never of positions: a
    slot's chunks follow from its own position (``slot_chunks``). The
    kernel holds a launch to this rule and refuses any other chunk; the
    card tests hold the rule to the kernel's ``paged_decode_plan``.
    Raises ValueError for shapes the kernel does not take."""
    if not (0 < N <= MAX_SLOTS and KV > 0 and H % KV == 0 and span > 0
            and head_dim in HEAD_DIMS):
        raise ValueError(f"the paged kernel takes no shapes "
                         f"{(N, H, KV, head_dim, span)}")
    tiles = N * KV * -(-(H // KV) // ROW_TILE)
    chunk = max(-(-span * tiles // TARGET_ITEMS),
                MIN_ITEM_BYTES // (4 * head_dim))
    chunk = min(-(-chunk // CHUNK_KEYS), -(-span // CHUNK_KEYS)) * CHUNK_KEYS
    return -(-span // chunk), chunk, tiles


def slot_chunks(position: int, span: int, chunk: int) -> int:
    """The chunks (work items per row tile) of a slot at ``position``:
    one for a negative position (its rows are zeros), else
    ``min(position, span - 1) // chunk + 1``."""
    return 1 if position < 0 else min(position, span - 1) // chunk + 1


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, its entry points typed once."""
    from ._cuda import load

    lib = load("paged_attention")
    P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
    lib.paged_decode_bf16.argtypes = [P] * 7 + [I] * 5 + [F, I, P]
    lib.paged_decode_pool_bf16.argtypes = [P] * 8 + [I] * 7 + [F, I, P]
    lib.paged_decode_map_dense.argtypes = [P, I, I, I, I, L, P]
    lib.paged_decode_map_pool.argtypes = [P, I, I, I, I, P]
    lib.paged_attention_error_string.argtypes = [I]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    for fn in (lib.paged_decode_bf16, lib.paged_decode_pool_bf16,
               lib.paged_decode_map_dense, lib.paged_decode_map_pool):
        fn.restype = I
    return lib


#: encoded tensor maps (CUtensorMap, 128 bytes) by everything a map holds:
#: the pointer, the shape and the slot stride; the pool's and the cache's
#: per-layer buffers live as long as the engine, so each is encoded once.
_MAPS: "OrderedDict[tuple, ctypes.Array]" = OrderedDict()
_MAPS_KEPT = 1024
#: the merge's arrival counters (int32, zeroed once) and partials (f32) of
#: each (device, stream): launches on one stream never overlap, and each
#: leaves every counter at 0.
_SCRATCH: Dict[tuple, tuple] = {}
_CACHE_LOCK = threading.Lock()    # both caches: look up, then fill


def _raise(lib, what: str, err: int) -> None:
    msg = lib.paged_attention_error_string(err).decode()
    raise RuntimeError(f"paged attention {what} failed: {msg} "
                       f"(cudaError {err})")


def _tensor_map(lib, t: torch.Tensor, page: int = 0) -> ctypes.Array:
    """The TMA map of a K or V leaf: the pool [n_blocks, page, KV, hd]
    when ``page``, else the dense cache [N, S, KV, hd] by its slot
    stride."""
    key = (t.data_ptr(), tuple(t.shape), t.stride(0), page)
    with _CACHE_LOCK:
        got = _MAPS.get(key)
        if got is not None:
            return got
        got = ctypes.create_string_buffer(128)
        a, b, kv, hd = t.shape
        err = (lib.paged_decode_map_pool(t.data_ptr(), a, b, kv, hd, got)
               if page else
               lib.paged_decode_map_dense(t.data_ptr(), a, b, kv, hd,
                                          t.stride(0), got))
        if err:
            _raise(lib, "tensor map", err)
        _MAPS[key] = got
        if len(_MAPS) > _MAPS_KEPT:
            _MAPS.popitem(last=False)
        return got


def _scratch(device: torch.device, stream: int, tiles: int,
             floats: int) -> tuple:
    """The counters and the workspace of (device, stream), at least
    ``tiles`` counters and ``floats`` floats: allocated on that stream,
    the counters zeroed once, both grown for a larger shape."""
    key = (device.index, stream)
    with _CACHE_LOCK:
        got = _SCRATCH.get(key)
        if got is None or got[0].numel() < tiles or got[1].numel() < floats:
            tiles = max(tiles, got[0].numel() if got else 0)
            floats = max(floats, got[1].numel() if got else 0)
            got = (torch.zeros(tiles, dtype=torch.int32, device=device),
                   torch.empty(floats, dtype=torch.float32, device=device))
            _SCRATCH[key] = got
        return got


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            positions: torch.Tensor, tables: Optional[torch.Tensor],
            span: int, scale: float) -> torch.Tensor:
    """One launch of the kernel on torch's current stream of q's device,
    over the pool when ``tables`` is given; raise on a refused launch.
    Returns the output."""
    N, H, hd = q.shape
    KV = k.shape[2]
    max_chunks, chunk, tiles = split_plan(N, H, KV, hd, span)
    lib = _library()
    page = k.shape[1] if tables is not None else 0
    kmap, vmap = (_tensor_map(lib, x, page) for x in (k, v))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = ws = 0
        if max_chunks > 1:
            c, w = _scratch(q.device, stream, tiles,
                            tiles * max_chunks * ROW_TILE * (hd + 2))
            counters, ws = c.data_ptr(), w.data_ptr()
        if page:
            err = lib.paged_decode_pool_bf16(
                q.data_ptr(), kmap, vmap, positions.data_ptr(),
                tables.data_ptr(), out.data_ptr(), ws, counters, N, H, KV,
                hd, page, k.shape[0], tables.shape[1], scale, chunk, stream)
        else:
            err = lib.paged_decode_bf16(
                q.data_ptr(), kmap, vmap, positions.data_ptr(),
                out.data_ptr(), ws, counters, N, H, KV, hd, span, scale,
                chunk, stream)
    if err:
        _raise(lib, "kernel launch", err)
    return out


def paged_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, positions: torch.Tensor, *,
                           page_size: int = 128,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over contiguous per-slot caches (see the module
    docstring). Requires the cache span divisible by ``page_size``. CPU
    tensors take the plain version; CUDA tensors launch the Hopper
    kernel (bf16 q/k/v, int32 positions, head_dim 64/128/256) and raise
    on anything else."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k, v, positions,
                                            page_size=page_size, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check_cuda_args(q, k, v, positions, page_size)
    out = _launch(q, k, v, positions, None, k.shape[1], float(scale))
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_pool(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, positions: torch.Tensor,
                                block_tables: torch.Tensor, *,
                                page_size: int = 128,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Decode attention over the pool through block tables (see the
    module docstring). CPU tensors take the plain version; CUDA tensors
    launch the Hopper kernel (bf16 q/k/v, int32 positions and tables,
    contiguous, head_dim 64/128/256) and raise on anything else."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_decode_attention_pool_plain(
            q, k, v, positions, block_tables, page_size=page_size,
            scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_pool runs on cuda or cpu, "
                         f"not {q.device}")
    _check_cuda_args(q, k, v, positions, page_size, block_tables)
    out = _launch(q, k, v, positions, block_tables,
                  block_tables.shape[1] * k.shape[1], float(scale))
    paged_decode_attention_pool.launches += 1
    return out


paged_decode_attention_pool.launches = 0


def paged_decode_attention_pool_sharded(q, k, v, positions, block_tables,
                                        mesh, *, page_size: int = 128,
                                        scale: Optional[float] = None,
                                        plain: bool = False) -> list:
    """Pool decode attention over the ``model`` axis of ``mesh``: Q and
    KV heads split together, and ``paged_decode_attention_pool`` (the
    Hopper kernel ``paged_decode_pool_bf16`` for CUDA shards) launched
    once per shard on that shard's own contiguous q/k/v, on torch's
    current stream of its device. Replaces the JAX
    ``paged_decode_attention_pool_sharded`` (a ``shard_map`` of the
    Pallas kernel).

    ``q`` [N, H, hd] and ``k``/``v`` [n_blocks, page, KV, hd] are whole
    tensors (split here, with the JAX refusal when the heads do not
    divide) or lists of per-shard blocks, one per shard of the mesh
    (None for another process's shard);
    ``positions`` and ``block_tables`` are the same on every shard.
    Returns the per-shard
    outputs [N, H/tp, hd] in shard order (``torch.cat(out, dim=1)``
    assembles them). ``plain`` runs the plain version per shard (the
    comparisons' reference). ``.launches`` counts the kernel launches,
    one per CUDA shard a call."""
    tp = mesh.shape["model"] if mesh is not None else 1
    fn = (paged_decode_attention_pool_plain if plain
          else paged_decode_attention_pool)
    if tp <= 1 and not isinstance(q, (list, tuple)):
        return [fn(q, k, v, positions, block_tables, page_size=page_size,
                   scale=scale)]
    if not isinstance(q, (list, tuple)):
        check_heads_divide("pool paged kernel", q.shape[1],
                           global_heads(k, 2), tp)
    qs = split_heads(q, mesh, 1)
    ks, vs = split_heads(k, mesh, 2), split_heads(v, mesh, 2)
    devices = [None if t is None else t.device for t in qs]
    before = paged_decode_attention_pool.launches
    out = [None if qs[i] is None else
           fn(qs[i], ks[i], vs[i], pos, tbl, page_size=page_size,
              scale=scale)
           for i, (pos, tbl) in enumerate(zip(
               on_shards(positions, devices),
               on_shards(block_tables, devices)))]
    # One per shard whose kernel launched (CPU shards launch none).
    paged_decode_attention_pool_sharded.launches += (
        paged_decode_attention_pool.launches - before)
    return out


paged_decode_attention_pool_sharded.launches = 0
