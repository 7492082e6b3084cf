"""Ragged paged attention over the block pool: the Hopper kernel, its
plain PyTorch version, and the wrapper that picks between them.

Replaces the Pallas TPU kernel ``ai_agent_kubectl_tpu/ops/
ragged_attention.py::ragged_attention_pool``: ONE kernel for every
attention shape the serving loop runs over the pool. Per slot n the
query columns ``0 .. q_lens[n]-1`` sit at absolute positions
``positions[n] + j`` and attend kv positions ``<= positions[n] + j``
through ``block_tables[n]`` — q_len 1 is a decode step, k+1 a verify
window, a prompt span a (suffix) prefill, 0 freezes the slot.

Shape contract (the JAX package's):

- ``q``            [N, W, H, hd]
- ``k``/``v``      [n_blocks, page, KV, hd] — the shared pool
- ``q_lens``       [N] int32
- ``positions``    [N] int32 — absolute position of query column 0
- ``block_tables`` [N, max_pages] int32; entries >= n_blocks are the
  unmapped-page sentinel (clamped to n_blocks - 1, never read past the
  slot's last live row)

Output [N, W, H, hd]; rows of padded columns and frozen slots are zeros.

The kernel (``csrc/ragged_attention.cu``, CUDA C++ for sm_90a) runs for
CUDA tensors; its source note gives its design and what bounds it. The
plain version runs for CPU tensors only. A CUDA tensor launches the
kernel or raises — nothing falls back to the plain version.
``ragged_attention_pool.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .attention import dense_attention

HEAD_DIMS = (64, 128, 256)


def ragged_attention_pool_plain(q, k, v, q_lens, positions, block_tables,
                                *, page_size: int,
                                scale: Optional[float] = None):
    """Gather each slot's pages through its table into a contiguous
    [N, max_pages*page, KV, hd] view (the JAX ``_pool_gather``) and run
    ``dense_attention`` under the mask ``kv <= pos + j  and  j < q_len``.

    Rows past the slot's last live row (``pos + max(q_len, 1) - 1``) are
    selected away, not multiplied by zero, so an unmapped or stale block
    (even one holding NaN) never reaches the output; columns past q_len
    are zeros, not the average a fully masked softmax would give."""
    N, W, H, hd = q.shape
    n_blocks, page, KV, _ = k.shape
    if page != page_size:
        raise ValueError(f"pool page {page} != page_size {page_size}")
    max_pages = block_tables.shape[1]
    idx = block_tables.long().clamp(0, n_blocks - 1)
    S = max_pages * page
    k_ctx = k[idx].reshape(N, S, KV, hd)
    v_ctx = v[idx].reshape(N, S, KV, hd)
    pos = positions.long()[:, None]                      # [N, 1]
    ql = q_lens.long()[:, None]                          # [N, 1]
    kv_pos = torch.arange(S, device=q.device)[None, :]   # [1, S]
    live = (kv_pos <= pos + ql.clamp(min=1) - 1)[:, :, None, None]
    k_ctx = torch.where(live, k_ctx, 0.0)
    v_ctx = torch.where(live, v_ctx, 0.0)
    cols = torch.arange(W, device=q.device)[None, :]     # [1, W]
    col_ok = cols < ql                                   # [N, W]
    mask = (kv_pos[:, None, :] <= (pos + cols)[:, :, None]) \
        & col_ok[:, :, None]                             # [N, W, S]
    out = dense_attention(q, k_ctx, v_ctx, mask, scale=scale)
    return torch.where(col_ok[:, :, None, None], out, 0.0)


def split_plan(N: int, W: int, H: int, KV: int, max_pages: int,
               page: int) -> tuple:
    """``(splits, keys_per_split, ws_rows)`` for a call: the keys of
    every 64-row tile cut into ranges of ``keys_per_split`` (a multiple
    of 64) when the (slot, KV head, row tile) blocks alone are under one
    per SM, and the rows of each split's workspaces. The kernel's own
    rule (``ragged_attention_plan`` in ``csrc/ragged_attention.cu``),
    read from its library, so it builds the kernel first. A function of
    the shapes only, never of positions or q_lens: a row's live splits
    follow from its own slot's last key. The source note bounds the
    workspaces (26.2 MB at head_dim 256)."""
    from ._cuda import split_plan as read_plan

    return read_plan("ragged_attention", "ragged_attention_plan", N, W, H,
                     KV, max_pages, page)


def _check_cuda_args(q, k, v, q_lens, positions, block_tables,
                     page_size: int) -> None:
    tensors = {"q": q, "k": k, "v": v, "q_lens": q_lens,
               "positions": positions, "block_tables": block_tables}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "k", "v"):
        if tensors[name].dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got "
                            f"{tensors[name].dtype}")
    for name in ("q_lens", "positions", "block_tables"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got "
                            f"{tensors[name].dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [N, W, H, hd] and k/v [n_blocks, "
                         f"page, KV, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    N, W, H, hd = q.shape
    _, page, KV, khd = k.shape
    if hd not in HEAD_DIMS or khd != hd:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS} for q and "
                         f"k/v, got {hd} and {khd}")
    if page != page_size:
        raise ValueError(f"pool page {page} != page_size {page_size}")
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if (q_lens.shape != (N,) or positions.shape != (N,)
            or block_tables.dim() != 2 or block_tables.shape[0] != N):
        raise ValueError("q_lens/positions must be [N] and block_tables "
                         "[N, max_pages]")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("q, k and v must be 16-byte aligned")


def ragged_attention_pool(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, q_lens: torch.Tensor,
                          positions: torch.Tensor,
                          block_tables: torch.Tensor, *,
                          page_size: int,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Ragged block-paged attention over the pool (see the module
    docstring). CPU tensors take the plain version; CUDA tensors launch
    the Hopper kernel (bf16 q/k/v, int32 indices, contiguous, head_dim
    64/128/256) and raise on anything else."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ragged_attention_pool_plain(q, k, v, q_lens, positions,
                                           block_tables,
                                           page_size=page_size, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_attention_pool runs on cuda or cpu, "
                         f"not {q.device}")
    _check_cuda_args(q, k, v, q_lens, positions, block_tables, page_size)
    from ._cuda import load, split_workspaces

    lib = load("ragged_attention")
    fn = lib.ragged_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    N, W, H, hd = q.shape
    n_blocks, page, KV, _ = k.shape
    max_pages = block_tables.shape[1]
    splits, kps, rows = split_plan(N, W, H, KV, max_pages, page)
    out = torch.empty_like(q)
    ws_o, ws_ml, _keep = split_workspaces(splits, rows, hd, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 q_lens.data_ptr(), positions.data_ptr(),
                 block_tables.data_ptr(), out.data_ptr(), ws_o, ws_ml,
                 N, W, H, KV, hd, page, n_blocks, max_pages,
                 float(scale), kps, splits, stream)
    if err != 0:
        lib.ragged_attention_error_string.restype = ctypes.c_char_p
        lib.ragged_attention_error_string.argtypes = [ctypes.c_int]
        msg = lib.ragged_attention_error_string(err).decode()
        raise RuntimeError(f"ragged attention kernel launch failed: "
                           f"{msg} (cudaError {err})")
    ragged_attention_pool.launches += 1
    return out


ragged_attention_pool.launches = 0


# ------------------------------------------------- over a model axis

def split_heads(x, mesh, axis: int) -> list:
    """Per-shard blocks of ``x``: a list is taken as the shards
    themselves, one per shard of ``mesh`` (the shards of one model
    coordinate hold its heads, over every data and expert row); a tensor
    is cut into the model axis's contiguous blocks of heads along
    ``axis``, each a tensor of its own (the kernels read contiguous k/v),
    on a mesh of that axis alone."""
    tp = mesh.shape["model"]
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} shards for a mesh of {mesh.size}")
        return list(x)
    if mesh.size != tp:
        raise ValueError(f"a whole tensor splits over a model axis alone, "
                         f"not a mesh of {mesh.size} shards")
    return [c.contiguous() for c in x.chunk(tp, dim=axis)]


def on_shards(x, devices) -> list:
    """A replicated argument (positions, q_lens, tables) on each shard's
    device: a list is taken as it is, a tensor moved where it is not
    (None for another process's shard, whose device is None)."""
    if isinstance(x, (list, tuple)):
        return list(x)
    return [None if d is None else x if x.device == d else x.to(d)
            for d in devices]


def global_heads(x, axis: int) -> int:
    """Heads along ``axis`` of a whole tensor or of its shards together."""
    if isinstance(x, (list, tuple)):
        return sum(t.shape[axis] for t in x)
    return x.shape[axis]


def check_heads_divide(kind: str, H: int, KV: int, tp: int) -> None:
    """The JAX sharded wrappers' refusal: Q and KV heads split together,
    whole KV groups per shard."""
    if KV % tp or H % tp:
        raise ValueError(
            f"{kind} needs KV ({KV}) and H ({H}) divisible by the model "
            f"axis ({tp}); engine startup resolves such meshes to the "
            f"gather path")


def ragged_attention_pool_sharded(q, k, v, q_lens, positions,
                                  block_tables, mesh, *, page_size: int,
                                  scale: Optional[float] = None,
                                  plain: bool = False) -> list:
    """Ragged pool attention over the ``model`` axis of ``mesh``: Q and
    KV heads split together, and ``ragged_attention_pool`` (the Hopper
    kernel for CUDA shards) launched once per shard on that shard's own
    contiguous q/k/v, on torch's current stream of its device. Replaces
    the JAX ``ragged_attention_pool_sharded`` (a ``shard_map`` of the
    Pallas kernel).

    ``q`` [N, W, H, hd] and ``k``/``v`` [n_blocks, page, KV, hd] are
    whole tensors (split here, with the JAX refusal when the heads do
    not divide) or lists of per-shard blocks, one per shard of the mesh
    (the pool's own shards; None for another process's shard, which
    launches nothing here);
    ``q_lens``, ``positions`` and ``block_tables`` are the same on every
    shard (a tensor, or one per shard). Each shard's local G = H/KV is
    the model's. Returns the per-shard outputs [N, W, H/tp, hd] in shard
    order (``torch.cat(out, dim=2)`` assembles them). ``plain`` runs the
    plain version per shard (the comparisons' reference). ``.launches``
    counts the kernel launches, one per CUDA shard a call."""
    tp = mesh.shape["model"] if mesh is not None else 1
    if tp <= 1 and not isinstance(q, (list, tuple)):
        fn = ragged_attention_pool_plain if plain else ragged_attention_pool
        return [fn(q, k, v, q_lens, positions, block_tables,
                   page_size=page_size, scale=scale)]
    if not isinstance(q, (list, tuple)):
        check_heads_divide("ragged pool kernel", q.shape[2],
                           global_heads(k, 2), tp)
    qs, ks, vs = (split_heads(x, mesh, ax) for x, ax in
                  ((q, 2), (k, 2), (v, 2)))
    devices = [None if t is None else t.device for t in qs]
    fn = ragged_attention_pool_plain if plain else ragged_attention_pool
    before = ragged_attention_pool.launches
    out = [None if qs[i] is None else
           fn(qs[i], ks[i], vs[i], ql, pos, tbl, page_size=page_size,
              scale=scale)
           for i, (ql, pos, tbl) in enumerate(zip(
               on_shards(q_lens, devices), on_shards(positions, devices),
               on_shards(block_tables, devices)))]
    # One per shard whose kernel launched (CPU shards launch none).
    ragged_attention_pool_sharded.launches += (ragged_attention_pool.launches
                                               - before)
    return out


ragged_attention_pool_sharded.launches = 0
