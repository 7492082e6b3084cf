"""Pipeline parallelism: the layer stack split into stages over the
``pipe`` axis.

The counterpart of the JAX package's ``parallel/pipeline.py``, on the
port's one-controller mesh (``parallel/mesh.py``):

- Every ``[L, ...]`` layer leaf and the cache's layer axis split over
  ``pipe`` (``parallel/sharding.py``): stage ``s`` is the sub-mesh of
  the shards at pipe coordinate ``s`` (``Mesh.select``), each holding
  L/pp contiguous layers. Inside a stage the ``data``, ``expert`` and
  ``model`` axes serve as everywhere else (PP x TP): each stage runs its
  layers with the mesh forward's per-shard layer code
  (``models/transformer.py::_MeshPass``), attention dense and MoE layers
  dense, as in the JAX stage body.
- The batch splits into microbatches and the stages run the GPipe
  schedule: at step ``t`` stage ``s`` runs microbatch ``t - s``. The
  launches are issued in that order (for each step, for each stage), so
  stages on distinct cards overlap; a bubble step launches nothing.
- The hidden state hands off by a copy to the next stage's devices (the
  JAX ``ppermute``; ``parallel/collectives.py::transfer``, which sends
  it to another process where the next stage lies there); each
  microbatch writes its own rows of each stage's cache. A process runs
  the stages it holds shards of, and only those.
- The embedding, final norm and head stay outside the stages, as in
  JAX, where they are replicated over ``pipe``: the first stage's shards
  embed, the last stage's run the norm and the head, and the logits
  return on the mesh's first device (on every process, on its first
  device of the mesh).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ModelConfig
from .collectives import transfer


def microbatch_count(B: int, n_stages: int,
                     microbatches: Optional[int] = None) -> int:
    """The microbatch count: the largest divisor of B within the stage
    count unless given (the JAX default); raises when it does not divide
    the batch."""
    M = microbatches
    if M is None:
        M = max(m for m in range(1, min(n_stages, B) + 1) if B % m == 0)
    if B % M:
        raise ValueError(f"microbatch count {M} must divide the batch ({B})")
    return M


def _stages(mesh, axis: str, cache) -> list:
    """(sub-mesh, shard indices, per-shard caches) of every stage."""
    from ..models.transformer import _shard_caches

    caches = _shard_caches(cache, mesh)
    out = []
    for s in range(mesh.shape[axis]):
        sub, idx = mesh.select(axis, s)
        out.append((sub, idx, [caches[i] for i in idx]))
    return out


def pipeline_layers(params, cfg: ModelConfig, h: list,
                    positions: torch.Tensor, cache, mesh, *,
                    axis: str = "pipe", microbatches: Optional[int] = None,
                    kv_limit: int, write_mask=None) -> list:
    """The layer stack run pipelined over ``axis``: ``h`` is the embedded
    batch on each first-stage shard (its data group's rows), ``params``
    the per-shard trees of the whole mesh, ``cache`` a ``KVCache`` over
    it (each shard its stage's layers; written in place). Returns the
    hidden states on each last-stage shard. Requires the layers to
    divide over the stages."""
    from ..models.transformer import _layer_trees, _MeshPass, _row_groups

    n_stages = mesh.shape[axis]
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers {cfg.n_layers} must divide pipe stages {n_stages}"
        )
    B = positions.shape[0]
    M = microbatch_count(B, n_stages, microbatches)
    Bm = B // M
    L_l = cfg.n_layers // n_stages
    stages = _stages(mesh, axis, cache)
    groups = _row_groups(cache)
    runs = [[_MeshPass(cfg, sub, None, positions, caches,
                       row_groups=groups, kv_limit=kv_limit,
                       write_mask=write_mask, moe_impl="dense",
                       rows=(m * Bm, (m + 1) * Bm), residual=False)
             for m in range(M)] for sub, _, caches in stages]
    stage_params = [[params[i] for i in idx] for _, idx, _ in stages]
    state = {(0, m): runs[0][m].take(h) for m in range(M)}
    outs = [None] * M
    for t in range(n_stages + M - 1):
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < M:
                continue                # a bubble: nothing to launch
            run, x = runs[s][m], state.pop((s, m))
            for li in range(L_l):
                x = run.layer(_layer_trees(stage_params[s], li), x, li)
            if s + 1 < n_stages:        # hand off to the next stage
                (_, src, _), (nxt, dst, _) = stages[s], stages[s + 1]
                state[(s + 1, m)] = transfer(
                    [(y, a, b, d) for y, a, b, d in
                     zip(x, src, dst, nxt.devices)], mesh)
            else:
                outs[m] = x
    return [None if outs[0][k] is None else
            torch.cat([o[k] for o in outs]) if M > 1 else outs[0][k]
            for k in range(len(outs[0]))]


def pipeline_forward(params, cfg: ModelConfig, tokens: torch.Tensor,
                     positions: torch.Tensor, cache, mesh, *,
                     axis: str = "pipe", microbatches: Optional[int] = None,
                     kv_limit: Optional[int] = None, attn_impl: str = "dense",
                     logits_at=None, write_mask=None):
    """``forward`` with the layer stack pipelined over ``axis`` (the JAX
    ``pipeline_forward``; ``models/transformer.py::forward`` calls it on
    a mesh whose pipe axis is > 1). Attention is dense whatever
    ``attn_impl`` asks, as in the JAX stage body. Returns (logits [B, S
    or 1, vocab] float32, cache)."""
    from ..models.transformer import _MeshPass, _row_groups

    if kv_limit is None:
        kv_limit = cache.max_seq
    stages = _stages(mesh, axis, cache)
    groups = _row_groups(cache)
    first, idx0, caches0 = stages[0]
    h = _MeshPass(cfg, first, tokens, positions, caches0, row_groups=groups,
                  residual=False).embed([params[i] for i in idx0])
    h = pipeline_layers(params, cfg, h, positions, cache, mesh, axis=axis,
                        microbatches=microbatches, kv_limit=kv_limit,
                        write_mask=write_mask)
    last, idx, caches = stages[-1]
    head = _MeshPass(cfg, last, tokens, positions, caches, row_groups=groups,
                     residual=False)
    logits = head.head([params[i] for i in idx], h, logits_at,
                       dest=mesh.home)
    return logits, cache
