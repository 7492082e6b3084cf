"""Partition policy: how params, KV cache and activations split over the
mesh axes, and the functions that split them.

The counterpart of the JAX package's ``parallel/sharding.py``. A spec is
a tuple of mesh axis names (or ``None``, or a tuple of names) over a
tensor's dimensions — the JAX ``PartitionSpec`` as a tuple, with the
same policy: Megatron tensor parallelism over the stacked-layer tree of
``models/transformer.py``.

- attention: wq/wk/wv column-parallel (heads split over ``model``), wo
  row-parallel;
- MLP: w_gate/w_up column-parallel, w_down row-parallel;
- MoE: experts split over ``expert``; within an expert the same
  column/row split over ``model``;
- embedding: vocab-sharded (the tied head's logits gather over
  ``model`` before sampling);
- KV cache and pool: KV heads over ``model``; the dense cache's slots
  over ``data`` (the pool never splits: its blocks are shared by every
  slot, so a data mesh serves the dense ladder); every leaf replicated
  over the axes it does not name (each expert row holds its data
  group's cache);
- pipe: every ``[L, ...]`` layer leaf and the cache's layer axis split
  into contiguous stages (each stage's shards hold L/pp layers); the
  embedding, final norm and head are replicated over ``pipe`` as in the
  JAX specs: the first stage's shards embed, the last stage's run the
  norm and the head (``parallel/pipeline.py``);
- seq: params replicated over ``seq`` (each seq row projects its block
  of a ring prefill on its own devices), the cache held by the seq-0
  row alone (``Mesh.cache_row``): the JAX replicas over ``seq`` hold the
  same values, and keeping one spares the host a second copy of every
  launch outside the ring.

``sanitize_spec`` drops an axis that does not divide its dimension. The
``shard_*`` functions split the port's tensors into per-shard tensors
on the mesh's devices, with one difference from the JAX placement: a
head-packed projection (wq, wk, wv) splits on whole heads or not at
all, since each shard runs the attention kernel on its own heads (XLA
may split a single KV head's columns and gather them back; a shard here
cannot). So Gemma-2B's single KV head is replicated under tp=2 and its
query heads split (``head_layout``). Shards on one device that would
hold the same block share one tensor (the weights are read-only). On a
mesh that spans processes each process places its own shards only
(``Mesh.is_local``): another process's shard holds None here, and no
process allocates another's bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..models.config import ModelConfig
from ..ops.quant import QuantInt8, QuantKV, ShardedKV, kv_map
from ..ops.quant4 import QuantInt4
from .mesh import Mesh

Spec = Tuple
Params = Dict[str, Any]


def P(*axes) -> Spec:
    """A spec: one entry per leading dimension (``None`` = whole)."""
    return tuple(axes)


def _axes_prod(mesh: Mesh, axes: tuple) -> int:
    p = 1
    for a in axes:
        p *= mesh.shape[a]
    return p


def sanitize_spec(mesh: Mesh, spec: Spec, shape: tuple) -> Spec:
    """Drop spec axes that don't divide their dimension (-> replicate
    there); the spec is cut or padded with ``None`` to the shape's
    rank."""
    out = []
    for dim, names in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if names is None:
            out.append(None)
            continue
        group = names if isinstance(names, tuple) else (names,)
        prod = _axes_prod(mesh, group)
        out.append(names if prod and dim % prod == 0 else None)
    return P(*out)


def param_specs(cfg: ModelConfig) -> Params:
    """The spec tree matching ``models/transformer.py::init_params`` (the
    leading ``n_layers`` axis over ``pipe``, a no-op on a ``model``
    mesh)."""
    layers: Params = {
        "attn_norm": P("pipe"),
        "wq": P("pipe", None, "model"),
        "wk": P("pipe", None, "model"),
        "wv": P("pipe", None, "model"),
        "wo": P("pipe", "model", None),
        "mlp_norm": P("pipe"),
    }
    if cfg.is_moe:
        layers.update(
            router=P("pipe"),
            w_gate=P("pipe", "expert", None, "model"),
            w_up=P("pipe", "expert", None, "model"),
            w_down=P("pipe", "expert", "model", None),
        )
    else:
        layers.update(
            w_gate=P("pipe", None, "model"),
            w_up=P("pipe", None, "model"),
            w_down=P("pipe", "model", None),
        )
    specs: Params = {
        "embed": P("model", None),
        "layers": layers,
        "final_norm": P(),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "model")
    return specs


def cache_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """The dense cache [L, B, S, KV, hd]: batch over data, KV heads over
    model (the JAX cache's ``lengths`` leaf included; the port keeps
    lengths on the host)."""
    kv = P("pipe", "data", None, "model", None)
    return {"k": kv, "v": kv, "lengths": P("data")}


def pool_cache_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """The pool [L, n_blocks, page, KV, hd]: KV heads over ``model``;
    the block axis never shards (any slot's table may map any block)."""
    kv = P(None, None, None, "model", None)
    return {"k": kv, "v": kv, "lengths": P()}


def residual_spec(mesh: Optional[Mesh], shape: tuple) -> Optional[Spec]:
    """Where the [B, S, d] residual's TP factor lands under the f≈1
    policy: the batch axis when data x model divides B (decode), else
    the sequence axis (prefill's B == 1), else None (the residual is
    replicated). Off on pipe and expert meshes."""
    if (mesh is None or "model" not in mesh.axis_names
            or mesh.shape["model"] <= 1 or mesh.shape["pipe"] > 1
            or mesh.shape["expert"] > 1):
        return None
    B, S = shape[0], shape[1]
    batch = sanitize_spec(mesh, P(("data", "model"),), (B,))
    if batch[0] is not None:
        return P(("data", "model"), None, None)
    seq = sanitize_spec(mesh, P("model"), (S,))
    if S > 1 and seq[0] is not None:
        d_ax = ("data",) if B % max(1, mesh.shape["data"]) == 0 \
            and mesh.shape["data"] > 1 else None
        return P(d_ax[0] if d_ax else None, "model", None)
    return None


def logits_spec(mesh: Optional[Mesh], vocab: int) -> Optional[Spec]:
    """[B, S, vocab] logits: the vocab axis over ``model`` (the head is
    vocab-sharded), or None when the vocab doesn't divide or the policy
    is off for this mesh."""
    if (mesh is None or "model" not in mesh.axis_names
            or mesh.shape["model"] <= 1 or mesh.shape["pipe"] > 1
            or mesh.shape["expert"] > 1):
        return None
    if vocab % mesh.shape["model"]:
        return None
    return P(None, None, "model")


def residual_fraction(mesh: Optional[Mesh], batch: int, dim: int) -> float:
    """The residual fraction the policy shards at the decode shape
    [batch, 1, dim]: 1.0 when the residual splits over the batch rows,
    else 0.0 (replicated)."""
    if mesh is None:
        return 0.0
    spec = residual_spec(mesh, (batch, 1, dim))
    if spec is None:
        return 0.0
    first = spec[0]
    group = first if isinstance(first, tuple) else (first,)
    return 1.0 if "model" in group else 0.0


def residual_split_dim(mesh: Optional[Mesh], shape: tuple) -> Optional[int]:
    """The residual's split dimension under ``residual_spec``: 0 (batch
    rows), 1 (sequence) or None (replicated)."""
    spec = residual_spec(mesh, shape)
    if spec is None:
        return None
    for d, names in enumerate(spec):
        group = names if isinstance(names, tuple) else (names,)
        if "model" in group:
            return d
    return None


# ------------------------------------------------------------- heads

def head_layout(cfg: ModelConfig, tp: int) -> Tuple[bool, bool]:
    """(query heads split, KV heads split) over a model axis of ``tp``
    — the JAX dense path's three layouts:

    - KV % tp == 0: query and KV heads split together (each shard holds
      whole KV groups, its local G the model's);
    - one KV head (MQA) and H % tp == 0: query heads split, the KV head
      replicated;
    - else: heads replicated (every shard runs all of them).
    """
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if tp <= 1:
        return False, False
    if KV % tp == 0 and H % tp == 0:
        return True, True
    if KV == 1 and H % tp == 0:
        return True, False
    return False, False


def kernel_heads_divide(cfg: ModelConfig, tp: int) -> bool:
    """Whether the sharded pool kernels serve this model at ``tp``: KV
    and H both divide the model axis."""
    return tp <= 1 or (cfg.n_kv_heads % tp == 0 and cfg.n_heads % tp == 0)


# ------------------------------------------------------------ placing

class ShardedParams(list):
    """A parameter tree per shard (shard ``i`` on ``mesh.devices[i]``),
    each with the unsharded tree's keys; a replicated leaf is the same
    values on every shard (the same tensor where shards share a
    device). Another process's shard is None."""


#: one cut of a tensor: (dimension, parts, this shard's part)
Cut = Tuple[int, int, int]


def _block(t: torch.Tensor, cuts: Sequence[Cut], device) -> torch.Tensor:
    """A shard's block of ``t``: each cut's dimension split into its
    parts where it divides (a size-1 axis stays whole), copied
    contiguous onto ``device``."""
    out, cut = t, False
    for d, parts, k in cuts:
        n = t.shape[d]
        if parts > 1 and n % parts == 0 and n >= parts:
            out = out.narrow(d, k * (n // parts), n // parts)
            cut = True
    if not cut:
        return out if out.device == device else out.to(device)
    return out.to(device).contiguous()


def _leaf_block(leaf, cuts: Sequence[Cut], device):
    """A leaf's block: a plain tensor, or each tensor field of a
    quantized leaf cut along the same dimensions."""
    if isinstance(leaf, (QuantInt8, QuantKV)):
        fields = dataclasses.fields(leaf)
        return type(leaf)(**{f.name: _block(getattr(leaf, f.name), cuts,
                                            device) for f in fields})
    return _block(leaf, cuts, device)


def _spec_cuts(mesh: Mesh, spec: Spec, shape: tuple, i: int) -> list:
    """Shard ``i``'s cuts of a tensor under ``spec`` (sanitized): one per
    split dimension, over the axis it names at the shard's coordinate
    (a single axis: no parameter or cache spec names a tuple)."""
    coords = mesh.coords(i)
    out = []
    for d, names in enumerate(sanitize_spec(mesh, spec, shape)):
        if names is None:
            continue
        for a in (names if isinstance(names, tuple) else (names,)):
            if mesh.shape[a] > 1:
                out.append((d, mesh.shape[a], coords[a]))
    return out


def _leaf_shards(leaf, spec: Spec, mesh: Mesh) -> list:
    """A weight leaf's block on every shard; shards on one device with
    the same cuts (replicas over ``data``, ``seq``, or an axis the leaf
    does not split) share one block."""
    if isinstance(leaf, QuantInt4):
        raise ValueError("QUANT=int4 does not compose with a multi-device "
                         "mesh; the engines serve int8 instead")
    out, made = [], {}
    for i, dev in enumerate(mesh.devices):
        if not mesh.is_local(i):
            out.append(None)
            continue
        cuts = _spec_cuts(mesh, spec, tuple(leaf.shape), i)
        key = (str(dev), tuple(cuts))
        if key not in made:
            made[key] = _leaf_block(leaf, cuts, dev)
        out.append(made[key])
    return out


def _no_model(spec: Spec) -> Spec:
    """``spec`` with the ``model`` axis dropped (a head-packed projection
    that stays whole over the model axis)."""
    return P(*(None if n == "model" else n for n in spec))


def shard_params(params: Params, mesh: Mesh,
                 cfg: ModelConfig) -> ShardedParams:
    """Split a parameter tree over the mesh per ``param_specs``
    (sanitized per leaf): Megatron splits over ``model``, the expert
    stacks over ``expert`` too, every leaf replicated over ``data``.
    Quantized leaves cut payload and scales along the weight's split
    axes (a size-1 scale axis stays whole: an expert stack's scales
    follow its expert and out-channel axes, the JAX ``_wspec``). The
    head-packed projections split on whole heads (``head_layout``) or
    stay whole over ``model``."""
    specs = param_specs(cfg)
    q_split, kv_split = head_layout(cfg, mesh.tp)
    whole = {"wq": not q_split, "wk": not kv_split, "wv": not kv_split}
    trees = [dict() if mesh.is_local(i) else None
             for i in range(mesh.size)]
    for key, spec in specs.items():
        if key == "layers":
            for t in trees:
                if t is not None:
                    t["layers"] = {}
            for name, lspec in spec.items():
                if whole.get(name):
                    lspec = _no_model(lspec)
                for t, s in zip(trees, _leaf_shards(
                        params["layers"][name], lspec, mesh)):
                    if t is not None:
                        t["layers"][name] = s
            continue
        for t, s in zip(trees, _leaf_shards(params[key], spec, mesh)):
            if t is not None:
                t[key] = s
    return ShardedParams(trees)


def _cache_spec(heads_split: bool, split_rows: bool) -> Spec:
    """The per-shard split of a cache leaf [L, X, Y, KV, hd]: layers over
    ``pipe``, slots (X) over ``data`` and KV heads over ``model``, the
    last two where asked."""
    return P("pipe", "data" if split_rows else None, None,
             "model" if heads_split else None, None)


def _kv_shards(leaf, mesh: Mesh, heads_split: bool,
               split_rows: bool) -> ShardedKV:
    """One cache leaf [L, X, Y, KV, hd] (or a ``QuantKV``) over the
    mesh's cache row (``Mesh.cache_row``): layers over ``pipe``, KV heads
    over ``model`` and slots over ``data`` where asked, else a whole copy
    per shard; each shard's leaf its own tensor."""
    mesh = mesh.cache_row()[0]
    spec = _cache_spec(heads_split, split_rows)
    out, seen = [], set()
    for i, dev in enumerate(mesh.devices):
        if not mesh.is_local(i):
            out.append(None)
            continue
        block = _leaf_block(leaf, _spec_cuts(mesh, spec, tuple(leaf.shape),
                                             i), dev)
        ptr = (block.q if isinstance(block, QuantKV) else block).data_ptr()
        if ptr in seen:
            # Each shard owns its copy: writes go to each shard's leaf.
            block = kv_map(torch.clone, block)
        seen.add(ptr)
        out.append(block)
    return ShardedKV(shards=out, heads_split=heads_split,
                     row_groups=mesh.dp if split_rows else 1)


def rows_split(mesh: Mesh, batch: int) -> bool:
    """Whether a dense cache of ``batch`` slots splits them over
    ``data`` (``cache_specs``: where the axis divides)."""
    return mesh.dp > 1 and batch % mesh.dp == 0


def shard_cache(cache, mesh: Mesh, cfg: ModelConfig, *,
                split_rows: bool = False):
    """A dense per-slot ``KVCache`` split over the mesh's cache row:
    layers over ``pipe``, KV heads over ``model`` where they divide
    (``cache_specs``), and with ``split_rows`` its slots over ``data``
    where that divides; else a whole copy per shard."""
    from ..models.transformer import KVCache

    heads = head_layout(cfg, mesh.tp)[1]
    split = split_rows and rows_split(mesh, cache.k.shape[1])
    return KVCache(k=_kv_shards(cache.k, mesh, heads, split),
                   v=_kv_shards(cache.v, mesh, heads, split))


def shard_pool_cache(cache, mesh: Mesh, cfg: ModelConfig):
    """A block-paged pool ``KVCache`` split over the mesh: KV heads over
    ``model`` where they divide (``pool_cache_specs``), every other axis
    whole; each shard's K and V are tensors of their own."""
    return shard_cache(cache, mesh, cfg)


def draft_cache_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """The draft's dense per-slot cache [L2, N, S_alloc, KV2, hd]: KV
    heads over ``model`` as the target's ``cache_specs``, slots over
    ``data``; no pipe factor (the draft stack is never pipelined). Where
    the draft's KV heads do not divide the model axis, ``sanitize_spec``
    drops it and the cache serves replicated (``draft_kv_fallback``)."""
    kv = P(None, "data", None, "model", None)
    return {"k": kv, "v": kv, "lengths": P("data")}


def draft_kv_fallback(mesh: Optional[Mesh], cfg: ModelConfig) -> bool:
    """True when the draft's KV heads do not divide the mesh's ``model``
    axis: its cache serves replicated, a whole copy per shard."""
    if (mesh is None or "model" not in mesh.axis_names
            or mesh.shape["model"] <= 1):
        return False
    return cfg.n_kv_heads % mesh.shape["model"] != 0


def shard_draft_cache(cache, mesh: Mesh, cfg: ModelConfig):
    """The draft's dense ``KVCache`` over the mesh per
    ``draft_cache_specs``: KV heads split where they divide the model
    axis (the port's whole-heads rule, ``head_layout``), slots over
    ``data`` where that divides, else replicated. The draft cache is
    kept in the serving dtype (``KV_QUANT`` applies to the target's)."""
    return shard_cache(cache, mesh, cfg, split_rows=True)


def token_spec() -> Spec:
    """[B, S] token and position arrays: batch over ``data``."""
    return P("data", None)


def replicate(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """One tensor on every shard's device (itself where it already
    is; None for another process's shard)."""
    return [None if not mesh.is_local(i) else t if t.device == d
            else t.to(d) for i, d in enumerate(mesh.devices)]
