"""int8 quantization of weights and of the KV cache, and the per-leaf
matmul dispatch.

The counterpart of the JAX package's ``ops/quant.py``:

- ``QuantInt8``: per-output-channel symmetric int8 for the projection
  matmuls, f32 scales applied in the epilogue — ``(x @ q) * scale``.
  The JAX package leaves the convert and the scale to XLA's fusion, not
  to a Pallas kernel, so plain PyTorch ops serve them here.
- ``QuantInt8W8A8``: the same payload and scales, but ``qmatmul`` also
  quantizes the activations per token and multiplies s8 x s8 into s32
  (``int8_matmul``), both scales in an f32 epilogue. ``to_w8a8`` retags
  the layer projections of an int8 tree.
- ``QuantKV`` (``KV_QUANT=int8``): an int8 KV cache with one f32 scale
  per (position, head) vector, written by ``kv_quantize`` and read by
  ``ops/attention.py::dense_attention_quant``; ``kv_map`` applies one
  leaf operation to both of its leaves (or to a plain cache tensor), and
  the group admission's ``kv_update_slice``, ``kv_set_slots`` (padding
  rows dropped) and ``kv_broadcast_rows`` go through it.
- A per-ROW int8 embedding (``quantize_embed_int8``): one scale per
  vocab row serves the token gather (``embed_lookup``) and the tied LM
  head (``tied_head``).
- ``qmatmul`` dispatches per leaf: a plain tensor, a ``QuantInt8``, or a
  packed ``QuantInt4`` (``ops/quant4.py``, the Hopper int4 kernel).
- ``random_params_int8`` draws a tree directly in quantized form on the
  device (no full-precision 7B tree is ever built), with the structure,
  shapes and dtypes ``quantize_params_int8(init_params(...))`` gives.
- MoE expert stacks ``[L, E, in, out]`` quantize per (layer, expert,
  out-channel) and stay int8 under int4 too (the int4 kernel serves 2-D
  slices; ``parallel/moe.py`` takes int8 experts); the router stays in
  full precision.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .quant4 import QuantInt4, pick_format, qmatmul4, true_div


@dataclasses.dataclass
class QuantInt8:
    """Per-output-channel symmetric int8 weight.

    q:     int8, the original weight's shape
    scale: f32, the original shape with the contraction axis (-2)
           collapsed to 1 (per (layer, output channel) for a stack)
    """

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __getitem__(self, i) -> "QuantInt8":
        """One layer of a stacked leaf (a view, no copy)."""
        return type(self)(q=self.q[i], scale=self.scale[i])


@dataclasses.dataclass
class QuantInt8W8A8(QuantInt8):
    """A ``QuantInt8`` whose ``qmatmul`` quantizes the activations per
    token too and multiplies s8 x s8 into s32 (W8A8); the payload and
    scales are the weight-only leaf's. The JAX package keeps it as a
    library option: no serving knob selects it."""


def to_w8a8(params: Dict[str, Any]) -> Dict[str, Any]:
    """Retag the layer projections' ``QuantInt8`` leaves of rank 3 as
    ``QuantInt8W8A8`` (same tensors). The embedding and the head stay
    weight-only (their outputs are the logits, where activation noise
    moves the argmax), and so do the rank-4 MoE expert stacks
    (``parallel/moe.py`` has no W8A8 path)."""
    out = dict(params)
    out["layers"] = {
        name: (QuantInt8W8A8(q=w.q, scale=w.scale)
               if isinstance(w, QuantInt8) and w.q.dim() == 3 else w)
        for name, w in params["layers"].items()}
    return out


def quantize_int8(w: torch.Tensor) -> QuantInt8:
    """Symmetric int8, one scale per (leading..., output channel): only
    the contraction axis (-2) is reduced."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax > 0, true_div(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantInt8(q=q, scale=scale)


def dequantize(w: QuantInt8, dtype=torch.bfloat16) -> torch.Tensor:
    return (w.q.float() * w.scale).to(dtype)


def quantize_embed_int8(embed: torch.Tensor,
                        chunk: int = 65536) -> QuantInt8:
    """Per-ROW symmetric int8 for the embedding [vocab, dim], quantized
    in vocab-row chunks to bound the f32 transient."""
    qs, ss = [], []
    for i in range(0, embed.shape[0], chunk):
        blk = embed[i:i + chunk].float()
        absmax = blk.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(absmax > 0, true_div(absmax, 127.0),
                            torch.ones_like(absmax))
        qs.append(torch.clamp(torch.round(blk / scale), -127, 127)
                  .to(torch.int8))
        ss.append(scale)
    return QuantInt8(q=torch.cat(qs), scale=torch.cat(ss))


def embed_lookup(emb, tokens: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Token-row gather for a plain or per-row ``QuantInt8`` embedding."""
    idx = tokens.long()
    if isinstance(emb, QuantInt8):
        return (emb.q[idx].float() * emb.scale[idx]).to(dtype)
    return emb[idx].to(dtype)


def tied_head(h: torch.Tensor, emb) -> torch.Tensor:
    """LM head through a (possibly per-row-quantized) tied embedding:
    ``logits[..., v] = h . emb[v]``, in h's dtype."""
    if isinstance(emb, QuantInt8):
        y = h @ emb.q.to(h.dtype).T
        return (y.float() * emb.scale[:, 0]).to(h.dtype)
    return h @ emb.to(h.dtype).T


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]``, both int8, into an exact int32 product.
    On the card ``torch._int_mm`` (cuBLASLt's s8 x s8 -> s32 GEMM, as the
    JAX package's ``dot_general`` with an int32 result is XLA's), which
    takes more than 16 rows and K, N multiples of 8: fewer rows (a decode
    step) are padded with zero rows and sliced off. On the CPU an int32
    product, exact as well. A float product would not be: float32 holds
    K * 127**2 exactly only for K < 1041."""
    if a.device.type == "cuda":
        M = a.shape[0]
        rows = max(M, 17)
        rows = -(-rows // 8) * 8
        if rows != M:
            a = torch.cat([a, a.new_zeros((rows - M, a.shape[1]))])
        return torch._int_mm(a, b)[:M]
    return a.to(torch.int32) @ b.to(torch.int32)


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain, ``QuantInt8``, ``QuantInt8W8A8`` or
    ``QuantInt4`` weight ``w [in, out]``. int8: the convert feeds the
    product and the scale multiplies in f32 before one cast; W8A8: per
    token symmetric activation quantization, an exact s32 product, both
    scales in the f32 epilogue; int4: the packed-nibble kernel."""
    if isinstance(w, QuantInt4):
        return qmatmul4(x, w)
    if isinstance(w, QuantInt8W8A8):
        ax = x.abs().amax(dim=-1, keepdim=True).float()
        sx = torch.clamp(true_div(ax, 127.0), min=1e-12)
        xq = torch.clamp(torch.round(x.float() / sx), -127, 127).to(
            torch.int8)
        y = int8_matmul(xq.reshape(-1, x.shape[-1]), w.q)
        y = y.reshape(*x.shape[:-1], w.q.shape[-1])
        return (y.float() * sx * w.scale[0]).to(x.dtype)
    if isinstance(w, QuantInt8):
        y = x @ w.q.to(x.dtype)
        # Scale in f32, cast once: rounding the scales to the activation
        # dtype first would add systematic per-channel error.
        return (y.float() * w.scale[0]).to(x.dtype)
    return x @ w


# ---------------------------------------------------------------- KV cache
#
# KV_QUANT=int8: each (position, head) vector of K and V is stored as
# head_dim int8 values and one f32 scale, 132 bytes against 256 in bf16
# at head_dim 128. Attention reads the int8 span directly: the K scale
# multiplies the scores and the V scale the probabilities
# (``dense_attention_quant``), so no dequantized copy of the span is made.


@dataclasses.dataclass
class QuantKV:
    """Symmetric int8 KV with one scale per head vector.

    q: int8 [..., n_kv_heads, head_dim]
    s: f32  [..., n_kv_heads]

    Every structural operation of the caches (a layer view, a slot or
    block copy, a row scatter, a gather through block tables) indexes
    leading axes only, so it applies to both leaves alike (``kv_map``).
    """

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self):
        """The payload's shape (the cache's geometry)."""
        return tuple(self.q.shape)

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.s.numel() * self.s.element_size())

    def __getitem__(self, i) -> "QuantKV":
        """Leading-axis indexing of both leaves (a view, no copy)."""
        return QuantKV(q=self.q[i], s=self.s[i])


def kv_quantize(x: torch.Tensor) -> QuantKV:
    """[..., hd] -> int8 with one f32 scale per trailing vector,
    bit-equal to the JAX ``kv_quantize`` (a zero vector gets scale 1 and
    zeros)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    s = torch.where(absmax > 0, true_div(absmax, 127.0),
                    torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return QuantKV(q=q, s=s)


def kv_dequantize(kv: QuantKV, dtype=torch.bfloat16) -> torch.Tensor:
    return (kv.q.float() * kv.s[..., None]).to(dtype)


@dataclasses.dataclass
class ShardedKV:
    """One KV cache leaf over the shards of a tensor-parallel mesh
    (``parallel/sharding.py``): each shard's own contiguous leaf — a
    tensor or a ``QuantKV`` — on its own device, never a view of a
    shared one (the attention kernels refuse non-contiguous k/v).
    ``heads_split``: the KV-head axis is split over the shards (each
    holds ``KV / tp`` heads); otherwise each shard holds a full copy.
    ``row_groups``: the slot axis (1) is split over a ``data`` axis of
    that size, the data groups major in shard order (a dense cache's
    ``cache_specs``); 1 = every shard holds every slot. On a mesh that
    spans processes another process's shard is None here."""

    shards: list
    heads_split: bool
    row_groups: int = 1

    @property
    def _first(self):
        return next(s for s in self.shards if s is not None)

    @property
    def shape(self):
        """The first local shard's geometry (KV heads per shard)."""
        return tuple(self._first.shape)

    @property
    def nbytes(self) -> int:
        """Bytes of this process's shards."""
        return sum(s.nbytes for s in self.shards if s is not None)

    @property
    def quantized(self) -> bool:
        return isinstance(self._first, QuantKV)


def kv_map(fn, *kvs):
    """``fn`` applied leaf by leaf: shard by shard over ``ShardedKV``
    arguments, then to ``q`` and then ``s`` of each ``QuantKV`` argument
    (leaves paired in order), or once to plain tensors. Returns a
    ``ShardedKV`` or ``QuantKV`` of the results, or the one result.
    Another process's shard (None) stays None."""
    if isinstance(kvs[0], ShardedKV):
        return ShardedKV(
            shards=[None if kvs[0].shards[i] is None
                    else kv_map(fn, *(kv.shards[i] for kv in kvs))
                    for i in range(len(kvs[0].shards))],
            heads_split=kvs[0].heads_split, row_groups=kvs[0].row_groups)
    if isinstance(kvs[0], QuantKV):
        return QuantKV(q=fn(*(kv.q for kv in kvs)),
                       s=fn(*(kv.s for kv in kvs)))
    return fn(*kvs)


def kv_update_slice(dst, src):
    """Write the KV block ``src`` at the origin of ``dst``, per leaf, in
    place (the JAX ``dynamic_update_slice`` at index 0). Returns
    ``dst``."""
    def upd(d, s):
        d[tuple(slice(0, n) for n in s.shape)].copy_(s)
        return d

    return kv_map(upd, dst, src)


def kv_set_slots(dst, src, slots):
    """Write per-row KV blocks ``src`` [L, R, depth, ...] into the slots
    (axis 1) of ``dst`` named by ``slots``, a host sequence of R ints, in
    place. A row whose slot lies outside ``[0, batch)`` is dropped (the
    group admission's padding rows carry ``batch``), as the JAX scatter's
    ``mode="drop"`` drops it: the slot vector is host truth, so the rows
    are filtered here and never reach an index the device would refuse.

    ``src`` may be shallower than ``dst`` along the sequence axis (2):
    only its ``depth`` positions are written. The slot's stale tail is
    never read (decode's causal mask exposes only positions below the
    slot's live length, and each later position is written by its own
    decode step before the mask reaches it).

    A ``dst`` whose slots are split over ``data`` (``row_groups`` > 1)
    takes a ``src`` whose every shard holds every row: each shard writes
    the rows bound for its own slots, at their local index. A ``dst`` of
    which no shard is this process's is left as it is. Returns
    ``dst``."""
    if isinstance(dst, ShardedKV) and all(s is None for s in dst.shards):
        return dst
    slots = [int(s) for s in np.asarray(slots).reshape(-1)]
    batch = dst.shape[1]

    def set_rows(rows):
        def put(d, s):
            depth = s.shape[2]
            for i, slot in rows:
                d[:, slot, :depth].copy_(s[:, i])
            return d
        return put

    if isinstance(dst, ShardedKV) and dst.row_groups > 1:
        per = len(dst.shards) // dst.row_groups
        for k, (d, s) in enumerate(zip(dst.shards, src.shards)):
            if d is None:
                continue
            lo = (k // per) * batch
            kv_map(set_rows([(i, slot - lo) for i, slot in enumerate(slots)
                             if lo <= slot < lo + batch]), d, s)
        return dst
    return kv_map(set_rows([(i, slot) for i, slot in enumerate(slots)
                            if 0 <= slot < batch]), dst, src)


def kv_broadcast_rows(src, n: int):
    """[L, 1, P, ...] -> [L, n, P, ...] per leaf (a view: the prefix
    spliced into ``n`` scratch rows)."""
    return kv_map(lambda a: a.expand(a.shape[0], n, *a.shape[2:]), src)


#: projection weights eligible for quantization (matmul RHS, output
#: channel last). Embeddings and norms are excluded.
_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def random_params_int8(generator: torch.Generator, cfg, dtype=None,
                       quantize_embed: bool = False, int4: bool = False,
                       device=None) -> Dict[str, Any]:
    """Random-init a tree DIRECTLY in quantized form on ``device``: no
    full-precision tree anywhere (a 7B bf16 init is ~17 GB). Weight
    values are arbitrary, as any random init's; the tree's structure,
    shapes and dtypes match ``quantize_params_int8(init_params(...))``
    (``int4=True``: ``quantize_params_int4``, with tileable projections
    packed and group-scaled, the rest int8, MoE expert stacks included).

    Payload bytes are drawn one ``[in, out]`` slice at a time straight
    into the int8 stack (``random_`` in place; a Mixtral expert stack is
    45 GB of int8), so no transient exceeds one slice. The scales and the
    router's normal draw follow the JAX ``random_params_int8``."""
    from ..models.convert import expected_shapes

    if dtype is None:
        dtype = torch.bfloat16
    shapes = expected_shapes(cfg)

    def int8_payload(shape):
        q = torch.empty(shape, dtype=torch.int8, device=device)
        for part in q.view(-1, *shape[-2:]):
            part.random_(-127, 128, generator=generator)
        return q

    def quantized(shape):
        # MoE expert stacks ([L, E, in, out]) stay int8 under int4.
        fmt = (pick_format(shape[-2], shape[-1])
               if int4 and len(shape) <= 3 else None)
        if fmt is not None:
            q = int8_payload(shape[:-1] + (shape[-1] // 2,))
            G = shape[-2] // fmt[0]
            scale = torch.full(shape[:-2] + (G, shape[-1]),
                               (shape[-2] ** -0.5) / 7.0,
                               dtype=torch.float32, device=device)
            return QuantInt4(q=q, scale=scale, group_in=fmt[0],
                             block_out=fmt[1])
        sshape = tuple(1 if i == len(shape) - 2 else s
                       for i, s in enumerate(shape))
        # Plausible magnitude: absmax ~ the init scale init_params uses.
        scale = torch.full(sshape, (shape[-2] ** -0.5) / 127.0,
                           dtype=torch.float32, device=device)
        return QuantInt8(q=int8_payload(shape), scale=scale)

    def dense(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * scale
        return w.to(dtype)

    def norm(shape):
        fill = torch.zeros if cfg.rms_offset else torch.ones
        return fill(shape, dtype=dtype, device=device)

    layers = {}
    for name, shape in shapes["layers"].items():
        if name in _QUANT_KEYS:
            layers[name] = quantized(shape)
        elif name == "router":
            # The JAX init scales every plain leaf but the embedding by
            # its leading dim to the -1/2 (here the layer count).
            layers[name] = dense(shape, shape[0] ** -0.5)
        else:
            layers[name] = norm(shape)
    vocab, d = shapes["embed"]
    if quantize_embed:
        embed = QuantInt8(q=int8_payload((vocab, d)),
                          scale=torch.full((vocab, 1), 1.0 / 127.0,
                                           dtype=torch.float32,
                                           device=device))
    else:
        embed = dense((vocab, d), 1.0)
    params: Dict[str, Any] = {"embed": embed, "layers": layers,
                              "final_norm": norm(shapes["final_norm"])}
    if "lm_head" in shapes:
        params["lm_head"] = quantized(shapes["lm_head"])
    return params


def quantize_params_int8(params: Dict[str, Any],
                         quantize_embed: bool = False) -> Dict[str, Any]:
    """Quantize every projection weight of an ``init_params`` tree to
    ``QuantInt8`` (and, with ``quantize_embed``, the embedding per row).
    Rank-4 MoE expert stacks get per-(layer, expert, out-channel)
    scales: ``quantize_int8`` reduces only the contraction axis. The
    router is left in full precision."""
    out = dict(params)
    layers = dict(params["layers"])
    for key in _QUANT_KEYS:
        if key in layers and layers[key].dim() in (3, 4):
            layers[key] = quantize_int8(layers[key])
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = quantize_int8(params["lm_head"])
    if quantize_embed:
        out["embed"] = quantize_embed_int8(params["embed"])
    return out


def is_quantized(params: Optional[Dict[str, Any]]) -> bool:
    """Whether a tree's projections are already quantized."""
    if not params:
        return False
    return any(isinstance(w, (QuantInt8, QuantInt4))
               for w in params["layers"].values())
