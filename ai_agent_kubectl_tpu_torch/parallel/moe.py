"""Mixture-of-Experts MLP: the dense all-experts evaluation and the
expert-parallel dispatch.

The counterpart of the JAX package's ``parallel/moe.py``.
``dense_moe`` evaluates every expert on every token and mixes the
outputs by the router's weights, which are zero off each token's top-k.
``expert_parallel_moe`` shards experts and tokens over the ``expert``
mesh axis: each token's top-k expert computations run on the shard that
owns the expert, GShard-style capacity-bounded dispatch and combine with
two all-to-alls (``parallel/collectives.py::all_to_all``). Routing
follows Mixtral: top-k over the float32 router logits, softmax over the
k picks only. The JAX package runs both as ``jnp.einsum`` with XLA
fusing the int8 convert, outside any Pallas kernel, so here they are
plain torch ops on either device.

- **Ties.** ``x @ router`` rounds to bf16, so equal logits among the
  experts are common. ``jax.lax.top_k`` keeps the lower index on a tie;
  ``torch.topk`` promises no order on the card. ``router_weights`` takes
  the first k of a stable descending sort instead, in the float total
  order XLA compares in (+0 above -0), so a tie at the k-th place picks
  the JAX expert on the CPU and on the card.
- **int8 experts.** Stacks ``[E, in, out]`` may be ``QuantInt8`` with
  per-(expert, out-channel) scales. The JAX ``_qeinsum`` converts the
  whole stack to the activation dtype inside one einsum; eagerly that
  would be a 0.94 GB bf16 copy per projection at Mixtral's widths. Each
  expert's product is taken one ``[in, out]`` slice at a time instead
  (``ops/quant.py::qmatmul``: convert, product, scale in a float32
  epilogue), which bounds the copy at one slice (117 MB for Mixtral)
  and computes the same function. Every step still converts every
  expert: a GEMM that reads int8 weights directly is later speed work
  (ROADMAP.md A11).
- **The dispatch's layout is the JAX one, since it decides which tokens
  drop.** The [B*S] tokens split into ``ep`` contiguous blocks, one per
  expert shard; a token's place in its expert's buffer is the running
  count of the block's earlier live tokens routed there; places past
  the capacity drop (the token gets nothing from that expert). The
  dispatch and combine gather and scatter the kept (token, expert)
  pairs where the JAX one multiplies by one-hot matrices: the same sums
  for finite activations (each buffer row has one source; a token's k
  picks add in expert order, which any order equals at Mixtral's and
  toy-moe's k = 2).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..models.config import ModelConfig
from ..ops.quant import qmatmul
from .collectives import all_gather, all_reduce, all_to_all


def router_weights(cfg: ModelConfig, logits: torch.Tensor) -> tuple:
    """Top-k routing: float32 logits [..., E] -> (mix [..., E] float32,
    idx [..., k] int64). ``mix`` holds the softmax over each token's k
    picks at their experts and zero elsewhere; the picks are the JAX
    ``lax.top_k``'s, the lower index first on a tie."""
    k = cfg.experts_per_token
    logits = logits.float()
    # XLA's top_k compares floats in their total order (+0 above -0):
    # sort on the bit pattern mapped to that order, stably.
    bits = logits.view(torch.int32)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(order, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    top_w = torch.softmax(torch.gather(logits, -1, idx), dim=-1)
    mix = torch.zeros(logits.shape, dtype=torch.float32,
                      device=logits.device)
    return mix.scatter(-1, idx, top_w), idx


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The experts' activation (the JAX ``_act``)."""
    if cfg.activation == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def dense_moe(cfg: ModelConfig, lp: Dict[str, Any],
              x: torch.Tensor) -> torch.Tensor:
    """All-experts evaluation of one layer: x [..., D] -> [..., D].

    ``lp`` holds the layer's ``router`` [D, E] (full precision) and the
    expert stacks ``w_gate``/``w_up`` [E, D, F] and ``w_down`` [E, F, D]
    (plain or ``QuantInt8``). Each product is ``qmatmul`` on one
    expert's slice (the JAX ``_qeinsum`` for that expert: the int8 slice
    converted to x's dtype, its per-out-channel scale applied in
    float32, one cast back). Each expert's output, in x's dtype, is
    weighted by its mix column and summed in float32; the sum is cast
    to x's dtype once."""
    return dense_moe_partial(cfg, lp, x, 0).to(x.dtype)


def dense_moe_partial(cfg: ModelConfig, lp: Dict[str, Any],
                      x: torch.Tensor, first: int) -> torch.Tensor:
    """``dense_moe`` over one shard's share of the experts and of their
    hidden width, before the cast: the float32 sum over its expert
    stacks (global experts ``first`` on) of each one's output on its
    slice of F, weighted by the router's mix. The shards' partials summed
    over the ``expert`` and ``model`` axes are ``dense_moe``'s sum."""
    logits = (x @ lp["router"]).float()
    mix, _ = router_weights(cfg, logits)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(lp["w_gate"].shape[0]):
        e = first + j
        gate = qmatmul(x, lp["w_gate"][j])
        up = qmatmul(x, lp["w_up"][j])
        y = qmatmul(_act(cfg, gate) * up, lp["w_down"][j])
        out += y.float() * mix[..., e:e + 1]
    return out


def default_capacity(cfg: ModelConfig, t_local: int,
                     capacity_factor: float = 2.0) -> int:
    """The JAX default per-expert capacity of one shard's buffer."""
    return max(1, int(capacity_factor * cfg.experts_per_token * t_local
                      / cfg.n_experts))


def ep_routes(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor,
              mask: torch.Tensor, capacity: int) -> tuple:
    """One shard's routing (the JAX ``_ep_shard`` up to its dispatch):
    x [T, D] and mask [T] -> (slot [T, k], each pick's row of the
    flattened [E * capacity] buffers, ``E * capacity`` where the pick
    drops; weight [T, k] float32, the pick's mix weight, 0 where it
    drops). A masked token routes nowhere; a live one's place in its
    expert's buffer is the count of the block's earlier live tokens
    routed there, and places past ``capacity`` drop."""
    logits = (x @ router).float()
    mix, idx = router_weights(cfg, logits)
    mix = mix * mask.float()[:, None]
    routed = mix > 0.0
    pos = torch.cumsum(routed.to(torch.int64), dim=0) - 1
    keep = (routed & (pos < capacity)).gather(1, idx)
    E = cfg.n_experts
    slot = torch.where(keep, idx * capacity + pos.gather(1, idx),
                       torch.full_like(idx, E * capacity))
    return slot, torch.where(keep, mix.gather(1, idx),
                             torch.zeros((), device=x.device))


def _ffn(cfg: ModelConfig, lp: Dict[str, Any],
         x: torch.Tensor) -> torch.Tensor:
    """The shard's experts on their buffers: x [E_local, C', D] ->
    [E_local, C', D] (the JAX ``_ffn``, one expert slice at a time)."""
    out = []
    for j in range(x.shape[0]):
        gate = qmatmul(x[j], lp["w_gate"][j])
        up = qmatmul(x[j], lp["w_up"][j])
        out.append(qmatmul(_act(cfg, gate) * up, lp["w_down"][j]))
    return torch.stack(out)


def expert_parallel_moe(cfg: ModelConfig, lps: Sequence[Dict[str, Any]],
                        xs: Sequence[torch.Tensor], mesh, *,
                        capacity_factor: float = 2.0,
                        capacity: Optional[int] = None,
                        token_mask: Optional[torch.Tensor] = None,
                        ) -> List[torch.Tensor]:
    """Top-k MoE with experts and tokens sharded over ``expert`` (the JAX
    ``expert_parallel_moe``), one controller over per-shard tensors.

    ``lps`` holds each shard's layer tree (``router`` [D, E] whole, the
    expert stacks its ``E / ep`` experts, F split over ``model`` where
    ``mlp_hidden`` divides it); ``xs`` each shard's copy of the whole
    window [B, S, D]; ``token_mask`` [B, S] marks live tokens (0 = dead
    slot or padding, kept out of routing and so out of capacity).
    Shard (.., e, .., m) takes the ``e``-th contiguous block of the
    [B*S] tokens, routes it, sends each kept token to its expert's
    owner (all-to-all #1 over its expert group), runs its experts on
    every source's buffer, returns the results (all-to-all #2) and
    combines them by the router's weights in float32; with F split, the
    partial sums add over the model group. Returns each shard's whole
    [B, S, D] output (the expert blocks gathered back).

    ``capacity`` defaults to ``max(1, int(capacity_factor * k *
    T_local / E))``; tokens past it drop. Raises the JAX ``ValueError``
    when B*S or E does not divide the expert axis. On a mesh that spans
    processes ``lps`` and ``xs`` hold None for another process's shard:
    this process routes and runs its own shards, and the all-to-alls
    cross processes (``parallel/collectives.py``)."""
    x0 = next(x for x in xs if x is not None)
    B, S, D = x0.shape
    T = B * S
    ep, E = mesh.shape["expert"], cfg.n_experts
    if T % ep or E % ep:
        raise ValueError(
            f"tokens {T} and experts {E} must divide the expert axis "
            f"({ep})")
    T_local = T // ep
    if capacity is None:
        capacity = default_capacity(cfg, T_local, capacity_factor)
    tp = mesh.shape["model"]
    use_tp = tp > 1 and cfg.mlp_hidden % tp == 0
    if token_mask is None:
        token_mask = torch.ones((B, S), dtype=torch.float32,
                                device=x0.device)
    k = cfg.experts_per_token
    sends, routes = [], []
    for i, (lp, x) in enumerate(zip(lps, xs)):
        if x is None:
            sends.append(None)
            routes.append(None)
            continue
        e = mesh.coord(i, "expert")
        rows = slice(e * T_local, (e + 1) * T_local)
        xt = x.reshape(T, D)[rows]
        m = token_mask.reshape(T)[rows].to(x.device)
        slot, w = ep_routes(cfg, lp["router"], xt, m, capacity)
        # One spare row past the buffers takes the dropped picks.
        buf = torch.zeros((E * capacity + 1, D), dtype=x.dtype,
                          device=x.device)
        buf[slot.reshape(-1)] = xt.repeat_interleave(k, dim=0)
        sends.append(buf[:-1].view(E, capacity, D))
        routes.append((slot, w))
    groups = mesh.groups("expert")
    recv = all_to_all(sends, 0, 1, groups, mesh)    # [E_local, ep*C, D]
    outs = [None if r is None else _ffn(cfg, lp, r)
            for lp, r in zip(lps, recv)]
    back = all_to_all(outs, 1, 0, groups, mesh)     # [E, C, D]
    ys = []
    for route, y in zip(routes, back):
        if route is None:
            ys.append(None)
            continue
        slot, w = route
        flat = torch.cat([y.reshape(E * capacity, D),
                          y.new_zeros((1, D))])
        picks = flat[slot].float() * w[..., None]   # [T_local, k, D]
        out = picks[:, 0]
        for j in range(1, k):
            out = out + picks[:, j]
        ys.append(out)
    if use_tp:
        ys = all_reduce(ys, mesh.groups("model"), mesh)
    ys = [None if y is None else y.to(x.dtype) for y, x in zip(ys, xs)]
    return [None if y is None else y.reshape(B, S, D)
            for y in all_gather(ys, 0, groups, mesh)]
