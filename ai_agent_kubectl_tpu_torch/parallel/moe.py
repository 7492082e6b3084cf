"""Mixture-of-Experts MLP on one card: the dense all-experts evaluation.

The counterpart of the JAX package's ``parallel/moe.py`` without its
mesh: ``dense_moe`` evaluates every expert on every token and mixes the
outputs by the router's weights, which are zero off each token's top-k.
Routing follows Mixtral: top-k over the float32 router logits, softmax
over the k picks only. The JAX package runs this as ``jnp.einsum`` with
XLA fusing the int8 convert, outside any Pallas kernel, so here it is
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

``expert_parallel_moe`` (the all-to-all dispatch over an ``expert`` mesh
axis) is not ported: ``moe_impl="ep"`` raises in
``models/transformer.py::_moe_mlp`` (ROADMAP.md A8).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..models.config import ModelConfig
from ..ops.quant import qmatmul


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
    logits = (x @ lp["router"]).float()
    mix, _ = router_weights(cfg, logits)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        gate = qmatmul(x, lp["w_gate"][e])
        up = qmatmul(x, lp["w_up"][e])
        y = qmatmul(_act(cfg, gate) * up, lp["w_down"][e])
        out += y.float() * mix[..., e:e + 1]
    return out.to(x.dtype)

