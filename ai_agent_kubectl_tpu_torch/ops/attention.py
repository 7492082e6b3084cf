"""Dense reference attention (GQA, causal, KV-cache aware), over a bf16
or float span (``dense_attention``) or an int8 one
(``dense_attention_quant``).

The numerically trusted baseline the hand-written kernels are held
against, in the JAX package's conventions:

- q:    [batch, q_len, n_heads, head_dim]
- k/v:  [batch, kv_len, n_kv_heads, head_dim] (n_kv_heads divides n_heads)
- mask: bool [batch, q_len, kv_len] or None — True = attend.
- softmax in float32, output in q.dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def repeat_kv(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand KV heads for GQA: [b, s, n_kv, d] -> [b, s, n_kv * n_rep, d]."""
    if n_rep == 1:
        return kv
    b, s, h, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) [+ mask]) v with GQA head grouping.

    Both products take operands in the query dtype and accumulate in
    float32 (the JAX version's ``preferred_element_type=float32``): the
    operands are widened to float32 first, which is exact for bf16, and
    the products then run in full float32. Queries group as
    [b, q, n_kv, g, d] against the unrepeated KV span. Masked logits are
    -1e30, so a fully masked row averages V like the JAX version does;
    callers that need zeros there mask the output."""
    B, Q, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, Q, KV, G, D).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          k.to(q.dtype).float()) * scale
    if logit_softcap > 0.0:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(q.dtype).float(),
                       v.to(q.dtype).float())
    return out.reshape(B, Q, H, D).to(q.dtype)


def dense_attention_quant(
    q: torch.Tensor,
    k_q: torch.Tensor,          # int8 [b, s, n_kv, d]
    k_s: torch.Tensor,          # f32  [b, s, n_kv]
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """``dense_attention`` over an int8 KV span (the JAX
    ``dense_attention_quant``, plain PyTorch ops as XLA's there).

    A (position, head) scale commutes out of the head_dim contraction:
    ``q . (K_q[s] * k_s[s]) == (q . K_q[s]) * k_s[s]``. So the K scale
    multiplies the scores and the V scale the probabilities, in the
    reference's order: scores, times ``k_s * scale``, softcap, mask,
    softmax, times ``v_s``, then the product with ``V_q``. Queries group
    as [b, q, n_kv, g, d] against the unrepeated span. Masked positions
    have probability 0, which the V scale multiplies: every scale the
    span can hold must be finite (the caches start at 1)."""
    B, Q, H, D = q.shape
    KV = k_q.shape[2]
    G = H // KV
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, Q, KV, G, D).float()
    # int8 -> float32 is exact, as int8 -> the query dtype is.
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k_q.float())
    logits = logits * (k_s.permute(0, 2, 1)[:, :, None, None, :] * scale)
    if logit_softcap > 0.0:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * v_s.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(q.dtype).float(),
                       v_q.float())
    return out.reshape(B, Q, H, D).to(q.dtype)


def causal_mask(q_len: int, kv_len: int, q_offset=0,
                device=None) -> torch.Tensor:
    """[1, q_len, kv_len] causal mask: query i (at absolute position
    q_offset + i) may attend to kv position j iff j <= q_offset + i."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return (kv_pos <= q_pos)[None, :, :]


def length_mask(kv_lens: torch.Tensor, kv_len: int) -> torch.Tensor:
    """[batch, 1, kv_len] validity mask for padded caches: position j is
    valid iff j < kv_lens[b]."""
    return (torch.arange(kv_len, device=kv_lens.device)[None, None, :]
            < kv_lens[:, None, None])
