"""Token sampling: greedy, temperature, top-k, top-p.

temperature 0 is greedy argmax — the service default (TEMPERATURE=0),
and the regime in which the port's transcripts are byte-identical to the
JAX package's. Sampled rows draw from a per-slot ``torch.Generator``
seeded with the request's seed, so a request's draws depend only on its
seed and its own step count, never on which other requests share the
batch. The draws are torch's, not ``jax.random``'s threefry bits:
reproducing those is later work.

Which rows sample is host knowledge (the engine knows each slot's
temperature), so an all-greedy batch never pays for the sampled path and
no branch here reads a device value.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _filter_top_k_p(scaled: torch.Tensor, top_k: int,
                    top_p: float) -> torch.Tensor:
    """Top-k then nucleus (top-p) filtering of temperature-scaled logits
    [..., vocab], full-vocab semantics (the JAX ``_filter_top_k_p``)."""
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    if top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cumprobs = torch.cumsum(probs, dim=-1)
        # Keep the smallest set with cumulative prob >= top_p (always at
        # least one token).
        cutoff = cumprobs - probs >= top_p
        cutoff_logit = torch.where(cutoff, float("inf"),
                                   sorted_logits).min(dim=-1,
                                                      keepdim=True).values
        scaled = torch.where(scaled < cutoff_logit, float("-inf"), scaled)
    return scaled


def _sample_filtered(scaled: torch.Tensor, generator: torch.Generator,
                     top_k: int, top_p: float) -> torch.Tensor:
    """One categorical draw per row of [rows, vocab] scaled logits under
    the top-k/top-p filters. With a top-k only the k survivors are
    softmaxed and drawn from (the JAX top-k-subset path)."""
    if top_k > 0:
        vals, idx = torch.topk(scaled, top_k, dim=-1)
        if top_p < 1.0:
            probs = torch.softmax(vals, dim=-1)
            cumprobs = torch.cumsum(probs, dim=-1)
            vals = torch.where(cumprobs - probs >= top_p, float("-inf"),
                               vals)
        choice = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                                   generator=generator)
        return torch.gather(idx, -1, choice)[..., 0].to(torch.int32)
    scaled = _filter_top_k_p(scaled, 0, top_p)
    return torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                             generator=generator)[..., 0].to(torch.int32)


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """[batch, vocab] -> [batch] int32 argmax ids."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_rows(logits: torch.Tensor, temperatures: Sequence[float],
                generators: Sequence[Optional[torch.Generator]],
                top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """[batch, vocab] f32 logits -> [batch] int32 tokens. Row i samples
    at ``temperatures[i]`` from ``generators[i]`` when its temperature
    is > 0 and it has a generator; every other row is greedy."""
    out = greedy_tokens(logits)
    for i, (t, gen) in enumerate(zip(temperatures, generators)):
        if t > 0.0 and gen is not None:
            row = logits[i:i + 1] / max(float(t), 1e-6)
            # A non-finite row would make the draw fail on the device;
            # its slot is frozen by the health check, so draw from zeros.
            row = torch.where(torch.isfinite(row).all(dim=-1, keepdim=True),
                              row, torch.zeros_like(row))
            out[i:i + 1] = _sample_filtered(row, gen, top_k, top_p)
    return out


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator], top_k: int = 0,
                 top_p: float = 1.0) -> torch.Tensor:
    """The single-sequence engine's sampler (the JAX
    ``sample_token_traced``): [batch, vocab] f32 -> [batch] int32, greedy
    argmax at temperature 0, else a draw from ``generator`` under the
    same top-k/top-p filters the batched path applies. The temperature
    is a host value, so the greedy path never touches the generator."""
    if temperature <= 0.0 or generator is None:
        return greedy_tokens(logits)
    rows = logits.shape[0]
    return sample_rows(logits, [temperature] * rows, [generator] * rows,
                       top_k=top_k, top_p=top_p)


def eos_mask(tokens: torch.Tensor, eos_ids: torch.Tensor) -> torch.Tensor:
    """[batch] bool — which sampled tokens are termination ids (a
    broadcast compare against the tiny static EOS set, a tensor on the
    tokens' device so the compare copies nothing from the host)."""
    return (tokens[..., None] == eos_ids).any(dim=-1)
