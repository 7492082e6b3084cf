"""Token sampling: greedy, temperature, top-k, top-p.

temperature 0 is greedy argmax — the service default (TEMPERATURE=0).
The batched engine samples every row, its admissions' first tokens
included, with ``sample_tokens_seeded``: token ``g`` of a request draws
from the key ``fold_in(PRNGKey(seed), g)`` of jax 0.9.0's default PRNG
(threefry2x32, ``jax_threefry_partitionable`` on), reproduced bit for
bit here in torch integer ops on the device, then the same uniform ->
gumbel -> ``categorical`` step as the JAX ``_sample_filtered``. A
request's tokens are a pure function of its seed, its generation index
and its logits, never of the batch, the chunk boundaries or a
preemption in between, and the same seed gives the JAX engine's
transcript. torch has no uint32 arithmetic on CUDA, so the hash runs in
int64 with every sum masked to 32 bits, as separate elementwise ops:
well over a hundred launches per threefry call, two calls per sampled
step (the key's ``fold_in`` and the bits). ``chip_smoke.py``'s
serve_qos phase counts a sampled step's launches on the card.

The single-sequence engine follows the JAX engine's split-chained key
schedule instead (``sample_token_keyed`` under keys from ``split``):
``PRNGKey(seed)`` splits into the first token's key and a chain key,
and every later step splits the chain key once and draws with the
second half. The same seed then gives the JAX single-sequence engine's
transcript, whatever the chunk boundaries.

Which rows sample is host knowledge (the engine knows each slot's
temperature), so an all-greedy batch never pays for the sampled path and
no branch here reads a device value.

Grammar-constrained decoding passes a [batch, vocab] legality ``mask``
(``apply_mask``): illegal logits become -inf before the temperature,
the top-k/top-p filters and the greedy argmax, and the key stream stays
the same, as in the JAX ``_sample_rows``. The gumbel draw is
vocab-shaped (or k-shaped under a top-k) whatever the mask, so a masked
sample equals the unmasked one whenever the unmasked winner is legal.
When fewer tokens are legal than ``top_k`` keeps, the top-k's tail is
-inf; those positions never win the draw.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..obs.profiler import scope


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


def apply_mask(logits: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Grammar legality: illegal logits set to -inf (``mask`` [batch,
    vocab] bool, True = legal; None leaves the logits as they are)."""
    if mask is None:
        return logits
    return logits.masked_fill(~mask, float("-inf"))


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """[batch, vocab] -> [batch] int32 argmax ids."""
    with scope("sampling"):
        return torch.argmax(logits, dim=-1).to(torch.int32)


# ------------------------------------------------ jax.random's threefry2x32

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
#: float32 ``finfo.tiny``: the uniform draw's lower bound in ``gumbel``
_TINY = float(torch.finfo(torch.float32).tiny)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple:
    """The Threefry-2x32 hash of jax's ``_threefry2x32_lowering`` (20
    rounds, a key injection after every four) on int64 tensors that
    hold uint32 values; the four arguments broadcast. Returns the two
    hashed words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seeds: torch.Tensor) -> tuple:
    """``jax.random.PRNGKey(seed)`` for 32-bit seeds: the key words
    ``(0, seed mod 2**32)``, as int64 tensors of the seeds' shape."""
    seeds = seeds.to(torch.int64)
    return torch.zeros_like(seeds), seeds & _M32


def fold_in(key: tuple, data: torch.Tensor) -> tuple:
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    pair ``(0, data mod 2**32)``."""
    k1, k2 = key
    data = data.to(torch.int64) & _M32
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def split(key: tuple, num: int = 2) -> tuple:
    """``jax.random.split(key, num)`` under ``jax_threefry_partitionable``:
    key ``i`` is the key hashed with the flat index's two 32-bit words
    ``(0, i)``. ``key`` is a pair of int64 tensors of one shape; returns
    ``num`` such pairs."""
    k1, k2 = key
    lo = torch.arange(num, dtype=torch.int64, device=k1.device)
    b0, b1 = threefry2x32(k1[..., None], k2[..., None],
                          torch.zeros_like(lo), lo)
    return tuple((b0[..., i], b1[..., i]) for i in range(num))


def slot_keys(seeds: torch.Tensor, ngen: torch.Tensor) -> tuple:
    """[batch] per-request seeds x [batch] generation indices -> the
    [batch] keys ``fold_in(PRNGKey(seed_i), ngen_i)`` (the JAX
    ``slot_keys``): token ``g`` of a request draws under a key that
    depends only on ``(seed, g)``, so a preempted request resumed at
    generation index ``g`` continues the stream it left."""
    return fold_in(prng_key(seeds), ngen)


def random_bits(key: tuple, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for a [batch] of keys under
    ``jax_threefry_partitionable``: the flat index's two 32-bit words
    hashed under each row's key, XORed. Returns [batch, n] int64."""
    k1, k2 = key
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)[None]
    b0, b1 = threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(lo),
                          lo)
    return b0 ^ b1


def gumbel(key: tuple, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") per row:
    ``-log(-log(u))`` of the uniform draw in [tiny, 1) that jax builds
    from the top 23 bits of each word. Returns [batch, n] float32."""
    bits = random_bits(key, n)
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    u = torch.clamp_min((one - 1.0) + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def categorical(key: tuple, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` per row of
    [batch, n] float32 logits: the argmax of logits plus gumbel noise
    (the first index on a tie, as ``jnp.argmax``). Returns [batch]
    int64."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


def _sample_filtered_seeded(scaled: torch.Tensor, keys: tuple, top_k: int,
                            top_p: float) -> torch.Tensor:
    """The JAX ``_sample_filtered`` per row under the row's key: with a
    top-k the draw is over the k kept values (and maps back through
    their indices), else over the whole vocabulary."""
    if top_k > 0:
        vals, idx = torch.topk(scaled, top_k, dim=-1)
        if top_p < 1.0:
            probs = torch.softmax(vals, dim=-1)
            cumprobs = torch.cumsum(probs, dim=-1)
            vals = torch.where(cumprobs - probs >= top_p, float("-inf"),
                               vals)
        choice = categorical(keys, vals)
        return torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32)
    scaled = _filter_top_k_p(scaled, 0, top_p)
    return categorical(keys, scaled).to(torch.int32)


def sample_tokens_seeded(logits: torch.Tensor, seeds: torch.Tensor,
                         ngen: torch.Tensor, temperatures: torch.Tensor,
                         top_k: int = 0, top_p: float = 1.0,
                         active: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """[batch, vocab] float32 logits -> [batch] int32 tokens, the JAX
    ``sample_tokens_seeded``: each row with a temperature above 0 (and
    ``active``, when given) draws under ``slot_keys(seeds, ngen)`` from
    its logits over ``max(temperature, 1e-6)``, the same top-k/top-p
    filtering as the single-sequence path; every other row is greedy.
    ``mask`` ([batch, vocab] bool, grammar legality) drops illegal
    logits to -inf before both. ``seeds``, ``ngen`` and ``temperatures``
    ([batch]; temperatures float32) are device tensors: nothing is read
    back."""
    with scope("sampling"):
        logits = apply_mask(logits, mask)
        greedy = greedy_tokens(logits)
        wants = temperatures > 0.0
        if active is not None:
            wants = wants & active
        t = torch.clamp_min(temperatures, 1e-6)[:, None]
        drawn = _sample_filtered_seeded(logits / t, slot_keys(seeds, ngen),
                                        top_k, top_p)
        return torch.where(wants, drawn, greedy)


def sample_token_keyed(logits: torch.Tensor, key: tuple,
                       temperature: float, top_k: int = 0,
                       top_p: float = 1.0) -> torch.Tensor:
    """The single-sequence engine's sampler, the JAX
    ``sample_token_traced``: [batch, vocab] float32 logits -> [batch]
    int32 tokens, the argmax at temperature 0, else every row drawn under
    ``key`` (a pair of [batch] int64 tensors) from its logits over
    ``max(temperature, 1e-6)`` with the top-k/top-p filters of
    ``_sample_filtered_seeded``. The temperature is a host value, so a
    greedy request never hashes a key."""
    if temperature <= 0.0:
        return greedy_tokens(logits)
    with scope("sampling"):
        t = torch.full((), max(float(temperature), 1e-6),
                       dtype=torch.float32, device=logits.device)
        return _sample_filtered_seeded(logits / t, key, top_k, top_p)


def eos_mask(tokens: torch.Tensor, eos_ids: torch.Tensor) -> torch.Tensor:
    """[batch] bool — which sampled tokens are termination ids (a
    broadcast compare against the tiny static EOS set, a tensor on the
    tokens' device so the compare copies nothing from the host)."""
    return (tokens[..., None] == eos_ids).any(dim=-1)
