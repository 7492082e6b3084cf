"""The port's seeded sampler against ``jax.random`` and the JAX
package's ``engine/sampling.py`` on the CPU.

The batched engine samples token ``g`` of a request under
``fold_in(PRNGKey(seed), g)``. The port reproduces jax 0.9.0's default
PRNG (threefry2x32 with ``jax_threefry_partitionable``) in torch integer
ops: its keys and random bits must be bit-equal to ``jax.random``'s over
a grid of seeds and generation indices, at the widths the engine draws
(a top-k of 40, the toy vocabulary, a Gemma-sized vocabulary). The
gumbel noise built from those bits goes through ``log`` twice; XLA's
float32 ``log`` on the CPU is not correctly rounded (torch's is), so the
noise is held to 4 float32 epsilons of ``max(1, |noise|)`` (an ulp of
the inner log, near 1, carries through the outer one) and the tokens
drawn with it exactly:
``sample_tokens_seeded`` must pick the JAX function's token in every row
over temperature x top-k x top-p, and the admission's first-token draw
(index 0, one row) must equal the JAX engine's ``sample_token_traced``
under ``fold_in(PRNGKey(seed), 0)``. The single-sequence engine's
schedule splits keys instead: ``split`` (and a chain of splits) must be
bit-equal to ``jax.random.split``, and ``sample_token_keyed`` must pick
``sample_token_traced``'s token under the same key (greedy, full-vocab
top-p, top-k subset).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.engine import sampling as jsampling
from ai_agent_kubectl_tpu_torch.engine import sampling

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 101, 202, 505, 2**31 - 1, 123456789]
NGEN = np.array([0, 1, 2, 5, 39, 1000, 2**20, 2**31 - 1], np.int32)
#: the widths the engine draws over: a top-k, the toy vocabulary, Gemma's
WIDTHS = (40, 256, 256_000)


def _jax_key(seed: int, g: int) -> np.ndarray:
    return np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), g))


@lru_cache(maxsize=None)
def _jax_bits(width: int):
    return jax.jit(lambda key: jax.random.bits(key, (width,), jnp.uint32))


@lru_cache(maxsize=None)
def _jax_first_token(top_k: int):
    return jax.jit(lambda logits, key: jsampling.sample_token_traced(
        logits, key, jnp.float32(0.9), top_k=top_k))


def _port_keys(seed: int):
    seeds = torch.full((len(NGEN),), seed, dtype=torch.int64)
    return sampling.slot_keys(seeds, torch.from_numpy(NGEN))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_are_bit_equal(seed):
    k1, k2 = sampling.prng_key(torch.tensor([seed]))
    assert [int(k1[0]), int(k2[0])] == list(
        np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))
    k1, k2 = _port_keys(seed)
    for i, g in enumerate(NGEN):
        assert [int(k1[i]), int(k2[i])] == list(
            _jax_key(seed, int(g)).astype(np.int64)), (seed, g)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_random_bits_are_bit_equal(seed, width):
    k1, k2 = _port_keys(seed)
    got = sampling.random_bits((k1[:4], k2[:4]), width).numpy()
    for i, g in enumerate(NGEN[:4]):
        want = np.asarray(_jax_bits(width)(
            jnp.asarray(_jax_key(seed, int(g)))))
        np.testing.assert_array_equal(got[i], want.astype(np.int64))


@pytest.mark.parametrize("width", WIDTHS[:2])
def test_gumbel_noise_within_four_epsilons(width):
    keys = _port_keys(SEEDS[3])
    got = sampling.gumbel(keys, width).numpy()
    for i, g in enumerate(NGEN):
        want = np.asarray(jax.random.gumbel(
            jnp.asarray(_jax_key(SEEDS[3], int(g))), (width,), jnp.float32))
        tol = 4 * np.finfo(np.float32).eps * np.maximum(1.0, np.abs(want))
        assert np.all(np.abs(got[i] - want) <= tol), g


def _case_inputs(temperature):
    rng = np.random.default_rng(17)
    logits = (rng.standard_normal((8, 256)) * 3.0).astype(np.float32)
    logits[1, 7] = logits[1].max() + 1e-3     # a near tie under greedy
    seeds = np.array(SEEDS, np.int32)
    temps = np.full((8,), temperature, np.float32)
    temps[2] = 0.0                            # a greedy row among them
    active = np.ones((8,), bool)
    active[5] = False                         # a frozen row: greedy
    return logits, seeds, NGEN.copy(), temps, active


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (t, k, p) for t in (0.0, 0.5, 0.9, 1.5) for k in (0, 1, 5, 40)
    for p in (1.0, 0.9, 0.3)])
def test_sample_tokens_seeded_matches_jax(temperature, top_k, top_p):
    logits, seeds, ngen, temps, active = _case_inputs(temperature)
    want = np.asarray(jsampling.sample_tokens_seeded(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.asarray(ngen),
        jnp.asarray(temps), top_k=top_k, top_p=top_p,
        active=jnp.asarray(active)))
    got = sampling.sample_tokens_seeded(
        torch.from_numpy(logits), torch.from_numpy(seeds),
        torch.from_numpy(ngen), torch.from_numpy(temps), top_k=top_k,
        top_p=top_p, active=torch.from_numpy(active))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("top_k", [0, 40])
def test_first_token_draw_matches_the_jax_admission(top_k):
    """An admission's first token in the JAX engine is
    ``sample_token_traced`` over one row under ``fold_in(seed, 0)``; the
    port draws it with ``sample_tokens_seeded`` at ngen 0."""
    rng = np.random.default_rng(3)
    for seed in SEEDS:
        logits = (rng.standard_normal((1, 256)) * 2.0).astype(np.float32)
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
        want = np.asarray(_jax_first_token(top_k)(jnp.asarray(logits), key))
        got = sampling.sample_tokens_seeded(
            torch.from_numpy(logits), torch.tensor([seed]),
            torch.zeros((1,), dtype=torch.int32),
            torch.tensor([0.9], dtype=torch.float32), top_k=top_k)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num", [2, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_is_bit_equal(seed, num):
    """``split`` is ``jax.random.split``, and so is a chain of splits of
    its second key (the single-sequence engine's decode schedule)."""
    jkey = jax.random.PRNGKey(seed)
    key = sampling.prng_key(torch.tensor([seed]))
    for _ in range(4):
        want = np.asarray(jax.random.split(jkey, num))
        got = sampling.split(key, num)
        assert len(got) == num
        for i, (k1, k2) in enumerate(got):
            assert k1.shape == k2.shape == (1,)
            assert [int(k1[0]), int(k2[0])] == want[i].tolist()
        jkey, key = jax.random.split(jkey)[1], got[1]


@lru_cache(maxsize=None)
def _jax_traced(top_k: int, top_p: float):
    return jax.jit(lambda logits, key, t: jsampling.sample_token_traced(
        logits, key, t, top_k=top_k, top_p=top_p))


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0), (0.9, 0, 1.0), (0.9, 0, 0.8), (0.9, 20, 1.0),
    (0.9, 20, 0.8), (1.5, 5, 0.3)])
def test_keyed_token_matches_sample_token_traced(temperature, top_k, top_p):
    """The single-sequence sampler under a split key equals the JAX
    ``sample_token_traced`` (greedy branch, full-vocab filters, top-k
    subset) for the same key."""
    rng = np.random.default_rng(11)
    for seed in SEEDS:
        logits = (rng.standard_normal((1, 256)) * 2.5).astype(np.float32)
        jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
        want = np.asarray(_jax_traced(top_k, top_p)(
            jnp.asarray(logits), jkey, jnp.float32(temperature)))
        key = sampling.split(sampling.prng_key(torch.tensor([seed])))[1]
        got = sampling.sample_token_keyed(torch.from_numpy(logits), key,
                                          temperature, top_k=top_k,
                                          top_p=top_p)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
