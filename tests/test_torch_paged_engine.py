"""The port's batched engine in its two paged-decode regimes, against the
JAX package's batched engine on the CPU.

Four configurations: the dense KV ladder (``kv_pool=False``) and the pool
with ragged attention off (``ragged_attention="off"``), each with
``decode_attn`` "paged" (the paged decode kernel: its plain version
here, the Pallas kernel in interpret mode in the JAX engine) and "dense"
(the dense reference over a KV bucket, or the pool's gather path).
``BatchedJaxEngine`` serves ``toy-8m`` in float32 from its own seeded
init; ``BatchedTorchEngine`` serves the same parameters
(``params_from_jax``). Three prompts arrive staggered — two of them while
the first is decoding — and at temperature 0 every transcript's token ids
must be identical between the engines. A repeat must give the same ids
(and hit the radix cache on the pool), and the pool's books must balance
after the drain. On the dense ladder a sampled transcript (temperature
0.9) must equal the JAX engine's for the same seed.
"""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu_torch.engine.batcher import (BatchedTorchEngine,
                                                       resolve_decode_attn)
from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax

# Tiny shapes: one intra-op thread is as fast, and spares the suite's
# other workers the cores that idle OpenMP threads spin on.
torch.set_num_threads(1)

PROMPTS = ["get pods in namespace kube-system",
           "describe deployment web in prod",
           "list services sorted by name"]
MAX_TOKENS = 12
COMMON = dict(dtype="float32", max_seq_len=128, prefill_buckets=(32, 64),
              batch_size=4, chunk_len=4, kv_page_size=16, kv_pool_page=16,
              prefix_cache=False)
CONFIGS = {
    "dense-paged": dict(kv_pool=False, decode_attn="paged"),
    "dense-dense": dict(kv_pool=False, decode_attn="dense"),
    "pool-off-paged": dict(ragged_attention="off", decode_attn="paged"),
    "pool-off-dense": dict(ragged_attention="off", decode_attn="dense"),
}
REGIMES = {"dense-paged": "paged", "dense-dense": "dense",
           "pool-off-paged": "paged", "pool-off-dense": "gather"}


def _record_ids(eng) -> dict:
    """Token ids of every finished request, by prompt ids: the JAX
    engine's results carry only text, so its finish is wrapped."""
    done: dict = {}
    finish = eng._finish

    def recording(slot_idx, *args, **kw):
        slot = eng._slots[slot_idx]
        if slot is not None:
            done[tuple(slot.req.prompt_ids)] = list(slot.detok.ids)
        return finish(slot_idx, *args, **kw)

    eng._finish = recording
    return done


async def _staggered(eng, tokenizer) -> list:
    """The first prompt alone until it has decoded a token, then the
    other two together. Returns each prompt's token ids."""
    done = _record_ids(eng)
    first = asyncio.ensure_future(
        eng.generate(PROMPTS[0], max_tokens=MAX_TOKENS, temperature=0.0))
    deadline = time.monotonic() + 60.0
    while (not first.done() and time.monotonic() < deadline
           and not any(s is not None and s.detok.ids for s in eng._slots)):
        await asyncio.sleep(0.001)
    await asyncio.gather(*[
        eng.generate(p, max_tokens=MAX_TOKENS, temperature=0.0)
        for p in PROMPTS[1:]])
    await first
    return [done[tuple(tokenizer.encode(p))] for p in PROMPTS]


def _books(eng) -> None:
    holders: dict = {}
    for slot in eng._slots:
        if slot is not None and slot.blocks:
            for b in slot.blocks:
                holders[b] = holders.get(b, 0) + 1
    for b, n in eng._radix._held.items():
        holders[b] = holders.get(b, 0) + n
    eng._pool.check(holders)


@pytest.mark.parametrize("name", list(CONFIGS))
async def test_greedy_transcripts_match_the_jax_engine(name):
    knobs = CONFIGS[name]
    jeng = BatchedJaxEngine(jconfig.get_config("toy-8m"),
                            tokenizer=JaxByteTokenizer(),
                            compile_cache_dir="", **COMMON, **knobs)
    await jeng.start()
    try:
        assert jeng._decode_impl == knobs["decode_attn"]
        want = await _staggered(jeng, jeng.tokenizer)
    finally:
        await jeng.stop()
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params),
                             get_config("toy-8m"))
    eng = BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                             params=params, device="cpu", **COMMON, **knobs)
    await eng.start()
    try:
        assert eng._decode_impl == knobs["decode_attn"]
        assert eng._attention_regime == REGIMES[name]
        got = await _staggered(eng, eng.tokenizer)
        assert got == want
        assert all(0 < len(ids) <= MAX_TOKENS for ids in got)
        again = await eng.generate(PROMPTS[0], max_tokens=MAX_TOKENS)
        assert list(again.token_ids) == got[0]
        health = eng.kv_pool_health()
        if eng.kv_pool:
            assert health["attention_regime"] == REGIMES[name]
            assert again.prefix_cache_hit, "the repeat missed the radix cache"
            assert eng._radix.hit_tokens_total > 0
            _books(eng)
        else:
            assert health is None
            assert eng._cache.k.shape[2] - 1 == eng._S_alloc
            if knobs["decode_attn"] == "paged":
                assert eng._S_alloc % eng.kv_page_size == 0
                assert eng._kv_buckets == (eng._S_alloc,)
            else:
                assert len(eng._kv_buckets) > 1
    finally:
        await eng.stop()
    assert all(s is None for s in eng._slots)


async def test_dense_ladder_prefix_hit_and_sampling():
    """The dense ladder with the system-prompt prefix cache: a rendered
    query's admission splices the cached prefix and prefills only its
    suffix, and its transcript equals a cold engine's; a sampled request
    draws its first token at index 0 of its seed stream, and its
    transcript (alone, and beside a second copy of itself) equals the
    JAX engine's for the same seed; a one-token budget finishes on the
    first token."""
    kw = dict(COMMON, max_seq_len=384, kv_pool=False, decode_attn="paged")
    # The reference needs no prefix cache: the sampled prompt is not a
    # rendered query, so no admission splices the system prompt.
    jeng = BatchedJaxEngine(jconfig.get_config("toy-8m"),
                            tokenizer=JaxByteTokenizer(),
                            compile_cache_dir="", **kw)
    await jeng.start()
    try:
        done = _record_ids(jeng)
        await jeng.generate(PROMPTS[1], max_tokens=8, temperature=0.9, seed=5)
        want = done[tuple(jeng.tokenizer.encode(PROMPTS[1]))]
    finally:
        await jeng.stop()
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params),
                             get_config("toy-8m"))
    warm = BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                              params=params, device="cpu",
                              **dict(kw, prefix_cache=True))
    cold = BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                              params=params, device="cpu", **kw)
    await asyncio.gather(warm.start(), cold.start())
    try:
        assert warm._prefix is not None and cold._prefix is None
        query = render_prompt("list pods in kube-system")
        a = await warm.generate(query, max_tokens=MAX_TOKENS)
        b = await cold.generate(query, max_tokens=MAX_TOKENS)
        assert a.prefix_cache_hit and not b.prefix_cache_hit
        assert a.token_ids == b.token_ids and a.completion_tokens > 0
        s1, s2 = await asyncio.gather(*[
            warm.generate(PROMPTS[1], max_tokens=8, temperature=0.9, seed=5)
            for _ in range(2)])
        assert list(s1.token_ids) == list(s2.token_ids) == want
        assert s1.completion_tokens > 0
        one = await warm.generate(PROMPTS[2], max_tokens=1)
        assert one.completion_tokens == 1 and one.finish_reason == "length"
    finally:
        await asyncio.gather(warm.stop(), cold.stop())


async def test_pool_gather_prefill_shape_ignores_the_radix_split():
    """The legacy pool ladder prefills a prompt at one shape whatever the
    radix match left to prefill: a cold admission (two windows), its
    repeat (only the last token) and a prompt that shares a page with it
    all run ``(bucket, kv_limit)`` = (64, 128) for their ~100 tokens, so
    the GEMM shapes behind a K/V row or the last logits never depend on
    the split. The repeat's greedy tokens equal the cold run's."""
    eng = BatchedTorchEngine(
        get_config("toy-8m"), tokenizer=ByteTokenizer(), device="cpu",
        **dict(COMMON, max_seq_len=256, ragged_attention="off",
               decode_attn="paged"))
    shapes = []
    forward = eng._forward

    def recording(tokens, positions, tables, **kw):
        if tokens.shape[1] > 1:
            shapes.append((tokens.shape[1], kw["kv_limit"]))
        return forward(tokens, positions, tables, **kw)

    await eng.start()
    try:
        eng._forward = recording
        prompt = ("get pods in namespace kube-system sorted by their "
                  "creation time and show labels, wide output please")
        assert 64 < len(eng.tokenizer.encode(prompt)) < 128 - MAX_TOKENS
        cold = await eng.generate(prompt, max_tokens=MAX_TOKENS)
        assert shapes == [(64, 128)] * 2 and not cold.prefix_cache_hit
        shapes.clear()
        again = await eng.generate(prompt, max_tokens=MAX_TOKENS)
        assert again.prefix_cache_hit and shapes == [(64, 128)]
        assert again.token_ids == cold.token_ids
        shapes.clear()
        await eng.generate(prompt[:20] + " deployments instead",
                           max_tokens=2)
        assert shapes == [(64, 128)]
        assert eng._pool_prefill_shape(200) == (64, 256)
        _books(eng)
    finally:
        await eng.stop()


def test_resolve_decode_attn():
    """auto: paged with the page raised to 64 for a GQA model on the card;
    dense for MQA, MHA, int8 KV, a dtype the kernel does not take and
    always on the CPU; explicit values pass through."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    llama = get_config("llama-3-8b-instruct")
    assert resolve_decode_attn("auto", llama, page_size=16,
                               device=cuda) == ("paged", 64)
    assert resolve_decode_attn("auto", llama, page_size=128,
                               device=cuda) == ("paged", 128)
    assert resolve_decode_attn("auto", llama, page_size=16,
                               device=cpu) == ("dense", 16)
    assert resolve_decode_attn("auto", llama, kv_quant="int8", page_size=16,
                               device=cuda) == ("dense", 16)
    assert resolve_decode_attn("auto", llama, page_size=16, device=cuda,
                               dtype=torch.float32) == ("dense", 16)
    for name in ("gemma-2b-it", "gemma-7b-it"):
        assert resolve_decode_attn("auto", get_config(name), page_size=16,
                                   device=cuda) == ("dense", 16)
    assert resolve_decode_attn("paged", llama, page_size=16,
                               device=cpu) == ("paged", 16)
    assert resolve_decode_attn("dense", llama, page_size=16,
                               device=cuda) == ("dense", 16)
