"""The port's continuous-batching engine on the CPU, against a greedy
reference built from the JAX package's forward.

``BatchedTorchEngine`` serves ``toy-8m`` in float32 with parameters
carried over from a JAX init (``params_from_jax``). Three prompts arrive
staggered — two of them while the first is decoding, so their
admissions ride a ragged prologue beside its decode step. At temperature
0 every transcript's token ids must equal a greedy loop over the JAX
``forward(attn_impl="ragged")`` (its Pallas kernel in interpret mode)
from the same parameters. A repeat then hits the radix cache and must
give the same ids, and the pool's books must balance after the drain.
At temperature 0.9 two sampled transcripts sharing the batch must equal
the JAX batched engine's for the same seeds (the port draws jax's
threefry stream, ``fold_in(PRNGKey(seed), g)``).
"""

import ast
import asyncio
import threading
import time
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.models import transformer as jt
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax

# Tiny shapes: one intra-op thread is as fast, and spares the suite's
# other workers the cores that idle OpenMP threads spin on.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PROMPTS = ["get pods in namespace kube-system",
           "describe deployment web in prod",
           "list services sorted by name"]
MAX_TOKENS = 12
PAGE, WIDTH = 16, 64


def _jax_params():
    return jt.init_params(jax.random.PRNGKey(0),
                          jconfig.get_config("toy-8m"), dtype=jnp.float32)


def _greedy_reference(jparams, prompt_ids):
    """Greedy transcript from a loop over the JAX pool/ragged forward:
    the prompt as one window, then one decode step per token."""
    cfg = jconfig.get_config("toy-8m")
    pages = 8
    fwd = jax.jit(partial(jt.forward, cfg=cfg, kv_limit=pages * PAGE,
                          attn_impl="ragged", page_size=PAGE))
    cache = jt.KVCache(
        k=jnp.zeros((cfg.n_layers, pages, PAGE, cfg.n_kv_heads,
                     cfg.head_dim), jnp.float32),
        v=jnp.zeros((cfg.n_layers, pages, PAGE, cfg.n_kv_heads,
                     cfg.head_dim), jnp.float32),
        lengths=jnp.zeros((pages,), jnp.int32))
    tables = jnp.arange(pages, dtype=jnp.int32)[None]
    P = len(prompt_ids)
    tokens = np.zeros((1, WIDTH), np.int32)
    tokens[0, :P] = prompt_ids
    logits, cache = fwd(
        jparams, tokens=jnp.asarray(tokens),
        positions=jnp.arange(WIDTH, dtype=jnp.int32)[None], cache=cache,
        write_mask=jnp.asarray(np.arange(WIDTH)[None] < P),
        block_tables=tables, q_lens=jnp.asarray([P], jnp.int32),
        logits_at=jnp.asarray([P - 1], jnp.int32))
    out = []
    tok = int(np.argmax(np.asarray(logits)[0, 0]))
    while tok not in cfg.eos_ids and len(out) < MAX_TOKENS:
        out.append(tok)
        if len(out) == MAX_TOKENS:
            break
        logits, cache = fwd(
            jparams, tokens=jnp.asarray([[tok]], jnp.int32),
            positions=jnp.asarray([[P + len(out) - 1]], jnp.int32),
            cache=cache, write_mask=jnp.asarray([True]),
            block_tables=tables, q_lens=jnp.asarray([1], jnp.int32),
            logits_at=jnp.asarray([0], jnp.int32))
        tok = int(np.argmax(np.asarray(logits)[0, 0]))
    return out


def _engine(params, **kw):
    defaults = dict(tokenizer=ByteTokenizer(), params=params,
                    dtype="float32", max_seq_len=256,
                    prefill_buckets=(32, 64), batch_size=4, chunk_len=4,
                    device="cpu")
    defaults.update(kw)
    return BatchedTorchEngine(get_config("toy-8m"), **defaults)


def _books(eng) -> None:
    holders: dict = {}
    for slot in eng._slots:
        if slot is not None and slot.blocks:
            for b in slot.blocks:
                holders[b] = holders.get(b, 0) + 1
    if eng._radix is not None:
        for b, n in eng._radix._held.items():
            holders[b] = holders.get(b, 0) + n
    eng._pool.check(holders)


async def test_greedy_transcripts_match_jax_reference():
    jparams = _jax_params()
    tok = ByteTokenizer()
    want = [_greedy_reference(jparams, tok.encode(p)) for p in PROMPTS]
    eng = _engine(params_from_jax(jax.tree.map(np.asarray, jparams)))
    await eng.start()
    chunks = []
    run_chunk = eng._run_chunk
    second_chunk = threading.Event()

    def recording(force, tables, adm=None, **kw):
        if len(chunks) == 1:
            # The second chunk is already staged when it gets here. It
            # tells the test to send the two late arrivals and waits until
            # both are queued, so they board the third chunk beside the
            # first prompt's decode however the host schedules the threads
            # (sent earlier, they could win the race to the second).
            second_chunk.set()
            deadline = time.monotonic() + 30.0
            while (eng._admissions.qsize() < 2
                   and time.monotonic() < deadline):
                time.sleep(0.001)
        staged = 0 if adm is None else int((adm[1] > 0).sum())
        chunks.append((staged, int(force.sum())))
        return run_chunk(force, tables, adm, **kw)

    eng._run_chunk = recording
    try:
        # The first prompt decodes alone; once its second chunk is staged
        # the other two arrive, so their admissions ride the third chunk's
        # ragged prologue beside its decode step.
        first = asyncio.ensure_future(
            eng.generate(PROMPTS[0], max_tokens=MAX_TOKENS))
        deadline = time.monotonic() + 60.0
        while not second_chunk.is_set():
            assert time.monotonic() < deadline, (
                "the first prompt's second chunk was never staged")
            await asyncio.sleep(0.001)
        rest = await asyncio.gather(*[
            eng.generate(p, max_tokens=MAX_TOKENS) for p in PROMPTS[1:]])
        got = [await first] + rest
        assert chunks[2] == (2, 3), chunks
        for prompt, res, ids in zip(PROMPTS, got, want):
            assert list(res.token_ids) == ids, prompt
            assert res.completion_tokens == len(ids)
            assert res.text == tok.decode(ids)
        again = await eng.generate(PROMPTS[0], max_tokens=MAX_TOKENS)
        assert again.prefix_cache_hit, "the repeat missed the radix cache"
        assert list(again.token_ids) == want[0]
        assert eng._radix.hit_tokens_total > 0
        pieces = [p async for p in eng.generate_stream(
            PROMPTS[1], max_tokens=MAX_TOKENS)]
        assert "".join(pieces) == tok.decode(want[1])
        _books(eng)
    finally:
        await eng.stop()
    assert all(s is None for s in eng._slots)


async def test_seeded_sampling_is_reproducible():
    """Sampled transcripts (temperature 0.9, top-k 20) are the JAX
    engine's for the same seeds, two of them sharing the batch, and a
    request repeated alone gives its transcript again."""
    kw = dict(dtype="float32", max_seq_len=128, prefill_buckets=(32, 64),
              batch_size=4, chunk_len=4, top_k=20, prefix_cache=False)
    jeng = BatchedJaxEngine(jconfig.get_config("toy-8m"),
                            tokenizer=JaxByteTokenizer(),
                            compile_cache_dir="", **kw)
    await jeng.start()
    try:
        want = await asyncio.gather(*[
            jeng.generate(p, max_tokens=8, temperature=0.9, seed=7)
            for p in PROMPTS[1:]])
    finally:
        await jeng.stop()
    eng = BatchedTorchEngine(
        get_config("toy-8m"), tokenizer=ByteTokenizer(), device="cpu",
        params=params_from_jax(jax.tree.map(np.asarray, jeng.params)), **kw)
    await eng.start()
    try:
        a, b = await asyncio.gather(
            eng.generate(PROMPTS[1], max_tokens=8, temperature=0.9, seed=7),
            eng.generate(PROMPTS[2], max_tokens=8, temperature=0.9, seed=7))
        c = await eng.generate(PROMPTS[1], max_tokens=8, temperature=0.9,
                               seed=7)
        assert [a.text, b.text] == [w.text for w in want]
        assert a.token_ids == c.token_ids
        assert a.completion_tokens > 0 and b.completion_tokens > 0
        _books(eng)
    finally:
        await eng.stop()


def test_engine_on_cuda_without_a_card_raises(monkeypatch):
    """A CUDA engine with no card raises; both paged-decode knobs
    construct and resolve on the CPU (auto is dense there); an explicit
    paged decode the kernel cannot serve on the card (float32) raises
    instead of switching, as does RAGGED_ATTENTION=on without the pool;
    int8 KV is accepted, and any other KV_QUANT raises the JAX message."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        _engine(None, device=None)
    for kw, regime in ((dict(kv_pool=False), "dense"),
                       (dict(ragged_attention="off"), "gather"),
                       (dict(kv_pool=False, decode_attn="paged"), "paged"),
                       (dict(ragged_attention="off", decode_attn="paged"),
                        "paged")):
        eng = _engine(None, **kw)
        eng._resolve_regime()
        assert eng._attention_regime == regime, kw
        assert eng._decode_impl == ("paged" if regime == "paged"
                                    else "dense")
    for kv_pool in (False, True):
        eng = _engine(None, kv_pool=kv_pool, ragged_attention="off",
                      decode_attn="paged")
        eng.device = torch.device("cuda")
        with pytest.raises(ValueError, match="DECODE_ATTN=paged"):
            eng._resolve_regime()
        eng = _engine(None, kv_pool=kv_pool, ragged_attention="off")
        eng.device = torch.device("cuda")
        eng._resolve_regime()
        assert eng._decode_impl == "dense"
    with pytest.raises(ValueError, match="RAGGED_ATTENTION=on"):
        _engine(None, kv_pool=False, ragged_attention="on")
    assert _engine(None, kv_quant="int8").kv_quant == "int8"
    with pytest.raises(ValueError,
                       match="KV_QUANT must be '' or 'int8', got 'int4'"):
        _engine(None, kv_quant="int4")
    with pytest.raises(ValueError, match="DECODE_ATTN"):
        _engine(None, decode_attn="flash")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "ai_agent_kubectl_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "ai_agent_kubectl_tpu"):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad
