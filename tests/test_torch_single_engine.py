"""The port's single-sequence engine (``TorchEngine``) against the JAX
package's ``JaxEngine``, on the CPU in float32, under ``QUANT`` "" and
"int4".

Both serve ``toy-8m`` at head_dim 128 (so ``flash_supported`` holds and
prefill runs flash: the JAX Pallas kernel in interpret mode, the port's
plain version) with ``max_seq_len=512`` and ``prefill_buckets=(32,
64)``; max_seq 512 leaves the byte-tokenized system prompt (321 tokens)
room for a suffix, so the prefix cache is live. Parameters come from one
JAX init, quantized in JAX under int4 (the per-row int8 embedding
included) and carried over with ``params_from_jax``: both packages
compute with the same packed bytes.

- At temperature 0 the transcripts are identical, token for token,
  across a plain prompt, a prompt that hits the system-prompt prefix
  (suffix prefill) and a prompt longer than 64 tokens (chunked
  prefill). The tokenizer renders every id as its own character, so the
  text comparison is a comparison of the ids.
- The first-token logits agree within 1e-4 (float32 round-off through
  four layers).
- The dense-cache ``forward`` matches the JAX ``forward`` on the same
  inputs (logits 1e-4, cache contents 1e-5), flash and dense.
- The batched engine under int4 matches a greedy loop over the JAX
  ragged forward on the same int4 tree.
- At temperature 0.9 (toy-8m at its own head_dim, dense prefill) the
  transcripts equal the JAX engine's, with an explicit seed and without
  one, under the full-vocab sampler and under top-k 20 with top-p 0.8:
  the port follows the JAX engine's split-chained key schedule.
- Guards: the factory builds ``TorchEngine`` at DECODE_BATCH_SIZE=1; a
  CUDA request with no card raises; KV_QUANT=int8 raises.
"""

import asyncio
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from ai_agent_kubectl_tpu.engine.jax_engine import JaxEngine
from ai_agent_kubectl_tpu.engine.prompts import render_prompt
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.models import transformer as jt
from ai_agent_kubectl_tpu.ops.quant4 import quantize_params_int4
from ai_agent_kubectl_tpu.server.output_parser import UnsafeCommandError
from ai_agent_kubectl_tpu.server.output_parser import (
    parse_llm_output as jax_parse)
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
from ai_agent_kubectl_tpu_torch.models import transformer as tt
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.server.app import create_app
from ai_agent_kubectl_tpu_torch.server.factory import build_engine
from test_torch_env import knob_env  # noqa: F401  (autouse)

torch.set_num_threads(1)

HD = dict(head_dim=128)
MAX_SEQ, BUCKETS, MAX_TOKENS = 512, (32, 64), 12
PROMPTS = {
    "plain": "get pods in namespace kube-system",
    "prefix_hit": render_prompt("list pods in prod"),
    "chunked": ("describe every deployment in every namespace and sort "
                "them by creation time, then show the ones with more than "
                "three replicas please"),
}
QUANTS = ["", "int4"]


class IdTokenizer:
    """UTF-8 bytes + 3 specials (the byte tokenizer's ids), decoded one
    character per id, so a transcript's text spells its ids exactly."""

    SPECIALS = 3
    pad_id, bos_id, eos_ids, vocab_size = 0, 1, (2,), 259

    def encode(self, text, *, add_bos=True):
        ids = [b + self.SPECIALS for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids):
        return "".join(chr(0x4E00 + i) for i in ids if i >= self.SPECIALS)


@functools.lru_cache(maxsize=None)
def _trees(quant: str):
    """(JAX tree, numpy tree) from one JAX init, int4-quantized in JAX."""
    jcfg = jconfig.get_config("toy-8m", **HD)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    if quant == "int4":
        jparams = quantize_params_int4(jparams, quantize_embed=True)
    return jparams, jax.tree.map(np.asarray, jparams)


@functools.lru_cache(maxsize=None)
def _run_engines(quant: str) -> dict:
    """Serve every prompt through both engines; returns per prompt kind
    (jax result, port result, jax first logits, port first logits)."""
    jparams, np_tree = _trees(quant)

    async def run():
        je = JaxEngine(jconfig.get_config("toy-8m", **HD),
                       tokenizer=IdTokenizer(), dtype="float32", quant=quant,
                       max_seq_len=MAX_SEQ, prefill_buckets=BUCKETS,
                       attn_impl="flash", compile_cache_dir="")
        je.params = jparams
        je._quantized = bool(quant)
        te = TorchEngine(get_config("toy-8m", **HD), tokenizer=IdTokenizer(),
                         params=params_from_jax(np_tree), dtype="float32",
                         quant=quant, max_seq_len=MAX_SEQ,
                         prefill_buckets=BUCKETS, attn_impl="flash",
                         device="cpu")
        await je.start()
        # Every decode program warm: the JAX engine then picks the same
        # KV-ladder bucket as the port for every chunk.
        je._ladder_thread.join(120.0)
        assert not je._ladder_thread.is_alive(), (
            "the JAX engine's decode ladder warm never finished")
        await te.start()
        out = {}
        try:
            for kind, prompt in PROMPTS.items():
                a = await je.generate(prompt, max_tokens=MAX_TOKENS)
                b = await te.generate(prompt, max_tokens=MAX_TOKENS)
                ids = IdTokenizer().encode(prompt)
                jl = np.asarray(je._prefill_prompt(ids, MAX_TOKENS)[0])
                tl = te._prefill_prompt(ids, MAX_TOKENS)[0].numpy()
                out[kind] = (a, b, jl, tl)
        finally:
            await je.stop()
            await te.stop()
        return out

    return asyncio.run(run())


@pytest.mark.parametrize("kind", list(PROMPTS))
@pytest.mark.parametrize("quant", QUANTS, ids=["bf", "int4"])
def test_greedy_transcripts_match_jax_engine(quant, kind):
    a, b, _, _ = _run_engines(quant)[kind]
    assert b.text == a.text
    assert b.completion_tokens == a.completion_tokens == MAX_TOKENS
    assert b.prompt_tokens == a.prompt_tokens
    assert IdTokenizer().decode(b.token_ids) == b.text
    assert b.prefix_cache_hit == a.prefix_cache_hit == (kind == "prefix_hit")
    assert b.finish_reason == a.finish_reason == "length"


@pytest.mark.parametrize("kind", list(PROMPTS))
@pytest.mark.parametrize("quant", QUANTS, ids=["bf", "int4"])
def test_first_token_logits_match_jax_engine(quant, kind):
    _, _, jl, tl = _run_engines(quant)[kind]
    assert tl.shape == jl.shape == (1, 512)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl", ["flash", "dense"])
@pytest.mark.parametrize("quant", QUANTS, ids=["bf", "int4"])
def test_dense_cache_forward_matches_jax(quant, impl):
    """Two rows prefill 32 tokens (one from 0, one continuing at 5 over a
    spliced context), then four decode steps with one row masked once."""
    jparams, np_tree = _trees(quant)
    jcfg = jconfig.get_config("toy-8m", **HD)
    tcfg = get_config("toy-8m", **HD)
    tparams = params_from_jax(np_tree, tcfg)
    B, S, max_seq, kv_limit = 2, 32, 128, 64
    jcache = jt.KVCache.zeros(jcfg, B, max_seq, dtype=jnp.float32)
    tcache = tt.KVCache.zeros(tcfg, B, max_seq, dtype=torch.float32,
                              device="cpu")
    rng = np.random.default_rng(0)

    def step(tokens, positions, impl, write_mask=None):
        nonlocal jcache
        jl, jcache = jt.forward(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
            jcache, kv_limit=kv_limit, attn_impl=impl,
            write_mask=None if write_mask is None
            else jnp.asarray(write_mask))
        tl, _ = tt.forward(
            tparams, tcfg, torch.from_numpy(tokens),
            torch.from_numpy(positions), tcache, kv_limit=kv_limit,
            attn_impl=impl, write_mask=None if write_mask is None
            else torch.from_numpy(write_mask))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        for jleaf, tleaf in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
            np.testing.assert_allclose(tleaf[:, :, :max_seq].numpy(),
                                       np.asarray(jleaf), atol=1e-5,
                                       rtol=1e-5)
        return np.asarray(jl)

    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    positions = (np.arange(S)[None] + np.array([[0], [5]])).astype(np.int32)
    logits = step(tokens, positions, impl)
    tok = logits[:, -1].argmax(-1).astype(np.int32)
    pos = positions[:, -1] + 1
    for i in range(4):
        mask = np.array([True, i != 2])
        logits = step(tok[:, None], pos[:, None].astype(np.int32), "dense",
                      write_mask=mask)
        tok = logits[:, 0].argmax(-1).astype(np.int32)
        pos = pos + 1


#: the engines' (TOP_K, TOP_P) under which sampled transcripts are held
SAMPLING = {"full_vocab": (0, 1.0), "top_k_top_p": (20, 0.8)}
SAMPLED_TOKENS, SEED = 24, 1234


@functools.lru_cache(maxsize=None)
def _run_sampled(top_k: int, top_p: float) -> dict:
    """Every prompt at temperature 0.9 through both engines (toy-8m,
    dense prefill), with an explicit seed and with none (the engine
    seed plus the prompt length). Returns {(kind, seed): (jax, port)}."""
    jcfg = jconfig.get_config("toy-8m")
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    kw = dict(tokenizer=IdTokenizer(), dtype="float32", max_seq_len=MAX_SEQ,
              prefill_buckets=BUCKETS, attn_impl="dense", top_k=top_k,
              top_p=top_p)

    async def run():
        je = JaxEngine(jcfg, compile_cache_dir="", **kw)
        je.params = jparams
        te = TorchEngine(get_config("toy-8m"), device="cpu",
                         params=params_from_jax(
                             jax.tree.map(np.asarray, jparams)), **kw)
        await je.start()
        je._ladder_thread.join(120.0)
        assert not je._ladder_thread.is_alive(), (
            "the JAX engine's decode ladder warm never finished")
        await te.start()
        out = {}
        try:
            for kind, prompt in PROMPTS.items():
                for seed in (SEED, None):
                    out[kind, seed] = tuple([await eng.generate(
                        prompt, max_tokens=SAMPLED_TOKENS, temperature=0.9,
                        seed=seed) for eng in (je, te)])
            out["plain", "greedy"] = await te.generate(
                PROMPTS["plain"], max_tokens=SAMPLED_TOKENS)
        finally:
            await je.stop()
            await te.stop()
        return out

    return asyncio.run(run())


@pytest.mark.parametrize("seed", [SEED, None], ids=["seed", "no_seed"])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_sampled_transcripts_match_jax_engine(sampling, seed):
    """At temperature 0.9 the port draws the JAX engine's tokens: the
    same split-chained threefry keys (the first token under the first
    half of ``split(PRNGKey(seed))``, each decode step under a split of
    the second), across chunk borders (8 + 8 + 1s), the prefix-hit and
    chunked prefill paths, the full-vocab and the top-k/top-p filters."""
    out = _run_sampled(*SAMPLING[sampling])
    for kind in PROMPTS:
        a, b = out[kind, seed]
        assert b.text == a.text, kind
        assert b.completion_tokens == a.completion_tokens > 0
        assert b.finish_reason == a.finish_reason
    # The draws are not the greedy transcript, and the seed matters.
    assert out["plain", seed][1].text != out["plain", "greedy"].text
    assert out["plain", SEED][1].text != out["plain", None][1].text


def _jax_ragged_greedy(jparams, prompt_ids, page=16, pages=8):
    """Greedy transcript from a loop over the JAX pool/ragged forward."""
    cfg = jconfig.get_config("toy-8m", **HD)
    fwd = jax.jit(partial(jt.forward, cfg=cfg, kv_limit=pages * page,
                          attn_impl="ragged", page_size=page))
    shape = (cfg.n_layers, pages, page, cfg.n_kv_heads, cfg.head_dim)
    cache = jt.KVCache(k=jnp.zeros(shape, jnp.float32),
                       v=jnp.zeros(shape, jnp.float32),
                       lengths=jnp.zeros((pages,), jnp.int32))
    tables = jnp.arange(pages, dtype=jnp.int32)[None]
    P, W = len(prompt_ids), 64
    tokens = np.zeros((1, W), np.int32)
    tokens[0, :P] = prompt_ids
    logits, cache = fwd(
        jparams, tokens=jnp.asarray(tokens),
        positions=jnp.arange(W, dtype=jnp.int32)[None], cache=cache,
        write_mask=jnp.asarray(np.arange(W)[None] < P), block_tables=tables,
        q_lens=jnp.asarray([P], jnp.int32),
        logits_at=jnp.asarray([P - 1], jnp.int32))
    out = [int(np.argmax(np.asarray(logits)[0, 0]))]
    while len(out) < MAX_TOKENS:
        logits, cache = fwd(
            jparams, tokens=jnp.asarray([[out[-1]]], jnp.int32),
            positions=jnp.asarray([[P + len(out) - 1]], jnp.int32),
            cache=cache, write_mask=jnp.asarray([True]), block_tables=tables,
            q_lens=jnp.asarray([1], jnp.int32),
            logits_at=jnp.asarray([0], jnp.int32))
        out.append(int(np.argmax(np.asarray(logits)[0, 0])))
    return out


async def test_batched_engine_int4_matches_jax_ragged_loop():
    jparams, np_tree = _trees("int4")
    prompt = PROMPTS["plain"]
    want = _jax_ragged_greedy(jparams, IdTokenizer().encode(prompt))
    assert cfg_eos_free(want)
    eng = BatchedTorchEngine(
        get_config("toy-8m", **HD), tokenizer=IdTokenizer(),
        params=params_from_jax(np_tree), dtype="float32", quant="int4",
        max_seq_len=256, prefill_buckets=BUCKETS, batch_size=2, chunk_len=4,
        device="cpu")
    await eng.start()
    try:
        res = await eng.generate(prompt, max_tokens=MAX_TOKENS)
    finally:
        await eng.stop()
    assert list(res.token_ids) == want


def cfg_eos_free(ids) -> bool:
    return not set(ids) & set(jconfig.get_config("toy-8m").eos_ids)


async def test_factory_serves_single_engine_at_batch_size_one():
    """DECODE_BATCH_SIZE=1 builds the single-sequence engine; over HTTP
    its status is the service's decision for the text it generated."""
    cfg = ServiceConfig(torch_device="cpu", decode_batch_size=1,
                        max_new_tokens=8, max_seq_len=512,
                        prefill_buckets="64,128", quant="int8")
    engine = build_engine(cfg)
    assert type(engine) is TorchEngine and engine.quant == "int8"
    assert engine.attn_impl == "dense"          # auto on the CPU
    texts = []
    inner = engine.generate

    async def recording(prompt, **kw):
        res = await inner(prompt, **kw)
        texts.append(res)
        return res

    engine.generate = recording
    async with TestClient(TestServer(create_app(cfg, engine))) as client:
        r = await client.get("/health")
        health = await r.json()
        assert r.status == 200 and health["engine"] == "torch"
        r = await client.post("/kubectl-command",
                              json={"query": "list all pods"})
        body = await r.json()
        try:
            jax_parse(texts[-1].text)
            want = 200
        except UnsafeCommandError:
            want = 422
        assert r.status == want, body
        assert texts[-1].prefix_cache_hit
        assert texts[-1].completion_tokens == 8


def test_engine_guards(monkeypatch):
    tcfg = get_config("toy-8m")
    assert TorchEngine(tcfg, kv_quant="int8",
                       device="cpu").kv_quant == "int8"
    with pytest.raises(ValueError,
                       match="KV_QUANT must be '' or 'int8', got 'int4'"):
        TorchEngine(tcfg, kv_quant="int4", device="cpu")
    with pytest.raises(ValueError, match="QUANT"):
        TorchEngine(tcfg, quant="int3", device="cpu")
    with pytest.raises(ValueError, match="ATTN_IMPL"):
        TorchEngine(tcfg, attn_impl="paged", device="cpu")
    with pytest.raises(ValueError, match="QUANT"):
        ServiceConfig(quant="fp8")
    with pytest.raises(ValueError, match="ATTN_IMPL"):
        ServiceConfig(attn_impl="ring")
    monkeypatch.setenv("QUANT", "int4")
    monkeypatch.setenv("ATTN_IMPL", "flash")
    cfg = ServiceConfig.from_env(env_file=None)
    assert (cfg.quant, cfg.attn_impl) == ("int4", "flash")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        TorchEngine(tcfg, device=None)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        TorchEngine.from_config(ServiceConfig(decode_batch_size=1))
