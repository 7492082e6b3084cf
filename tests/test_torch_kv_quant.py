"""The port's int8 KV cache (``KV_QUANT=int8``) and W8A8 weight leaf
against the JAX package's, on the CPU in float32.

Inputs are drawn with numpy from fixed seeds; one JAX init of ``toy-8m``
(4 query heads over 2 KV heads of 64; ``toy-moe`` once) is carried over
with ``params_from_jax``, so both packages compute with the same weights.

- ``kv_quantize``: the int8 bytes equal and the scales bit-equal to the
  JAX function's, the roundtrip within ``amax / 254`` a vector (half a
  step), a zero vector exact.
- ``dense_attention_quant`` with a mask, at G = 1, 2 and 8 query heads a
  KV head, with and without a softcap: within ``1e-5`` (float32, another
  summation order).
- The caches: shapes, every scale 1 at the start (trash block and rows
  included), the bytes ``2 L rows KV (hd + 4)``.
- ``forward`` over an int8 pool (the gather path) and an int8 dense
  cache: logits within ``1e-4`` of the JAX forward (as
  ``tests/test_torch_model.py``), the written payload bytes equal to
  JAX's and the scales within ``1e-5`` (the K/V projections round
  differently in the two packages). An int8 cache asked to attend
  through the ragged, paged or flash kernel raises.
- The engines against the JAX engines built with ``kv_quant="int8"``:
  ``BatchedTorchEngine`` with ``RAGGED_ATTENTION=on`` asked (it resolves
  to the gather path), with ``DECODE_ATTN=paged`` asked on the pool
  (gather) and on the dense ladder (dense), and ``TorchEngine``. Greedy
  and seeded temperature-0.9 transcripts byte-identical (every id is its
  own character), ``_decode_impl`` and ``_attention_regime`` equal, the
  repeat hits its prefix, the pool's books balance, a copy-on-write
  copies both leaves, and no attention kernel wrapper is called. A
  preempted request resumes to its uncontended transcript (the QoS test,
  under int8).
- W8A8: ``qmatmul`` equal to JAX's (an exact s32 product, also past
  K = 1041 where float32 stops being exact), ``to_w8a8`` retags only the
  rank-3 layer projections, and a W8A8 forward within ``1e-4``.
- ``KV_QUANT=int8`` boots through ``ServiceConfig.from_env`` and serves
  over HTTP in all three batched regimes and the single-sequence engine.
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

from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.jax_engine import JaxEngine
from ai_agent_kubectl_tpu.engine.prompts import render_prompt
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.models import transformer as jt
from ai_agent_kubectl_tpu.ops import attention as jattn
from ai_agent_kubectl_tpu.ops import quant as jq
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine import qos as port_qos
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
from ai_agent_kubectl_tpu_torch.models import config as tconfig
from ai_agent_kubectl_tpu_torch.models import transformer as tt
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.obs import Trace, use_trace
from ai_agent_kubectl_tpu_torch.ops import attention as tattn
from ai_agent_kubectl_tpu_torch.ops import quant as tq
from ai_agent_kubectl_tpu_torch.server.app import create_app
from ai_agent_kubectl_tpu_torch.server.factory import build_engine
from test_torch_env import knob_env  # noqa: F401  (autouse)

# Tiny shapes: one intra-op thread is as fast, and spares the suite's
# other workers the cores that idle OpenMP threads spin on.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_params(model: str = "toy-8m"):
    """(JAX tree, numpy tree) of one float32 JAX init."""
    jparams = jt.init_params(jax.random.PRNGKey(0),
                             jconfig.get_config(model), dtype=jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


# ------------------------------------------------------------ kv_quantize

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 7, 2, 64)) * 4).astype(np.float32)
    x[1, 2, 0] = 0.0                     # a zero vector
    x[2, 3, 1, 5] = 300.0                # one outlier sets its scale
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want, got = jq.kv_quantize(jx), tq.kv_quantize(tx)
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy().view(np.int32),
                                  np.asarray(want.s).view(np.int32))
    deq = tq.kv_dequantize(got, torch.float32).numpy()
    np.testing.assert_array_equal(
        deq, np.asarray(jq.kv_dequantize(want, jnp.float32)))
    xf = tx.float().numpy()
    amax = np.abs(xf).max(-1, keepdims=True)
    # Half a quantization step, with the float32 rounding of the product.
    assert (np.abs(deq - xf) <= amax / 254 * (1 + 1e-6) + 1e-7).all()
    assert (deq[1, 2, 0] == 0).all() and got.s[1, 2, 0] == 1.0


# -------------------------------------------------- dense_attention_quant

@pytest.mark.parametrize("softcap", [0.0, 30.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_dense_attention_quant_matches_jax(G, softcap):
    """B=2, 5 queries over 24 int8 positions of 2 KV heads; the causal
    mask at offsets 0 and 19, so the first row's tail is masked (with
    scales of 1 behind it, as a fresh cache holds)."""
    rng = np.random.default_rng(G)
    B, Q, KV, D, S = 2, 5, 2, 64, 24
    q = rng.standard_normal((B, Q, KV * G, D)).astype(np.float32)
    k = jq.kv_quantize(jnp.asarray(
        rng.standard_normal((B, S, KV, D)).astype(np.float32) * 3))
    v = jq.kv_quantize(jnp.asarray(
        rng.standard_normal((B, S, KV, D)).astype(np.float32)))
    k_s = np.asarray(k.s).copy()
    v_s = np.asarray(v.s).copy()
    k_s[0, 10:], v_s[0, 10:] = 1.0, 1.0
    pos = np.array([0, 19])[:, None] + np.arange(Q)[None]
    mask = np.arange(S)[None, None] <= pos[:, :, None]
    want = jattn.dense_attention_quant(
        jnp.asarray(q), k.q, jnp.asarray(k_s), v.q, jnp.asarray(v_s),
        jnp.asarray(mask), logit_softcap=softcap)
    got = tattn.dense_attention_quant(
        torch.from_numpy(q), torch.from_numpy(np.array(k.q)),
        torch.from_numpy(k_s), torch.from_numpy(np.array(v.q)),
        torch.from_numpy(v_s), torch.from_numpy(mask),
        logit_softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ----------------------------------------------------------------- caches

@pytest.mark.parametrize("layout", ["pool", "dense"])
def test_int8_cache_structure(layout):
    """Both layouts: a QuantKV in each of k and v, the payload zero and
    every scale 1 (the trash block or rows too), geometry read off the
    payload, and the bytes 2 L rows KV (hd + 4)."""
    cfg = tconfig.get_config("toy-8m")
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if layout == "pool":
        cache = tt.KVCache.pool(cfg, 6, 16, dtype=torch.float32,
                                device="cpu", kv_quant="int8")
        shape = (L, 7, 16, KV, hd)
        assert (cache.n_blocks, cache.page) == (6, 16)
        want = jq.QuantKV(q=jnp.zeros(shape, jnp.int8),
                          s=jnp.ones(shape[:-1], jnp.float32))
    else:
        cache = tt.KVCache.zeros(cfg, 3, 40, dtype=torch.float32,
                                 device="cpu", kv_quant="int8")
        shape = (L, 3, 41, KV, hd)
        assert cache.max_seq == 40
        # The JAX cache has no trash row.
        want = jt.KVCache.zeros(jconfig.get_config("toy-8m"), 3, 41,
                                kv_quant="int8").k
    assert cache.quantized
    for leaf in (cache.k, cache.v):
        assert isinstance(leaf, tq.QuantKV)
        assert leaf.shape == shape == want.q.shape
        assert leaf.s.shape == want.s.shape
        assert leaf.q.dtype == torch.int8 and leaf.s.dtype == torch.float32
        assert not leaf.q.any() and (leaf.s == 1).all()
        assert leaf[1].q.shape == shape[1:] and leaf[1].s.shape == shape[1:4]
    rows = shape[1] * shape[2]
    assert cache.nbytes == 2 * L * rows * KV * (hd + 4)
    bf16 = 2 * L * rows * KV * hd * 2
    assert cache.nbytes / bf16 == (hd + 4) / (2 * hd)
    with pytest.raises(ValueError, match="KV_QUANT must be"):
        tt.KVCache.zeros(cfg, 1, 8, device="cpu", kv_quant="int4")


PAGE, N_BLOCKS, MAX_PAGES = 8, 16, 4
FORWARDS = {"pool": ("toy-8m", "pool"), "dense": ("toy-8m", "dense"),
            "moe-pool": ("toy-moe", "pool")}


@pytest.mark.parametrize("case", list(FORWARDS))
def test_forward_over_int8_cache_matches_jax(case):
    """A window (a prefill from 0, one continuing at 5, and a frozen row
    on the pool or a 2-token prefill on the dense cache), then four
    decode steps feeding the greedy token back, through the JAX forward
    and the port's over int8 caches: the pool through the gather path,
    the dense cache through the dense read."""
    model, layout = FORWARDS[case]
    jcfg, tcfg = jconfig.get_config(model), tconfig.get_config(model)
    jparams, np_tree = _jax_params(model)
    tparams = params_from_jax(np_tree, tcfg)
    L, KV, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    span, W = MAX_PAGES * PAGE, 8
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (3, W)).astype(np.int32)
    starts = np.array([0, 5, 9], np.int32)
    q_lens = np.array([8, 3, 0 if layout == "pool" else 2], np.int32)
    if layout == "pool":
        shape = (L, N_BLOCKS, PAGE, KV, hd)
        jcache = jt.KVCache(
            k=jq.QuantKV(q=jnp.zeros(shape, jnp.int8),
                         s=jnp.ones(shape[:-1], jnp.float32)),
            v=jq.QuantKV(q=jnp.zeros(shape, jnp.int8),
                         s=jnp.ones(shape[:-1], jnp.float32)),
            lengths=jnp.zeros((N_BLOCKS,), jnp.int32))
        tcache = tt.KVCache.pool(tcfg, N_BLOCKS, PAGE, dtype=torch.float32,
                                 device="cpu", kv_quant="int8")
        sentinel = N_BLOCKS + 3
        tables = np.array([[3, 1, 5, sentinel], [0, 2, 7, sentinel],
                           [4, sentinel, sentinel, sentinel]], np.int32)
        extra = dict(block_tables=tables)
    else:
        jcache = jt.KVCache.zeros(jcfg, 3, span, dtype=jnp.float32,
                                  kv_quant="int8")
        tcache = tt.KVCache.zeros(tcfg, 3, span, dtype=torch.float32,
                                  device="cpu", kv_quant="int8")
        extra = {}
    jfwd = jax.jit(partial(jt.forward, cfg=jcfg, kv_limit=span,
                           attn_impl="dense", page_size=PAGE))

    def step(tokens, positions, write_mask, logits_at):
        nonlocal jcache, tcache
        wm = None if write_mask is None else jnp.asarray(write_mask)
        jl, jcache = jfwd(jparams, tokens=jnp.asarray(tokens),
                          positions=jnp.asarray(positions), cache=jcache,
                          write_mask=wm, logits_at=jnp.asarray(logits_at),
                          **{k: jnp.asarray(v) for k, v in extra.items()})
        tl, tcache = tt.forward(
            tparams, tcfg, torch.from_numpy(tokens),
            torch.from_numpy(positions), tcache, kv_limit=span,
            page_size=PAGE, attn_impl="dense",
            write_mask=(None if write_mask is None
                        else torch.from_numpy(write_mask)),
            logits_at=torch.from_numpy(logits_at),
            **{k: torch.from_numpy(v) for k, v in extra.items()})
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=1e-4)
        return jl

    positions = starts[:, None] + np.arange(W, dtype=np.int32)[None]
    wmask = (np.arange(W)[None] < q_lens[:, None] if layout == "pool"
             else None)
    logits = step(tokens, positions, wmask, np.maximum(q_lens, 1) - 1)
    live = q_lens > 0
    pos = starts + q_lens
    tok = logits[:, 0].argmax(-1).astype(np.int32)
    for _ in range(4):
        logits = step(tok[:, None], pos[:, None].astype(np.int32), live,
                      np.zeros(3, np.int32))
        tok = np.where(live, logits[:, 0].argmax(-1), tok).astype(np.int32)
        pos = pos + live
    # The written rows: every real block of the pool (the trash block
    # aside), every position of the dense cache (its trash row aside).
    for jleaf, tleaf in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
        real = (tleaf[:, :N_BLOCKS] if layout == "pool"
                else tleaf[:, :, :span])
        np.testing.assert_array_equal(real.q.numpy(), np.asarray(jleaf.q))
        np.testing.assert_allclose(real.s.numpy(), np.asarray(jleaf.s),
                                   rtol=1e-5)
        assert real.q.any() and torch.isfinite(tleaf.s).all()


@pytest.mark.parametrize("layout,impl,S", [
    ("pool", "ragged", 4), ("pool", None, 1), ("pool", "paged", 1),
    ("dense", "paged", 1), ("dense", "flash", 4)])
def test_int8_cache_refuses_the_attention_kernels(layout, impl, S):
    """No kernel reads int8 KV: an int8 cache routed to the ragged, paged
    (one column) or flash (a window) kernel raises before any write."""
    cfg = tconfig.get_config("toy-8m")
    _, np_tree = _jax_params()
    params = params_from_jax(np_tree, cfg)
    kw = {}
    if layout == "pool":
        cache = tt.KVCache.pool(cfg, 4, 8, dtype=torch.float32,
                                device="cpu", kv_quant="int8")
        kw["block_tables"] = torch.arange(4, dtype=torch.int32)[None]
    else:
        cache = tt.KVCache.zeros(cfg, 1, 32, dtype=torch.float32,
                                 device="cpu", kv_quant="int8")
    with pytest.raises(NotImplementedError, match="does not read int8 KV"):
        tt.forward(params, cfg, torch.zeros((1, S), dtype=torch.int32),
                   torch.arange(S, dtype=torch.int32)[None], cache,
                   attn_impl=impl, page_size=8, **kw)
    assert not cache.k.q.any() and (cache.k.s == 1).all()


# ---------------------------------------------------------------- engines

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


#: rendered prompts: each starts with the system prompt (272 byte
#: tokens), so the prefix paths run — the radix preload on the pool, the
#: prefix splice on the dense ladder and the single-sequence engine
PROMPTS = [render_prompt(q) for q in ("get pods in namespace kube-system",
                                      "describe deployment web in prod",
                                      "list services sorted by name")]
MAX_TOKENS = 12
COMMON = dict(dtype="float32", kv_quant="int8", max_seq_len=384,
              prefill_buckets=(32, 64))
BATCHED = dict(COMMON, batch_size=4, chunk_len=4, kv_page_size=16,
               kv_pool_page=16)
ENGINES = {
    "ragged-asked": dict(BATCHED, ragged_attention="on"),
    "pool-paged-asked": dict(BATCHED, ragged_attention="off",
                             decode_attn="paged"),
    "dense-ladder": dict(BATCHED, kv_pool=False, decode_attn="paged"),
    "single": dict(COMMON, attn_impl="flash"),
}
#: what each kind must resolve to, as the JAX engine does:
#: (_decode_impl, _attention_regime) or the single engine's prefill impl
RESOLVED = {"ragged-asked": ("dense", "gather"),
            "pool-paged-asked": ("dense", "gather"),
            "dense-ladder": ("dense", "dense"), "single": ("dense",)}
#: the port's attention kernel wrappers, as the forward reaches them
KERNELS = ("ragged_attention_pool", "paged_decode_attention_pool",
           "paged_decode_attention", "flash_attention_cached")


async def _drive(eng):
    """Greedy: the first prompt alone until it has a token, then the
    other two together, then the first again (a prefix hit); sampled:
    two prompts together at temperature 0.9 under seeds 7 and 8 (the
    single engine serves them in turn). Returns (greedy texts, the
    repeat's prefix hit, sampled texts)."""
    first = asyncio.ensure_future(
        eng.generate(PROMPTS[0], max_tokens=MAX_TOKENS))
    await asyncio.sleep(0.05)
    rest = await asyncio.gather(*[eng.generate(p, max_tokens=MAX_TOKENS)
                                  for p in PROMPTS[1:]])
    again = await eng.generate(PROMPTS[0], max_tokens=MAX_TOKENS)
    greedy = [r.text for r in [await first] + rest + [again]]
    sampled = await asyncio.gather(*[
        eng.generate(p, max_tokens=MAX_TOKENS, temperature=0.9, seed=s)
        for p, s in zip(PROMPTS[1:], (7, 8))])
    return greedy, again.prefix_cache_hit, [r.text for r in sampled]


def _resolved(eng) -> tuple:
    if hasattr(eng, "_attention_regime"):
        return eng._decode_impl, eng._attention_regime
    return (eng.attn_impl,)


@functools.lru_cache(maxsize=None)
def _transcripts(kind: str) -> dict:
    """Both engines of ``kind`` over the same toy-8m weights, int8 KV.
    The port's attention kernel wrappers are replaced for its run by
    recorders, and its copies-on-write are recorded with the rows
    copied."""
    jparams, np_tree = _jax_params()
    kw = ENGINES[kind]
    jcfg, tcfg = jconfig.get_config("toy-8m"), tconfig.get_config("toy-8m")

    async def run():
        if kind == "single":
            je = JaxEngine(jcfg, tokenizer=IdTokenizer(),
                           compile_cache_dir="", **kw)
            te_cls = TorchEngine
        else:
            je = BatchedJaxEngine(jcfg, tokenizer=IdTokenizer(),
                                  compile_cache_dir="", **kw)
            te_cls = BatchedTorchEngine
        je.params = jparams
        await je.start()
        if kind == "single":
            je._ladder_thread.join(120.0)
            assert not je._ladder_thread.is_alive(), (
                "the JAX engine's decode ladder warm never finished")
        try:
            want = await _drive(je)
            want_resolved = _resolved(je)
        finally:
            await je.stop()
        te = te_cls(tcfg, tokenizer=IdTokenizer(), device="cpu",
                    params=params_from_jax(np_tree, tcfg), **kw)
        calls = {name: 0 for name in KERNELS}
        saved = {name: getattr(tt, name) for name in KERNELS}

        def recorder(name):
            def fn(*args, **kwargs):
                calls[name] += 1
                return saved[name](*args, **kwargs)
            return fn

        cows = []
        if kind != "single":
            run_cow = te._run_cow

            def recording_cow(src, dst, rows):
                run_cow(src, dst, rows)
                cows.append([tuple(
                    bool(torch.equal(leaf[:, dst, :rows], leaf[:, src, :rows]))
                    for leaf in (kv.q, kv.s))
                    for kv in (te._cache.k, te._cache.v)])

            te._run_cow = recording_cow
        for name in KERNELS:
            setattr(tt, name, recorder(name))
        try:
            await te.start()
            try:
                got = await _drive(te)
                books = _books(te) if kind != "single" else None
                quantized = (te._cache if kind != "single"
                             else te._new_cache()).quantized
                prefix = te._prefix or getattr(te, "_radix", None)
            finally:
                await te.stop()
        finally:
            for name in KERNELS:
                setattr(tt, name, saved[name])
        return {"want": want, "got": got, "want_resolved": want_resolved,
                "got_resolved": _resolved(te), "calls": calls,
                "launches": {name: getattr(tt, name).launches
                             for name in KERNELS},
                "cows": cows, "books": books, "quantized": quantized,
                "prefix": prefix is not None}

    return asyncio.run(run())


def _books(eng) -> bool:
    """The pool's books (``BlockPool.check`` raises), or None without a
    pool."""
    if not eng.kv_pool:
        return None
    holders: dict = {}
    for slot in eng._slots:
        for b in (slot.blocks or []) if slot is not None else []:
            holders[b] = holders.get(b, 0) + 1
    for b, n in eng._radix._held.items():
        holders[b] = holders.get(b, 0) + n
    eng._pool.check(holders)
    return True


@pytest.mark.parametrize("kind", list(ENGINES))
def test_greedy_transcripts_match_the_jax_engines(kind):
    out = _transcripts(kind)
    assert out["quantized"] and out["prefix"]
    assert out["got"][0] == out["want"][0]
    assert all(len(t) == MAX_TOKENS for t in out["got"][0])
    # The repeat is the first prompt's transcript again, off its prefix.
    assert out["got"][0][3] == out["got"][0][0]
    assert out["got"][1] and out["want"][1]


@pytest.mark.parametrize("kind", list(ENGINES))
def test_sampled_transcripts_match_the_jax_engines(kind):
    out = _transcripts(kind)
    assert out["got"][2] == out["want"][2]
    assert out["got"][2] != out["got"][0][1:3]


@pytest.mark.parametrize("kind", list(ENGINES))
def test_regime_resolves_as_the_jax_engines(kind):
    out = _transcripts(kind)
    assert out["got_resolved"] == out["want_resolved"] == RESOLVED[kind]


@pytest.mark.parametrize("kind", list(ENGINES))
def test_no_attention_kernel_reads_int8_kv(kind):
    """Neither the kernels' launch counters nor their wrappers move: the
    int8 cache never reaches the ragged, paged or flash wrappers."""
    out = _transcripts(kind)
    assert out["calls"] == {name: 0 for name in KERNELS}
    assert out["launches"] == {name: 0 for name in KERNELS}


@pytest.mark.parametrize("kind", ["ragged-asked", "pool-paged-asked"])
def test_pool_books_and_copy_on_write(kind):
    """The repeat maps its cached chain with a partial tail page, which
    is copied on write: payload and scales of K and V alike."""
    out = _transcripts(kind)
    assert out["books"] is True
    assert out["cows"], "no copy-on-write ran"
    assert all(leaves == [(True, True), (True, True)]
               for leaves in out["cows"])


def test_copy_on_write_copies_both_leaves():
    """``_run_cow`` on an int8 pool with distinct bytes and scales in
    every block: the first ``rows`` rows of block ``src`` land in
    ``dst`` in every layer, in both leaves of K and V, and nothing
    else moves."""
    eng = BatchedTorchEngine(tconfig.get_config("toy-8m"),
                             tokenizer=IdTokenizer(), device="cpu",
                             params={}, **ENGINES["pool-paged-asked"])
    eng._resolve_regime()
    eng._init_decode_state()
    gen = torch.Generator().manual_seed(5)
    for kv in (eng._cache.k, eng._cache.v):
        kv.q.random_(-127, 128, generator=gen)
        kv.s.uniform_(0.5, 2.0, generator=gen)
    before = [kv.q.clone() for kv in (eng._cache.k, eng._cache.v)] + [
        kv.s.clone() for kv in (eng._cache.k, eng._cache.v)]
    eng._run_cow(3, 7, 5)
    after = [kv.q for kv in (eng._cache.k, eng._cache.v)] + [
        kv.s for kv in (eng._cache.k, eng._cache.v)]
    for b, a in zip(before, after):
        want = b.clone()
        want[:, 7, :5] = b[:, 3, :5]
        assert torch.equal(a, want)


# ------------------------------------------------------ preempt and resume

QOS_COMMON = dict(dtype="float32", kv_quant="int8", max_seq_len=64,
                  prefill_buckets=(16,), prefix_cache=False, chunk_len=4)
#: (prompt, temperature, seed): a greedy and a sampled background
#: request, and one interactive probe
BG_REQS = [("bulk a ", 0.0, 101), ("bulk b ", 0.9, 202)]
PROBE = ("quick q ", 0.0, 505)
QOS_REGIMES = {
    "pool-ragged-asked": dict(ragged_attention="on"),
    "pool-paged-asked": dict(ragged_attention="off", decode_attn="paged"),
    "dense-paged-asked": dict(kv_pool=False, decode_attn="paged"),
}


@pytest.fixture(scope="module")
def int8_baseline():
    """The JAX engine's uncontended int8-KV transcripts (preemption
    off) and its parameters, which the port's engines serve."""
    from ai_agent_kubectl_tpu.engine.tokenizer import (
        ByteTokenizer as JaxByteTokenizer)

    eng = BatchedJaxEngine(jconfig.get_config("toy-8m"),
                           tokenizer=JaxByteTokenizer(),
                           compile_cache_dir="", batch_size=2,
                           preempt_wait_ms=0.0, **QOS_COMMON)
    asyncio.run(eng.start())

    async def run():
        return {p: (await eng.generate(p, max_tokens=40, temperature=t,
                                       seed=s)).text
                for p, t, s in BG_REQS + [PROBE]}

    try:
        base = asyncio.run(run())
    finally:
        asyncio.run(eng.stop())
    params = params_from_jax(jax.tree.map(np.asarray, eng.params),
                             tconfig.get_config("toy-8m"))
    return base, params


@pytest.mark.parametrize("regime", list(QOS_REGIMES))
async def test_preempted_victim_resumes_as_the_jax_engine(int8_baseline,
                                                          regime):
    """Two background requests fill both slots; an interactive probe
    preempts one of them, which resumes (its int8 KV re-mapped in the
    pool, or prefilled and spliced on the dense ladder) and finishes
    with its uncontended transcript."""
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer

    want, params = int8_baseline
    eng = BatchedTorchEngine(tconfig.get_config("toy-8m"),
                             tokenizer=ByteTokenizer(), params=params,
                             device="cpu", batch_size=2,
                             preempt_wait_ms=15.0, preempt_budget=2,
                             **QOS_COMMON, **QOS_REGIMES[regime])
    await eng.start()
    traces = {}

    async def run_bg(p, t, s):
        traces[p] = tr = Trace(f"qos-{p.strip()}", "POST", "/t")
        with use_trace(tr), port_qos.use_qos(port_qos.QoSContext(
                tenant="bulk", lane="background")):
            return await eng.generate(p, max_tokens=40, temperature=t,
                                      seed=s)

    try:
        tasks = [asyncio.ensure_future(run_bg(*r)) for r in BG_REQS]
        for _ in range(2000):
            await asyncio.sleep(0.005)
            if all(s is not None and len(s.detok.ids) > 0
                   for s in eng._slots):
                break
        else:
            pytest.fail("background never filled the slots")
        p, t, s = PROBE
        with port_qos.use_qos(port_qos.QoSContext(tenant="quiet",
                                                  lane="interactive")):
            probe = await eng.generate(p, max_tokens=8, temperature=t,
                                       seed=s)
        results = dict(zip([r[0] for r in BG_REQS],
                           await asyncio.gather(*tasks)))
        assert eng._cache.quantized
        assert eng.stats()["qos"]["preemptions"] >= 1
        assert probe.text == want[PROBE[0]][:len(probe.text)]
        for prompt, r in results.items():
            assert r.text == want[prompt], \
                f"transcript changed across preemption for {prompt!r}"
        events = [m for tr in traces.values() for _, m, _ in tr._events]
        assert any("replayed into slot" in m for m in events)
        if eng.kv_pool:
            _books(eng)
    finally:
        await eng.stop()


# ------------------------------------------------------------------ W8A8

@pytest.mark.parametrize("T,K,N", [(1, 64, 32), (16, 64, 32),
                                   (3, 1536, 24)])
def test_w8a8_qmatmul_matches_jax(T, K, N):
    """The s8 x s8 -> s32 product is exact on both sides (at K = 1536
    too, where a float32 product of 127-sized terms would round), so the
    outputs agree to float32 rounding of the epilogue."""
    rng = np.random.default_rng(K + T)
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = (rng.standard_normal((2, T, K)) * 3).astype(np.float32)
    jw = jq.quantize_int8(jnp.asarray(w))
    tw = tq.quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    want = jq.qmatmul(jnp.asarray(x), jq.QuantInt8W8A8(q=jw.q,
                                                       scale=jw.scale))
    got = tq.qmatmul(torch.from_numpy(x),
                     tq.QuantInt8W8A8(q=tw.q, scale=tw.scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # Within 2 % of the weight-only product (the JAX test's bound).
    ref = x @ tq.dequantize(tw, torch.float32).numpy()
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 0.02
    xq = np.clip(np.round(x / np.maximum(np.abs(x).max(-1, keepdims=True)
                                         / 127, 1e-12)), -127, 127)
    exact = (xq.astype(np.int64) @ tw.q.numpy().astype(np.int64))
    got_i = tq.int8_matmul(torch.from_numpy(xq.reshape(-1, K)).to(
        torch.int8), tw.q)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), exact.reshape(-1, N))


@pytest.mark.parametrize("model", ["toy-8m", "toy-moe"])
def test_to_w8a8_retags_only_rank3_layer_leaves(model):
    """As the JAX ``to_w8a8``: the rank-3 layer projections become
    W8A8 (same tensors), the embedding, the head and rank-4 expert
    stacks stay weight-only; a W8A8 forward agrees with JAX's."""
    jcfg, tcfg = jconfig.get_config(model), tconfig.get_config(model)
    jparams, np_tree = _jax_params(model)
    jtree = jq.to_w8a8(jq.quantize_params_int8(jparams, quantize_embed=True))
    ttree = tq.to_w8a8(tq.quantize_params_int8(params_from_jax(np_tree, tcfg),
                                               quantize_embed=True))
    kinds = ((jq.QuantInt8W8A8, tq.QuantInt8W8A8),
             (jq.QuantInt8, tq.QuantInt8))
    for name, w in ttree["layers"].items():
        jw = jtree["layers"][name]
        want = next((t for j, t in kinds if isinstance(jw, j)), None)
        if want is None:
            assert not isinstance(w, tq.QuantInt8), name
            continue
        assert type(w) is want, name
        np.testing.assert_array_equal(w.q.numpy(), np.asarray(jw.q))
    assert isinstance(ttree["layers"]["wq"], tq.QuantInt8W8A8)
    assert type(ttree["embed"]) is tq.QuantInt8
    if "lm_head" in ttree:
        assert type(ttree["lm_head"]) is tq.QuantInt8
    if tcfg.is_moe:
        assert type(ttree["layers"]["w_gate"]) is tq.QuantInt8
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    positions = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    jl, _ = jt.forward(jtree, jcfg, jnp.asarray(tokens),
                       jnp.asarray(positions),
                       jt.KVCache.zeros(jcfg, 2, 16, jnp.float32),
                       kv_limit=16)
    tl, _ = tt.forward(ttree, tcfg, torch.from_numpy(tokens),
                       torch.from_numpy(positions),
                       tt.KVCache.zeros(tcfg, 2, 16, dtype=torch.float32,
                                        device="cpu"), kv_limit=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


# ------------------------------------------------------- boot and serve

SERVED = {
    "pool": ({}, "gather"),
    "pool-ragged-off-paged": ({"RAGGED_ATTENTION": "off",
                               "DECODE_ATTN": "paged"}, "gather"),
    "dense-ladder-paged": ({"KV_POOL": "false", "DECODE_ATTN": "paged"},
                           "dense"),
    "single": ({"DECODE_BATCH_SIZE": "1", "ATTN_IMPL": "flash"}, None),
}


@pytest.mark.parametrize("kind", list(SERVED))
async def test_kv_quant_int8_boots_and_serves(monkeypatch, kind):
    """``KV_QUANT=int8`` from the environment through the factory and
    the app: the engine's cache is int8, the regime as resolved, and
    one request answered as the service decides."""
    env, regime = SERVED[kind]
    for name, value in dict(TORCH_DEVICE="cpu", MODEL_NAME="toy-8m",
                            KV_QUANT="int8", DTYPE="float32",
                            MAX_NEW_TOKENS="4", PREFILL_BUCKETS="64,128",
                            RATE_LIMIT="1000/minute", **env).items():
        monkeypatch.setenv(name, value)
    cfg = ServiceConfig.from_env(env_file=None)
    assert cfg.kv_quant == "int8"
    engine = build_engine(cfg)
    assert type(engine) is (TorchEngine if regime is None
                            else BatchedTorchEngine)
    async with TestClient(TestServer(create_app(cfg, engine))) as client:
        r = await client.post("/kubectl-command",
                              json={"query": "list all pods"})
        assert r.status in (200, 422), await r.text()
        cache = (engine._cache if regime is not None
                 else engine._new_cache())
        assert cache.quantized and isinstance(cache.k, tq.QuantKV)
        if regime is not None:
            assert engine._attention_regime == regime
        else:
            assert engine.attn_impl == "dense"
