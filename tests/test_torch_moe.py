"""The port's mixture-of-experts slice against the JAX package's, on the
CPU in float32, at ``toy-moe`` (2 layers, dim 256, 4 experts of 448, 2
routed per token, 4 query heads over 2 KV heads of 64).

Inputs are drawn with numpy from fixed seeds; one JAX init is carried
over with ``params_from_jax``, so both packages compute with the same
weights (and, quantized, the same bytes).

- ``router_weights``: the mix (``rtol=1e-6``: a float32 softmax over
  the k picks) and the picked indices (exactly), including ties at the
  k-th place, where ``lax.top_k`` keeps the lower index.
- ``dense_moe`` on one layer: float32 and int8 experts, within
  ``1e-5`` (float32, a different summation order over the experts).
- ``forward`` over the dense cache and over the pool (ragged, paged,
  gather): a prefill window, then decode steps with a frozen row;
  logits within ``1e-4`` (as ``tests/test_torch_model.py``).
- ``quantize_params_int8``/``int4`` leaves bit-equal to JAX's, the
  rank-4 expert stacks int8 under int4 too, and ``random_params_int8``
  with the structure, shapes and dtypes of the quantized init.
- Greedy transcripts through ``BatchedTorchEngine`` (ragged pool,
  ``RAGGED_ATTENTION=off``, ``KV_POOL=false``) and ``TorchEngine``,
  under ``QUANT`` "" and "int4", byte-identical to the JAX engines';
  seeded temperature-0.9 transcripts equal too.
- ``MOE_IMPL``: auto, dense and ep read (ep builds the one-device
  expert mesh in the engine); ep without a mesh refused in the forward
  with the JAX message.
"""

import asyncio
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.jax_engine import JaxEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.models import transformer as jt
from ai_agent_kubectl_tpu.ops import quant as jq
from ai_agent_kubectl_tpu.ops import quant4 as jq4
from ai_agent_kubectl_tpu.parallel import moe as jmoe
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
from ai_agent_kubectl_tpu_torch.models import config as tconfig
from ai_agent_kubectl_tpu_torch.models import transformer as tt
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.ops import quant as tq
from ai_agent_kubectl_tpu_torch.ops import quant4 as tq4
from ai_agent_kubectl_tpu_torch.parallel import moe as tmoe
from test_torch_env import knob_env  # noqa: F401  (autouse)

# Tiny shapes: one intra-op thread is as fast, and spares the suite's
# other workers the cores that idle OpenMP threads spin on.
torch.set_num_threads(1)

JCFG, TCFG = jconfig.get_config("toy-moe"), tconfig.get_config("toy-moe")
F32 = dict(atol=1e-5, rtol=1e-5)
QUANTIZE = {"": None, "int8": (jq.quantize_params_int8,
                               tq.quantize_params_int8),
            "int4": (jq4.quantize_params_int4, tq4.quantize_params_int4)}


@functools.lru_cache(maxsize=None)
def _jax_params(quant: str = ""):
    """One JAX init of toy-moe (seed 0), quantized in JAX under
    ``quant`` (the embedding per row), and its numpy tree."""
    jparams = jt.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    if quant:
        jparams = QUANTIZE[quant][0](jparams, quantize_embed=True)
    return jparams, jax.tree.map(np.asarray, jparams)


def _logits(shape, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------ routing

def _router_cases():
    ties = np.array([[1.0, 3.0, 3.0, 3.0],     # three tied for the top
                     [2.0, 2.0, 0.0, 2.0],     # a tie at the k-th place
                     [0.5, 0.5, 0.5, 0.5],     # all four tied
                     [4.0, -1.0, 4.0, 1.0],
                     [-0.0, 0.0, -2.0, -0.0]], np.float32)  # +0 above -0
    # bf16-rounded logits on a coarse grid: ties among 4 experts common
    coarse = np.round(_logits((64, 4), 1)).astype(np.float32)
    return {"random": _logits((3, 5, 4), 0), "ties": ties, "coarse": coarse}


@pytest.mark.parametrize("case", list(_router_cases()))
def test_router_weights_match_jax(case):
    logits = _router_cases()[case]
    jmix, jidx = jmoe.router_weights(JCFG, jnp.asarray(logits))
    mix, idx = tmoe.router_weights(TCFG, torch.from_numpy(logits))
    assert mix.dtype == torch.float32 and mix.shape == logits.shape
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(mix.numpy(), np.asarray(jmix), rtol=1e-6,
                               atol=0)
    if case == "ties":
        assert idx.numpy().tolist() == [[1, 2], [0, 1], [0, 1], [0, 2],
                                        [1, 0]]


@pytest.mark.parametrize("quant", ["", "int8"], ids=["f32", "int8"])
def test_dense_moe_matches_jax(quant):
    jparams, np_tree = _jax_params(quant)
    tparams = params_from_jax(np_tree, TCFG)
    jlp = {k: (jq.QuantInt8(q=v.q[1], scale=v.scale[1])
               if isinstance(v, jq.QuantInt8) else v[1])
           for k, v in jparams["layers"].items()}
    tlp = {k: v[1] for k, v in tparams["layers"].items()}
    if quant:
        assert isinstance(tlp["w_gate"], tq.QuantInt8)
        assert tlp["w_gate"].q.shape == (4, 256, 448)
    x = _logits((2, 5, 256), 2, scale=1.0)
    want = np.asarray(jmoe.dense_moe(JCFG, jlp, jnp.asarray(x)))
    got = tmoe.dense_moe(TCFG, tlp, torch.from_numpy(x))
    assert got.shape == (2, 5, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)


# ------------------------------------------------------------ forward

PAGE, N_BLOCKS, MAX_PAGES = 8, 16, 4
REGIMES = {"pool-ragged": ("pool", "ragged"), "pool-paged": ("pool", "paged"),
           "pool-gather": ("pool", "dense"), "dense": ("dense", "dense")}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_forward_matches_jax(regime):
    """A window (a prefill from 0, one continuing at 5, and a frozen row
    on the pool or a 2-token prefill on the dense cache), then four
    decode steps feeding the greedy token back, through the JAX
    ``forward`` (its Pallas kernels in interpret mode) and the port's.
    The window runs ragged, or the gather path / the dense read."""
    layout, impl = REGIMES[regime]
    jparams, np_tree = _jax_params()
    tparams = params_from_jax(np_tree, TCFG)
    L, KV, hd = JCFG.n_layers, JCFG.n_kv_heads, JCFG.head_dim
    span = MAX_PAGES * PAGE
    W = 8
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, JCFG.vocab_size, (3, W)).astype(np.int32)
    starts = np.array([0, 5, 9], np.int32)
    q_lens = np.array([8, 3, 0 if layout == "pool" else 2], np.int32)
    if layout == "pool":
        shape = (L, N_BLOCKS, PAGE, KV, hd)
        jcache = jt.KVCache(k=jnp.zeros(shape, jnp.float32),
                            v=jnp.zeros(shape, jnp.float32),
                            lengths=jnp.zeros((N_BLOCKS,), jnp.int32))
        tcache = tt.KVCache.pool(TCFG, N_BLOCKS, PAGE, dtype=torch.float32,
                                 device="cpu")
        sentinel = N_BLOCKS + 3
        extra = dict(block_tables=np.array(
            [[3, 1, 5, sentinel], [0, 2, 7, sentinel],
             [4, sentinel, sentinel, sentinel]], np.int32))
    else:
        jcache = jt.KVCache.zeros(JCFG, 3, span, dtype=jnp.float32)
        tcache = tt.KVCache.zeros(TCFG, 3, span, dtype=torch.float32,
                                  device="cpu")
        extra = {}
    jfwd = jax.jit(partial(jt.forward, cfg=JCFG, kv_limit=span,
                           page_size=PAGE), static_argnames=("attn_impl",))

    def step(tokens, positions, write_mask, logits_at, attn_impl, q_lens):
        nonlocal jcache, tcache
        kw = dict(extra)
        if attn_impl == "ragged":
            kw["q_lens"] = q_lens
        wm = None if write_mask is None else jnp.asarray(write_mask)
        jl, jcache = jfwd(jparams, tokens=jnp.asarray(tokens),
                          positions=jnp.asarray(positions), cache=jcache,
                          write_mask=wm, logits_at=jnp.asarray(logits_at),
                          attn_impl=attn_impl,
                          **{k: jnp.asarray(v) for k, v in kw.items()})
        tl, tcache = tt.forward(
            tparams, TCFG, torch.from_numpy(tokens),
            torch.from_numpy(positions), tcache, kv_limit=span,
            page_size=PAGE, attn_impl=attn_impl, moe_impl="dense",
            write_mask=(None if write_mask is None
                        else torch.from_numpy(write_mask)),
            logits_at=torch.from_numpy(logits_at),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=1e-4)
        return jl

    positions = starts[:, None] + np.arange(W, dtype=np.int32)[None]
    if layout == "pool":
        wmask = np.arange(W)[None] < q_lens[:, None]
        window_impl = "ragged" if impl == "ragged" else "dense"
    else:
        # The dense cache's JAX write mask is per row: padding columns
        # write past the prompt, where decode overwrites them first.
        wmask, window_impl = None, "dense"
    logits = step(tokens, positions, wmask, np.maximum(q_lens, 1) - 1,
                  window_impl, q_lens)
    live = q_lens > 0
    pos = starts + q_lens
    tok = logits[:, 0].argmax(-1).astype(np.int32)
    for _ in range(4):
        logits = step(tok[:, None], pos[:, None].astype(np.int32), live,
                      np.zeros(3, np.int32), impl, np.ones(3, np.int32))
        tok = np.where(live, logits[:, 0].argmax(-1), tok).astype(np.int32)
        pos = pos + live


def test_ep_refused_in_the_forward():
    _, np_tree = _jax_params()
    tparams = params_from_jax(np_tree, TCFG)
    cache = tt.KVCache.zeros(TCFG, 1, 16, dtype=torch.float32, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="MOE_IMPL=ep needs a mesh with an "
                       "expert axis whose size divides tokens and experts"):
        tt.forward(tparams, TCFG, tok, tok, cache, moe_impl="ep")
    for impl in ("auto", "dense"):
        logits, _ = tt.forward(tparams, TCFG, tok, tok, cache,
                               moe_impl=impl)
        assert torch.isfinite(logits).all()


# --------------------------------------------------------- quantizers

def _describe(tree):
    """{path: (kind, shapes, dtypes, format)} of a JAX or port tree."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, val in node.items():
                walk(val, f"{path}{key}/")
            return
        q = getattr(node, "q", None)
        if q is None:
            out[path] = ("plain", tuple(node.shape),
                         str(node.dtype).replace("torch.", ""))
            return
        kind = "int4" if hasattr(node, "group_in") else "int8"
        out[path] = (kind, tuple(q.shape), tuple(node.scale.shape),
                     str(q.dtype).replace("torch.", ""),
                     str(node.scale.dtype).replace("torch.", ""),
                     (node.group_in, node.block_out) if kind == "int4"
                     else None)
    walk(tree, "")
    return out


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_moe_trees_match_jax(quant):
    jtree = _jax_params(quant)[1]
    ttree = QUANTIZE[quant][1](params_from_jax(_jax_params()[1], TCFG),
                               quantize_embed=True)
    assert _describe(ttree) == _describe(jtree)
    layers = ttree["layers"]
    for key in ("w_gate", "w_up", "w_down"):
        # rank-4 expert stacks: int8 per (layer, expert, out-channel)
        assert type(layers[key]) is tq.QuantInt8, key
        assert layers[key].scale.shape[:2] == (2, 4)
        assert layers[key].scale.shape[-2] == 1
    assert type(layers["router"]) is torch.Tensor
    if quant == "int4":
        assert type(layers["wq"]) is tq4.QuantInt4
    for path, leaf in _flat(ttree).items():
        np.testing.assert_array_equal(leaf.numpy(), _flat(jtree)[path],
                                      err_msg=path)


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for key, val in tree.items():
            out.update(_flat(val, f"{prefix}{key}/"))
    elif hasattr(tree, "q"):
        out[prefix + "q"], out[prefix + "scale"] = tree.q, tree.scale
    else:
        out[prefix] = tree
    return out


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_random_params_int8_has_the_quantized_structure(int4):
    """Drawn directly in quantized form: the structure, shapes and dtypes
    of ``quantize_params_int8/int4(init_params(...))`` (and of the JAX
    ``random_params_int8``), int8 bytes in [-127, 127], and a router
    that does not route every token to the same experts."""
    own = tt.init_params(torch.Generator().manual_seed(0), TCFG,
                         dtype=torch.float32)
    want = (tq4.quantize_params_int4 if int4 else tq.quantize_params_int8)(
        own, quantize_embed=True)
    got = tq.random_params_int8(torch.Generator().manual_seed(0), TCFG,
                                dtype=torch.float32, quantize_embed=True,
                                int4=int4)
    assert _describe(got) == _describe(want)
    jrand = jq.random_params_int8(jax.random.PRNGKey(0), JCFG,
                                  dtype=jnp.float32, quantize_embed=True,
                                  int4=int4)
    assert _describe(got) == _describe(jax.tree.map(np.asarray, jrand))
    q = got["layers"]["w_down"].q
    assert int(q.min()) >= -127 and int(q.max()) <= 127
    assert len(torch.unique(q[1, 3])) > 200        # every slice drawn
    x = torch.randn((64, TCFG.dim), generator=torch.Generator().manual_seed(1))
    _, idx = tmoe.router_weights(TCFG, x @ got["layers"]["router"][0])
    assert len(torch.unique(idx[:, 0])) == TCFG.n_experts


# ------------------------------------------------------------ engines

PROMPTS = ["get pods in namespace kube-system",
           "describe deployment web in prod",
           "list services sorted by name"]
MAX_TOKENS = 12
BATCHED = dict(dtype="float32", max_seq_len=128, prefill_buckets=(32, 64),
               batch_size=4, chunk_len=4, kv_page_size=16, kv_pool_page=16,
               prefix_cache=False)
ENGINES = {
    "ragged": dict(BATCHED),
    "pool-off": dict(BATCHED, ragged_attention="off", decode_attn="paged"),
    "dense-ladder": dict(BATCHED, kv_pool=False, decode_attn="paged"),
    "single": dict(dtype="float32", max_seq_len=128,
                   prefill_buckets=(32, 64), attn_impl="dense",
                   prefix_cache=False),
}


async def _drive(eng):
    """Greedy: the first prompt alone until it has a token, then the
    other two together; sampled: two prompts together at temperature
    0.9 under seeds 7 and 8 (the single engine serves them in turn).
    Returns (greedy texts, sampled texts)."""
    first = asyncio.ensure_future(
        eng.generate(PROMPTS[0], max_tokens=MAX_TOKENS))
    await asyncio.sleep(0.05)
    rest = await asyncio.gather(*[eng.generate(p, max_tokens=MAX_TOKENS)
                                  for p in PROMPTS[1:]])
    greedy = [r.text for r in [await first] + rest]
    sampled = await asyncio.gather(*[
        eng.generate(p, max_tokens=MAX_TOKENS, temperature=0.9, seed=s)
        for p, s in zip(PROMPTS[1:], (7, 8))])
    return greedy, [r.text for r in sampled]


@functools.lru_cache(maxsize=None)
def _transcripts(kind: str, quant: str) -> dict:
    """Both engines of ``kind`` over the same toy-moe weights."""
    jparams, np_tree = _jax_params(quant)
    kw = dict(ENGINES[kind], quant=quant)

    async def run():
        if kind == "single":
            je = JaxEngine(JCFG, tokenizer=JaxByteTokenizer(),
                           compile_cache_dir="", **kw)
            te_cls = TorchEngine
        else:
            je = BatchedJaxEngine(JCFG, tokenizer=JaxByteTokenizer(),
                                  compile_cache_dir="", **kw)
            te_cls = BatchedTorchEngine
        je.params = jparams
        je._quantized = bool(quant)
        await je.start()
        if kind == "single":
            je._ladder_thread.join(120.0)
            assert not je._ladder_thread.is_alive(), (
                "the JAX engine's decode ladder warm never finished")
        try:
            want = await _drive(je)
        finally:
            await je.stop()
        te = te_cls(TCFG, tokenizer=ByteTokenizer(), device="cpu",
                    params=params_from_jax(np_tree, TCFG), **kw)
        await te.start()
        try:
            got = await _drive(te)
            if kind != "single":
                _books(te)
        finally:
            await te.stop()
        return {"want": want, "got": got}

    return asyncio.run(run())


def _books(eng) -> None:
    if not eng.kv_pool:
        return
    holders: dict = {}
    for slot in eng._slots:
        for b in (slot.blocks or []) if slot is not None else []:
            holders[b] = holders.get(b, 0) + 1
    for b, n in eng._radix._held.items():
        holders[b] = holders.get(b, 0) + n
    eng._pool.check(holders)


@pytest.mark.parametrize("quant", ["", "int4"], ids=["f32", "int4"])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_greedy_transcripts_match_the_jax_engines(kind, quant):
    out = _transcripts(kind, quant)
    assert out["got"][0] == out["want"][0]
    assert all(len(t) > 0 for t in out["got"][0])


@pytest.mark.parametrize("quant", ["", "int4"], ids=["f32", "int4"])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_sampled_transcripts_match_the_jax_engines(kind, quant):
    out = _transcripts(kind, quant)
    assert out["got"][1] == out["want"][1]
    assert out["got"][1] != out["got"][0][1:]


# -------------------------------------------------------------- config

@pytest.mark.parametrize("value", ["auto", "dense", "DENSE"])
def test_moe_impl_is_read(monkeypatch, value):
    monkeypatch.setenv("MOE_IMPL", value)
    cfg = ServiceConfig.from_env(env_file=None)
    assert cfg.moe_impl == value.lower()
    engine = TorchEngine.from_config(ServiceConfig(
        torch_device="cpu", model_name="toy-moe", moe_impl=cfg.moe_impl,
        decode_batch_size=1))
    assert engine.moe_impl == value.lower()


def test_moe_impl_ep_refused_at_boot(monkeypatch):
    """``MOE_IMPL=ep`` now boots: the engine builds the JAX engine's
    one-device expert mesh for an MoE model (served in
    ``tests/test_torch_mesh_serving.py``); a bad value is still
    refused."""
    monkeypatch.setenv("MOE_IMPL", "ep")
    assert ServiceConfig.from_env(env_file=None).moe_impl == "ep"
    with pytest.raises(ValueError, match="MOE_IMPL must be"):
        ServiceConfig(moe_impl="expert")
    eng = TorchEngine(TCFG, moe_impl="ep", device="cpu")
    eng._setup_mesh()
    assert eng.mesh.size == 1 and eng.mesh.shape["expert"] == 1
    # A dense model ignores the knob, as in the JAX engine.
    dense = TorchEngine(tconfig.get_config("toy-8m"), moe_impl="ep",
                        device="cpu")
    dense._setup_mesh()
    assert dense.moe_impl == "ep" and dense.mesh is None
