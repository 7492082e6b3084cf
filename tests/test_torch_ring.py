"""Ring attention and ring prefill on a ``seq`` axis (``MESH_SHAPE`` sp):
the port against the JAX package on the CPU, in float32.

- ``parallel/ring_attention.py::ring_attention`` against the JAX
  function on the same numpy inputs at seq 2, 4 and 8, with GQA and
  position offsets (the JAX suite's 2e-5); a fully masked row against the
  JAX block partial and merge; the JAX text for an indivisible length.
- ``forward(attn_impl="ring")`` against the JAX forward on the same mesh
  at sp=2 and sp=2,tp=2, with a plain and an int8 cache: the logits, and
  every position's K/V in the one cache of the seq-0 row; then a decode
  step over that cache.
- ``TorchEngine`` on ``sp=2`` with a prompt beyond the largest bucket
  against ``JaxEngine`` on the same mesh (both take the ring), on
  ``sp=3`` (512 does not divide: both prefill in chunks), and a prompt
  that extends the cached system prefix (the suffix path, never the
  ring).
- ``BatchedTorchEngine`` on ``sp=2`` against ``BatchedJaxEngine`` on the
  same mesh: a long admission through the ring beside short ones, the
  pool's loud fallback to the dense ladder, ``sharding_health``.

The JAX engines are built once for the module on the suite's virtual
CPU devices; the port's meshes are ``devices=[cpu] * N`` on the JAX
engines' own weights (``params_from_jax``).
"""

import asyncio
import logging

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
from ai_agent_kubectl_tpu.models import transformer as jtf
from ai_agent_kubectl_tpu.parallel import mesh as jmesh
from ai_agent_kubectl_tpu.parallel import ring_attention as jring
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
from ai_agent_kubectl_tpu_torch.models import transformer as tt
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.ops.quant import QuantKV
from ai_agent_kubectl_tpu_torch.parallel import mesh as pmesh
from ai_agent_kubectl_tpu_torch.parallel import ring_attention as pring
from ai_agent_kubectl_tpu_torch.parallel.sharding import shard_params
from test_torch_env import knob_env  # noqa: F401  (autouse)

torch.set_num_threads(1)

#: toy-8m, buckets (64, 128), 512 positions, no prefix cache
KW = dict(dtype="float32", max_seq_len=512, prefill_buckets=(64, 128),
          attn_impl="dense", prefix_cache=False)
BATCH_KW = dict(KW, batch_size=4, chunk_len=4)
#: a ~300-token query (ByteTokenizer: one token a byte), beyond the
#: largest bucket
LONG = ("describe every pod of the payments namespace that restarted "
        "in the last hour, with its node, its image and the events "
        "around the restart; then list the deployments whose replicas "
        "are not all ready and the services that select them, grouped "
        "by namespace and sorted by the number of restarts, newest "
        "first, with owners")
SHORT = ["list pods", "get nodes -o wide", "describe deployment web"]
MAX_TOKENS = 8
DEADLINE_S = 120


def _mesh(pkg, **axes):
    if pkg is jmesh:
        cfg = jmesh.MeshConfig(**axes)
        return jmesh.build_mesh(cfg, jax.devices()[:cfg.n_devices])
    cfg = pmesh.MeshConfig(**axes)
    return pmesh.build_mesh(cfg, ["cpu"] * cfg.n_devices)


# ------------------------------------------------------ ring_attention

def _qkv(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    return q, k, v, pos


@pytest.mark.parametrize("n,shape,offset", [
    (2, (2, 64, 4, 4, 16), 0), (4, (2, 64, 4, 4, 16), 0),
    (8, (2, 64, 4, 4, 16), 0),
    (4, (2, 32, 8, 2, 16), 0),          # GQA: 8 query heads on 2 KV
    (4, (1, 32, 4, 4, 16), 100),        # positions past a cached prefix
])
def test_ring_attention_matches_jax(n, shape, offset):
    q, k, v, pos = _qkv(n + offset, *shape)
    pos = pos + offset
    want = jring.ring_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos),
                                _mesh(jmesh, seq=n))
    got = pring.ring_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(pos),
                               _mesh(pmesh, seq=n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_ring_fully_masked_row_outputs_zero_as_jax():
    """Queries before every key (positions a block's keys never reach):
    the port's block partials merged over two key blocks from the empty
    state, with the ``l == 0`` guard, against the JAX ``_block_attention``
    and ``_merge``: 0 for the fully masked rows, not NaN."""
    q, k, v, _ = _qkv(3, 1, 8, 4, 2, 16)
    qpos = np.array([[-5, -4, 0, 1, 2, 3, 4, 5]], np.int32)
    kpos = np.arange(8, dtype=np.int32)[None]
    scale = 16 ** -0.5
    outs = []
    for ring, conv, full, zeros, where in (
            (jring, jnp.asarray, jnp.full, jnp.zeros, jnp.where),
            (pring, torch.from_numpy,
             lambda s, x: torch.full(s, x), torch.zeros, torch.where)):
        qq, kk, vv, qp, kp = (conv(x) for x in (q, k, v, qpos, kpos))
        state = (full((1, 8, 4, 1), -np.inf), zeros((1, 8, 4, 1)),
                 zeros((1, 8, 4, 16)))
        for lo in (0, 4):
            part = ring._block_attention(qq, kk[:, lo:lo + 4],
                                         vv[:, lo:lo + 4], qp,
                                         kp[:, lo:lo + 4], scale)
            state = ring._merge(*state, *part)
        _, l, acc = state
        outs.append(np.asarray(acc / where(l == 0.0, 1.0, l)))
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-5, atol=2e-5)
    assert np.isfinite(outs[1]).all() and (outs[1][:, :2] == 0).all()


def test_ring_rejects_indivisible_seq_with_the_jax_text():
    q, k, v, pos = _qkv(4, 1, 36, 4, 4, 16)
    msgs = []
    for pkg, ring, conv in ((jmesh, jring.ring_attention, jnp.asarray),
                            (pmesh, pring.ring_attention, torch.from_numpy)):
        with pytest.raises(ValueError, match="not divisible") as e:
            ring(*(conv(x) for x in (q, k, v, pos)), _mesh(pkg, seq=8))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "seq len 36 not divisible by seq axis size 8"


# ------------------------------------------------------------- forward

def _whole(leaf, heads_split: bool):
    """A port cache leaf as the JAX one: the seq-0 row's shards joined on
    their heads, the trash row dropped."""
    shards = leaf.shards if hasattr(leaf, "shards") else [leaf]
    if isinstance(shards[0], QuantKV):
        shards = [s.q.float() * s.s[..., None] for s in shards]
    x = torch.cat(shards, dim=3) if heads_split and len(shards) > 1 \
        else shards[0]
    return x[:, :, :-1].numpy()


def _jax_whole(leaf):
    if isinstance(leaf, jtf.QuantKV):
        return np.asarray(leaf.q, np.float32) * np.asarray(leaf.s)[..., None]
    return np.asarray(leaf)


@pytest.mark.parametrize("axes", [dict(seq=2), dict(seq=2, model=2)],
                         ids=["sp2", "sp2_tp2"])
@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["plain", "int8"])
def test_ring_forward_matches_jax(axes, kv_quant):
    jcfg, pcfg = jconfig.get_config("toy-8m"), get_config("toy-8m")
    jparams = jtf.init_params(jax.random.PRNGKey(5), jcfg, jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), pcfg)
    jm, pm = _mesh(jmesh, **axes), _mesh(pmesh, **axes)
    sharded = shard_params(params, pm, pcfg)
    S, T = 32, 64
    tok = np.random.default_rng(9).integers(0, 512, (1, S)).astype(np.int32)
    pos = np.arange(S, dtype=np.int32)[None]
    jcache = jtf.KVCache.zeros(jcfg, 1, T, dtype=jnp.float32,
                               kv_quant=kv_quant)
    cache = tt.KVCache.zeros(pcfg, 1, T, dtype=torch.float32,
                             kv_quant=kv_quant, mesh=pm)
    jl, jcache = jtf.forward(jparams, jcfg, jnp.asarray(tok),
                             jnp.asarray(pos), jcache, kv_limit=S,
                             attn_impl="ring", mesh=jm)
    pl, _ = tt.forward(sharded, pcfg, torch.from_numpy(tok),
                       torch.from_numpy(pos), cache, kv_limit=S,
                       attn_impl="ring", mesh=pm)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    # One cache, the seq-0 row's: every block's K/V landed in it.
    heads = pm.tp > 1
    assert len(getattr(cache.k, "shards", [cache.k])) == pm.size // 2
    np.testing.assert_allclose(_whole(cache.k, heads)[:, :, :S],
                               _jax_whole(jcache.k)[:, :, :S],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_whole(cache.v, heads)[:, :, :S],
                               _jax_whole(jcache.v)[:, :, :S],
                               rtol=1e-4, atol=1e-4)
    # A decode step over that cache, on the seq-0 row.
    t1, p1 = np.array([[7]], np.int32), np.array([[S]], np.int32)
    jl, _ = jtf.forward(jparams, jcfg, jnp.asarray(t1), jnp.asarray(p1),
                        jcache, kv_limit=T, mesh=jm)
    pl, _ = tt.forward(sharded, pcfg, torch.from_numpy(t1),
                       torch.from_numpy(p1), cache, kv_limit=T, mesh=pm)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------------- engines

def _counted(mp, cls, name: str) -> list:
    """Count an engine method's calls (its results recorded)."""
    calls = []
    real = getattr(cls, name)

    def wrapped(self, *a, **kw):
        out = real(self, *a, **kw)
        calls.append(out is not None)
        return out

    mp.setattr(cls, name, wrapped)
    return calls


async def _serve(eng, prompts, temps=None) -> list:
    await eng.start()
    try:
        outs = await asyncio.wait_for(asyncio.gather(*[
            eng.generate(p, max_tokens=MAX_TOKENS,
                         temperature=(temps or [0.0] * len(prompts))[i],
                         seed=11 + i)
            for i, p in enumerate(prompts)]), DEADLINE_S)
        return [r.text for r in outs]
    finally:
        await eng.stop()


async def _serve_one_by_one(eng, prompts) -> list:
    await eng.start()
    try:
        out = []
        for p in prompts:
            r = await asyncio.wait_for(eng.generate(
                p, max_tokens=MAX_TOKENS, temperature=0.0), DEADLINE_S)
            out.append(r.text)
        return out
    finally:
        await eng.stop()


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engines on seq meshes, once: transcripts, ring calls (True
    for a ring prefill, False for a fallback), weights as the port's
    tree."""
    jcfg = jconfig.get_config("toy-8m")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        rings = _counted(mp, JaxEngine, "_prefill_ring")
        for name, spec, cls, kw, prompts in (
                ("sp2", "sp=2", JaxEngine, KW, [LONG, SHORT[0]]),
                ("sp3", "sp=3", JaxEngine, KW, [LONG]),
                ("batched", "sp=2", BatchedJaxEngine, BATCH_KW,
                 [LONG] + SHORT)):
            rings.clear()
            eng = cls(jcfg, tokenizer=JaxByteTokenizer(),
                      compile_cache_dir="", mesh_shape=spec, **kw)
            serve = _serve if cls is BatchedJaxEngine else _serve_one_by_one
            texts = asyncio.run(serve(eng, prompts))
            out[name] = {"texts": texts, "rings": list(rings),
                         "health": eng.sharding_health(),
                         "params": params_from_jax(
                             jax.tree.map(np.asarray, eng.params),
                             get_config("toy-8m"))}
    return out


@pytest.mark.parametrize("name,spec,n", [("sp2", "sp=2", 2),
                                         ("sp3", "sp=3", 3)])
async def test_single_engine_long_prompt_on_a_seq_mesh_matches_jax(
        jax_runs, name, spec, n):
    want = jax_runs[name]
    eng = TorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                      params=want["params"], device="cpu", mesh_shape=spec,
                      devices=["cpu"] * n, **KW)
    prompts = [LONG, SHORT[0]] if name == "sp2" else [LONG]
    assert await _serve_one_by_one(eng, prompts) == want["texts"]
    assert eng.mesh.shape["seq"] == n
    # sp=2 pads 300 tokens to 512 and rings; 512 does not divide by 3.
    assert want["rings"] == [n == 2]
    assert eng.ring_prefills == (1 if n == 2 else 0)
    assert eng.sharding_health() == want["health"]


async def test_batched_engine_on_a_seq_mesh_matches_jax(jax_runs, caplog):
    want = jax_runs["batched"]
    eng = BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                             params=want["params"], device="cpu",
                             mesh_shape="sp=2", devices=["cpu"] * 2,
                             **BATCH_KW)
    with caplog.at_level(logging.WARNING):
        assert await _serve(eng, [LONG] + SHORT) == want["texts"]
    assert "falling back to the dense KV ladder" in caplog.text
    assert want["rings"] == [True] and eng.ring_prefills == 1
    health = eng.sharding_health()
    assert health["kv_pool_mesh_fallback"] and health["mesh"]["seq"] == 2
    assert {k: health[k] for k in want["health"]} == want["health"]


async def test_a_prefix_hit_takes_the_suffix_path_never_the_ring():
    """With the prefix cache on, a long prompt extending the system
    prompt prefills its suffix in chunks (the JAX routing: the suffix
    path first); its transcript equals the unsharded engine's."""
    cfg = get_config("toy-8m")
    params = tt.init_params(torch.Generator().manual_seed(1), cfg,
                            dtype=torch.float32)
    kw = dict(KW, prefix_cache=True, max_seq_len=1024,
              prefill_buckets=(64, 128))
    prompt = render_prompt(LONG + " " + LONG)
    texts = []
    for mesh_kw in (dict(mesh_shape="sp=2", devices=["cpu"] * 2), {}):
        eng = TorchEngine(cfg, tokenizer=ByteTokenizer(), params=params,
                          device="cpu", **mesh_kw, **kw)
        texts.append(await _serve_one_by_one(eng, [prompt]))
        assert eng._prefix is not None and eng.ring_prefills == 0
        ids = eng.tokenizer.encode(prompt)
        assert eng._prefix.matches(ids)
        assert len(ids) - eng._prefix.n > kw["prefill_buckets"][-1]
    assert texts[0] == texts[1]
