"""Pipeline parallelism on a ``pipe`` axis (``MESH_SHAPE`` pp): the port
against the JAX package on the CPU, in float32.

- ``parallel/pipeline.py::pipeline_forward`` against the JAX function at
  (pp, microbatches) (2, 2), (4, 4), (2, 1) and (4, 2) (the JAX suite's
  2e-4): the logits, and each stage's L/pp layers of the cache; the JAX
  texts of both ``ValueError``s.
- ``BatchedTorchEngine`` at ``pp=2,tp=2,dp=2`` and at ``pp=2,tp=2`` with
  an int8 KV cache against ``BatchedJaxEngine`` on the same meshes
  (greedy transcripts equal); each stage's shards hold L/pp layers of
  the weights and of the cache (payload and scales); the pool falls back
  to the dense ladder and an explicit ``DECODE_ATTN=paged`` to dense,
  loudly, and ``auto`` resolves to dense on a pipe axis.
- toy-moe at ``pp=2`` (its experts dense in the stages) against the JAX
  engine, and at ``pp=2,ep=2`` (warned, dense); ``MOE_IMPL=ep`` with a
  pipe axis and layers the stages do not divide refuse with the JAX
  messages.
- ``TorchEngine`` at ``pp=2`` against ``JaxEngine`` at ``pp=2``.

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
from ai_agent_kubectl_tpu.parallel import pipeline as jpipe
from ai_agent_kubectl_tpu.parallel import sharding as jsh
from ai_agent_kubectl_tpu_torch.engine.batcher import (BatchedTorchEngine,
                                                       resolve_decode_attn)
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
from ai_agent_kubectl_tpu_torch.models import transformer as tt
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.ops.quant import QuantKV
from ai_agent_kubectl_tpu_torch.parallel import mesh as pmesh
from ai_agent_kubectl_tpu_torch.parallel import pipeline as ppipe
from ai_agent_kubectl_tpu_torch.parallel.sharding import shard_params
from test_torch_env import knob_env  # noqa: F401  (autouse)

torch.set_num_threads(1)

PROMPTS = ["list pods", "get nodes -o wide", "describe deployment web"]
#: the JAX suite's test_mesh_serving.py settings
KW = dict(dtype="float32", max_seq_len=128, prefill_buckets=(32, 64),
          attn_impl="dense", prefix_cache=False, batch_size=4, chunk_len=4)
SINGLE_KW = dict(dtype="float32", max_seq_len=96, prefill_buckets=(32,),
                 attn_impl="dense", prefix_cache=False)
DEADLINE_S = 120


def _meshes(**axes):
    jc, pc = jmesh.MeshConfig(**axes), pmesh.MeshConfig(**axes)
    return (jmesh.build_mesh(jc, jax.devices()[:jc.n_devices]),
            pmesh.build_mesh(pc, ["cpu"] * pc.n_devices))


# ----------------------------------------------------- pipeline_forward

@pytest.mark.parametrize("pp,micro", [(2, 2), (4, 4), (2, 1), (4, 2)])
def test_pipeline_forward_matches_jax(pp, micro):
    jcfg, cfg = jconfig.get_config("toy-8m"), get_config("toy-8m")
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    B, S, T = 4, 8, 32
    tok = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                      jcfg.vocab_size), np.int32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jm, pm = _meshes(pipe=pp)
    sc = jsh.shard_cache(jtf.KVCache.zeros(jcfg, B, T, dtype=jnp.float32),
                         jm, jcfg)
    want, wcache = jax.jit(
        lambda p, t, q, c: jpipe.pipeline_forward(p, jcfg, t, q, c, jm,
                                                  microbatches=micro)
    )(jsh.shard_params(jparams, jm, jcfg), jnp.asarray(tok),
      jnp.asarray(pos), sc)
    params = shard_params(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg), pm, cfg)
    cache = tt.KVCache.zeros(cfg, B, T, dtype=torch.float32, mesh=pm)
    got, _ = ppipe.pipeline_forward(params, cfg, torch.from_numpy(tok),
                                    torch.from_numpy(pos), cache, pm,
                                    microbatches=micro)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # Each stage's shard holds its L/pp layers of weights and cache.
    L = cfg.n_layers // pp
    assert all(p["layers"]["wq"].shape[0] == L for p in params)
    assert all(s.shape[0] == L for s in cache.k.shards)
    whole = torch.cat([s[:, :, :T] for s in cache.k.shards]).numpy()
    np.testing.assert_allclose(whole, np.asarray(wcache.k), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("pp,B,micro,text", [
    (8, 3, 2, "n_layers 4 must divide pipe stages 8"),
    (2, 3, 2, "microbatch count 2 must divide the batch (3)")])
def test_pipeline_errors_are_the_jax_texts(pp, B, micro, text):
    jcfg, cfg = jconfig.get_config("toy-8m"), get_config("toy-8m")
    jm, pm = _meshes(pipe=pp)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    tok = np.zeros((B, 8), np.int32)
    pos = np.broadcast_to(np.arange(8), (B, 8)).astype(np.int32)
    msgs = []
    with pytest.raises(ValueError) as e:
        jpipe.pipeline_forward(jparams, jcfg, jnp.asarray(tok),
                               jnp.asarray(pos),
                               jtf.KVCache.zeros(jcfg, B, 32,
                                                 dtype=jnp.float32),
                               jm, microbatches=micro)
    msgs.append(str(e.value))
    with pytest.raises(ValueError) as e:
        ppipe.pipeline_forward(
            [params] * pm.size, cfg, torch.from_numpy(tok),
            torch.from_numpy(pos),
            tt.KVCache.zeros(cfg, B, 32, dtype=torch.float32, mesh=pm),
            pm, microbatches=micro)
    msgs.append(str(e.value))
    assert msgs == [text, text]


def test_a_ring_prefill_on_a_pipe_and_seq_mesh_runs_dense_stages():
    """pp=2,sp=2: the pipe path takes the forward, as in JAX, so a ring
    prefill attends densely over ``cache[:, :kv_limit]`` on the seq-0
    row's stages; the logits and a decode step equal the unsharded
    forward's."""
    cfg = get_config("toy-8m")
    params = tt.init_params(torch.Generator().manual_seed(2), cfg,
                            dtype=torch.float32)
    pm = pmesh.build_mesh(pmesh.MeshConfig(pipe=2, seq=2), ["cpu"] * 4)
    sharded = shard_params(params, pm, cfg)
    tok = torch.randint(0, cfg.vocab_size, (1, 32),
                        generator=torch.Generator().manual_seed(3))
    pos = torch.arange(32)[None]
    whole = tt.KVCache.zeros(cfg, 1, 64, dtype=torch.float32)
    split = tt.KVCache.zeros(cfg, 1, 64, dtype=torch.float32, mesh=pm)
    assert len(split.k.shards) == 2          # the seq-0 row's two stages
    for t, p, kw in ((tok, pos, dict(attn_impl="ring", kv_limit=32)),
                     (tok[:, :1], pos[:, -1:] + 1, {})):
        want, _ = tt.forward(params, cfg, t, p, whole, **kw)
        got, _ = tt.forward(sharded, cfg, t, p, split, mesh=pm, **kw)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_a_pipe_mesh_refuses_block_tables_with_the_jax_text():
    cfg = get_config("toy-8m")
    _, pm = _meshes(pipe=2)
    params = shard_params(tt.init_params(torch.Generator().manual_seed(0),
                                         cfg, dtype=torch.float32), pm, cfg)
    with pytest.raises(NotImplementedError,
                       match="block-paged KV does not compose with a pipe"):
        tt.forward(params, cfg, torch.zeros((1, 1), dtype=torch.int32),
                   torch.zeros((1, 1), dtype=torch.int32),
                   tt.KVCache.pool(cfg, 4, 16, dtype=torch.float32),
                   block_tables=torch.zeros((1, 2), dtype=torch.int32),
                   mesh=pm)


# ------------------------------------------------------------- engines

async def _run(eng, prompts=PROMPTS, max_tokens: int = 8) -> list:
    await eng.start()
    try:
        outs = await asyncio.wait_for(asyncio.gather(*[
            eng.generate(p, max_tokens=max_tokens, temperature=0.0)
            for p in prompts]), DEADLINE_S)
        return [r.text for r in outs]
    finally:
        await eng.stop()


#: name -> (model, JAX engine class, MESH_SHAPE, kwargs)
JAX_RUNS = {
    "pp2_tp2_dp2": ("toy-8m", BatchedJaxEngine, "pp=2,tp=2,dp=2", KW),
    "pp2_tp2_int8": ("toy-8m", BatchedJaxEngine, "pp=2,tp=2",
                     dict(KW, kv_quant="int8")),
    "moe_pp2": ("toy-moe", BatchedJaxEngine, "pp=2", KW),
    "single_pp2": ("toy-8m", JaxEngine, "pp=2", SINGLE_KW),
}


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX engine on its pipe mesh, once: transcripts, its sharding
    view and its weights as the port's tree."""
    out = {}
    for name, (model, cls, spec, kw) in JAX_RUNS.items():
        eng = cls(jconfig.get_config(model), tokenizer=JaxByteTokenizer(),
                  compile_cache_dir="", mesh_shape=spec, **kw)
        texts = asyncio.run(_run(eng))
        out[name] = {"texts": texts, "health": eng.sharding_health(),
                     "params": params_from_jax(
                         jax.tree.map(np.asarray, eng.params),
                         get_config(model))}
    return out


def _stage_layers(eng) -> set:
    """The layer counts every shard holds, of the weights and the cache
    (payload and scales)."""
    seen = {p["layers"]["wq"].shape[0] for p in eng.params}
    for leaf in (eng._cache.k, eng._cache.v):
        for s in leaf.shards:
            seen |= ({s.q.shape[0], s.s.shape[0]} if isinstance(s, QuantKV)
                     else {s.shape[0]})
    return seen


@pytest.mark.parametrize("name,n", [("pp2_tp2_dp2", 8), ("pp2_tp2_int8", 4)])
async def test_batched_engine_on_a_pipe_mesh_matches_jax(jax_runs, caplog,
                                                         name, n):
    want = jax_runs[name]
    _, _, spec, kw = JAX_RUNS[name]
    eng = BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                             params=want["params"], device="cpu",
                             mesh_shape=spec, devices=["cpu"] * n, **kw)
    with caplog.at_level(logging.WARNING):
        assert await _run(eng) == want["texts"]
    assert "falling back to the dense KV ladder" in caplog.text
    assert eng.mesh.shape["pipe"] == 2 and eng.mesh.size == n
    assert _stage_layers(eng) == {get_config("toy-8m").n_layers // 2}
    assert eng._cache.quantized == (kw.get("kv_quant") == "int8")
    health = eng.sharding_health()
    assert health["kv_pool_mesh_fallback"] and health["mesh"]["pipe"] == 2
    assert health["residual_tp_fraction"] == 0.0   # off on a pipe mesh
    assert {k: health[k] for k in want["health"]} == want["health"]


async def test_paged_decode_falls_back_to_dense_on_a_pipe_mesh(jax_runs,
                                                               caplog):
    """An explicit ``DECODE_ATTN=paged`` on the dense ladder of a pipe
    mesh serves dense with the JAX warning; ``auto`` resolves to dense on
    a pipe axis even where it would pick paged on the card."""
    llama = get_config("llama-3-8b-instruct")
    card = torch.device("cuda")
    assert resolve_decode_attn("auto", llama, page_size=16, device=card)[0] \
        == "paged"
    assert resolve_decode_attn("auto", llama, page_size=16, device=card,
                               pipe=2) == ("dense", 16)
    want = jax_runs["pp2_tp2_dp2"]
    eng = BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                             params=want["params"], device="cpu",
                             mesh_shape="pp=2", devices=["cpu"] * 2,
                             decode_attn="paged", **KW)
    with caplog.at_level(logging.WARNING):
        assert await _run(eng) == want["texts"]
    assert ("paged decode attention does not compose with a pipe mesh "
            "axis; falling back to dense") in caplog.text
    assert eng._decode_impl == "dense" and not eng.kv_pool


@pytest.mark.parametrize("spec,n", [("pp=2", 2), ("pp=2,ep=2", 4)])
async def test_toy_moe_on_a_pipe_mesh_runs_dense_experts_as_jax(
        jax_runs, caplog, monkeypatch, spec, n):
    want = jax_runs["moe_pp2"]
    calls = []
    monkeypatch.setattr(tt, "expert_parallel_moe",
                        lambda *a, **kw: calls.append(a))
    eng = BatchedTorchEngine(get_config("toy-moe"), tokenizer=ByteTokenizer(),
                             params=want["params"], device="cpu",
                             mesh_shape=spec, devices=["cpu"] * n, **KW)
    with caplog.at_level(logging.WARNING):
        assert await _run(eng) == want["texts"]
    assert not calls                    # no dispatch inside a stage
    assert ("pipe>1 disables expert-parallel MoE dispatch"
            in caplog.text) == (spec == "pp=2,ep=2")


@pytest.mark.parametrize("model,spec,moe_impl", [
    ("toy-moe", "pp=2", "ep"), ("toy-8m", "pp=3", "auto")])
def test_pipe_refusals_are_the_jax_messages(model, spec, moe_impl):
    msgs = []
    for eng in (JaxEngine(jconfig.get_config(model),
                          tokenizer=JaxByteTokenizer(), compile_cache_dir="",
                          mesh_shape=spec, moe_impl=moe_impl),
                TorchEngine(get_config(model), tokenizer=ByteTokenizer(),
                            device="cpu", mesh_shape=spec,
                            moe_impl=moe_impl)):
        with pytest.raises(ValueError) as e:
            eng._setup_mesh()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


async def test_single_engine_on_a_pipe_mesh_matches_jax(jax_runs):
    want = jax_runs["single_pp2"]
    eng = TorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                      params=want["params"], device="cpu", mesh_shape="pp=2",
                      devices=["cpu"] * 2, **SINGLE_KW)
    await eng.start()
    try:
        got = []
        for p in PROMPTS:
            r = await asyncio.wait_for(eng.generate(
                p, max_tokens=8, temperature=0.0), DEADLINE_S)
            got.append(r.text)
    finally:
        await eng.stop()
    assert got == want["texts"]
    assert eng.sharding_health() == want["health"]
    assert {p["layers"]["wq"].shape[0] for p in eng.params} == {2}
