"""Speculative decoding on a tensor-parallel mesh (``SPEC_DECODE`` with
``MESH_SHAPE=tp=N``): the port against the JAX package, on the CPU in
float32 at toy-8m (target and draft: 4 query heads over 2 KV heads).

The claim is the JAX suite's ``test_spec_tp.py``: the draft world rides
the mesh (its weights split as the target's, its cache on KV heads where
they divide tp, replicated where they do not) and nothing of it shows in
a transcript. The reference is ``BatchedJaxEngine`` on one device with
speculation off, built once per module (the JAX spec-on-tp engines are
slow-marked in the JAX suite and not built here); the port's engines
serve its weights on ``devices=[cpu] * N``.

- ``draft_cache_specs``, ``draft_kv_fallback`` and ``shard_draft_cache``
  against the JAX functions: toy-8m at tp in {2, 4, 8}, gemma-2b-it at
  tp=2 (specs and flags exact; each shard's cache equal to the JAX
  shard's data).
- ``BatchedTorchEngine`` spec-on at tp=2 with k in {2, 4} and at tp=8
  with k=4 (the draft KV fallback): transcripts byte-identical to the
  JAX spec-off engine at temperature 0 and seeded 0.9; ``draft_sharded``
  and ``draft_kv_fallback`` in ``sharding_health`` and ``spec_health``
  as JAX's ``draft_kv_fallback`` gives them; drafts made; books and the
  ledger balanced; the tp=8 engine's ``/health`` and ``/metrics``.
- ``draft:die`` and a ``decode:nan`` drill on tp=2: each byte-identical
  to the spec-off reference, no request failed but the poisoned one,
  books and ledger balanced.
- The fleet's OR of ``draft_kv_fallback``, as the JAX test.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.models import transformer as jtf
from ai_agent_kubectl_tpu.parallel import mesh as jmesh
from ai_agent_kubectl_tpu.parallel import sharding as jsh
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.fleet import EngineFleet
from ai_agent_kubectl_tpu_torch.engine.protocol import RequestQuarantined
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.models.transformer import KVCache
from ai_agent_kubectl_tpu_torch.parallel import mesh as pmesh
from ai_agent_kubectl_tpu_torch.parallel import sharding as psh
from ai_agent_kubectl_tpu_torch.server.app import create_app
from ai_agent_kubectl_tpu_torch.testing.faults import FaultInjector
from test_torch_env import knob_env  # noqa: F401  (autouse)

torch.set_num_threads(1)

PROMPTS = ["list pods", "get nodes -o wide", "describe deployment web"]
TEMPS = [0.0, 0.9, 0.9]
SEEDS = [7, 123, 5]
#: the JAX suite's test_spec_tp.py settings
KW = dict(dtype="float32", max_seq_len=128, prefill_buckets=(32, 64),
          attn_impl="dense", prefix_cache=False, batch_size=4, chunk_len=4)
#: the drills' requests: (prompt, temperature, seed, max_tokens)
DRILL = {"during": ("during drill", 0.9, 3, 20),
         "after": ("after drill", 0.0, None, 12),
         "innocent a": ("innocent a", 0.0, 2, 16),
         "innocent b": ("innocent b", 0.9, 3, 16)}
#: (tp, k) -> whether the draft KV falls back
SPEC_MESHES = {(2, 2): False, (2, 4): False, (8, 4): True}


def _specs(tree) -> dict:
    return {k: tuple(v) for k, v in tree.items()}


# ------------------------------------------------------------- specs

@pytest.mark.parametrize("name,tp", [("toy-8m", 2), ("toy-8m", 4),
                                     ("toy-8m", 8), ("gemma-2b-it", 2)])
def test_draft_cache_specs_and_fallback_match_jax(name, tp):
    jcfg, pcfg = jconfig.get_config(name), get_config(name)
    jm = jmesh.build_mesh(jmesh.MeshConfig(model=tp), jax.devices()[:tp])
    pm = pmesh.build_mesh(pmesh.MeshConfig(model=tp), ["cpu"] * tp)
    assert _specs(psh.draft_cache_specs(pcfg)) == \
        _specs(jsh.draft_cache_specs(jcfg))
    assert psh.draft_kv_fallback(pm, pcfg) is \
        bool(jsh.draft_kv_fallback(jm, jcfg))
    assert psh.draft_kv_fallback(None, pcfg) is False
    assert tuple(psh.token_spec()) == tuple(jsh.token_spec())
    # Each shard's cache is the JAX shard's data (a small cache of the
    # draft's geometry with distinct values).
    shape = (2, 4, 6, pcfg.n_kv_heads, pcfg.head_dim)
    rng = np.random.default_rng(tp)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    theirs = jsh.shard_draft_cache(jtf.KVCache(
        k=jnp.asarray(k), v=jnp.asarray(v),
        lengths=jnp.zeros((4,), jnp.int32)), jm, jcfg)
    ours = psh.shard_draft_cache(KVCache(k=torch.from_numpy(k),
                                         v=torch.from_numpy(v)), pm, pcfg)
    by_device = {s.device.id: np.asarray(s.data)
                 for s in theirs.k.addressable_shards}
    first = jax.devices()[0].id
    assert ours.k.heads_split is not psh.draft_kv_fallback(pm, pcfg)
    for i, shard in enumerate(ours.k.shards):
        np.testing.assert_array_equal(shard.numpy(), by_device[first + i])


# ----------------------------------------------------------- engines

async def _serve(eng) -> list:
    outs = await asyncio.gather(*[
        eng.generate(p, max_tokens=16, temperature=t, seed=s)
        for p, t, s in zip(PROMPTS, TEMPS, SEEDS)])
    return [r.text for r in outs]


async def _one(eng, key) -> str:
    prompt, temp, seed, n = DRILL[key]
    return (await eng.generate(prompt, max_tokens=n, temperature=temp,
                               seed=seed)).text


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX spec-off engine on one device, once: the burst's and the
    drills' transcripts, and its weights as the port's tree."""
    eng = BatchedJaxEngine(jconfig.get_config("toy-8m"),
                           tokenizer=JaxByteTokenizer(),
                           compile_cache_dir="", **KW)

    async def run():
        await eng.start()
        try:
            burst = await _serve(eng)
            return burst, {key: await _one(eng, key) for key in DRILL}
        finally:
            await eng.stop()

    burst, drills = asyncio.run(run())
    return {"burst": burst, "drills": drills,
            "params": params_from_jax(jax.tree.map(np.asarray, eng.params),
                                      get_config("toy-8m"))}


def _spec_engine(params, tp, k, **kw) -> BatchedTorchEngine:
    return BatchedTorchEngine(
        get_config("toy-8m"), tokenizer=ByteTokenizer(), params=params,
        device="cpu", **KW, mesh_shape=f"tp={tp}", devices=["cpu"] * tp,
        spec_decode=True, spec_draft_k=k, spec_draft_model="toy-8m",
        spec_draft_seed=1234, **kw)


def _books(eng) -> None:
    holders: dict = {}
    for slot in list(eng._slots) + list(eng._parked):
        if slot is not None and slot.blocks:
            for b in slot.blocks:
                holders[b] = holders.get(b, 0) + 1
    if eng._radix is not None:
        for b, n in eng._radix._held.items():
            holders[b] = holders.get(b, 0) + n
    eng._pool.check(holders)
    assert eng.ledger_snapshot()["conservation"]["balanced"]


@pytest.mark.parametrize("tp,k", list(SPEC_MESHES),
                         ids=[f"tp{t}_k{k}" for t, k in SPEC_MESHES])
async def test_spec_on_a_tp_mesh_matches_jax_spec_off(jax_ref, tp, k):
    jm = jmesh.build_mesh(jmesh.MeshConfig(model=tp), jax.devices()[:tp])
    fallback = bool(jsh.draft_kv_fallback(jm, jconfig.get_config("toy-8m")))
    assert fallback is SPEC_MESHES[(tp, k)]
    eng = _spec_engine(jax_ref["params"], tp, k)
    await eng.start()
    try:
        assert await _serve(eng) == jax_ref["burst"]
        for view in (eng.sharding_health(), eng.spec_health()):
            assert view["draft_sharded"] is True
            assert view["draft_kv_fallback"] is fallback
        assert eng.spec_health()["drafted_tokens_total"] > 0
        leaf = eng._draft_cache.k
        assert len(leaf.shards) == tp and leaf.heads_split is not fallback
        assert len(eng._draft_params) == tp
        _books(eng)
    finally:
        await eng.stop()


async def test_spec_tp8_health_and_metrics_through_the_app(jax_ref):
    eng = _spec_engine(jax_ref["params"], 8, 4)
    app = create_app(ServiceConfig(torch_device="cpu",
                                   rate_limit="1000/minute"), eng)
    async with TestClient(TestServer(app)) as c:
        assert await _serve(eng) == jax_ref["burst"]
        health = await (await c.get("/health")).json()
        metrics = await (await c.get("/metrics")).text()
    assert health["spec"]["draft_sharded"] is True
    assert health["spec"]["draft_kv_fallback"] is True
    assert health["sharding"]["draft_kv_fallback"] is True
    fams = {line.split()[0]: float(line.split()[-1])
            for line in metrics.splitlines()
            if line and not line.startswith("#")}
    assert fams["spec_draft_sharded"] == 1.0
    assert fams["spec_draft_kv_fallback"] == 1.0
    assert fams["mesh_devices"] == 8.0


async def test_draft_die_on_tp2_degrades_without_failures(jax_ref):
    inj = FaultInjector()
    inj.set("draft", "die")
    eng = _spec_engine(jax_ref["params"], 2, 2, faults=inj)
    await eng.start()
    try:
        assert await _one(eng, "during") == jax_ref["drills"]["during"]
        assert inj.fired("draft") == 1
        h = eng.spec_health()
        assert not h["active"] and h["degraded_total"] == 1
        assert h["draft_sharded"] is True
        assert await _one(eng, "after") == jax_ref["drills"]["after"]
        _books(eng)
    finally:
        await eng.stop()


async def test_nan_containment_on_tp2_replays_byte_identical(jax_ref):
    """decode:nan aimed at one request on tp=2: it quarantines, the
    innocents replay through the sharded draft re-prefill and finish as
    the spec-off reference."""
    inj = FaultInjector()
    inj.set("decode", "nan")
    inj.target_substr = "poison"
    eng = _spec_engine(jax_ref["params"], 2, 2, faults=inj,
                       quarantine_retry_budget=0)
    await eng.start()
    try:
        async def poison():
            with pytest.raises(RequestQuarantined):
                await eng.generate("poison me", max_tokens=16,
                                   temperature=0.0, seed=1)

        _, a, b = await asyncio.gather(poison(), _one(eng, "innocent a"),
                                       _one(eng, "innocent b"))
        assert [a, b] == [jax_ref["drills"]["innocent a"],
                          jax_ref["drills"]["innocent b"]]
        _books(eng)
    finally:
        await eng.stop()


def test_fleet_ors_draft_kv_fallback():
    """The JAX suite's test: one replica serving its draft KV replicated
    shows on the fleet's sharding and spec views."""

    class _Eng:
        def __init__(self, fallback):
            self._f = fallback

        def sharding_health(self):
            return {"devices": 8, "pool_sharded": True,
                    "kv_pool_mesh_fallback": False,
                    "draft_sharded": True, "draft_kv_fallback": self._f}

        def spec_health(self):
            return {"enabled": True, "active": True,
                    "drafted_tokens_total": 10,
                    "accepted_tokens_total": 5,
                    "draft_sharded": True, "draft_kv_fallback": self._f}

    class _Rep:
        def __init__(self, eng):
            self.engine = eng

    fleet = EngineFleet.__new__(EngineFleet)
    fleet.replicas = [_Rep(_Eng(False)), _Rep(_Eng(True))]
    assert fleet.sharding_health()["draft_kv_fallback"] is True
    assert fleet.spec_health()["draft_kv_fallback"] is True
    fleet.replicas = [_Rep(_Eng(False)), _Rep(_Eng(False))]
    assert fleet.sharding_health()["draft_kv_fallback"] is False
    assert fleet.spec_health()["draft_kv_fallback"] is False
