"""Serving on a mesh of data, expert and model axes (``MESH_SHAPE``
dp/ep/tp): the port's engines against the JAX package's single-device
engines, on the CPU in float32.

The JAX engines run on one of the suite's virtual CPU devices and are
built once per module; the port's meshes are ``devices=[cpu] * N`` on
the JAX engines' own weights (``params_from_jax``).

- ``toy-moe`` through ``BatchedTorchEngine`` at ``tp=2`` (dense MoE
  under tp), ``ep=2``, ``ep=2,tp=2``, ``dp=2,ep=2,tp=2`` (eight shards:
  the pool falls back to the dense ladder, the slots split over data)
  and ``MOE_IMPL=ep`` on one device (the one-device expert mesh): greedy
  transcripts byte-identical to ``BatchedJaxEngine``'s on one device
  (the JAX suite's ``test_mesh_serving.py`` claim; toy-moe's capacity
  never drops), and the dispatch counted where an expert axis serves it.
- ``TorchEngine`` on toy-moe at ``ep=2`` (the decode's single token does
  not divide the axis: dense over the split experts) and ``tp=2``
  against ``JaxEngine`` on one device, greedy and seeded 0.9.
- ``dp=2,tp=2`` on toy-8m with the pool asked for, through the app:
  transcripts equal, ``kv_pool_mesh_fallback`` true in ``/health`` and
  ``/metrics``, ``pool_sharded`` false.
- ``Mesh.groups`` against the JAX device layout of the same mesh.
- The environment: ``MESH_SHAPE=ep=2``, ``MOE_IMPL=ep``, ``SPEC_DECODE``
  with a tp mesh and an MoE model on a mesh boot; ``SPEC_DECODE`` with a
  data axis refuses with the JAX message.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.jax_engine import JaxEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.parallel import mesh as jmesh
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
from ai_agent_kubectl_tpu_torch.models import transformer as tt
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.parallel import mesh as pmesh
from ai_agent_kubectl_tpu_torch.server.app import create_app
from test_torch_env import knob_env  # noqa: F401  (autouse)

torch.set_num_threads(1)

PROMPTS = ["list pods", "get nodes -o wide", "describe deployment web"]
TEMPS = [0.0, 0.9, 0.9]
SEEDS = [7, 123, 5]
#: the JAX suite's test_mesh_serving.py settings
KW = dict(dtype="float32", max_seq_len=128, prefill_buckets=(32, 64),
          attn_impl="dense", prefix_cache=False, batch_size=4, chunk_len=4)
SINGLE_KW = dict(dtype="float32", max_seq_len=96, prefill_buckets=(32,),
                 attn_impl="dense", prefix_cache=False)
#: name -> (MESH_SHAPE, devices, whether the dispatch serves its MoE)
MOE_MESHES = {"tp2": ("tp=2", 2, False), "ep2": ("ep=2", 2, True),
              "ep2_tp2": ("ep=2,tp=2", 4, True),
              "dp2_ep2_tp2": ("dp=2,ep=2,tp=2", 8, True)}


async def _run(eng, *, sampled: bool = False, max_tokens: int = 8) -> list:
    """Start, serve the prompts (greedy, or at the seeded temperatures),
    stop."""
    await eng.start()
    try:
        outs = await asyncio.gather(*[
            eng.generate(p, max_tokens=max_tokens,
                         temperature=t if sampled else 0.0, seed=s)
            for p, t, s in zip(PROMPTS, TEMPS, SEEDS)])
        return [r.text for r in outs]
    finally:
        await eng.stop()


def _jax_run(eng, name, **kw) -> dict:
    texts = asyncio.run(_run(eng, **kw))
    return {"texts": texts, "params": params_from_jax(
        jax.tree.map(np.asarray, eng.params), get_config(name))}


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX reference on one device, once: its transcripts and its
    weights as the port's tree."""
    return {
        "moe": _jax_run(BatchedJaxEngine(
            jconfig.get_config("toy-moe"), tokenizer=JaxByteTokenizer(),
            compile_cache_dir="", **KW), "toy-moe"),
        "moe_single": _jax_run(JaxEngine(
            jconfig.get_config("toy-moe"), tokenizer=JaxByteTokenizer(),
            compile_cache_dir="", **SINGLE_KW), "toy-moe", sampled=True,
            max_tokens=6),
        "toy": _jax_run(BatchedJaxEngine(
            jconfig.get_config("toy-8m"), tokenizer=JaxByteTokenizer(),
            compile_cache_dir="", **KW), "toy-8m", sampled=True),
    }


def _dispatches(monkeypatch) -> list:
    """Count the forward's expert-parallel dispatches."""
    calls = []
    real = tt.expert_parallel_moe

    def counted(*a, **kw):
        calls.append(len(a[1]))
        return real(*a, **kw)

    monkeypatch.setattr(tt, "expert_parallel_moe", counted)
    return calls


@pytest.mark.parametrize("name", list(MOE_MESHES) + ["moe_impl_ep"])
async def test_toy_moe_batched_on_a_mesh_matches_jax(jax_runs, monkeypatch,
                                                     name):
    want = jax_runs["moe"]
    if name == "moe_impl_ep":
        spec, n, ep = "", 1, True
        mesh_kw = dict(moe_impl="ep")
    else:
        spec, n, ep = MOE_MESHES[name]
        mesh_kw = dict(mesh_shape=spec, devices=["cpu"] * n)
    calls = _dispatches(monkeypatch)
    eng = BatchedTorchEngine(get_config("toy-moe"), tokenizer=ByteTokenizer(),
                             params=want["params"], device="cpu", **KW,
                             **mesh_kw)
    assert await _run(eng) == want["texts"]
    assert eng.mesh is not None and eng.mesh.size == n
    assert dict(eng.mesh.shape) == {
        **{a: 1 for a in pmesh.AXES},
        **dict(pmesh.MeshConfig.parse(spec).__dict__)}
    # The dispatch ran wherever an expert axis serves the MoE, over
    # every shard; dense under tp=2 ran none.
    assert bool(calls) is ep and set(calls) <= {n}
    health = eng.sharding_health()
    fallback = name == "dp2_ep2_tp2"
    assert health["kv_pool_mesh_fallback"] is fallback
    assert health["pool_sharded"] is not fallback
    if fallback:
        assert eng._attention_regime == "dense" and not eng.kv_pool
        leaf = eng._cache.k
        assert leaf.row_groups == 2 and len(leaf.shards) == 8
        assert all(s.shape[1] == KW["batch_size"] // 2
                   and s.shape[3] == 1 for s in leaf.shards)


@pytest.mark.parametrize("spec,n", [("ep=2", 2), ("tp=2", 2)])
async def test_single_sequence_engine_on_toy_moe_matches_jax(jax_runs,
                                                             spec, n):
    want = jax_runs["moe_single"]
    eng = TorchEngine(get_config("toy-moe"), tokenizer=ByteTokenizer(),
                      params=want["params"], device="cpu", mesh_shape=spec,
                      devices=["cpu"] * n, **SINGLE_KW)
    assert await _run(eng, sampled=True, max_tokens=6) == want["texts"]
    assert eng.sharding_health()["devices"] == n


async def test_data_axis_falls_back_from_the_pool_loudly(jax_runs):
    """``dp=2,tp=2`` with the pool asked for: the dense ladder serves
    the JAX transcripts, and /health and /metrics say so."""
    want = jax_runs["toy"]
    eng = BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                             params=want["params"], device="cpu", **KW,
                             kv_pool=True, mesh_shape="dp=2,tp=2",
                             devices=["cpu"] * 4)
    app = create_app(ServiceConfig(torch_device="cpu",
                                   rate_limit="1000/minute"), eng)
    async with TestClient(TestServer(app)) as c:
        outs = await asyncio.gather(*[
            eng.generate(p, max_tokens=8, temperature=t, seed=s)
            for p, t, s in zip(PROMPTS, TEMPS, SEEDS)])
        health = await (await c.get("/health")).json()
        metrics = await (await c.get("/metrics")).text()
    assert [r.text for r in outs] == want["texts"]
    sh = health["sharding"]
    assert sh["kv_pool_mesh_fallback"] is True
    assert sh["pool_sharded"] is False
    assert sh["devices"] == 4 and sh["attention_regime"] == "dense"
    fams = {line.split()[0]: float(line.split()[-1])
            for line in metrics.splitlines()
            if line and not line.startswith("#")}
    assert fams["kv_pool_mesh_fallback"] == 1.0
    assert fams["mesh_devices"] == 4.0


@pytest.mark.parametrize("axes", ["model", "expert", "data",
                                  ("expert", "model")])
def test_mesh_groups_follow_the_jax_device_layout(axes):
    """Shard ``i`` of ``dp=2,ep=2,tp=2`` is JAX device ``i`` of the same
    mesh; a collective's groups are the JAX mesh's slices over the
    axes."""
    jm = jmesh.build_mesh(jmesh.MeshConfig(data=2, expert=2, model=2),
                          jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    names = (axes,) if isinstance(axes, str) else axes
    inner = [k for k, a in enumerate(jm.axis_names) if a in names]
    outer = [k for k, a in enumerate(jm.axis_names) if a not in names]
    width = int(np.prod([ids.shape[k] for k in inner]))
    want = ids.transpose(outer + inner).reshape(-1, width).tolist()
    first = jax.devices()[0].id
    pm = pmesh.build_mesh(pmesh.MeshConfig(data=2, expert=2, model=2),
                          ["cpu"] * 8)
    assert pm.groups(axes) == [[i - first for i in g] for g in want]
    for i in range(8):
        c = pm.coords(i)
        assert ids[c["data"], c["expert"], 0, 0, c["model"]] - first == i


@pytest.mark.parametrize("env", [
    {"MESH_SHAPE": "ep=2", "MODEL_NAME": "toy-moe"},
    {"MOE_IMPL": "ep", "MODEL_NAME": "toy-moe"},
    {"MESH_SHAPE": "tp=2", "MODEL_NAME": "toy-moe"},
    {"MESH_SHAPE": "dp=2,ep=2,tp=2", "MODEL_NAME": "toy-moe"},
    {"MESH_SHAPE": "tp=2", "SPEC_DECODE": "true",
     "SPEC_DRAFT_MODEL": "toy-8m", "ENGINE": "torch-batched"},
], ids=["ep2", "moe_impl_ep", "moe_tp2", "dp_ep_tp", "spec_tp2"])
def test_mesh_knobs_boot_from_the_environment(monkeypatch, env):
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours = ServiceConfig.from_env(env_file=None)
    theirs = JaxServiceConfig.from_env(env_file=None)
    for field in ("mesh_shape", "moe_impl", "spec_decode", "model_name"):
        assert getattr(ours, field) == getattr(theirs, field)
    cls = BatchedTorchEngine if ours.batched_engine else TorchEngine
    n = pmesh.MeshConfig.parse(ours.mesh_shape).n_devices
    eng = cls.from_config(ours, devices=["cpu"] * n)
    eng._setup_mesh()
    if ours.moe_impl == "ep":
        assert eng.mesh.size == 1 and eng.mesh.shape["expert"] == 1
    else:
        assert eng.mesh.size == n


@pytest.mark.parametrize("spec", ["dp=2", "dp=2,tp=2"])
def test_spec_decode_with_a_data_axis_refuses_as_jax(monkeypatch, spec):
    for k, v in {"TORCH_DEVICE": "cpu", "MESH_SHAPE": spec,
                 "SPEC_DECODE": "true", "SPEC_DRAFT_MODEL": "toy-8m",
                 "ENGINE": "torch-batched"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="SPEC_DECODE does not compose "
                       "with a mesh that has a >1 data axis"):
        ServiceConfig.from_env(env_file=None)
    with pytest.raises(ValueError, match="SPEC_DECODE does not compose "
                       "with a mesh that has a >1 data axis"):
        JaxServiceConfig.from_env(env_file=None)
