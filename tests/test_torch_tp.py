"""Tensor-parallel serving (``MESH_SHAPE=tp=N``, the ``model`` axis) of
the port against the JAX package, on the CPU.

The JAX side runs on the suite's virtual CPU devices (``conftest.py``
forces eight); the port's mesh is ``devices=[cpu] * N``: one process,
each shard's tensors its own. Everything is float32.

- The two sharded pool wrappers' plain versions against the JAX
  ``ragged_attention_pool_sharded`` and ``paged_decode_attention_pool_
  sharded`` (Pallas in interpret mode, ``shard_map`` over 2 devices) and
  against the unsharded plain version (tolerance 2e-5, the JAX kernel
  tests' float32 softmax round-off); the JAX refusal when heads do not
  divide.
- ``MeshConfig.parse``, ``sanitize_spec``, ``param_specs``,
  ``cache_specs``, ``pool_cache_specs``, ``residual_spec``,
  ``logits_spec`` and ``residual_fraction`` against the JAX functions
  over a table of shapes and meshes (exact).
- ``shard_params`` of converted JAX weights: each shard's tensors equal
  the JAX shard's ``addressable_shards`` data (exact).
- The forward at tp=2 against the JAX forward and the port's own
  unsharded forward (logits within 1e-4 and 1e-5: float32 sums split
  over the shards reassociate).
- Greedy and seeded 0.9 transcripts of ``BatchedTorchEngine`` at tp=2,
  byte-identical to ``BatchedJaxEngine`` at tp=2 and to the port's
  unsharded engine in the ragged regime, the paged pool, the gather path
  (toy-8m with one KV head: the pool kernels refuse it, as in JAX) and
  the dense ladder; the pool books and every shard's KV; ``TorchEngine``
  at tp=2 against ``JaxEngine`` at tp=2.
- ``/health``'s ``sharding`` section and the five mesh families of
  ``/metrics`` against the JAX app's; every family of the JAX app's
  ``/metrics`` in the port's.
- The refusals: pipe and seq axes, too many devices from the
  environment, and ``QUANT=int4`` resolving to int8; speculative
  decoding and an MoE model on a mesh boot (served in
  ``tests/test_torch_spec_tp.py`` and ``test_torch_mesh_serving.py``).

Each JAX engine is built once per module.
"""

import asyncio
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from jax.sharding import PartitionSpec

from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.jax_engine import JaxEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.models import transformer as jtf
from ai_agent_kubectl_tpu.ops.paged_attention import (
    paged_decode_attention_pool_sharded as jax_paged_sharded)
from ai_agent_kubectl_tpu.ops.ragged_attention import (
    ragged_attention_pool_sharded as jax_ragged_sharded)
from ai_agent_kubectl_tpu.parallel import mesh as jmesh
from ai_agent_kubectl_tpu.parallel import sharding as jsh
from ai_agent_kubectl_tpu.server.app import create_app as jax_create_app
from ai_agent_kubectl_tpu.server.metrics import Metrics as JaxMetrics
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
from ai_agent_kubectl_tpu_torch.models import config as pconfig
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.models.transformer import (KVCache,
                                                           forward)
from ai_agent_kubectl_tpu_torch.obs.attribution import categorize
from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
    paged_decode_attention_pool_plain, paged_decode_attention_pool_sharded)
from ai_agent_kubectl_tpu_torch.ops.quant import QuantInt8
from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
    ragged_attention_pool_plain, ragged_attention_pool_sharded)
from ai_agent_kubectl_tpu_torch.parallel import collectives
from ai_agent_kubectl_tpu_torch.parallel import mesh as pmesh
from ai_agent_kubectl_tpu_torch.parallel import sharding as psh
from ai_agent_kubectl_tpu_torch.server.app import create_app
from ai_agent_kubectl_tpu_torch.server.metrics import Metrics
from test_torch_env import knob_env  # noqa: F401  (autouse)

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
CPU2 = ["cpu"] * 2


def _narrow_llama(pkg):
    """A 4-layer Llama-shaped config at narrow widths, G = 4 (8 query
    heads over 2 KV heads), untied head: the grouping Llama-3-8B keeps
    per shard at tp=2."""
    return dataclasses.replace(
        pkg.get_config("llama-3-8b-instruct"), n_layers=4, dim=256,
        n_heads=8, n_kv_heads=2, head_dim=32, mlp_hidden=512,
        vocab_size=512, max_seq_len=256)


def _mqa_toy(pkg):
    """toy-8m with one KV head: the pool kernels refuse it at tp=2 (KV
    does not divide), so the engines serve the gather path."""
    return dataclasses.replace(pkg.get_config("toy-8m"), n_kv_heads=1)


CONFIGS = {"toy": lambda pkg: pkg.get_config("toy-8m"),
           "llama": _narrow_llama, "mqa": _mqa_toy}


def _jax_mesh(**axes):
    cfg = jmesh.MeshConfig(**axes)
    return jmesh.build_mesh(cfg, jax.devices()[:cfg.n_devices])


def _port_mesh(**axes):
    """A port mesh of any shape (the policy functions read only its
    shape; ``build_mesh`` serves the model axis alone)."""
    cfg = pmesh.MeshConfig(**axes)
    return pmesh.Mesh(cfg, (torch.device("cpu"),) * cfg.n_devices)


# ------------------------------------------------ the sharded wrappers

def _pool_case(H, KV, hd, seed):
    """A mixed pool case: decode, a verify window, a prefill span and a
    frozen slot, a shared page, the unmapped-page sentinel (99) and a NaN
    block (11) only a clamped sentinel reaches."""
    rng = np.random.default_rng(seed)
    page, n_blocks, W = 8, 12, 8
    k = rng.standard_normal((n_blocks, page, KV, hd)).astype(np.float32)
    v = rng.standard_normal((n_blocks, page, KV, hd)).astype(np.float32)
    k[11] = np.nan
    v[11] = np.nan
    q = rng.standard_normal((4, W, H, hd)).astype(np.float32)
    q_lens = np.array([1, 5, 8, 0], np.int32)
    positions = np.array([19, 11, 0, 19], np.int32)
    tables = np.array([[7, 2, 9, 99], [7, 5, 99, 99], [0, 99, 99, 99],
                       [7, 2, 9, 99]], np.int32)
    return q, k, v, q_lens, positions, tables, page


CASES = {"h4_kv2": (4, 2, 16, 0), "h8_kv2_g4": (8, 2, 32, 1),
         "h8_kv8_g1": (8, 8, 16, 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_sharded_matches_jax_and_unsharded(case):
    q, k, v, q_lens, pos, tables, page = _pool_case(*CASES[case])
    want = np.asarray(jax_ragged_sharded(q, k, v, q_lens, pos, tables,
                                         _jax_mesh(model=2), page_size=page))
    t = [torch.from_numpy(x) for x in (q, k, v, q_lens, pos, tables)]
    mesh = pmesh.build_mesh(pmesh.MeshConfig(model=2), CPU2)
    shards = ragged_attention_pool_sharded(*t, mesh, page_size=page,
                                           plain=True)
    assert len(shards) == 2 and all(s.shape[2] == q.shape[2] // 2
                                    for s in shards)
    got = torch.cat(shards, dim=2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    whole = ragged_attention_pool_plain(*t, page_size=page)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)
    # The serving wrapper (the plain version for CPU shards) on the
    # pool's own per-shard blocks gives the same.
    ks = [c.contiguous() for c in t[1].chunk(2, dim=2)]
    vs = [c.contiguous() for c in t[2].chunk(2, dim=2)]
    qs = [c.contiguous() for c in t[0].chunk(2, dim=2)]
    again = ragged_attention_pool_sharded(qs, ks, vs, *t[3:], mesh,
                                          page_size=page)
    assert torch.equal(torch.cat(again, dim=2), got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_pool_sharded_matches_jax_and_unsharded(case):
    q, k, v, _, pos, tables, page = _pool_case(*CASES[case])
    q1 = np.ascontiguousarray(q[:, 0])
    want = np.asarray(jax_paged_sharded(q1, k, v, pos, tables,
                                        _jax_mesh(model=2), page_size=page))
    t = [torch.from_numpy(x) for x in (q1, k, v, pos, tables)]
    mesh = pmesh.build_mesh(pmesh.MeshConfig(model=2), CPU2)
    shards = paged_decode_attention_pool_sharded(*t, mesh, page_size=page,
                                                 plain=True)
    got = torch.cat(shards, dim=1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    whole = paged_decode_attention_pool_plain(*t, page_size=page)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)


@pytest.mark.parametrize("which", ["ragged", "paged"])
def test_sharded_wrappers_refuse_non_dividing_heads_as_jax(which):
    """tp=4 over 2 KV heads: both packages refuse with one message."""
    q, k, v, q_lens, pos, tables, page = _pool_case(4, 2, 16, 0)
    t = [torch.from_numpy(x) for x in (q, k, v, q_lens, pos, tables)]
    mesh = pmesh.build_mesh(pmesh.MeshConfig(model=4), ["cpu"] * 4)
    jm = _jax_mesh(model=4)
    with pytest.raises(ValueError) as theirs:
        if which == "ragged":
            jax_ragged_sharded(q, k, v, q_lens, pos, tables, jm,
                               page_size=page)
        else:
            jax_paged_sharded(q[:, 0], k, v, pos, tables, jm,
                              page_size=page)
    with pytest.raises(ValueError) as ours:
        if which == "ragged":
            ragged_attention_pool_sharded(*t, mesh, page_size=page)
        else:
            paged_decode_attention_pool_sharded(
                t[0][:, 0].contiguous(), t[1], t[2], t[4], t[5], mesh,
                page_size=page)
    assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------ mesh and specs

@pytest.mark.parametrize("spec", ["", "tp=2", "model:4", "dp=2,tp=4",
                                  "data:2,model:4", "ep=2,pp=2,sp=2",
                                  "TP=8", " tp = 2 , dp = 1 "])
def test_mesh_config_parse_matches_jax(spec):
    ours, theirs = pmesh.MeshConfig.parse(spec), jmesh.MeshConfig.parse(spec)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.shape, ours.n_devices, ours.describe()) == (
        theirs.shape, theirs.n_devices, theirs.describe())


def test_mesh_helpers():
    mesh = pmesh.build_mesh(pmesh.MeshConfig.parse("tp=2"), CPU2)
    assert (mesh.size, mesh.tp, pmesh.mesh_axis_size(mesh, "model"),
            pmesh.mesh_axis_size(mesh, "data")) == (2, 2, 2, 1)
    assert pmesh.mesh_axis_size(None, "model") == 1
    one = pmesh.single_device_mesh()
    assert (one.size, one.tp, dict(one.shape)) == (
        1, 1, dict(_jax_mesh().shape))
    assert pmesh.distinct_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="wants 4 devices, got 2"):
        pmesh.build_mesh(pmesh.MeshConfig(model=4), CPU2)


def test_mesh_config_parse_refuses_as_jax():
    msgs = []
    for cls in (pmesh.MeshConfig, jmesh.MeshConfig):
        with pytest.raises(ValueError) as e:
            cls.parse("tp=2,xx=2")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _tree_specs(tree):
    return {k: (_tree_specs(v) if isinstance(v, dict) else tuple(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["toy-8m", "toy-moe", "gemma-2b-it",
                                  "llama-3-8b-instruct"])
def test_spec_trees_match_jax(name):
    pc, jc = get_config(name), jconfig.get_config(name)
    assert psh.param_specs(pc) == _tree_specs(jsh.param_specs(jc))
    assert psh.cache_specs(pc) == _tree_specs(jsh.cache_specs(jc))
    assert psh.pool_cache_specs(pc) == _tree_specs(jsh.pool_cache_specs(jc))


MESHES = [dict(model=1), dict(model=2), dict(model=4), dict(model=8),
          dict(data=2, model=2), dict(data=2, model=4),
          dict(pipe=2, model=2), dict(expert=2, model=2), dict(data=4),
          dict(data=2, expert=2, model=2)]
SHAPES = [(4, 1, 256), (8, 1, 2048), (3, 1, 256), (1, 8, 256),
          (1, 7, 256), (2, 8, 256), (6, 4, 4096), (1, 1, 256)]
VOCABS = [512, 511, 32000, 128256, 256000]


@pytest.mark.parametrize("axes", MESHES,
                         ids=lambda a: ",".join(f"{k}={v}"
                                                for k, v in a.items()))
def test_residual_and_logits_policy_matches_jax(axes):
    pm, jm = _port_mesh(**axes), _jax_mesh(**axes)
    for shape in SHAPES:
        theirs = jsh.residual_spec(jm, shape)
        assert psh.residual_spec(pm, shape) == (
            None if theirs is None else tuple(theirs)), shape
        assert psh.residual_fraction(pm, shape[0], shape[2]) == \
            jsh.residual_fraction(jm, shape[0], shape[2])
    for vocab in VOCABS:
        theirs = jsh.logits_spec(jm, vocab)
        assert psh.logits_spec(pm, vocab) == (
            None if theirs is None else tuple(theirs))
    for spec, shape in ((("model", None), (512, 64)),
                        (("pipe", None, "model"), (4, 256, 256)),
                        (("pipe", "model", None), (4, 7, 256)),
                        ((("data", "model"),), (6,)),
                        ((None, None, None, "model", None),
                         (4, 9, 16, 1, 64)),
                        (("model",), (3, 5))):
        assert psh.sanitize_spec(pm, spec, shape) == tuple(
            jsh.sanitize_spec(jm, PartitionSpec(*spec), shape))
    assert psh.residual_fraction(None, 4, 256) == \
        jsh.residual_fraction(None, 4, 256)


@pytest.mark.parametrize("config", ["toy", "llama"])
def test_shard_params_matches_jax_addressable_shards(config):
    jcfg, pcfg = CONFIGS[config](jconfig), CONFIGS[config](pconfig)
    jparams = jtf.init_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    jm = _jax_mesh(model=2)
    placed = jsh.shard_params(jparams, jm, jcfg)
    ours = psh.shard_params(
        params_from_jax(jax.tree.map(np.asarray, jparams), pcfg),
        pmesh.build_mesh(pmesh.MeshConfig(model=2), CPU2), pcfg)
    order = list(jm.devices.flat)

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), v

    n = 0
    for path, leaf in leaves(placed):
        by_dev = {s.device: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        for i, dev in enumerate(order):
            mine = ours[i]
            for k in path:
                mine = mine[k]
            np.testing.assert_array_equal(mine.numpy(), by_dev[dev],
                                          err_msg=str(path))
            n += 1
    assert n == 2 * len(list(leaves(placed)))
    # The split leaves really split: wq, w_gate and the vocab rows.
    assert ours[0]["layers"]["wq"].shape[-1] == pcfg.n_heads * \
        pcfg.head_dim // 2
    assert ours[0]["embed"].shape[0] == pcfg.vocab_size // 2


# ------------------------------------------------------------ forward

@pytest.mark.parametrize("config", ["toy", "llama"])
def test_shard_cache_matches_jax_addressable_shards(config):
    """A filled cache split as the JAX package places it: KV heads over
    the model axis, each shard's own contiguous tensor."""
    jcfg, pcfg = CONFIGS[config](jconfig), CONFIGS[config](pconfig)
    rng = np.random.default_rng(11)
    shape = (pcfg.n_layers, 3, 9, pcfg.n_kv_heads, pcfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    jm = _jax_mesh(model=2)
    placed = jsh.shard_cache(jtf.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                                         lengths=jnp.zeros((3,), jnp.int32)),
                             jm, jcfg)
    ours = psh.shard_cache(KVCache(k=torch.from_numpy(k),
                                   v=torch.from_numpy(v)),
                           pmesh.build_mesh(pmesh.MeshConfig(model=2), CPU2),
                           pcfg)
    for jleaf, pleaf in ((placed.k, ours.k), (placed.v, ours.v)):
        by_dev = {s.device: np.asarray(s.data)
                  for s in jleaf.addressable_shards}
        assert pleaf.heads_split
        for i, dev in enumerate(jm.devices.flat):
            assert pleaf.shards[i].is_contiguous()
            np.testing.assert_array_equal(pleaf.shards[i].numpy(),
                                          by_dev[dev])
    assert psh.shard_pool_cache(
        KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v)),
        pmesh.build_mesh(pmesh.MeshConfig(model=2), CPU2),
        pcfg).k.shards[1].shape == ours.k.shards[1].shape


@pytest.mark.parametrize("tp", [3, 4])
def test_forward_with_heads_and_widths_not_dividing_tp(tp):
    """toy-8m (4 over 2 heads, d 256, F 704, vocab 512) at tp=3: nothing
    divides, every weight stays whole and each shard computes the whole
    model; at tp=4 the heads are replicated (2 KV heads) while wo, the MLP
    and the vocab split. Logits within 1e-5 of the unsharded forward."""
    cfg = get_config("toy-8m")
    params = init_toy_params()
    mesh = pmesh.build_mesh(pmesh.MeshConfig(model=tp), ["cpu"] * tp)
    sharded = psh.shard_params(params, mesh, cfg)
    assert psh.head_layout(cfg, tp) == (False, False)
    rng = np.random.default_rng(tp)
    tok = torch.from_numpy(rng.integers(0, 512, (4, 6)).astype(np.int32))
    pos = torch.arange(6, dtype=torch.int32)[None].repeat(4, 1)
    c0 = KVCache.zeros(cfg, 4, 16, dtype=torch.float32)
    c1 = KVCache.zeros(cfg, 4, 16, dtype=torch.float32, mesh=mesh)
    for t, p in ((tok, pos), (tok[:, :1], pos[:, -1:] + 1)):
        l0, _ = forward(params, cfg, t, p, c0, kv_limit=16)
        l1, _ = forward(sharded, cfg, t, p, c1, kv_limit=16, mesh=mesh)
        np.testing.assert_allclose(l1.numpy(), l0.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("config", ["toy", "llama", "mqa"])
def test_forward_logits_match_jax_and_unsharded(config):
    """A prefill window then a decode step on the dense cache: the
    port's tp=2 forward within 1e-4 of the JAX forward and 1e-5 of its
    own unsharded one; the residual split over the batch rows at decode
    (B=4) and over the sequence at prefill (S=8)."""
    jcfg, pcfg = CONFIGS[config](jconfig), CONFIGS[config](pconfig)
    jparams = jtf.init_params(jax.random.PRNGKey(5), jcfg, jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), pcfg)
    mesh = pmesh.build_mesh(pmesh.MeshConfig(model=2), CPU2)
    sharded = psh.shard_params(params, mesh, pcfg)
    rng = np.random.default_rng(7)
    B, S, T = 4, 8, 32
    tok = rng.integers(0, pcfg.vocab_size, (B, S)).astype(np.int32)
    pos = (np.arange(S)[None] + np.array([0, 3, 5, 9])[:, None]).astype(
        np.int32)
    jcache = jtf.KVCache.zeros(jcfg, B, T, dtype=jnp.float32)
    c0 = KVCache.zeros(pcfg, B, T, dtype=torch.float32)
    c1 = KVCache.zeros(pcfg, B, T, dtype=torch.float32, mesh=mesh)
    calls = collectives.all_reduce.calls
    steps = [(tok, pos), (tok[:, :1], pos[:, -1:] + 1)]
    for t, p in steps:
        jl, jcache = jtf.forward(jparams, jcfg, jnp.asarray(t),
                                 jnp.asarray(p), jcache, kv_limit=T)
        l0, _ = forward(params, pcfg, torch.from_numpy(t),
                        torch.from_numpy(p), c0, kv_limit=T)
        l1, _ = forward(sharded, pcfg, torch.from_numpy(t),
                        torch.from_numpy(p), c1, kv_limit=T, mesh=mesh)
        np.testing.assert_allclose(l1.numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(l1.numpy(), l0.numpy(),
                                   atol=1e-5, rtol=1e-5)
    # Each shard's cache holds its own heads (or a whole copy of an
    # unsplit KV head) of the unsharded cache.
    split = psh.head_layout(pcfg, 2)[1]
    for i in range(2):
        mine = c1.shard(i).k
        whole = (c0.k.chunk(2, dim=3)[i] if split else c0.k)
        np.testing.assert_allclose(mine.numpy(), whole.numpy(),
                                   atol=1e-5, rtol=1e-5)
    # Two joins per layer and the embedding's, the head's gather.
    assert collectives.all_reduce.calls - calls >= 2 * len(steps) * (
        2 * pcfg.n_layers + 1)


def test_collectives_sum_in_shard_order_and_are_billed():
    a, b = torch.tensor([1.0, 2.0, 3.0, 4.0]), torch.tensor([10.0] * 4)
    assert [x.tolist() for x in collectives.all_reduce([a, b])] == \
        [[11.0, 12.0, 13.0, 14.0]] * 2
    assert [x.tolist() for x in collectives.reduce_scatter([a, b], 0)] == \
        [[11.0, 12.0], [13.0, 14.0]]
    assert [x.tolist() for x in collectives.all_gather([a[:2], b[:2]], 0)] \
        == [[1.0, 2.0, 10.0, 10.0]] * 2
    assert categorize("o_proj/all_reduce") == "all_reduce"
    assert categorize("mlp/all_reduce/aten::add") == "all_reduce"


# ------------------------------------------------------------ engines

PROMPTS = ["list pods", "get nodes -o wide", "describe deployment web"]
TEMPS = [0.0, 0.9, 0.9]
SEEDS = [7, 123, 5]
ENGINE_KW = dict(dtype="float32", max_seq_len=128, prefill_buckets=(32, 64),
                 attn_impl="dense", prefix_cache=False, batch_size=4,
                 chunk_len=4)
#: regime -> (config, engine keywords, the regime /health reports)
REGIMES = {
    "ragged": ("toy", dict(ragged_attention="on"), "ragged"),
    "paged": ("toy", dict(ragged_attention="off", decode_attn="paged",
                          kv_pool_page=16), "paged"),
    "gather": ("mqa", dict(ragged_attention="on"), "gather"),
    "dense": ("toy", dict(kv_pool=False), "dense"),
}
#: the five mesh families of /metrics
MESH_FAMILIES = ("mesh_devices", "sharding_residual_fraction",
                 "kv_pool_mesh_fallback", "spec_draft_sharded",
                 "spec_draft_kv_fallback")


async def _serve(eng) -> list:
    outs = await asyncio.gather(*[
        eng.generate(p, max_tokens=10, temperature=t, seed=s)
        for p, t, s in zip(PROMPTS, TEMPS, SEEDS)])
    return [r.text for r in outs]


async def _http_view(app, eng) -> dict:
    """Serve the prompts through a started app, then read /health's
    sharding section and the five mesh families of /metrics."""
    async with TestClient(TestServer(app)) as c:
        texts = await _serve(eng)
        health = await (await c.get("/health")).json()
        text = await (await c.get("/metrics")).text()
    fams = {}
    for line in text.splitlines():
        name = line.split(" ")[0]
        if name in MESH_FAMILIES:
            fams[name] = float(line.split()[-1])
    return {"texts": texts, "sharding": health.get("sharding"),
            "families": fams}


def _jax_engine(regime):
    config, kw, _ = REGIMES[regime]
    return BatchedJaxEngine(CONFIGS[config](jconfig),
                            tokenizer=JaxByteTokenizer(), compile_cache_dir="",
                            mesh_shape="tp=2", **ENGINE_KW, **kw)


def _port_engine(regime, params, tp=True, **over):
    config, kw, _ = REGIMES[regime]
    mesh = dict(mesh_shape="tp=2", devices=CPU2) if tp else {}
    return BatchedTorchEngine(CONFIGS[config](pconfig),
                              tokenizer=ByteTokenizer(), params=params,
                              device="cpu", **ENGINE_KW,
                              **{**kw, **mesh, **over})


@pytest.fixture(scope="module")
def jax_runs():
    """Each regime's JAX engine at tp=2, once: its transcripts, its
    parameters as the port's tree, its sharding and pool views, and (the
    ragged regime, served through the JAX app) its /health section and
    mesh families."""
    runs = {}
    for regime, (config, _, _) in REGIMES.items():
        eng = _jax_engine(regime)
        if regime == "ragged":
            app = jax_create_app(JaxServiceConfig(
                engine="fake", rate_limit="1000/minute"), eng)
            view = asyncio.run(_http_view(app, eng))
        else:
            asyncio.run(eng.start())
            try:
                view = {"texts": asyncio.run(_serve(eng))}
            finally:
                asyncio.run(eng.stop())
        view["params"] = params_from_jax(
            jax.tree.map(np.asarray, eng.params), CONFIGS[config](pconfig))
        view["health"] = eng.sharding_health()
        view["pool"] = eng.kv_pool_health()
        runs[regime] = view
    return runs


def _books(eng) -> None:
    holders: dict = {}
    for slot in eng._slots:
        for b in (slot.blocks or []) if slot is not None else []:
            holders[b] = holders.get(b, 0) + 1
    if eng._radix is not None:
        for b, n in eng._radix._held.items():
            holders[b] = holders.get(b, 0) + n
    eng._pool.check(holders)


@pytest.mark.parametrize("regime", sorted(REGIMES))
async def test_batched_tp2_transcripts_match_jax_and_unsharded(jax_runs,
                                                              regime):
    want = jax_runs[regime]
    params = want["params"]
    ref = _port_engine(regime, params, tp=False)
    await ref.start()
    try:
        unsharded = await _serve(ref)
        ref_pool = ref.kv_pool_health()
    finally:
        await ref.stop()
    eng = _port_engine(regime, params)
    await eng.start()
    try:
        assert eng.mesh is not None and eng.mesh.tp == 2
        got = await _serve(eng)
        assert got == want["texts"] == unsharded
        health = eng.sharding_health()
        assert health == want["health"]
        assert health["attention_regime"] == REGIMES[regime][2]
        assert eng.stats()["sharding"] == health
        pool = eng.kv_pool_health()
        if pool is None:
            assert want["pool"] is None
            return
        # The books balance, block for block as the unsharded engine's
        # (the JAX pool's geometry differs: its auto pool keeps a chunk
        # of slack past max_seq, the port's only under spec decode).
        _books(eng)
        keys = ("n_blocks", "free", "live", "cached")
        assert {k: pool[k] for k in keys} == {k: ref_pool[k] for k in keys}
        assert pool["attention_regime"] == want["pool"]["attention_regime"]
        # Every shard holds the whole pool's blocks, of its own heads,
        # equal to the unsharded engine's on the blocks the tree kept.
        leaf = eng._cache.k
        assert len(leaf.shards) == 2
        split = psh.head_layout(eng.model_cfg, 2)[1]
        assert leaf.heads_split == split
        for shard in leaf.shards:
            assert shard.shape[1] == eng._pool_n_blocks + 1
            assert shard.is_contiguous()
            assert shard.shape[3] == (eng.model_cfg.n_kv_heads // 2
                                      if split else
                                      eng.model_cfg.n_kv_heads)
    finally:
        await eng.stop()


async def test_health_and_metrics_sharding_as_the_jax_app(jax_runs):
    """The ragged regime's engines through both apps: /health's sharding
    section and the five mesh families equal."""
    want = jax_runs["ragged"]
    eng = _port_engine("ragged", want["params"])
    app = create_app(ServiceConfig(torch_device="cpu",
                                   rate_limit="1000/minute"), eng)
    got = await _http_view(app, eng)
    assert got["texts"] == want["texts"]
    assert got["sharding"] == want["sharding"] == want["health"]
    assert got["families"] == want["families"]
    assert got["families"] == {
        "mesh_devices": 2.0, "sharding_residual_fraction": 1.0,
        "kv_pool_mesh_fallback": 0.0, "spec_draft_sharded": 0.0,
        "spec_draft_kv_fallback": 0.0}


def _families(metrics) -> set:
    return {m.name for m in metrics.registry.collect()}


def test_every_jax_metrics_family_is_the_ports():
    theirs, ours = _families(JaxMetrics()), _families(Metrics())
    assert len(theirs) == 82
    assert theirs == ours


async def test_single_sequence_engine_tp2_matches_jax():
    """``TorchEngine`` at tp=2 against ``JaxEngine`` at tp=2 (the JAX
    suite's toy settings) and its own unsharded run; its sharding view
    is the JAX engine's."""
    kw = dict(dtype="float32", max_seq_len=96, prefill_buckets=(32,),
              attn_impl="dense", prefix_cache=False)
    jeng = JaxEngine(jconfig.get_config("toy-8m"),
                     tokenizer=JaxByteTokenizer(), compile_cache_dir="",
                     mesh_shape="tp=2", **kw)
    await jeng.start()
    try:
        want = [(await jeng.generate(p, max_tokens=6, temperature=t,
                                     seed=s)).text
                for p, t, s in zip(PROMPTS, TEMPS, SEEDS)]
        params = params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                 pconfig.get_config("toy-8m"))
        jhealth = jeng.sharding_health()
    finally:
        await jeng.stop()
    outs = []
    for mesh in ({}, dict(mesh_shape="tp=2", devices=CPU2)):
        eng = TorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                          params=params, device="cpu", **kw, **mesh)
        await eng.start()
        try:
            outs.append([(await eng.generate(p, max_tokens=6,
                                             temperature=t, seed=s)).text
                         for p, t, s in zip(PROMPTS, TEMPS, SEEDS)])
            health = eng.sharding_health()
        finally:
            await eng.stop()
    assert outs[0] == outs[1] == want
    assert health == jhealth


async def test_int4_serves_int8_under_a_mesh_with_the_jax_warning(caplog):
    params = init_toy_params()
    ref = _port_engine("dense", params, tp=False, quant="int8")
    await ref.start()
    try:
        want = await _serve(ref)
    finally:
        await ref.stop()
    eng = _port_engine("dense", params, quant="int4")
    with caplog.at_level(logging.WARNING):
        await eng.start()
    try:
        assert eng.quant == "int8"
        assert "QUANT=int4 does not compose with a multi-device mesh" \
            in caplog.text
        assert isinstance(eng.params[0]["layers"]["wq"], QuantInt8)
        assert await _serve(eng) == want
    finally:
        await eng.stop()


async def test_host_tier_round_trip_on_a_mesh():
    """A demoted chain returns from host RAM on a tp=2 engine as on the
    unsharded one: the same transcripts, onloads and payload size (each
    shard's rows in shard order)."""
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt

    params = init_toy_params()
    out = []
    for mesh in ({}, dict(mesh_shape="tp=2", devices=CPU2)):
        eng = BatchedTorchEngine(
            get_config("toy-8m"), tokenizer=ByteTokenizer(), params=params,
            device="cpu", **{**ENGINE_KW, "max_seq_len": 512},
            ragged_attention="on", kv_pool_page=16, host_kv_blocks=16,
            **mesh)
        await eng.start()
        try:
            prompt = render_prompt("inspect the rollout of web")
            r1 = await eng.generate(prompt, max_tokens=8, temperature=0.0)
            assert eng._radix.evict_for(eng._pool.n_blocks)
            demoted = eng._host_store.stats()["used"]
            r2 = await eng.generate(prompt + r1.text + " and then?",
                                    max_tokens=8, temperature=0.0)
            _books(eng)
            block = min(eng._radix.cached_blocks())
            out.append((r1.text, r2.text, demoted,
                        eng._host_store.onloaded_total,
                        eng._pool_offload_block(block).size))
        finally:
            await eng.stop()
    assert out[0] == out[1]
    assert out[0][2] > 0 and out[0][3] > 0


def init_toy_params():
    from ai_agent_kubectl_tpu_torch.models.transformer import init_params

    return init_params(torch.Generator().manual_seed(0), get_config("toy-8m"),
                       dtype=torch.float32)


# ---------------------------------------------------------- refusals

@pytest.mark.parametrize("spec,axis", [("dp=2,pp=2", "pipe"),
                                       ("ep=2,sp=2", "seq"),
                                       ("pp=2,tp=2", "pipe"),
                                       ("sp=2", "seq")])
def test_non_model_axes_are_refused_at_boot_naming_a8(monkeypatch, spec,
                                                      axis):
    """No longer refused: the pipe and seq axes (A8 rows 4 and 5) boot
    from the environment beside any served axis, as in the JAX package,
    and build their meshes, and so do the DCN and distributed knobs
    (``tests/test_torch_server.py``; the two-process runs are
    ``tests/test_torch_dcn.py``'s). Served in ``tests/test_torch_ring.py``
    and ``tests/test_torch_pp.py``."""
    monkeypatch.setenv("MESH_SHAPE", spec)
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    assert ServiceConfig.from_env(env_file=None).mesh_shape == spec
    assert JaxServiceConfig.from_env(env_file=None).mesh_shape == spec
    cfg = pmesh.MeshConfig.parse(spec)
    mesh = pmesh.build_mesh(cfg, ["cpu"] * cfg.n_devices)
    assert mesh.shape[axis] == 2 and mesh.size == cfg.n_devices
    # Each stage or seq row is a sub-mesh of the other axes.
    for c in range(2):
        sub, idx = mesh.select(axis, c)
        assert sub.shape[axis] == 1 and len(idx) == mesh.size // 2
        assert all(mesh.coord(i, axis) == c for i in idx)
    row, idx = mesh.cache_row()
    assert row.shape["seq"] == 1
    assert len(idx) == mesh.size // (2 if axis == "seq" else 1)


def test_spec_decode_and_moe_on_a_mesh_are_refused(monkeypatch):
    """No longer refused: speculative decoding and an MoE model on a tp
    mesh boot from the environment as in the JAX package, and the
    engines set their meshes up (served in
    ``tests/test_torch_spec_tp.py`` and ``test_torch_mesh_serving.py``)."""
    monkeypatch.setenv("MESH_SHAPE", "tp=2")
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    assert ServiceConfig.from_env(env_file=None).mesh_shape == "tp=2"
    assert JaxServiceConfig.from_env(env_file=None).mesh_shape == "tp=2"
    monkeypatch.setenv("SPEC_DECODE", "true")
    monkeypatch.setenv("SPEC_DRAFT_MODEL", "toy-8m")
    assert ServiceConfig.from_env(env_file=None).spec_decode
    assert JaxServiceConfig.from_env(env_file=None).spec_decode
    monkeypatch.delenv("SPEC_DECODE")
    monkeypatch.setenv("MODEL_NAME", "toy-moe")
    assert ServiceConfig.from_env(env_file=None).model_name == "toy-moe"
    eng = TorchEngine(get_config("toy-moe"), tokenizer=ByteTokenizer(),
                      device="cpu", mesh_shape="tp=2", devices=CPU2)
    eng._setup_mesh()
    assert eng.mesh.tp == 2
    spec = BatchedTorchEngine(get_config("toy-8m"),
                              tokenizer=ByteTokenizer(), device="cpu",
                              mesh_shape="tp=2", devices=CPU2,
                              spec_decode=True, spec_draft_model="toy-8m")
    spec._setup_mesh()
    assert spec.mesh.tp == 2


def test_too_many_devices_fails_fast_as_the_jax_engine(monkeypatch):
    """The JAX suite's ``test_mesh_shape_too_many_devices_fails_fast``:
    one message, on 8 devices each; and from the environment, where the
    port's devices are the distinct CPU (one), tp=2 raises too."""
    jeng = BatchedJaxEngine(jconfig.get_config("toy-8m"),
                            tokenizer=JaxByteTokenizer(),
                            compile_cache_dir="", mesh_shape="tp=16",
                            **ENGINE_KW)
    with pytest.raises(ValueError, match="devices") as theirs:
        jeng._setup_mesh()
    eng = BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                             device="cpu", mesh_shape="tp=16",
                             devices=["cpu"] * 8, **ENGINE_KW)
    with pytest.raises(ValueError, match="devices") as ours:
        eng._setup_mesh()
    assert str(ours.value) == str(theirs.value)
    monkeypatch.setenv("MESH_SHAPE", "tp=2")
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    env_eng = BatchedTorchEngine.from_config(
        ServiceConfig.from_env(env_file=None))
    with pytest.raises(ValueError, match="wants 2 devices; only 1 present"):
        env_eng._setup_mesh()
