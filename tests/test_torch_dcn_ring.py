"""A seq axis across processes (``DCN_MESH_SHAPE=sp=2``): the ring
prefill's hops, its K/V writes into the seq-0 row's cache and its join
of the rows' hidden states crossing two port processes over gloo,
against the JAX package and the port's one-process meshes, on the CPU in
float32.

- Two OS processes of ``[cpu] * 2`` each, spawned once for the file:
  toy-8m's ring prefill (``forward(attn_impl="ring")``, B=2, S=32,
  ``init_params`` in JAX carried across by ``params_from_jax``) at ICI
  ``tp=2`` x DCN ``sp=2`` (seq row 0 all of rank 0's shards, row 1 all
  of rank 1's: every hop crosses) and at ICI ``sp=2`` x DCN ``sp=2``
  (rows 0-1 on rank 0, rows 2-3 on rank 1: hops 0->1 and 2->3 stay
  inside a process, 1->2 and 3->0 cross). Rank 0's logits are bitwise
  the port's one-process ``sp=2,tp=2`` and ``sp=4`` meshes' and within
  ``TOL`` of the JAX ring forward on the same mesh shape in one process
  (the suite's virtual CPU devices); every position's K/V in the seq-0
  row's cache is the one-process mesh's; rank 1 returns no logits, and
  holds its own rows' weights and no cache.
- ``python -m ai_agent_kubectl_tpu_torch.server`` started twice as two
  ranks with toy-8m, ``MESH_SHAPE=tp=2`` and ``DCN_MESH_SHAPE=sp=2``:
  ``ENGINE=torch`` at ``DECODE_BATCH_SIZE=1`` (the single-sequence
  engine) and ``ENGINE=torch-batched`` (the dense ladder: a seq axis
  takes the pool away, loudly). Rank 0 answers a long query beside two
  short ones, each rendered past the largest bucket (128; the byte
  tokenizer's system prompt alone is 300 tokens), so every one takes
  the ring: the greedy transcripts are byte-identical to ``JaxEngine``'s
  and ``BatchedJaxEngine``'s on ``MESH_SHAPE=sp=2,tp=2`` in one process
  on the same weights, both ranks count the same ring prefills, the
  books balance, rank 1 binds no port and exits 0 after rank 0 stops.

Every process wait has a deadline that fails naming what never
happened.
"""

import asyncio
import json
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.jax_engine import JaxEngine
from ai_agent_kubectl_tpu.engine.prompts import render_prompt
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.models import transformer as jtf
from ai_agent_kubectl_tpu.parallel import mesh as jmesh
from ai_agent_kubectl_tpu.server.sanitize import sanitize_query
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.models.transformer import (KVCache, forward,
                                                           init_params)
from ai_agent_kubectl_tpu_torch.parallel import mesh as pmesh
from ai_agent_kubectl_tpu_torch.parallel.sharding import shard_params
from test_torch_dcn import (REPO, SERVE_ENV, WAIT_S, _child_env, _finish,
                            _free_port, _get, _metric, _port_open, _post,
                            _ready, _sse_transcript)
from test_torch_env import knob_env  # noqa: F401  (autouse)

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
B, S, MAX_SEQ = 2, 32, 64
#: name -> (ICI MESH_SHAPE beside DCN sp=2, the one-process mesh of the
#: same shards in the same order)
FORWARDS = {"tp2": ("tp=2", "sp=2,tp=2"), "sp2": ("sp=2", "sp=4")}
LONG = ("describe every pod of the payments namespace that restarted in "
        "the last hour with its node and image")
QUERIES = [LONG, "list all pods", "get nodes -o wide"]
#: name -> (ENGINE, DECODE_BATCH_SIZE, the JAX engine compared)
SERVED = {"single": ("torch", "1", JaxEngine),
          "batched": ("torch-batched", "4", BatchedJaxEngine)}
#: both ranks' environment beside test_torch_dcn's: every prompt would
#: take the suffix path with the prefix cache on
RING_ENV = dict(SERVE_ENV, DCN_MESH_SHAPE="sp=2", HBM_PREFIX_CACHE="false")
ONE_PROCESS_MESH = "sp=2,tp=2"


def _tokens() -> torch.Tensor:
    rng = np.random.default_rng(9)
    return torch.from_numpy(rng.integers(0, 512, (B, S)).astype(np.int32))


def _positions() -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)


def _leaves(leaf) -> list:
    """A cache leaf's per-shard tensors (None: another process's)."""
    return list(leaf.shards) if hasattr(leaf, "shards") else [leaf]


# ------------------------------------------------- the two-process forward

FORWARD_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.transformer import KVCache, forward
from ai_agent_kubectl_tpu_torch.parallel import distributed
from ai_agent_kubectl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from ai_agent_kubectl_tpu_torch.parallel.sharding import shard_params

rank, coord, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
distributed.init_distributed(coord, 2, rank)
cfg = get_config("toy-8m")
params = torch.load(f"{out}/params.pt")
tokens, positions = torch.load(f"{out}/inputs.pt")
report = {}
for name, ici in @FORWARDS@:
    mesh = build_mesh(MeshConfig.parse(ici),
                      distributed.global_devices(["cpu"] * 2),
                      dcn=MeshConfig.parse("sp=2"))
    sp = shard_params(params, mesh, cfg)
    cache = KVCache.zeros(cfg, @B@, @T@, dtype=torch.float32, mesh=mesh)
    logits, _ = forward(sp, cfg, tokens, positions, cache, kv_limit=@S@,
                        attn_impl="ring", mesh=mesh)
    leaves = lambda x: list(x.shards) if hasattr(x, "shards") else [x]
    torch.save({"logits": logits, "k": leaves(cache.k),
                "v": leaves(cache.v)}, f"{out}/{name}-{rank}.pt")
    report[name] = {"owners": list(mesh.owners), "seq": mesh.sp,
                    "params": [p is not None for p in sp],
                    "cache": [c is not None for c in leaves(cache.k)]}
report["traffic"] = distributed.report()["traffic"]
distributed.shutdown()
print(json.dumps(report), flush=True)
"""


@pytest.fixture(scope="module")
def weights():
    """The JAX init's weights: (JAX tree, the port's tree)."""
    jcfg = jconfig.get_config("toy-8m")
    jparams = jtf.init_params(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    get_config("toy-8m"))


@pytest.fixture(scope="module")
def two_rank_ring(weights, tmp_path_factory):
    """Both ranks' results and reports: two processes spawned once."""
    out = tmp_path_factory.mktemp("dcn_ring")
    torch.save(weights[1], out / "params.pt")
    torch.save((_tokens(), _positions()), out / "inputs.pt")
    script = (FORWARD_WORKER.replace("@B@", str(B)).replace("@S@", str(S))
              .replace("@T@", str(MAX_SEQ))
              .replace("@FORWARDS@", repr([(k, v[0])
                                           for k, v in FORWARDS.items()])))
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), coord,
                               str(out)], cwd=str(REPO), env=_child_env({}),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = _finish(procs, "finish the two-process ring forwards")
    for r, (rc, _, err) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{err[-3000:]}"
    reports = [json.loads(o.strip().splitlines()[-1]) for _, o, _ in outs]
    got = {name: [torch.load(out / f"{name}-{r}.pt", weights_only=False)
                  for r in range(2)] for name in FORWARDS}
    return reports, got


@pytest.fixture(scope="module")
def one_process(weights) -> dict:
    """The port's one-process mesh of the same shards in the same order,
    on four CPU devices: name -> (logits, cache)."""
    cfg = get_config("toy-8m")
    out = {}
    for name, (_, spec) in FORWARDS.items():
        mesh = pmesh.build_mesh(pmesh.MeshConfig.parse(spec), ["cpu"] * 4)
        cache = KVCache.zeros(cfg, B, MAX_SEQ, dtype=torch.float32,
                              mesh=mesh)
        logits, _ = forward(shard_params(weights[1], mesh, cfg), cfg,
                            _tokens(), _positions(), cache, kv_limit=S,
                            attn_impl="ring", mesh=mesh)
        out[name] = (logits, cache)
    return out


@pytest.mark.parametrize("name", list(FORWARDS))
def test_ring_forward_across_processes_is_the_one_process_mesh_and_jax(
        two_rank_ring, one_process, weights, name):
    """Rank 0's logits bitwise the one-process mesh's, within TOL of the
    JAX ring forward on the same mesh shape; rank 1 gets none."""
    _, got = two_rank_ring
    one, _ = one_process[name]
    jcfg = jconfig.get_config("toy-8m")
    spec = jmesh.MeshConfig.parse(FORWARDS[name][1])
    jm = jmesh.build_mesh(spec, jax.devices()[:spec.n_devices])
    want, _ = jtf.forward(weights[0], jcfg, jnp.asarray(_tokens().numpy()),
                          jnp.asarray(_positions().numpy()),
                          jtf.KVCache.zeros(jcfg, B, MAX_SEQ,
                                            dtype=jnp.float32),
                          kv_limit=S, attn_impl="ring", mesh=jm)
    r0, r1 = got[name][0]["logits"], got[name][1]["logits"]
    assert r1 is None
    assert r0.shape == (B, S, jcfg.vocab_size)
    assert torch.equal(r0, one)
    torch.testing.assert_close(r0, torch.from_numpy(np.array(want)), **TOL)


@pytest.mark.parametrize("name", list(FORWARDS))
def test_seq0_row_cache_across_processes_is_the_one_process_mesh(
        two_rank_ring, one_process, name):
    """Every position's K/V of every block landed in the seq-0 row's
    cache on rank 0, bit for bit the one-process mesh's (the rows of
    rank 1 crossed to it); past the window the cache is still zero."""
    _, got = two_rank_ring
    _, cache = one_process[name]
    for leaf in ("k", "v"):
        mine, want = got[name][0][leaf], _leaves(getattr(cache, leaf))
        assert len(mine) == len(want)
        for a, b in zip(mine, want):
            assert torch.equal(a, b)
            assert a[:, :, :S].abs().sum() > 0
            assert not a[:, :, S:].any()


@pytest.mark.parametrize("name", list(FORWARDS))
def test_each_rank_holds_its_rows_weights_and_only_rank0_a_cache(
        two_rank_ring, name):
    """The hybrid layout of a seq axis: each rank's shards are its own
    seq rows (ICI tp=2: row 0 on rank 0, row 1 on rank 1; ICI sp=2: rows
    0-1 and 2-3), each with its own copy of the weights; the cache is the
    seq-0 row's, rank 0's alone, and rank 1 holds none of it. Rank 1's
    rows crossed to rank 0 (bytes sent both ways)."""
    reports, got = two_rank_ring
    for r, rep in enumerate(reports):
        assert rep[name]["owners"] == [0, 0, 1, 1]
        assert rep[name]["seq"] == (2 if name == "tp2" else 4)
        assert rep[name]["params"] == [o == r for o in [0, 0, 1, 1]]
        assert rep[name]["cache"] == [r == 0] * len(got[name][0]["k"])
        assert got[name][1]["k"] == [None] * len(got[name][0]["k"])
        assert rep["traffic"]["bytes"] > 0


# ------------------------------------------------------ the served path

@pytest.fixture(scope="module", params=list(SERVED))
def serve_kind(request) -> str:
    return request.param


def _jax_transcripts(kind: str, tree) -> list:
    """The JAX engine of ``kind`` from the servers' environment on the
    one-process ``sp=2,tp=2`` mesh, on the servers' seeded weights: each
    query's greedy transcript as the app renders it."""
    engine, batch, cls = SERVED[kind]
    env = {k: v for k, v in RING_ENV.items()
           if k not in ("DCN_MESH_SHAPE", "NUM_PROCESSES", "ENGINE")}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setenv("MESH_SHAPE", ONE_PROCESS_MESH)
        mp.setenv("DECODE_BATCH_SIZE", batch)
        jcfg = JaxServiceConfig.from_env(env_file=None)
    eng = cls.from_config(jcfg)
    eng.params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)

    async def run():
        await eng.start()
        try:
            outs = []
            for q in QUERIES:
                r = await asyncio.wait_for(eng.generate(
                    render_prompt(sanitize_query(q)),
                    max_tokens=jcfg.max_new_tokens, temperature=0.0),
                    WAIT_S)
                outs.append(r.text)
            return outs
        finally:
            await eng.stop()

    return asyncio.run(run())


@pytest.fixture(scope="module")
def served(serve_kind):
    """Two server processes, rank 0 on HTTP; while they start, the JAX
    engine's transcripts; then each query's stream in turn, /health and
    /metrics, then rank 0 stopped and both processes' exits and
    reports."""
    engine, batch, _ = SERVED[serve_kind]
    coord = f"127.0.0.1:{_free_port()}"
    ports = [_free_port(), _free_port()]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ai_agent_kubectl_tpu_torch.server",
         "--devices", "cpu,cpu"], cwd=str(REPO),
        env=_child_env(dict(RING_ENV, ENGINE=engine, DECODE_BATCH_SIZE=batch,
                            COORDINATOR_ADDRESS=coord, PROCESS_ID=str(r),
                            PORT=str(ports[r]))),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    url = f"http://127.0.0.1:{ports[0]}"
    out = {"kind": serve_kind}
    try:
        out["jax"] = _jax_transcripts(serve_kind, init_params(
            torch.Generator().manual_seed(0), get_config("toy-8m"),
            dtype=torch.float32))
        end = time.monotonic() + WAIT_S
        while not _ready(url):
            if any(p.poll() is not None for p in procs) or \
                    time.monotonic() > end:
                for p in procs:
                    p.kill()
                errs = [p.communicate()[1][-1500:] for p in procs]
                pytest.fail(f"rank 0 did not answer /health with "
                            f"engine_ready within {WAIT_S:.0f} s: {errs}")
            time.sleep(0.2)
        out["rank1_port_open"] = _port_open(ports[1])
        out["streams"] = [
            _sse_transcript(_post(f"{url}/kubectl-command/stream",
                                  {"query": q})[1]) for q in QUERIES]
        out["metrics"] = _get(f"{url}/metrics")[1]
        out["health"] = json.loads(_get(f"{url}/health")[1])
    finally:
        if procs[0].poll() is None:
            procs[0].send_signal(signal.SIGTERM)
        out["exits"] = _finish(procs, "exit after rank 0's stop")
    out["reports"] = [json.loads(o.strip().splitlines()[-1]) if o.strip()
                      else None for _, o, _ in out["exits"]]
    return out


def test_rank0_serves_the_jax_transcripts_over_a_dcn_seq_axis(served):
    assert [text for text, _ in served["streams"]] == served["jax"]
    assert all(last in ("done", "error") for _, last in served["streams"])
    sh = served["health"]["sharding"]
    assert sh["mesh"] == dict(zip(pmesh.AXES, pmesh.MeshConfig.parse(
        ONE_PROCESS_MESH).shape))
    assert sh["devices"] == 4
    # A seq axis takes the pool away from the batched engine, loudly.
    assert sh["kv_pool_mesh_fallback"] is (served["kind"] == "batched")


def test_every_long_prompt_took_the_ring_across_both_ranks(served):
    """Every rendered prompt passes the largest bucket, so each query's
    prefill is a ring prefill, and rank 1 took part in every one (the
    reports count those since the engine's start)."""
    reps = served["reports"]
    assert reps[0] is not None and reps[1] is not None
    assert [rep["ring_forwards"] for rep in reps] == [len(QUERIES)] * 2
    assert all(rep["traffic"]["bytes"] > 0 for rep in reps)


def test_served_books_balance_over_a_dcn_seq_axis(served):
    m = served["metrics"]
    # The single-sequence engine has no batcher books (nor, as in the JAX
    # app, the mesh gauge): its requests ran one at a time to their end.
    if served["kind"] == "batched":
        assert _metric(m, "mesh_devices") == 4.0
        assert _metric(m, "engine_batch_occupancy") == 0.0
        assert _metric(m, "engine_queue_depth") == 0.0
        assert _metric(m, "engine_kv_pages_used") == 0.0
        assert served["health"]["kv_pool"] is None


def test_rank1_binds_no_port_and_exits_zero_over_a_dcn_seq_axis(served):
    assert served["rank1_port_open"] is False
    (rc0, _, err0), (rc1, _, err1) = served["exits"]
    assert rc0 == 0, err0[-2000:]
    assert rc1 == 0, err1[-2000:]
    assert served["reports"][1]["rank"] == 1
    # Every forward of the serving reached rank 1 (and returned at once
    # outside the ring prefills: no cache lies there).
    assert served["reports"][1]["calls"] == served["reports"][0]["calls"]
