"""DCN and distributed init (``DCN_MESH_SHAPE``, ``COORDINATOR_ADDRESS``,
``NUM_PROCESSES``, ``PROCESS_ID``, ``DISTRIBUTED_INIT``): the port's
processes joined over gloo, against the JAX package, on the CPU in
float32.

- The hybrid layout: ``parallel/mesh.py::build_mesh(..., dcn=)`` places
  every shard where ``mesh_utils.create_hybrid_device_mesh(...,
  process_is_granule=True)`` places its device, over stub devices of
  two processes (one process, no spawn), on seven ICI x DCN specs (two
  of them a seq axis across the processes).
- In one process: the wrong device count and two granules asked of one
  process raise, as the JAX ``build_mesh`` does
  (``tests/test_parallel.py``); ``init_distributed``'s return values
  and refusals; the server's explicit ranks only when
  ``NUM_PROCESSES`` > 1 (the JAX entry point's rule).
- Two OS processes of ``[cpu] * 2`` each, spawned once for the file:
  the JAX suite's ``tests/test_distributed_dcn.py`` forward (toy-8m,
  B=4, S=8, ``kv_limit=16``, ``init_params`` in JAX carried across by
  ``params_from_jax``) at ``tp=2`` x DCN ``dp=2`` (the batch crosses the
  process boundary) and at ``tp=2`` x DCN ``pp=2`` (the stage hand-off
  crosses it), and at ``tp=2`` x DCN ``tp=2`` (a join every layer):
  rank 0's logits bitwise equal to the port's one-process four-shard
  mesh's and within ``TOL`` of the JAX single-process forward, none on
  rank 1 (only rank 0 samples); each rank holds its own shards only. toy-moe
  over tp=2 x DCN ep=2 (the expert dispatch's all-to-alls across the
  processes) against the one-process mesh.
- ``python -m ai_agent_kubectl_tpu_torch.server`` started twice
  (``ENGINE=torch-batched``, toy-8m, ``MESH_SHAPE=tp=2``) with
  ``DCN_MESH_SHAPE=dp=2`` (the dense ladder) and with ``tp=2`` (the
  pool): rank 0 answers three queries whose greedy transcripts are
  byte-identical to ``BatchedJaxEngine``'s on ``MESH_SHAPE=dp=2,tp=2``
  (or ``tp=4``) in one process on the same weights, the books balance,
  rank 1 binds no port, and rank 1 exits 0 after rank 0 stops; and the
  pool pair again with speculative decoding on (toy-8m drafting for
  itself), its transcripts and spec counters the port's one-process
  tp=4 engine's.
- The boot refusals of what rank 0 cannot mirror to another process's
  shards, each naming its ROADMAP.md row.
- A posted call's bytes: handles and tensors, never a shard; a follower
  runs only ``distributed.CALLS``' functions and unpickles only
  ``distributed._DATA``'s types, and refuses anything else.

Every process wait has a deadline that fails naming what never
happened.
"""

import asyncio
import functools
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import mesh_utils

from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.prompts import render_prompt
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.models import transformer as jtf
from ai_agent_kubectl_tpu.parallel import mesh as jmesh
from ai_agent_kubectl_tpu.server.sanitize import sanitize_query
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.models.transformer import (KVCache, forward,
                                                           init_params)
from ai_agent_kubectl_tpu_torch.parallel import distributed
from ai_agent_kubectl_tpu_torch.parallel import mesh as pmesh
from ai_agent_kubectl_tpu_torch.parallel.sharding import shard_params
from ai_agent_kubectl_tpu_torch.server import __main__ as server_main
from test_torch_env import knob_env  # noqa: F401  (autouse)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = dict(atol=2e-5, rtol=2e-5)
#: seconds any spawned process may take to reach what is waited for
WAIT_S = 90.0
B, S, KV_LIMIT = 4, 8, 16
#: name -> DCN spec of the two-process forward (ICI tp=2 in each)
FORWARDS = {"dp": ("dp=2", "dp=2,tp=2"), "pp": ("pp=2", "pp=2,tp=2"),
            "tp": ("tp=2", "tp=4")}
QUERIES = ["list all pods", "get nodes -o wide", "describe deployment web"]
#: name -> (the servers' DCN_MESH_SHAPE beside MESH_SHAPE=tp=2, the JAX
#: engine's one-process MESH_SHAPE, more of the servers' environment): a
#: data axis serves the dense ladder, a model axis the pool (toy-8m's 2
#: KV heads over 4 shards: the gather path, in both packages), and
#: speculative decoding (toy-8m drafting for itself; spec on is
#: byte-identical to the JAX spec-off engine at temperature 0, as
#: ``tests/test_torch_spec_tp.py`` holds it on one process's tp mesh)
SPEC_ENV = {"SPEC_DECODE": "true", "SPEC_DRAFT_MODEL": "toy-8m",
            "SPEC_DRAFT_K": "3"}
SERVED = {"dp": ("dp=2", "dp=2,tp=2", {}), "tp": ("tp=2", "tp=4", {}),
          "spec": ("tp=2", "tp=4", SPEC_ENV)}
#: the served path's environment (both ranks)
SERVE_ENV = {"TORCH_DEVICE": "cpu", "ENGINE": "torch-batched",
             "MODEL_NAME": "toy-8m", "MESH_SHAPE": "tp=2",
             "NUM_PROCESSES": "2",
             "DTYPE": "float32", "DECODE_BATCH_SIZE": "4",
             "MAX_NEW_TOKENS": "8", "MAX_SEQ_LEN": "512",
             "PREFILL_BUCKETS": "64,128", "RATE_LIMIT": "1000/minute"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(extra: dict) -> dict:
    """The environment of a spawned rank: no inherited service knob,
    one intra-op thread (two ranks share the box's cores)."""
    from test_torch_env import KNOBS

    env = {k: v for k, v in os.environ.items()
           if k not in KNOBS and k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), **extra)
    return env


def _finish(procs, what: str) -> list:
    """Each process's (rc, stdout, stderr), within the deadline; a
    process still running past it is killed and the test fails naming
    ``what`` never happened."""
    end = time.monotonic() + WAIT_S
    outs = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=max(1.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            err = p.communicate()[1]
            pytest.fail(f"rank {r} did not {what} within {WAIT_S:.0f} s: "
                        f"{err[-1500:]}")
        outs.append((p.returncode, out, err))
    return outs


# ------------------------------------------------------------ the layout

class _Stub:
    """A device as ``create_hybrid_device_mesh`` reads one."""

    platform = device_kind = "cpu"

    def __init__(self, id_: int, process: int):
        self.id, self.process_index = id_, process


@pytest.mark.parametrize("ici,dcn", [("tp=2", "dp=2"), ("tp=2", "pp=2"),
                                     ("tp=2", "tp=2"), ("dp=2,tp=2", "dp=2"),
                                     ("ep=2", "dp=2"), ("tp=2", "sp=2"),
                                     ("sp=2", "sp=2")])
def test_hybrid_layout_matches_create_hybrid_device_mesh(ici, dcn):
    """Shard by shard: the port's owner and local device index of shard
    ``i`` are the process and per-process index of the device JAX puts
    at flat position ``i``."""
    icfg, dcfg = pmesh.MeshConfig.parse(ici), pmesh.MeshConfig.parse(dcn)
    n, procs = icfg.n_devices, dcfg.n_devices
    stubs = [_Stub(p * n + j, p) for p in range(procs) for j in range(n)]
    want = mesh_utils.create_hybrid_device_mesh(
        jmesh.MeshConfig.parse(ici).shape, jmesh.MeshConfig.parse(dcn).shape,
        devices=stubs, process_is_granule=True)
    mesh = pmesh.build_mesh(icfg, [(p, torch.device("cpu", j))
                                   for p in range(procs) for j in range(n)],
                            dcn=dcfg)
    assert mesh.config.shape == want.shape
    assert [(d.process_index, d.id % n) for d in want.reshape(-1)] == \
        [(mesh.owner(i), mesh.devices[i].index) for i in range(mesh.size)]
    assert mesh.hybrid and mesh.local_shards == [
        i for i in range(mesh.size) if mesh.owner(i) == 0]


def test_single_process_errors_as_the_jax_build_mesh():
    """The JAX rig's negative test (``tests/test_parallel.py``): the
    wrong device count, and one process asked for two granules."""
    tp2, dp2 = pmesh.MeshConfig.parse("tp=2"), pmesh.MeshConfig.parse("dp=2")
    with pytest.raises(ValueError, match="wants 4 devices, got 2"):
        pmesh.build_mesh(tp2, ["cpu"] * 2, dcn=dp2)
    with pytest.raises(ValueError, match="Number of slices 1 must equal"):
        pmesh.build_mesh(tp2, ["cpu"] * 4, dcn=dp2)
    with pytest.raises(Exception):
        jmesh.build_mesh(jmesh.MeshConfig.parse("tp=2"),
                         devices=jax.devices()[:4],
                         dcn=jmesh.MeshConfig.parse("dp=2"))
    # A DCN spec of one device is the plain mesh.
    mesh = pmesh.build_mesh(tp2, ["cpu"] * 2, dcn=pmesh.MeshConfig())
    assert not mesh.hybrid and mesh.size == 2


# ------------------------------------------------------ init_distributed

def test_init_distributed_return_values(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.init_distributed() is False
    assert distributed.is_primary() and distributed.world_size() == 1
    with pytest.raises(ValueError, match="MASTER_ADDR, MASTER_PORT, RANK, "
                                         "WORLD_SIZE"):
        distributed.init_distributed(require=True)
    with pytest.raises(ValueError, match="missing: NUM_PROCESSES"):
        distributed.init_distributed("127.0.0.1:1")
    addr = f"127.0.0.1:{_free_port()}"
    try:
        assert distributed.init_distributed(addr, 1, 0)
        assert distributed.init_distributed(addr, 1, 0) is True
        assert distributed.is_primary() and distributed.rank() == 0
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n,want", [(1, (None, None)), (2, (2, 1))])
def test_server_passes_explicit_ranks_only_above_one_process(
        monkeypatch, n, want):
    calls = []
    monkeypatch.setattr(distributed, "init_distributed",
                        lambda *a, **kw: calls.append((a, kw)) or True)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "h:1")
    monkeypatch.setenv("NUM_PROCESSES", str(n))
    monkeypatch.setenv("PROCESS_ID", "1" if n > 1 else "0")
    assert server_main.join_group(
        ServiceConfig.from_env(env_file=None)) is True
    assert calls == [(("h:1",) + want, {"require": False})]
    calls.clear()
    monkeypatch.delenv("COORDINATOR_ADDRESS")
    assert server_main.join_group(
        ServiceConfig.from_env(env_file=None)) is False
    assert calls == []


# ------------------------------------------------- the two-process forward

FORWARD_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.transformer import (KVCache, forward,
                                                           init_params)
from ai_agent_kubectl_tpu_torch.parallel import distributed
from ai_agent_kubectl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from ai_agent_kubectl_tpu_torch.parallel.sharding import shard_params

rank, coord, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
report = {"first": distributed.init_distributed(coord, 2, rank),
          "again": distributed.init_distributed(coord, 2, rank),
          "rank": distributed.rank(), "world": distributed.world_size(),
          "primary": distributed.is_primary()}
cfg = get_config("toy-8m")
params = torch.load(f"{out}/params.pt")
tokens = torch.arange(@S@, dtype=torch.int32)[None].repeat(@B@, 1)
for name, dcn in @FORWARDS@:
    mesh = build_mesh(MeshConfig.parse("tp=2"),
                      distributed.global_devices(["cpu"] * 2),
                      dcn=MeshConfig.parse(dcn))
    sp = shard_params(params, mesh, cfg)
    cache = KVCache.zeros(cfg, @B@, @KV@, dtype=torch.float32, mesh=mesh,
                          split_rows=True)
    logits, _ = forward(sp, cfg, tokens, tokens.clone(), cache,
                        kv_limit=@KV@, mesh=mesh)
    torch.save(logits, f"{out}/{name}-{rank}.pt")
    report[name] = {"owners": list(mesh.owners),
                    "params": [p is not None for p in sp],
                    "cache": [c is not None for c in cache.k.shards]}
moe = get_config("toy-moe")
mesh = build_mesh(MeshConfig.parse("tp=2"),
                  distributed.global_devices(["cpu"] * 2),
                  dcn=MeshConfig.parse("ep=2"))
cache = KVCache.zeros(moe, @B@, @KV@, dtype=torch.float32, mesh=mesh,
                      split_rows=True)
logits, _ = forward(
    shard_params(init_params(torch.Generator().manual_seed(0), moe,
                             dtype=torch.float32), mesh, moe),
    moe, tokens, tokens.clone(), cache, kv_limit=@KV@, mesh=mesh)
torch.save(logits, f"{out}/moe-{rank}.pt")
distributed.shutdown()
print(json.dumps(report), flush=True)
"""


@pytest.fixture(scope="module")
def jax_forward(tmp_path_factory):
    """The JAX suite's weights and single-process forward: (port tree,
    logits)."""
    jcfg = jconfig.get_config("toy-8m")
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tokens = jnp.tile(jnp.arange(S, dtype=jnp.int32)[None], (B, 1))
    logits, _ = jtf.forward(jparams, jcfg, tokens, tokens,
                            jtf.KVCache.zeros(jcfg, B, KV_LIMIT,
                                              dtype=jnp.float32),
                            kv_limit=KV_LIMIT)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             get_config("toy-8m"))
    return params, torch.from_numpy(np.array(logits))


@pytest.fixture(scope="module")
def two_rank_forward(jax_forward, tmp_path_factory):
    """Both ranks' logits and reports: two processes spawned once."""
    out = tmp_path_factory.mktemp("dcn_forward")
    torch.save(jax_forward[0], out / "params.pt")
    script = (FORWARD_WORKER.replace("@S@", str(S)).replace("@B@", str(B))
              .replace("@KV@", str(KV_LIMIT))
              .replace("@FORWARDS@", repr([(k, v[0])
                                           for k, v in FORWARDS.items()])))
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), coord,
                               str(out)], cwd=str(REPO), env=_child_env({}),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = _finish(procs, "finish the two-process forwards")
    for r, (rc, _, err) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{err[-3000:]}"
    reports = [json.loads(o.strip().splitlines()[-1]) for _, o, _ in outs]
    logits = {name: [torch.load(out / f"{name}-{r}.pt") for r in range(2)]
              for name in list(FORWARDS) + ["moe"]}
    return reports, logits


def test_two_ranks_join_the_group(two_rank_forward):
    reports, _ = two_rank_forward
    for r, rep in enumerate(reports):
        assert rep["first"] is True and rep["again"] is True
        assert (rep["rank"], rep["world"], rep["primary"]) == (r, 2, r == 0)


@pytest.mark.parametrize("name", list(FORWARDS))
def test_two_process_forward_is_the_one_process_mesh_and_jax(
        two_rank_forward, jax_forward, name):
    """Rank 0's logits bitwise the one-process mesh's in the same shard
    order, and within TOL of the JAX forward; rank 1 gets none (only
    rank 0 samples)."""
    reports, logits = two_rank_forward
    params, want = jax_forward
    cfg = get_config("toy-8m")
    mesh = pmesh.build_mesh(pmesh.MeshConfig.parse(FORWARDS[name][1]),
                            ["cpu"] * 4)
    tokens = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    cache = KVCache.zeros(cfg, B, KV_LIMIT, dtype=torch.float32, mesh=mesh,
                          split_rows=True)
    one, _ = forward(shard_params(params, mesh, cfg), cfg, tokens,
                     tokens.clone(), cache, kv_limit=KV_LIMIT, mesh=mesh)
    r0, r1 = logits[name]
    assert r0.shape == (B, S, cfg.vocab_size)
    assert r1 is None
    assert torch.equal(r0, one)
    torch.testing.assert_close(r0, want, **TOL)


def test_expert_dispatch_across_processes_is_the_one_process_mesh(
        two_rank_forward):
    """toy-moe over tp=2 x DCN ep=2: the expert-parallel dispatch's two
    all-to-alls cross the processes; rank 0's logits bitwise equal to
    the one-process ep=2,tp=2 mesh's (held against the JAX package in
    ``tests/test_torch_mesh_serving.py``), rank 1 gets none."""
    _, logits = two_rank_forward
    cfg = get_config("toy-moe")
    mesh = pmesh.build_mesh(pmesh.MeshConfig.parse("ep=2,tp=2"), ["cpu"] * 4)
    tokens = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    cache = KVCache.zeros(cfg, B, KV_LIMIT, dtype=torch.float32, mesh=mesh,
                          split_rows=True)
    one, _ = forward(
        shard_params(init_params(torch.Generator().manual_seed(0), cfg,
                                 dtype=torch.float32), mesh, cfg),
        cfg, tokens, tokens.clone(), cache, kv_limit=KV_LIMIT, mesh=mesh)
    r0, r1 = logits["moe"]
    assert r1 is None and torch.equal(r0, one)


@pytest.mark.parametrize("name", list(FORWARDS))
def test_each_rank_holds_its_own_shards_only(two_rank_forward, name):
    reports, _ = two_rank_forward
    owners = reports[0][name]["owners"]
    assert owners == [0, 0, 1, 1] == reports[1][name]["owners"]
    for r, rep in enumerate(reports):
        mine = [o == r for o in owners]
        assert rep[name]["params"] == mine
        # The pipe mesh's cache: each stage's shards in their process.
        assert rep[name]["cache"] == mine


# ------------------------------------------------------ the served path

def _get(url: str, timeout: float = 5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def _post(url: str, body: dict, timeout: float = 60.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _sse_transcript(body: str) -> tuple:
    """(the streamed token pieces joined, the last event's name)."""
    pieces, last = [], None
    for frame in body.split("\n\n"):
        if not frame.strip():
            continue
        lines = frame.split("\n")
        event = next((ln[7:] for ln in lines if ln.startswith("event: ")),
                     None)
        data = "\n".join(ln[6:] for ln in lines if ln.startswith("data: "))
        if event is None:
            pieces.append(data)
        last = event
    return "".join(pieces), last


def _metric(text: str, name: str) -> float:
    return next(float(ln.split()[-1]) for ln in text.splitlines()
                if ln.startswith(name + " ") or ln.startswith(name + "{"))


@pytest.fixture(scope="module", params=list(SERVED))
def serve_spec(request) -> str:
    return request.param


@functools.lru_cache(maxsize=None)
def _jax_transcripts(mesh_shape: str) -> list:
    """``BatchedJaxEngine`` from the servers' environment (speculation
    off) on ``mesh_shape``, the one-process mesh of the servers' shards
    (``SERVED``), on the servers' seeded weights: the greedy transcript
    of each query as the app renders it."""
    cfg = get_config("toy-8m")
    tree = init_params(torch.Generator().manual_seed(0), cfg,
                       dtype=torch.float32)
    env = {k: v for k, v in SERVE_ENV.items()
           if k not in ("DCN_MESH_SHAPE", "NUM_PROCESSES", "ENGINE")}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setenv("MESH_SHAPE", mesh_shape)
        jcfg = JaxServiceConfig.from_env(env_file=None)
    eng = BatchedJaxEngine.from_config(jcfg)
    eng.params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)

    async def run():
        await eng.start()
        try:
            outs = await asyncio.gather(*[
                eng.generate(render_prompt(sanitize_query(q)),
                             max_tokens=jcfg.max_new_tokens,
                             temperature=0.0) for q in QUERIES])
            return [r.text for r in outs]
        finally:
            await eng.stop()

    return asyncio.run(run())


def _one_process_spec(mesh_shape: str) -> tuple:
    """The port's ``BatchedTorchEngine`` from the servers' environment
    with speculation on, in this process on ``mesh_shape`` over
    ``[cpu] * 4``: each query's greedy transcript, and its
    ``spec_health`` once they and the first query again (the servers'
    plain answer) are answered."""
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine

    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(SERVE_ENV, **SPEC_ENV).items():
            mp.setenv(k, v)
        mp.setenv("MESH_SHAPE", mesh_shape)
        mp.setenv("NUM_PROCESSES", "1")
        eng = BatchedTorchEngine.from_config(
            ServiceConfig.from_env(env_file=None), devices=["cpu"] * 4)

    async def run():
        await eng.start()
        try:
            def ask(q):
                return eng.generate(
                    render_prompt(sanitize_query(q)),
                    max_tokens=int(SERVE_ENV["MAX_NEW_TOKENS"]),
                    temperature=0.0)

            outs = await asyncio.gather(*[ask(q) for q in QUERIES])
            await ask(QUERIES[0])
            return [r.text for r in outs], eng.spec_health()
        finally:
            await eng.stop()

    return asyncio.run(run())


@pytest.fixture(scope="module")
def served(serve_spec):
    """Two server processes, rank 0 on HTTP; while they start, the JAX
    engine's transcripts (``jax``) and, with speculation on, the port's
    one-process engine's (``one_process``: transcripts, spec_health);
    then the three queries' streams, one plain answer, /health and
    /metrics after the drain, then rank 0 stopped and both processes'
    exits."""
    dcn, mesh_shape, extra = SERVED[serve_spec]
    coord = f"127.0.0.1:{_free_port()}"
    ports = [_free_port(), _free_port()]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ai_agent_kubectl_tpu_torch.server",
         "--devices", "cpu,cpu"], cwd=str(REPO),
        env=_child_env(dict(SERVE_ENV, **extra, COORDINATOR_ADDRESS=coord,
                            DCN_MESH_SHAPE=dcn, PROCESS_ID=str(r),
                            PORT=str(ports[r]))),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    url = f"http://127.0.0.1:{ports[0]}"
    out = {"spec": serve_spec}
    try:
        out["jax"] = _jax_transcripts(mesh_shape)
        out["one_process"] = (_one_process_spec(mesh_shape) if extra
                              else None)
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

        async def ask_all():
            return await asyncio.gather(*[asyncio.to_thread(
                _post, f"{url}/kubectl-command/stream", {"query": q})
                for q in QUERIES])

        out["streams"] = [_sse_transcript(body) for _, body in
                          asyncio.run(ask_all())]
        out["plain"] = _post(f"{url}/kubectl-command", {"query": QUERIES[0]})
        out["metrics"] = _get(f"{url}/metrics")[1]
        out["health"] = json.loads(_get(f"{url}/health")[1])
    finally:
        if procs[0].poll() is None:
            procs[0].send_signal(signal.SIGTERM)
        out["exits"] = _finish(procs, "exit after rank 0's stop")
    return out


def _ready(url: str) -> bool:
    try:
        return bool(json.loads(_get(f"{url}/health")[1]).get("engine_ready"))
    except (urllib.error.URLError, ConnectionError, ValueError):
        return False


def _port_open(port: int) -> bool:
    with socket.socket() as s:
        s.settimeout(1.0)
        return s.connect_ex(("127.0.0.1", port)) == 0


def test_rank0_serves_the_jax_transcripts(served):
    jax_served = served["jax"]
    got = [text for text, _ in served["streams"]]
    assert got == jax_served
    assert all(last in ("done", "error") for _, last in served["streams"])
    status, body = served["plain"]
    # A random model's command fails the safety parse (422) unless it
    # happens to start with "kubectl ", as the JAX app answers.
    assert status == (200 if jax_served[0].strip().startswith("kubectl ")
                      else 422), body
    sh = served["health"]["sharding"]
    want = pmesh.MeshConfig.parse(SERVED[served["spec"]][1])
    assert sh["draft_sharded"] is (served["spec"] == "spec")
    assert sh["mesh"] == dict(zip(pmesh.AXES, want.shape))
    assert sh["devices"] == 4
    assert sh["kv_pool_mesh_fallback"] is (want.data > 1)


def test_speculation_across_processes_is_the_one_process_engine(served):
    """With speculation on, the draft's forwards and slot views reach
    rank 1 as the target's do: the transcripts and the spec counters are
    the port's one-process tp=4 engine's; off, /health says it is."""
    spec = served["health"]["spec"]
    if served["one_process"] is None:
        assert spec is None
        return
    texts, want = served["one_process"]
    assert [text for text, _ in served["streams"]] == texts
    assert spec["drafted_tokens_total"] > 0
    for key in ("drafted_tokens_total", "accepted_tokens_total",
                "degraded_total", "draft_sharded", "draft_kv_fallback",
                "active"):
        assert spec[key] == want[key], key


def test_served_books_balance(served):
    m = served["metrics"]
    assert _metric(m, "engine_batch_occupancy") == 0.0
    assert _metric(m, "engine_queue_depth") == 0.0
    assert _metric(m, "mesh_devices") == 4.0
    pool = served["health"]["kv_pool"]
    if pool is None:                # the dense ladder
        assert _metric(m, "engine_kv_pages_used") == 0.0
    else:       # every block free or held by the radix tree alone
        assert pool["live"] == 0
        assert pool["free"] + pool["cached"] == pool["n_blocks"]


def test_rank1_binds_no_port_and_exits_zero_after_rank0(served):
    assert served["rank1_port_open"] is False
    (rc0, _, err0), (rc1, out1, err1) = served["exits"]
    assert rc0 == 0, err0[-2000:]
    assert rc1 == 0, err1[-2000:]
    report = json.loads(out1.strip().splitlines()[-1])
    # Every forward, allocation and splice of the burst reached rank 1.
    assert report["rank"] == 1
    assert report["calls"] > len(QUERIES) * int(SERVE_ENV["MAX_NEW_TOKENS"])
    # Its launches while serving apart from its engine's start's.
    for key in ("launches", "launches_at_start"):
        assert set(report[key]) >= {"ragged_attention_pool_sharded",
                                    "flash_attention_cached"}


def test_follower_exits_nonzero_when_rank0_is_gone():
    """A follower whose rank 0 dies mid-wait fails its next poll of the
    store at once (the store lives in rank 0), and exits non-zero."""
    coord = f"127.0.0.1:{_free_port()}"
    script = (
        "import sys, time\n"
        "from ai_agent_kubectl_tpu_torch.parallel import distributed\n"
        "r = int(sys.argv[1])\n"
        "distributed.init_distributed(sys.argv[2], 2, r)\n"
        "if r == 0:\n"
        "    time.sleep(1.0)\n"
        "    import os; os._exit(3)\n"
        "distributed.HANDS.follow(None)\n")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), coord],
                              cwd=str(REPO), env=_child_env({}),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    (rc0, _, _), (rc1, _, err1) = _finish(procs, "end after rank 0 died")
    assert rc0 == 3
    assert rc1 != 0, err1[-2000:]


# --------------------------------------------------------------- refusals

@pytest.mark.parametrize("env,match", [
    ({"DCN_MESH_SHAPE": "dp=2", "HOST_KV_BLOCKS": "64"}, "A12 row 2"),
    ({"DCN_MESH_SHAPE": "tp=2", "FLEET_SIZE": "2"}, "A12 row 3"),
    ({"NUM_PROCESSES": "2", "ENGINE": "fake"}, "ENGINE=fake has no mesh"),
])
def test_boot_refuses_what_cannot_be_mirrored(monkeypatch, env, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        ServiceConfig.from_env(env_file=None)


def test_engine_refuses_a_dcn_spec_over_another_process_count():
    """One process cannot serve a DCN spec of two: the device total is
    ``MESH_SHAPE x DCN_MESH_SHAPE``, with the JAX engine's message."""
    from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine

    eng = TorchEngine(get_config("toy-8m"), device="cpu", mesh_shape="tp=2",
                      dcn_mesh_shape="dp=2", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="MESH_SHAPE='tp=2' DCN_MESH_SHAPE="
                                         "'dp=2' wants 4 devices; only 2 "
                                         "present"):
        eng._setup_mesh()


# ------------------------------------------------------- the call's bytes

def test_a_call_carries_handles_and_tensor_bytes_never_a_shard():
    """What rank 0 posts: a registered object by its handle, a tensor as
    its bytes (unpickled where the follower serves), and a shard holder
    without a handle refused, so no shard's bytes travel."""
    import io

    mesh = pmesh.build_mesh(pmesh.MeshConfig.parse("tp=2"), ["cpu"] * 2)
    cache = KVCache.zeros(get_config("toy-8m"), 1, 8, dtype=torch.float32,
                          mesh=mesh)
    tokens = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    follower_cache = object()
    buf = io.BytesIO()
    distributed._Pickler(buf, {id(cache): "k0"}).dump(
        (distributed._call_name(forward), (cache, tokens), {"kv_limit": 8}))
    name, (got_cache, got_tokens), kw = distributed._Unpickler(
        io.BytesIO(buf.getvalue()), {"k0": follower_cache},
        torch.device("cpu")).load()
    assert distributed._call(name) is forward and kw == {"kv_limit": 8}
    assert got_cache is follower_cache
    assert torch.equal(got_tokens, tokens) and got_tokens.dtype == torch.int32
    with pytest.raises(ValueError, match="KVCache crosses to the followers "
                                         "without a handle"):
        distributed._Pickler(io.BytesIO(), {}).dump((cache,))
    with pytest.raises(ValueError, match="ShardedKV crosses"):
        distributed._Pickler(io.BytesIO(), {id(cache): "k0"}).dump(
            (cache.k,))


class _Store:
    """The few store calls ``Hands.follow`` makes, over a dict."""

    def __init__(self, posts):
        self.d = {f"call/{i}": p for i, p in enumerate(posts)}

    def check(self, keys):
        return all(k in self.d for k in keys)

    def get(self, key):
        return self.d[key]

    def add(self, key, n):
        self.d[key] = self.d.get(key, 0) + n
        return self.d[key]

    def delete_key(self, key):
        self.d.pop(key, None)


class _Reduces:
    """An argument whose unpickling would call ``os.system``."""

    def __reduce__(self):
        return os.system, ("true",)


def _name(fn):
    return distributed._call_name(fn)


@pytest.mark.parametrize("what,call,match", [
    ("a function by reference", lambda: (None, os.system, ("true",), {}, []),
     "which followers do not load"),
    ("a name outside CALLS", lambda: (None, ("os", "system"), ("true",), {},
                                      []), "not in distributed.CALLS"),
    ("a classmethod through getattr", lambda: (None, KVCache.zeros, (), {},
                                               []), "builtins.getattr"),
    ("an argument's reduce", lambda: (None, _name(forward), (_Reduces(),),
                                      {}, []), "which followers do not load"),
])
def test_a_follower_runs_no_call_outside_its_lists(monkeypatch, what, call,
                                                   match):
    """Anyone who reaches the coordinator's port can post to the store:
    a follower unpickles only ``_DATA``'s types and runs only ``CALLS``'
    functions, and refuses anything else loudly."""
    import pickle

    post = pickle.dumps(call())
    ran = []
    monkeypatch.setattr(os, "system", lambda cmd: ran.append(cmd) or 0)
    monkeypatch.setitem(distributed._state, "store", _Store([post]))
    with pytest.raises(pickle.UnpicklingError, match=match):
        distributed.Hands().follow(torch.device("cpu"))
    assert ran == []


def test_a_follower_runs_a_listed_call_and_rank0_posts_no_other(monkeypatch):
    """The same loop runs a call of ``CALLS`` (``mark_served``: the
    launches so far noted for ``report``) to the stop; rank 0 refuses to
    post a function outside ``CALLS``."""
    import pickle

    monkeypatch.setitem(distributed._state, "launches_at_start", None)
    monkeypatch.setitem(distributed._state, "store", _Store([
        pickle.dumps((None, _name(distributed.mark_served), (), {}, [])),
        pickle.dumps(distributed._STOP)]))
    hands = distributed.Hands()
    hands.follow(torch.device("cpu"))
    assert hands.calls == 1
    rep = distributed.report()
    assert rep["launches_at_start"] == distributed._state["launches_at_start"]
    assert set(rep["launches"]) == set(rep["launches_at_start"])
    with pytest.raises(ValueError, match="posix.system is not a call the "
                                         "followers take"):
        distributed.Hands().run(os.system, "true")
