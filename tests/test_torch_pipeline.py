"""The decode chunk pipeline (``CHUNK_PIPE_DEPTH``) and the host-scan
termination path (``DEVICE_TERMINATION=false``) of the port's batched
engine against the JAX package's, on the CPU.

Both engines run the JAX suite's engine settings
(``tests/test_termination_pipeline.py``: toy-8m in float32,
``ByteTokenizer``, 3 slots, chunk 4, one prefill bucket of 32, 128
positions) in the pool's gather regime (``RAGGED_ATTENTION=off``, where
an eager admission delivers its first token through an in-flight entry
of its own), the port on the JAX engine's parameters. Each JAX engine is
built once per module.

- ``scan_chunk_row`` of both packages on the JAX suite's unit cases.
- Greedy and seeded 0.9 transcripts byte-identical to the JAX engine's
  at depths 1 and 3, with equal wasted steps and chunk counts; the
  port's ragged regime at depth 3 against depth 1.
- A budget that expires mid-chunk, a burst whose slots all finish ahead
  of the pipe (no wasted step), one host read per consumed entry, EOS
  mid-chunk (both engines rebuilt with that EOS id), a client that
  disconnects with two chunks in flight (the abort's waste as the JAX
  engine bills it).
- ``DEVICE_TERMINATION=false`` at depth 3: the legacy ladder chosen with
  the JAX warning, the JAX transcripts and wasted steps, and the
  pipeline's gauges over both apps' ``/metrics`` and ``/debug/chunks``.
- Grammar and speculative decoding together, then a one-shot
  ``decode:nan`` replay, at depth 3 against the JAX engine at depth 3.
- A depth below 1 raises as the JAX engine does.

Transcripts are compared byte for byte, counters for equality.
"""

import asyncio
import gc
import logging
import threading
import time

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine import protocol as jax_protocol
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.server.app import create_app as jax_create_app
from ai_agent_kubectl_tpu.testing import faults as jax_faults
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine import protocol as port_protocol
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.server.app import create_app
from ai_agent_kubectl_tpu_torch.testing import faults as port_faults
from test_torch_env import knob_env  # noqa: F401  (autouse)

torch.set_num_threads(1)

TOY = get_config("toy-8m")
#: the JAX suite's engine settings
ENGINE_KW = dict(dtype="float32", max_seq_len=128, prefill_buckets=(32,),
                 prefix_cache=False, batch_size=3, chunk_len=4)
#: the JAX suite's greedy prompts, budgets expiring at every chunk phase
GREEDY = [("list pods", 9), ("get events", 6), ("describe node x", 13),
          ("scale web to 3", 4)]
#: one seeded burst at 0.9, all at once
SAMPLED = [("rollout status web", 17, 11), ("top nodes", 10, 12),
           ("cordon node a", 23, 13)]
#: a burst whose slots all finish ahead of a depth-3 pipe
EARLY = [(f"describe pod web-{i}", 2 + 3 * i) for i in range(3)]


def _jax_engine(depth=3, cfg=None, **kw):
    return BatchedJaxEngine(cfg or jconfig.get_config("toy-8m"),
                            tokenizer=JaxByteTokenizer(),
                            compile_cache_dir="", chunk_pipe_depth=depth,
                            **{**ENGINE_KW, **kw})


def _port_engine(params, depth=3, cfg=None, **kw):
    return BatchedTorchEngine(cfg or TOY, tokenizer=ByteTokenizer(),
                              params=params, device="cpu",
                              chunk_pipe_depth=depth,
                              **{"ragged_attention": "off", **ENGINE_KW,
                                 **kw})


def _started(engines):
    for eng in engines.values():
        asyncio.run(eng.start())
    return engines


def _stopped(engines):
    for eng in engines.values():
        asyncio.run(eng.stop())


@pytest.fixture(scope="module")
def jax_engines():
    """The JAX engines at depths 3 and 1 and under the host scan (depth
    3, RAGGED_ATTENTION=on asked: the JAX warning and the legacy
    ladder)."""
    engines = _started({
        3: _jax_engine(3), 1: _jax_engine(1),
        "scan": _jax_engine(3, device_termination=False,
                            ragged_attention="on")})
    yield engines
    _stopped(engines)


@pytest.fixture(scope="module")
def params(jax_engines):
    return params_from_jax(jax.tree.map(np.asarray, jax_engines[3].params),
                           TOY)


@pytest.fixture(scope="module")
def port_engines(params):
    """The port's engines on the JAX parameters, as ``jax_engines``; the
    host scan asks for the default ragged regime."""
    engines = _started({
        3: _port_engine(params, 3), 1: _port_engine(params, 1),
        "scan": _port_engine(params, 3, device_termination=False,
                             ragged_attention="auto")})
    yield engines
    _stopped(engines)


async def _until(cond, what: str, limit: float = 60.0) -> None:
    """Poll ``cond`` until it holds, failing the test with ``what`` when
    it has not within ``limit`` seconds: a scheduler thread that lost a
    race must fail its test, not hang the run."""
    deadline = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < deadline, (
            f"{what} within {limit:.0f} s")
        await asyncio.sleep(0.002)


async def _quiet(eng) -> None:
    """Wait until the scheduler idles: the chunks dispatched past the
    last request's end count against the depth until the idle scheduler
    prunes them, so a request that arrives before that boards later
    chunks. Its next idle pop (reached only with nothing in flight and
    no live slot) comes after the turn that pruned them, its books
    included."""
    q = eng._admissions
    get, idle = q.get, threading.Event()

    def watched(*args, **kw):
        idle.set()
        return get(*args, **kw)

    q.get = watched
    try:
        await _until(idle.is_set, "the scheduler never went idle")
    finally:
        q.__dict__.pop("get", None)


async def _together(eng, calls) -> list:
    """``calls`` (each a function giving one request's coroutine) sent at
    once from an idle scheduler that is held at its next pop until every
    one is queued: the burst then boards the same chunks in both engines
    however the threads are scheduled."""
    await _quiet(eng)
    q = eng._admissions
    pops = {name: getattr(q, name) for name in ("get", "get_nowait")}
    opened, held = threading.Event(), threading.Event()

    def hold(pop):
        def call(*args, **kw):
            held.set()
            opened.wait(10.0)
            return pop(*args, **kw)
        return call

    for name, pop in pops.items():
        setattr(q, name, hold(pop))
    try:
        await _until(held.is_set, "the scheduler never reached its next pop")
        tasks = [asyncio.ensure_future(call()) for call in calls]
        await _until(lambda: q.qsize() >= len(calls),
                     "the burst was never wholly queued")
        opened.set()
        return await asyncio.gather(*tasks)
    finally:
        opened.set()
        for name in pops:
            q.__dict__.pop(name, None)


async def _burst(eng, reqs) -> list:
    """``reqs`` ((prompt, generate's keywords) each) at once."""
    return await _together(eng, [
        (lambda p=p, kw=kw: eng.generate(p, **kw)) for p, kw in reqs])


def _counts(eng) -> dict:
    s = eng.stats()
    return {k: s[k] for k in ("wasted_decode_steps", "chunks_dispatched",
                              "chunks_consumed", "chunks_pruned")}


async def _traffic(eng) -> tuple:
    """The greedy prompts one at a time, then the seeded burst: each
    (text, completion tokens, finish reason), and the growth of the
    pipeline's counters."""
    await _quiet(eng)
    c0 = _counts(eng)
    out = []
    for prompt, max_tokens in GREEDY:
        await _quiet(eng)
        r = await eng.generate(prompt, max_tokens=max_tokens,
                               temperature=0.0)
        out.append((r.text, r.completion_tokens, r.finish_reason))
    rs = await _burst(eng, [(p, dict(max_tokens=m, temperature=0.9, seed=s))
                            for p, m, s in SAMPLED])
    out += [(r.text, r.completion_tokens, r.finish_reason) for r in rs]
    await _quiet(eng)
    c1 = _counts(eng)
    return out, {k: c1[k] - c0[k] for k in c0}


@pytest.fixture(scope="module")
def jax_traffic(jax_engines):
    return {k: asyncio.run(_traffic(eng)) for k, eng in jax_engines.items()}


# ------------------------------------------------------- scan_chunk_row

#: (row, already emitted, eos ids, max tokens, the result): the JAX
#: suite's cases (EOS at step 1, the budget at step 2, no finish), the
#: budget on the row's last entry and EOS on its first
SCAN_CASES = [
    ([11, 2, 99, 98], 0, (2,), 64, ([11], "stop", 2)),
    ([11, 12, 13, 99], 5, (2,), 8, ([11, 12, 13], "length", 1)),
    ([11, 12, 13, 14], 0, (2,), 64, ([11, 12, 13, 14], None, 0)),
    ([11, 12, 13, 14], 4, (2,), 8, ([11, 12, 13, 14], "length", 0)),
    ([2, 11, 12, 13], 3, (2, 7), 64, ([], "stop", 3)),
]


@pytest.mark.parametrize("row,emitted,eos,max_tokens,result", SCAN_CASES)
def test_scan_chunk_row_matches_the_jax_function(row, emitted, eos,
                                                  max_tokens, result):
    want = jax_protocol.scan_chunk_row(row, emitted, eos, max_tokens)
    got = port_protocol.scan_chunk_row(np.array(row, np.int32), emitted,
                                       eos, max_tokens)
    assert got == want == result


# ---------------------------------------------------------- transcripts

@pytest.mark.parametrize("depth", [1, 3])
async def test_transcripts_equal_the_jax_engine(port_engines, jax_traffic,
                                                depth):
    """Greedy and seeded transcripts, wasted steps and chunk counts equal
    the JAX engine's at the same depth; depth 1 and 3 serve the same
    transcripts, with no step wasted."""
    eng = port_engines[depth]
    assert eng.stats()["pipe_depth"] == depth
    assert eng.stats()["device_termination"] is True
    got, counts = await _traffic(eng)
    want, jax_counts = jax_traffic[depth]
    assert got == want
    assert counts == jax_counts
    assert counts["wasted_decode_steps"] == 0
    assert got == jax_traffic[4 - depth][0]
    assert {f for _, _, f in got} == {"length"}


async def test_ragged_regime_serves_the_same_transcripts_at_both_depths(
        params):
    """The port's default regime (staged admissions in the ragged
    prologue) at depth 3 against depth 1."""
    outs = {}
    for depth in (1, 3):
        eng = _port_engine(params, depth, ragged_attention="auto")
        await eng.start()
        try:
            assert eng._attention_regime == "ragged"
            outs[depth] = await _traffic(eng)
        finally:
            await eng.stop()
    assert outs[3][0] == outs[1][0]
    assert outs[3][1]["wasted_decode_steps"] == 0
    assert outs[3][1]["chunks_dispatched"] > outs[1][1]["chunks_dispatched"]


async def test_budget_expires_mid_chunk(port_engines, jax_engines):
    """max_tokens=6 at chunk 4: the device budget stops the slot at step
    1 of its second chunk, with no wasted step, as in the JAX engine."""
    outs = []
    for eng in (port_engines[3], jax_engines[3]):
        w0 = eng.stats()["wasted_decode_steps"]
        r = await eng.generate("list services everywhere", max_tokens=6,
                               temperature=0.0)
        outs.append((r.text, r.completion_tokens, r.finish_reason,
                     eng.stats()["wasted_decode_steps"] - w0))
    assert outs[0] == outs[1]
    assert outs[0][1:] == (6, "length", 0)


async def test_all_done_early_wastes_nothing(port_engines, jax_engines):
    """A burst whose slots all finish ahead of the depth-3 pipe: every
    request completes and, with the done mask, no step runs for a
    finished slot."""
    outs = []
    for eng in (port_engines[3], jax_engines[3]):
        w0 = eng.stats()["wasted_decode_steps"]
        rs = await _burst(eng, [(p, dict(max_tokens=m, temperature=0.0))
                                for p, m in EARLY])
        outs.append(([(r.text, r.completion_tokens, r.finish_reason)
                      for r in rs], eng.stats()["wasted_decode_steps"] - w0))
    assert outs[0] == outs[1]
    assert outs[0][1] == 0
    for (_, n, finish), (_, m) in zip(outs[0][0], EARLY):
        assert n <= m and finish in ("stop", "length")


async def test_one_host_read_per_consumed_entry(port_engines, jax_engines):
    """Host reads equal the consumed entries (each chunk, and the
    admission's first token), as many as the JAX engine makes; the
    chunks dispatched past the request's end are pruned unread."""
    outs = []
    for eng in (port_engines[3], jax_engines[3]):
        await _quiet(eng)
        calls = []
        orig = eng._fetch
        eng._fetch = lambda h, orig=orig: (calls.append(1), orig(h))[1]
        s0 = eng.stats()
        try:
            r = await eng.generate("rollout status of deployment api",
                                   max_tokens=10, temperature=0.0)
            await _quiet(eng)          # the pipe drains behind the result
        finally:
            del eng._fetch
        s1 = eng.stats()
        consumed = s1["chunks_consumed"] - s0["chunks_consumed"]
        dispatched = s1["chunks_dispatched"] - s0["chunks_dispatched"]
        pruned = s1["chunks_pruned"] - s0["chunks_pruned"]
        assert len(calls) == consumed + 1
        assert dispatched == consumed + pruned
        outs.append((r.text, len(calls), consumed, pruned))
    assert outs[0] == outs[1]
    assert outs[0][3] > 0


def _hold_until_disconnect(eng, prompt: str):
    """Hold the scheduler at the first sweep that finds ``prompt``'s slot
    with a text piece sent to its client and two chunks in flight for it,
    until the client has disconnected: the abort lands at the same
    scheduler point in both engines."""
    ids = eng.tokenizer.encode(prompt)
    orig, emit = eng._sweep_finishes, eng._emit
    sent, held = set(), []

    def emitting(req, event, payload):
        if event == "token":
            sent.add(id(req))
        emit(req, event, payload)

    def hooked():
        for s in eng._slots:
            if (s is not None and not held and id(s.req) in sent
                    and list(s.req.prompt_ids) == ids
                    and s.decode_chunks_inflight >= 2):
                held.append(s.decode_chunks_inflight)
                assert s.req.cancel.wait(10.0)
        orig()

    eng._sweep_finishes, eng._emit = hooked, emitting
    return held


async def test_client_disconnect_with_a_deep_pipe(port_engines,
                                                  jax_engines):
    """A client that disconnects after its first token, with two chunks
    in flight for it: the slot frees at the next sweep, the chunks in
    flight are billed as waste as the JAX engine bills them, and the
    engine goes on serving."""
    outs = []
    for eng in (port_engines[3], jax_engines[3]):
        await _quiet(eng)
        w0 = eng.stats()["wasted_decode_steps"]
        held = _hold_until_disconnect(eng, "get events --watch")
        try:
            agen = eng.generate_stream("get events --watch", max_tokens=100)
            first = await agen.__anext__()
            await agen.aclose()
            # The request's own stream, left behind by the closed one, is
            # finalized (its cancel set) once nothing refers to it.
            gc.collect()
            for _ in range(500):
                await asyncio.sleep(0.01)
                if all(s is None for s in eng._slots):
                    break
        finally:
            del eng._sweep_finishes, eng._emit
        assert all(s is None for s in eng._slots)
        wasted = eng.stats()["wasted_decode_steps"] - w0
        r = await eng.generate("get pods", max_tokens=4, temperature=0.0)
        outs.append((first, held, wasted, r.text, r.completion_tokens))
    assert outs[0] == outs[1]
    assert outs[0][1] == [2]
    assert outs[0][2] == 2 * ENGINE_KW["chunk_len"]
    assert outs[0][4] > 0


async def test_eos_mid_chunk_stops_there(params, port_engines):
    """The greedy stream of a prompt, then both engines rebuilt with a
    token that first appears mid-chunk as their EOS id: generation stops
    exactly there, finish "stop", no wasted step."""
    prompt = "get deployments in default namespace"
    full = await port_engines[3].generate(prompt, max_tokens=20,
                                          temperature=0.0)
    ids = list(full.token_ids)
    # Token k (the admission samples token 0; chunk rows follow) lands
    # on step (k - 1) % 4 of its chunk: mid-chunk unless k % 4 == 0.
    k = next(k for k in range(1, len(ids))
             if k % ENGINE_KW["chunk_len"] and ids[k] not in ids[:k])
    outs = []
    for make, cfg in ((_port_engine, get_config("toy-8m",
                                                eos_ids=(ids[k],))),
                      (_jax_engine, jconfig.get_config("toy-8m",
                                                       eos_ids=(ids[k],)))):
        eng = (make(params, 3, cfg=cfg) if make is _port_engine
               else make(3, cfg=cfg))
        await eng.start()
        try:
            r = await eng.generate(prompt, max_tokens=20, temperature=0.0)
            outs.append((r.text, r.completion_tokens, r.finish_reason,
                         eng.stats()["wasted_decode_steps"]))
        finally:
            await eng.stop()
    assert outs[0] == outs[1]
    assert outs[0][1:] == (k, "stop", 0)


# ------------------------------------------------ DEVICE_TERMINATION=false

def test_host_scan_resolves_to_the_legacy_ladder(port_engines, jax_engines,
                                                 params, caplog):
    """The ragged regime arms staged admissions inside the chunk carry:
    without device termination it resolves to the legacy ladder, with
    the JAX warning."""
    eng = port_engines["scan"]
    assert eng._attention_regime == jax_engines["scan"]._attention_regime
    assert eng._attention_regime == "gather"
    assert eng.stats()["device_termination"] is False
    assert eng.stats()["pipe_depth"] == 3
    with caplog.at_level(logging.WARNING):
        _port_engine(params, 3, device_termination=False,
                     ragged_attention="on")._resolve_regime()
    assert ("RAGGED_ATTENTION needs DEVICE_TERMINATION (staged admissions "
            "arm inside the chunk carry); serving the legacy ladder"
            in caplog.text)


async def test_host_scan_serves_the_jax_transcripts_and_waste(
        port_engines, jax_traffic):
    """DEVICE_TERMINATION=false at depth 3: the JAX host-scan engine's
    transcripts (the device-terminated ones too: the semantics do not
    change), and the same wasted steps, which the done mask would have
    saved."""
    got, counts = await _traffic(port_engines["scan"])
    want, jax_counts = jax_traffic["scan"]
    assert got == want == jax_traffic[3][0]
    assert counts == jax_counts
    assert counts["wasted_decode_steps"] > 0


async def _pipeline_view(app, engine) -> dict:
    async with TestClient(TestServer(app)) as c:
        r = await c.post("/kubectl-command", json={"query": "list pods"})
        text = await (await c.get("/metrics")).text()
        chunks = await (await c.get("/debug/chunks")).json()
        health = await (await c.get("/health")).json()
    gauges = {}
    for line in text.splitlines():
        for name in ("decode_pipe_depth", "decode_pipe_occupancy",
                     "wasted_decode_steps_total"):
            if line.startswith(name + " "):
                gauges[name] = float(line.split()[-1])
    pipe = chunks["pipeline"]
    return {"status": r.status, "gauges": gauges,
            "pipeline": {k: pipe[k] for k in ("pipe_depth",
                                              "device_termination")},
            "pipeline_keys": sorted(pipe),
            "events": sorted({e["event"] for e in chunks["events"]}),
            "health": health["status"]}


async def test_pipeline_gauges_as_the_jax_app(params):
    """``decode_pipe_depth``, ``decode_pipe_occupancy``,
    ``wasted_decode_steps_total``, ``/debug/chunks`` and ``/health``
    over both apps, each on its host-scan engine at depth 3."""
    cfg = dict(rate_limit="1000/minute", max_new_tokens=24)
    views = []
    for create, config, engine in (
            (create_app, ServiceConfig(torch_device="cpu", **cfg),
             _port_engine(params, 3, device_termination=False)),
            (jax_create_app, JaxServiceConfig(engine="fake", **cfg),
             _jax_engine(3, device_termination=False))):
        views.append(await _pipeline_view(create(config, engine), engine))
    assert views[0] == views[1]
    view = views[0]
    assert view["gauges"]["decode_pipe_depth"] == 3.0
    assert view["gauges"]["wasted_decode_steps_total"] > 0
    assert view["pipeline"] == {"pipe_depth": 3,
                                "device_termination": False}
    assert {"dispatch", "consume"} <= set(view["events"])


# ------------------------------------ grammar, spec and a decode:nan replay

#: (prompt, temperature, seed): greedy and seeded 0.9, at once
FEATURE_REQS = [("pod q0 ", 0.0, 1), ("bulk b ", 0.9, 7),
                ("pod q1 ", 0.9, 11)]
FEATURE_KW = dict(grammar_decode=True, spec_decode=True, spec_draft_k=2,
                  spec_draft_model="toy-8m", max_seq_len=96)


def _nan_once(inj, target: str, skip: int = 2) -> None:
    """Arm ``decode:nan`` one-shot on ``target``'s slot: the (skip+1)-th
    dispatch that carries it NaNs its logits, then the point disarms."""
    seen = {"n": 0}
    orig = type(inj).decode_nan_slots.__get__(inj)

    def once(prompts, replica=None):
        hits = orig(prompts, replica)
        if not hits:
            return hits
        seen["n"] += 1
        if seen["n"] <= skip:
            return []
        inj.release("decode")
        return hits

    inj.decode_nan_slots = once
    inj.target_substr = target
    inj.set("decode", "nan")


async def _feature_run(eng, inj) -> dict:
    async def burst():
        rs = await _burst(eng, [(p, dict(max_tokens=24, temperature=t,
                                         seed=s))
                                for p, t, s in FEATURE_REQS])
        return [r.text for r in rs]

    g0, s0 = eng.grammar_health(), eng.spec_health()
    clean = await burst()
    g1, s1 = eng.grammar_health(), eng.spec_health()
    _nan_once(inj, FEATURE_REQS[1][0])
    replayed = await burst()
    c = eng.stats()["containment"]
    return {
        "clean": clean, "replayed": replayed,
        "grammar": {k: g1[k] - g0[k] for k in (
            "forced_tokens_total", "masked_steps_total",
            "fast_forward_splices_total")},
        "spec": {k: s1[k] - s0[k] for k in ("drafted_tokens_total",
                                            "accepted_tokens_total")},
        "containment": {k: c[k] for k in ("resets", "health_trips",
                                          "quarantined", "replayed_tokens")},
    }


async def test_grammar_spec_and_a_nan_replay_at_depth_three(params):
    """Grammar and speculative decoding on one engine at depth 3 (a
    draft that disagrees, from seed 1234): transcripts, grammar counters
    and spec totals as the JAX engine's at depth 3; then a one-shot
    ``decode:nan`` on one request of the same burst: every request
    replays to its clean transcript, with the JAX engine's containment
    counts."""
    jinj = jax_faults.FaultInjector()
    jeng = _jax_engine(3, faults=jinj, ragged_attention="off",
                       spec_draft_seed=1234, **FEATURE_KW)
    await jeng.start()
    try:
        draft = params_from_jax(jax.tree.map(np.asarray, jeng._draft_params),
                                TOY)
        want = await _feature_run(jeng, jinj)
    finally:
        await jeng.stop()
    pinj = port_faults.FaultInjector()
    peng = _port_engine(params, 3, faults=pinj, spec_draft_params=draft,
                        **FEATURE_KW)
    await peng.start()
    try:
        got = await _feature_run(peng, pinj)
    finally:
        await peng.stop()
    assert got == want
    assert got["replayed"] == got["clean"]
    assert got["containment"]["resets"] == {"slot_health": 1}
    assert got["grammar"]["masked_steps_total"] > 0
    assert got["spec"]["drafted_tokens_total"] > 0
    assert all(t.startswith("kubectl ") for t in got["clean"])


# -------------------------------------------------------------- the knob

def test_depth_below_one_raises_as_the_jax_engine(monkeypatch):
    errors = []
    for make in (lambda: _jax_engine(0),
                 lambda: _port_engine(None, 0),
                 lambda: BatchedTorchEngine.from_config(
                     ServiceConfig.from_env(env_file=None))):
        monkeypatch.setenv("CHUNK_PIPE_DEPTH", "0")
        monkeypatch.setenv("TORCH_DEVICE", "cpu")
        with pytest.raises(ValueError) as e:
            make()
        errors.append(str(e.value))
    assert errors == ["chunk_pipe_depth must be >= 1"] * 3
    assert ServiceConfig.from_env(env_file=None).chunk_pipe_depth == \
        JaxServiceConfig.from_env(env_file=None).chunk_pipe_depth == 0


# ----------------------- a preempted request resumed over its own chunks

async def test_resume_over_its_own_chunks_in_flight_keeps_the_transcript(
        params):
    """Two background requests (grammar on, readonly, seeded 0.9) fill
    both slots; an interactive probe preempts one of them while three of
    its chunks are in flight. The probe's forced run ("kubectl ", 8
    tokens) spends its budget at admission, so its slot frees at once;
    the scheduler reads the oldest of those chunks (no seat for the
    victim's row) and the victim resumes into the same slot with the
    other two still in flight. Their rows index the victim's stream
    before it left, one chunk further on than the resumed seat expects:
    they must be discarded, not delivered to it. The JAX engine delivers
    them (it checks a row's request, not its seat), so the reference
    here is each request's uncontended transcript."""
    from ai_agent_kubectl_tpu_torch.engine import qos as port_qos

    reqs = [("bulk a ", 0.9, 11), ("bulk b ", 0.9, 12)]
    eng = _port_engine(params, 3, ragged_attention="auto", batch_size=2,
                       grammar_decode=True, preempt_wait_ms=15.0,
                       max_seq_len=96)
    await eng.start()
    seen = {}
    preempt, resume = eng._maybe_preempt, eng._admit_resume

    def gated_preempt():
        slots = [s for s in eng._slots if s is not None]
        if (not seen and len(slots) == 2
                and eng._admissions.qsize() >= 1
                and min(len(s.detok.ids) for s in slots) >= 10
                and all(s.decode_chunks_inflight == 3 for s in slots)):
            time.sleep(0.03)                 # past PREEMPT_WAIT_MS
            seen["preempted"] = preempt()
            return seen["preempted"]
        return False if not seen else preempt()

    def watched_resume(req):
        seen["stale"] = sum(1 for e in eng._inflight
                            if e[0] == "chunk" and req in e[2])
        return resume(req)

    eng._maybe_preempt, eng._admit_resume = gated_preempt, watched_resume
    try:
        async def run(p, t, s, lane, n):
            with port_qos.use_qos(port_qos.QoSContext(tenant=lane,
                                                      lane=lane)):
                return await eng.generate(p, max_tokens=n, temperature=t,
                                          seed=s)

        alone = [(await run(p, t, s, "background", 40)).text
                 for p, t, s in reqs]
        await _quiet(eng)
        tasks = [asyncio.ensure_future(run(p, t, s, "background", 40))
                 for p, t, s in reqs]
        await _until(lambda: all(s is not None for s in eng._slots),
                     "the two background requests never held both "
                     "slots")
        probe = await run("quick q ", 0.0, 5, "interactive", 8)
        got = [r.text for r in await asyncio.gather(*tasks)]
    finally:
        await eng.stop()
    assert seen.get("preempted") is True and seen.get("stale", 0) >= 1
    assert probe.completion_tokens == 8 and probe.text == "kubectl "
    assert got == alone
