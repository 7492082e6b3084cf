"""The port's engine fleet (``engine/fleet.py``) against the JAX package's,
on the CPU: toy-8m replicas of ``BatchedTorchEngine`` (float32,
``ByteTokenizer``, the ragged regime) on the weights of one
``BatchedJaxEngine`` carried across with ``params_from_jax``. That one
JAX engine is the transcript reference: the JAX fleet's transcripts equal
a single JAX engine's (``tests/test_fleet.py``), so every fleet
transcript here is held against it byte for byte.

Scenarios mirror ``tests/test_fleet.py``: prefix affinity and routing;
a fleet's greedy and seeded 0.9 transcripts (``generate`` and the
stream); a replica hard-killed mid-stream and mid-``generate`` (the
request re-splices on the sibling from prompt, generated ids and seed);
a drain, eject and rejoin cycle; a hedge that wins byte-identically with
the loser billed ``hedge_loser`` and the books balanced; a quarantine
that never migrates; the migration budget; ``r0:scheduler:die`` with the
reset budget spent; the monitor's eject and auto-rejoin; ``/health``'s
``fleet`` keys and the ten ``fleet_*`` families against the JAX app;
the factory's fleet and its refusals against the JAX factory's.

No assertion waits on a wall-clock race: a replica is killed or drained
while its scheduler thread is held before a chunk dispatch (``_Gate``),
so the request is in flight by construction, and every async test runs
under its own timeout.
"""

import asyncio
import importlib
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine import fleet as jax_fleet
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.fake import FakeChunkedEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.server.app import create_app as jax_create_app
from ai_agent_kubectl_tpu.server.factory import (
    build_engine as jax_build_engine)
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine import fleet as port_fleet
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.fleet import (REPLICA_ACTIVE,
                                                     REPLICA_EJECTED,
                                                     EngineFleet)
from ai_agent_kubectl_tpu_torch.engine.protocol import (EngineUnavailable,
                                                        RequestQuarantined)
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.server.app import create_app
from ai_agent_kubectl_tpu_torch.server.factory import build_engine
from ai_agent_kubectl_tpu_torch.testing.faults import FaultInjector

torch.set_num_threads(1)

TOY = get_config("toy-8m")
COMMON = dict(dtype="float32", max_seq_len=64, prefill_buckets=(16,),
              prefix_cache=False, batch_size=4, chunk_len=4)
#: (prompt, temperature, seed): greedy and seeded sampling
CASES = [("pod alpha ", 0.0, 101), ("pod beta ", 0.9, 202)]
MAX_TOKENS = 40
#: each async test's own limit (seconds)
LIMIT = 60.0


def _run(coro):
    """One scenario under its own timeout."""
    return asyncio.wait_for(coro, LIMIT)


@pytest.fixture(scope="module")
def ref():
    """The one JAX engine of this file: its weights (numpy) and its
    transcripts of CASES and of the two short prompts below."""
    jeng = BatchedJaxEngine(jconfig.get_config("toy-8m"),
                            tokenizer=JaxByteTokenizer(),
                            compile_cache_dir="", ragged_attention="on",
                            **COMMON)

    async def go():
        await jeng.start()
        try:
            texts = {}
            for prompt, temp, seed in CASES:
                r = await jeng.generate(prompt, max_tokens=MAX_TOKENS,
                                        temperature=temp, seed=seed)
                texts[prompt] = r.text
            for prompt in ("pod gamma ", "pod delta "):
                r = await jeng.generate(prompt, max_tokens=16)
                texts[prompt] = r.text
            return texts
        finally:
            await jeng.stop()

    texts = asyncio.run(go())
    params = jax.tree.map(np.asarray, jeng.params)
    return {"params": params, "texts": texts}


def _engine(ref, faults=None, **kw):
    return BatchedTorchEngine(
        TOY, tokenizer=ByteTokenizer(),
        params=params_from_jax(ref["params"], TOY), device="cpu",
        faults=faults, **{**COMMON, **kw})


async def _fleet(ref, n=2, faults=None, fleet_kw=None, **kw):
    fleet = EngineFleet(
        [_engine(ref, faults.for_replica(i) if faults is not None else None,
                 **kw) for i in range(n)],
        **{"affinity": False, **(fleet_kw or {})})
    await fleet.start()
    return fleet


class _Gate:
    """Holds an engine's scheduler thread before each chunk dispatch once
    ``after`` chunks were read since the gate was set, until ``release``:
    the request it serves is then in flight, with tokens generated and
    chunks in the pipe, for as long as the test needs. A dispatch
    released on a stopped engine does not run."""

    def __init__(self, eng, after: int = 2):
        self.eng, self.after = eng, after
        self.base = eng._chunks_consumed
        self.reached = threading.Event()
        self.opened = threading.Event()
        real = type(eng)._dispatch_chunk.__get__(eng)

        def dispatch():
            if (eng._chunks_consumed - self.base >= self.after
                    and not self.opened.is_set()):
                self.reached.set()
                self.opened.wait(LIMIT)
                if not eng._running:
                    return
            real()

        eng._dispatch_chunk = dispatch

    async def wait(self):
        await _wait_for(self.reached.is_set,
                        "the held replica never read its chunks")

    def release(self):
        self.opened.set()


async def _collect(fleet, prompt, temp, seed, *, stream=True):
    if not stream:
        return (await fleet.generate(prompt, max_tokens=MAX_TOKENS,
                                     temperature=temp, seed=seed)).text
    pieces = []
    async for p in fleet.generate_stream(prompt, max_tokens=MAX_TOKENS,
                                         temperature=temp, seed=seed):
        pieces.append(p)
    return "".join(pieces)


async def _kill(eng, gate):
    """Hard-kill a held engine: stop() first, then let the held thread
    see it."""
    stop = asyncio.create_task(eng.stop())
    await asyncio.sleep(0.02)
    gate.release()
    await stop


async def _wait_for(cond, what: str):
    deadline = asyncio.get_running_loop().time() + LIMIT / 2
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, what
        await asyncio.sleep(0.01)


# ------------------------------------------------------- router units


def test_prefix_affinity_matches_jax():
    outs = []
    for mod in (jax_fleet, port_fleet):
        aff = mod.PrefixAffinity(maxsize=3)
        aff.record("sys prompt + turn1", 0)
        aff.record("sys prompt + turn1 + answer1", 1)
        got = [aff.lookup("sys prompt + turn1 + answer1 + turn2"),
               aff.lookup("sys prompt + turn1 plus other stuff"),
               aff.lookup("unrelated prompt")]
        aff.record("aaaa", 0)
        aff.record("bbbb", 1)
        got.append(len(aff._map))
        aff.forget_replica(1)
        got.append(aff.lookup("bbbb"))
        outs.append(got)
    assert outs[0] == outs[1] == [1, 0, None, 3, None]
    assert port_fleet.REPLICA_STATES == jax_fleet.REPLICA_STATES


class _Ready:
    """The least an engine needs to be routed to."""

    ready = True

    async def start(self):
        pass

    async def stop(self, drain_secs=0.0):
        pass


async def _route_script(mod) -> list:
    fleet = mod.EngineFleet([_Ready() for _ in range(3)])
    await fleet.start()
    try:
        r0, r1, r2 = fleet.replicas
        got = []
        r0.inflight, r1.inflight, r2.inflight = 5, 1, 3
        got.append(fleet._route("x").idx)
        r1.state = mod.REPLICA_DRAINING
        got.append(fleet._route("x").idx)
        r2.state = mod.REPLICA_EJECTED
        got.append(fleet._route("x").idx)
        for _ in range(5):
            r0.breaker.record_failure()
        got.append(fleet._route("x"))
        r0.breaker = type(r0.breaker)()
        r1.state = r2.state = mod.REPLICA_ACTIVE
        r0.inflight = r1.inflight = r2.inflight = 0
        fleet.affinity.record("session alpha", 1)
        r1.inflight = fleet.AFFINITY_SLACK
        got.append(fleet._route("session alpha + next turn").idx)
        r1.inflight = fleet.AFFINITY_SLACK + 1
        got.append(fleet._route("session alpha + next turn").idx)
        return got
    finally:
        await fleet.stop()


def test_route_skips_unhealthy_prefers_least_loaded_and_affinity():
    outs = [asyncio.run(_route_script(mod))
            for mod in (jax_fleet, port_fleet)]
    assert outs[0] == outs[1] == [1, 2, 0, None, 1, 0]


# -------------------------------------------- transcripts and migration


def test_fleet_transcripts_equal_the_jax_engine(ref):
    async def go():
        fleet = await _fleet(ref)
        try:
            assert len({r.engine.weights_version
                        for r in fleet.replicas}) == 1
            for prompt, temp, seed in CASES:
                want = ref["texts"][prompt]
                assert await _collect(fleet, prompt, temp, seed,
                                      stream=False) == want
                assert await _collect(fleet, prompt, temp, seed) == want
            assert fleet._migrations == 0
        finally:
            await fleet.stop()

    asyncio.run(_run(go()))


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "generate"])
def test_migration_mid_request_byte_identical(ref, stream):
    """Replica 0 (the idle fleet's pick) is hard-killed while it holds
    the request: the request re-splices on replica 1 from (prompt,
    generated ids, seed) and its transcript equals the JAX engine's, at
    temperature 0 and 0.9."""
    async def go():
        fleet = await _fleet(ref)
        try:
            for i, (prompt, temp, seed) in enumerate(CASES):
                victim = fleet.replicas[0]
                gate = _Gate(victim.engine)
                task = asyncio.create_task(
                    _collect(fleet, prompt, temp, seed, stream=stream))
                await gate.wait()
                assert victim.flights
                await _kill(victim.engine, gate)
                assert await task == ref["texts"][prompt], prompt
                assert fleet._migrations == i + 1
                assert fleet._migrated_tokens > 0
                await _wait_for(lambda: victim.state == REPLICA_EJECTED,
                                "the monitor never ejected the victim")
                del victim.engine._dispatch_chunk
                await fleet.rejoin(0)
            h = fleet.fleet_health()
            assert h["migrations"] == 2 and h["rejoins"] == 2
            assert h["ejects"] == 2 and h["active"] == 2
        finally:
            await fleet.stop()

    asyncio.run(_run(go()))


def test_drain_eject_rejoin_cycle_drops_nothing(ref):
    async def go():
        fleet = await _fleet(ref)
        prompt, temp, seed = CASES[1]
        want = ref["texts"][prompt]
        try:
            gate = _Gate(fleet.replicas[0].engine)
            task = asyncio.create_task(_collect(fleet, prompt, temp, seed))
            await gate.wait()
            drain = asyncio.create_task(fleet.drain(0))
            await _wait_for(lambda: fleet._migrations == 1,
                            "the drain's nudge never migrated")
            gate.release()
            assert await task == want
            await drain
            h = fleet.fleet_health()
            assert h["drains"] == 1 and h["migrations"] == 1
            assert fleet.replicas[0].state == REPLICA_EJECTED
            assert fleet.replicas[0].eject_cause == "drain"
            assert fleet.ready
            del fleet.replicas[0].engine._dispatch_chunk
            await fleet.rejoin(0)
            h = fleet.fleet_health()
            assert h["active"] == 2 and h["rejoins"] == 1
            assert fleet.replicas[0].breaker.state == "closed"
            assert await _collect(fleet, prompt, temp, seed) == want
            assert fleet.ledger_snapshot()["conservation"]["balanced"]
        finally:
            await fleet.stop()

    asyncio.run(_run(go()))


def _slow_first_event(eng, delay):
    """The engine decodes at once but its stream holds the first event
    for ``delay`` seconds: a replica that stalls past the hedge budget
    while its slot keeps generating."""
    real = eng.stream_events

    async def stream_events(prompt, **kw):
        agen = real(prompt, **kw)
        try:
            first = await agen.__anext__()
            await asyncio.sleep(delay)
            yield first
            async for ev in agen:
                yield ev
        finally:
            await agen.aclose()

    eng.stream_events = stream_events


def test_hedge_wins_byte_identical_and_bills_the_loser(ref):
    async def go():
        fleet = await _fleet(ref, fleet_kw={"hedge_ms": 40})
        prompt = "pod gamma "
        try:
            loser = fleet.replicas[0].engine
            _slow_first_event(loser, delay=LIMIT)
            # The loser has read tokens and not finished when the hedge's
            # first event wins: held after its first chunk's read until
            # the race is decided, while the hedge's scheduler waits for
            # that hold. (Left to the clock, a loser discarded before its
            # first read, or finished before the discard, bills no
            # hedge_loser step: either happened now and then under load.)
            gate = _Gate(loser, after=1)
            hedge = fleet.replicas[1].engine
            real = type(hedge)._dispatch_chunk.__get__(hedge)

            def after_the_loser():
                assert gate.reached.wait(LIMIT), "the loser never read"
                real()

            hedge._dispatch_chunk = after_the_loser
            before = dict(loser.ledger_snapshot()["classes"])
            try:
                got = await fleet.generate(prompt, max_tokens=16)
            finally:
                gate.release()
            assert got.text == ref["texts"][prompt]
            assert fleet._hedges == 1 and fleet._hedge_wins == 1
            assert fleet.fleet_health()["hedges"] == 1
            assert all(r.breaker.state == "closed" for r in fleet.replicas)
            await _wait_for(lambda: all(s is None for s in loser._slots),
                            "the losing branch never finished")
            classes = loser.ledger_snapshot()["classes"]
            assert classes["hedge_loser"] >= 1
            assert classes["delivered"] == before["delivered"]
            snap = fleet.ledger_snapshot()
            assert snap["conservation"]["balanced"]
            assert snap["classes"]["hedge_loser"] == classes["hedge_loser"]
        finally:
            await fleet.stop()

    asyncio.run(_run(go()))


def test_hedge_survives_primary_stream_ending_without_done(ref):
    """A primary whose stream closes without a done event while a hedge
    races: the hedge wins, and nothing migrates."""
    async def go():
        fleet = await _fleet(ref, fleet_kw={"hedge_ms": 30})
        try:
            async def ends_early(prompt, **kw):
                await asyncio.sleep(0.1)
                return
                yield  # pragma: no cover

            fleet.replicas[0].engine.stream_events = ends_early
            _slow_first_event(fleet.replicas[1].engine, delay=0.2)
            got = await fleet.generate("pod delta ", max_tokens=16)
            assert got.text == ref["texts"]["pod delta "]
            assert fleet._hedges == 1 and fleet._migrations == 0
        finally:
            await fleet.stop()

    asyncio.run(_run(go()))


def test_quarantine_is_terminal_never_migrated(ref):
    async def go():
        inj = FaultInjector.from_spec("r0:decode:nan")
        fleet = await _fleet(ref, faults=inj, quarantine_retry_budget=0)
        try:
            fleet.replicas[1].inflight = 10     # route to replica 0
            with pytest.raises(RequestQuarantined):
                await fleet.generate("pod poison ", max_tokens=16)
            fleet.replicas[1].inflight = 0
            assert fleet._migrations == 0
            assert fleet.replicas[0].breaker.state == "closed"
        finally:
            await fleet.stop()

    asyncio.run(_run(go()))


def _dies_after_first_event(eng):
    real = eng.stream_events

    async def stream_events(prompt, **kw):
        agen = real(prompt, **kw)
        try:
            yield await agen.__anext__()
        finally:
            await agen.aclose()
        raise EngineUnavailable("replica died mid-request")

    eng.stream_events = stream_events


def test_migration_budget_exhausted_raises(ref):
    async def go():
        fleet = await _fleet(ref, fleet_kw={"migration_budget": 1})
        try:
            for rep in fleet.replicas:
                _dies_after_first_event(rep.engine)
            with pytest.raises(EngineUnavailable):
                await fleet.generate("pod doomed ", max_tokens=16)
            assert fleet._migrations == 1
        finally:
            await fleet.stop()

    asyncio.run(_run(go()))


def test_scheduler_die_with_reset_budget_spent_migrates(ref):
    """``r0:scheduler:die`` on a replica whose reset budget is spent: the
    supervisor cannot restart it, fails its requests, and the fleet
    carries them to replica 1 (byte-identical); the monitor then ejects
    replica 0 as ``reset_budget_exhausted``."""
    async def go():
        inj = FaultInjector()
        fleet = await _fleet(ref, faults=inj, reset_max_per_min=1)
        prompt, temp, seed = CASES[0]
        try:
            sup = fleet.replicas[0].engine.supervisor
            sup._reset_times.append(sup._timer())     # the budget, spent
            gate = _Gate(fleet.replicas[0].engine)
            task = asyncio.create_task(_collect(fleet, prompt, temp, seed))
            await gate.wait()
            inj.set("scheduler", "die", replica=0)
            gate.release()
            assert await task == ref["texts"][prompt]
            assert fleet._migrations == 1
            assert inj.fired("scheduler") == 1
            await _wait_for(
                lambda: fleet.replicas[0].state == REPLICA_EJECTED,
                "the monitor never ejected the dead replica")
            assert fleet.replicas[0].eject_cause == "reset_budget_exhausted"
            assert sup.budget_denials >= 1
            assert fleet.replicas[1].engine.ready
        finally:
            await fleet.stop()

    asyncio.run(_run(go()))


def test_monitor_ejects_dead_replica_and_auto_rejoins(ref):
    async def go():
        fleet = await _fleet(ref, fleet_kw={"rejoin_secs": 0.05})
        try:
            victim = fleet.replicas[0]
            await victim.engine.stop()
            await _wait_for(lambda: victim.state == REPLICA_EJECTED,
                            "never ejected")
            assert victim.eject_cause == "not_ready"
            await _wait_for(lambda: victim.state == REPLICA_ACTIVE,
                            "never rejoined")
            assert fleet._ejects == 1 and fleet._rejoins == 1
            got = await fleet.generate("pod gamma ", max_tokens=16)
            assert got.text == ref["texts"]["pod gamma "]
        finally:
            await fleet.stop()

    asyncio.run(_run(go()))


# ------------------------------------------------------------ HTTP surface


FLEET_FAMILIES = ("fleet_replicas", "fleet_replica_occupancy",
                  "fleet_replica_inflight", "fleet_replica_breaker_state",
                  "fleet_migrations", "fleet_migrated_tokens",
                  "fleet_hedges", "fleet_drains", "fleet_ejects",
                  "fleet_rejoins")


def _families(text: str) -> dict:
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name in FLEET_FAMILIES:
            out[fam.name] = (fam.type, fam.documentation, sorted(
                (s.name, tuple(sorted(s.labels.items())), s.value)
                for s in fam.samples if not s.name.endswith("_created")))
    return out


async def _fleet_http(client, fleet) -> list:
    """The same script against either app: /health, one request, a
    scrape, a drain of replica 0, /health and a scrape again."""
    out = []
    r = await client.get("/health")
    body = await r.json()
    out.append((r.status, sorted(body), sorted(body["fleet"]),
                sorted(body["fleet"]["replicas"][0]),
                body["fleet"]["size"], body["fleet"]["active"]))
    r = await client.post("/kubectl-command", json={"query": "list pods"})
    out.append(r.status in (200, 422))
    out.append(_families(await (await client.get("/metrics")).text()))
    await fleet.drain(0, drain_secs=0.2)
    r = await client.get("/health")
    body = await r.json()
    out.append((r.status, body["fleet"]["ejected"], body["fleet"]["drains"],
                body["fleet"]["replicas"][0]["eject_cause"]))
    out.append(_families(await (await client.get("/metrics")).text()))
    return out


def test_health_and_metrics_expose_fleet_as_the_jax_app(ref):
    async def go():
        outs = []
        jfleet = jax_fleet.EngineFleet(
            [FakeChunkedEngine(chunk_len=2) for _ in range(2)])
        jcfg = JaxServiceConfig(engine="fake", model_name="toy-8m",
                                llm_timeout=5.0, rate_limit="1000/minute")
        async with TestClient(TestServer(jax_create_app(jcfg, jfleet))) \
                as client:
            outs.append(await _fleet_http(client, jfleet))
        pfleet = EngineFleet([_engine(ref) for _ in range(2)])
        pcfg = ServiceConfig(torch_device="cpu", llm_timeout=5.0,
                             rate_limit="1000/minute", max_new_tokens=8)
        async with TestClient(TestServer(create_app(pcfg, pfleet))) \
                as client:
            outs.append(await _fleet_http(client, pfleet))
        assert outs[0] == outs[1]
        assert set(outs[0][2]) == set(FLEET_FAMILIES)
        assert outs[0][3] == (200, 1, 1, "drain")

    asyncio.run(_run(go()))


def test_factory_builds_fleet_and_refuses_as_the_jax_factory():
    def cfg(**kw):
        return ServiceConfig(torch_device="cpu", **kw)

    def jcfg(**kw):
        return JaxServiceConfig(**{"model_name": "toy-8m", "engine": "jax",
                                   "decode_batch_size": 4, **kw})

    eng = build_engine(cfg(fleet_size=2, fleet_hedge_ms=25.0,
                           fleet_migration_budget=2,
                           fault_points="r1:scheduler:die"))
    assert isinstance(eng, EngineFleet) and len(eng.replicas) == 2
    assert (eng.hedge_ms, eng.migration_budget) == (25.0, 2)
    f0, f1 = (rep.engine.faults for rep in eng.replicas)
    assert f1.has("scheduler") and not f0.has("scheduler")
    assert f0.inner is f1.inner
    for kw in ({"fault_points": "r5:scheduler:die"},
               {"fault_points": "r0:generate:error"}):
        errors = []
        for build, make in ((build_engine, cfg), (jax_build_engine, jcfg)):
            with pytest.raises(ValueError) as ei:
                build(make(fleet_size=2, **kw))
            errors.append(str(ei.value))
        assert errors[0] == errors[1]
    errors = []
    for build, make in ((build_engine, cfg), (jax_build_engine, jcfg)):
        with pytest.raises(ValueError) as ei:
            build(make(engine="openai", fleet_size=2))
        errors.append(str(ei.value).split(" (ENGINE=")[0])
    assert errors[0] == errors[1] == "FLEET_SIZE > 1 requires a local engine"


def test_chip_smoke_counts_the_fleets_launches_apart_from_its_references():
    """chip_smoke.py's serve_fleet reads the kernel counters in windows:
    a fleet window's launches are its own, the reference runs' go to
    their own books, and a fleet window whose replicas stepped without
    launching the ragged kernel fails the gate, whatever the references
    launched."""
    chip = importlib.import_module("chip_smoke")
    engines = [SimpleNamespace(forward_steps=0) for _ in range(2)]
    win = chip._LaunchWindows(engines)
    ragged = win.counters["ragged_attention_pool"]
    saved = ragged.launches
    try:
        with win.window("fleet", "a"):
            engines[0].forward_steps += 3
            engines[1].forward_steps += 2
            ragged.launches += 2 * 5          # two layers a step
        with win.window("reference"):
            engines[0].forward_steps += 4
            ragged.launches += 2 * 4
        with win.window("fleet", "a"):
            engines[1].forward_steps += 1
            ragged.launches += 2
        win.gate("serve_fleet", 2)
        assert win.books["fleet"]["ragged_attention_pool"] == 12
        assert win.books["reference"]["ragged_attention_pool"] == 8
        assert win.segments == {"a": {"ragged": 12, "forward_steps": [3, 3]}}
        with win.window("reference"):
            ragged.launches += 100
        with win.window("fleet", "b"):
            engines[1].forward_steps += 1
        with pytest.raises(AssertionError, match=r"serve_fleet \(b\): 0 "):
            win.gate("serve_fleet", 2)
    finally:
        ragged.launches = saved
