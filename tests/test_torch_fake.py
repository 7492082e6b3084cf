"""``ENGINE=fake``: the port's rule-table ``FakeEngine`` and its numpy
pipeline twin ``FakeChunkedEngine`` against the JAX package's, on the CPU.

Each scenario runs once per package on the same script, seeds and knobs
(``_pkg`` gathers each package's modules) and the two outcomes must be
equal: ``EngineResult``s, ``stats()`` (its clock readings masked), the
goodput ledger, finish reasons and wasted steps at pipe depths 1-3 under
both termination modes (the template is
``tests/test_termination_pipeline.py``), the rule table, the fake-engine
halves of the JAX chaos, containment, sentinel, fleet and rollout suites,
and the HTTP app under ``ENGINE=fake`` with the degraded-fallback and
breaker drill of the verify recipe
(``DEGRADED_FALLBACK=true BREAKER_THRESHOLD=2
FAULT_POINTS=generate:error:1.0``). Every scenario takes milliseconds.
"""

import asyncio
import dataclasses
import importlib
import re
import time
import zlib
from types import SimpleNamespace

import pytest
from aiohttp.test_utils import TestClient, TestServer
from test_torch_env import knob_env  # noqa: F401  (autouse)

LIMIT = 30.0


def _pkg(root: str) -> SimpleNamespace:
    mods = {name.split(".")[-1]: importlib.import_module(f"{root}.{name}")
            for name in ("engine.fake", "engine.fallback", "engine.fleet",
                         "engine.rollout", "engine.protocol",
                         "engine.prompts", "testing.faults", "config",
                         "server.app", "server.factory", "server.executor")}
    return SimpleNamespace(root=root, **mods)


JAX = _pkg("ai_agent_kubectl_tpu")
PORT = _pkg("ai_agent_kubectl_tpu_torch")


def _both(scenario):
    """``scenario(pkg)`` run for the port and for the JAX package; the
    outcomes must be equal. Returns the port's."""
    async def go():
        return [await asyncio.wait_for(scenario(pkg), LIMIT)
                for pkg in (PORT, JAX)]

    ours, theirs = asyncio.run(go())
    assert ours == theirs
    return ours


def _outcome(coro_result):
    """An engine call's result, or its exception, as comparable data."""
    if isinstance(coro_result, BaseException):
        return (type(coro_result).__name__, str(coro_result))
    if dataclasses.is_dataclass(coro_result):
        # token_ids: the port's results carry the ids too (empty here)
        out = dataclasses.asdict(coro_result)
        assert not out.pop("token_ids", ())
        return out
    return coro_result


#: clock readings in ``stats()`` (wall or monotonic times, durations)
_CLOCKED = re.compile(r"(_ms|_s|_secs|_seconds|_at|_t|^t|time|rate|"
                      r"p50|p95|p99|mean|max|min|burn.*|ewma)$")


def _stable(obj):
    """``stats()`` with its clock readings masked (their keys kept)."""
    if isinstance(obj, dict):
        return {k: ("*" if isinstance(v, float) and _CLOCKED.search(str(k))
                    else "*" if k in ("steptime", "slo", "last_reset")
                    else _stable(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_stable(v) for v in obj]
    return obj


# ------------------------------------------------------------- rule table

QUERIES = ["list all pods", "show me the nodes", "get deployments in prod",
           "list services", "show namespaces", "logs of web-1",
           "fetch the logs for api-7", "describe pod web-1",
           "delete pod web-1", "scale deployment api to 5 replicas",
           "why did the autoscaler delete pod web-1?", "what is up",
           "GET PODS", "show deploys", ""]


@pytest.mark.parametrize("table", ["RULES", "READ_ONLY_RULES"])
def test_rule_command_matches_the_jax_table(table):
    """The port's table is the JAX one, mutating rules included; the
    fallback answers from the read-only half."""
    ours = getattr(PORT.fallback, table)
    theirs = getattr(JAX.fallback, table)
    assert [(p.pattern, p.flags, t) for p, t in ours] == [
        (p.pattern, p.flags, t) for p, t in theirs]
    for q in QUERIES:
        assert PORT.fallback.rule_command(q, rules=ours) == \
            JAX.fallback.rule_command(q, rules=theirs), q
    assert PORT.fallback.rule_command("delete pod web-1") == \
        "kubectl delete pod web-1"


def test_fallback_engine_stays_read_only():
    async def scenario(pkg):
        eng = pkg.fallback.FallbackEngine()
        out = []
        for q in QUERIES:
            r = await eng.generate(pkg.prompts.render_prompt(q))
            out.append((r.text, r.engine))
        return out

    out = _both(scenario)
    assert ("kubectl get all", "fallback-rules") in out
    assert not any("delete" in t or "scale" in t for t, _ in out)


# ------------------------------------------------------------- FakeEngine

async def _fake_engine_case(pkg, case):
    eng = pkg.fake.FakeEngine(delay=0.05 if case == "timeout" else 0.0)
    out = []
    if case == "not-started":
        try:
            await eng.generate("list pods")
        except Exception as e:       # noqa: BLE001 - the outcome compared
            out.append(_outcome(e))
        return out
    await eng.start()
    if case == "rules":
        for q in QUERIES:
            out.append(_outcome(await eng.generate(
                pkg.prompts.render_prompt(q))))
    elif case == "scripted":
        eng.scripted = ["```kubectl get pods```", "rm -rf /"]
        for q in ("a", "b", "list nodes"):
            out.append(_outcome(await eng.generate(q)))
    elif case == "fail-with":
        eng.fail_with = pkg.protocol.EngineUnavailable("boom")
        for q in ("list pods", "list pods"):
            try:
                out.append(_outcome(await eng.generate(q)))
            except Exception as e:   # noqa: BLE001
                out.append(_outcome(e))
    elif case == "timeout":
        try:
            await eng.generate("list pods", timeout=0.01)
        except Exception as e:       # noqa: BLE001
            out.append(_outcome(e))
        r = await eng.generate("list pods")
        out.append((r.text, r.decode_ms))
    elif case == "stream":
        for q in ("show the nodes", "scale deployment api to 3"):
            out.append([p async for p in eng.generate_stream(
                pkg.prompts.render_prompt(q))])
    out.append((eng.calls, eng.ready, eng.name, eng.weights_version))
    await eng.stop()
    out.append(eng.ready)
    return out


@pytest.mark.parametrize("case", ["rules", "scripted", "fail-with",
                                  "timeout", "stream", "not-started"])
def test_fake_engine_matches_the_jax_fake(case):
    _both(lambda pkg: _fake_engine_case(pkg, case))


# ------------------------------------------------------ FakeChunkedEngine

RAGGED = [(f"query {i}", 1 + (i * 5) % 17) for i in range(16)]


async def _ragged(pkg, **kw):
    eng = pkg.fake.FakeChunkedEngine(batch_size=4, chunk_len=4, **kw)
    await eng.start()
    try:
        rs = await asyncio.gather(*[eng.generate(p, max_tokens=mt)
                                    for p, mt in RAGGED])
        out = [(r.text, r.completion_tokens, r.finish_reason,
                r.prompt_tokens) for r in rs]
        return out, _stable(eng.stats()), eng.ledger_snapshot()
    finally:
        await eng.stop()


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("device_termination", [True, False],
                         ids=["device", "host-scan"])
def test_chunked_fake_depths_and_termination_match_the_jax_fake(
        depth, device_termination):
    """A ragged mix of EOS- and budget-terminated requests at each depth
    and termination mode: transcripts, finish reasons, the pipeline
    counters, wasted steps and the ledger equal the JAX fake's; device
    termination wastes nothing, the host scan does."""
    out, stats, ledger = _both(lambda pkg: _ragged(
        pkg, chunk_pipe_depth=depth, device_termination=device_termination))
    assert {r for _, _, r, _ in out} == {"stop", "length"}
    assert (stats["wasted_decode_steps"] == 0) == device_termination
    assert stats["fetches"] == stats["chunks_consumed"]
    assert ledger["conservation"]


def test_chunked_fake_transcripts_do_not_depend_on_the_pipe():
    async def scenario(pkg):
        runs = [await _ragged(pkg, chunk_pipe_depth=d,
                              device_termination=t)
                for d in (1, 3) for t in (True, False)]
        return [r[0] for r in runs]

    runs = _both(scenario)
    assert all(r == runs[0] for r in runs)


def test_chunked_fake_disconnect_bills_waste_alike():
    async def scenario(pkg):
        eng = pkg.fake.FakeChunkedEngine(batch_size=2, chunk_len=4,
                                         chunk_pipe_depth=3)
        await eng.start()
        try:
            agen = eng.generate_stream("disconnect me please",
                                       max_tokens=500)
            first = await agen.__aiter__().__anext__()
            await agen.aclose()
            deadline = time.monotonic() + LIMIT
            while any(s is not None for s in eng._slots):
                assert time.monotonic() < deadline, "the slot never freed"
                await asyncio.sleep(0.005)
            r = await eng.generate("next request", max_tokens=6)
            st = eng.stats()
            return (first, r.text, st["wasted_decode_steps"] > 0,
                    eng.ledger_snapshot()["classes"])
        finally:
            await eng.stop()

    assert _both(scenario)[2]


# -------------------------------------------------------------- containment

def _long_stream(n):
    def stream(prompt):
        h = zlib.crc32(prompt.encode())
        return [7 + ((h >> (i % 24)) + 3 * i) % 200 for i in range(n)] + [2]
    return stream


async def _gather_outcomes(eng, prompts, max_tokens):
    results = await asyncio.gather(
        *[eng.generate(p, max_tokens=max_tokens) for p in prompts],
        return_exceptions=True)
    return [_outcome(r) if isinstance(r, BaseException) else r.text
            for r in results]


async def _containment(pkg, drill):
    kw = dict(batch_size=8, chunk_len=4, chunk_pipe_depth=3)
    inj = pkg.faults.FaultInjector()
    prompts = [f"probe number {i:02d}" for i in range(12)]
    if drill == "nan":
        inj.set("decode", "nan")
        inj.target_substr = "number 07"
    elif drill == "poison_step":
        inj.set("decode", "poison_step")
        inj.target_substr = "number 05"
        prompts = prompts[:8]
    elif drill in ("budget-0", "budget-2"):
        inj.set("decode", "nan")
        inj.target_substr = "poison me"
        kw.update(batch_size=2, quarantine_retry_budget=int(drill[-1]))
        prompts = ["poison me please"]
    eng = pkg.fake.FakeChunkedEngine(faults=inj, **kw)
    await eng.start()
    try:
        out = await _gather_outcomes(eng, prompts, 12)
        c = eng.stats()["containment"]
        return out, {k: c[k] for k in ("resets", "quarantined")}, \
            eng.stats()["queue_depth"]
    finally:
        await eng.stop()


@pytest.mark.parametrize("drill", ["nan", "poison_step", "budget-0",
                                   "budget-2"])
def test_containment_drills_match_the_jax_fake(drill):
    """A one-slot ``decode:nan``, a step-wide ``poison_step`` bisected to
    its culprit, and the retry budget going terminal: the same requests
    quarantined, the survivors' transcripts, the resets by cause."""
    out, books, queued = _both(lambda pkg: _containment(pkg, drill))
    assert queued == 0
    assert sum(isinstance(o, tuple) for o in out) == 1


def test_scheduler_die_restarts_with_nothing_dropped_as_the_jax_fake():
    async def scenario(pkg):
        kw = dict(batch_size=2, chunk_len=4, chunk_pipe_depth=3,
                  stream_fn=_long_stream(40))
        inj = pkg.faults.FaultInjector()
        eng = pkg.fake.FakeChunkedEngine(faults=inj, **kw)
        await eng.start()
        try:
            prompts = [f"die probe {i}" for i in range(6)]
            tasks = [asyncio.create_task(eng.generate(p, max_tokens=30))
                     for p in prompts]
            deadline = time.monotonic() + LIMIT
            while not (any(s is not None and len(s.emitted) >= 3
                           for s in eng._slots) and eng._queue):
                assert time.monotonic() < deadline, "never mid-flight"
                await asyncio.sleep(0)
            inj.set("scheduler", "die")
            results = await asyncio.gather(*tasks)
            return ([r.text for r in results],
                    eng.stats()["containment"]["resets"])
        finally:
            await eng.stop()

    texts, resets = _both(scenario)
    assert resets == {"scheduler_death": 1} and all(texts)


# ----------------------------------------------------------------- sentinel

def test_sentinel_phases_and_stats_match_the_jax_fake():
    async def scenario(pkg):
        eng = pkg.fake.FakeChunkedEngine(batch_size=2, chunk_len=2,
                                         sentinel_min_samples=5)
        await eng.start()
        try:
            for i in range(6):
                await eng.generate(f"steady traffic {i}", max_tokens=16)
            snap = eng.steptime_health()
            return sorted((d["phase"], d["bucket"])
                          for d in snap["digests"].values())
        finally:
            await eng.stop()

    digests = _both(scenario)
    assert {p for p, _ in digests} == {"decode", "prefill"}


# -------------------------------------------------------------------- fleet

async def _fleet(pkg, n=2, **ekw):
    ekw.setdefault("chunk_len", 2)
    fleet = pkg.fleet.EngineFleet([pkg.fake.FakeChunkedEngine(**ekw)
                                   for _ in range(n)])
    await fleet.start()
    return fleet


def test_fleet_serves_and_migrates_as_the_jax_fake():
    """A fleet of two fakes serves each prompt's single-engine bytes,
    a replica stopped mid-stream hands its request over byte-identical,
    and a drain ejects and rejoins with nothing dropped."""
    async def scenario(pkg):
        fleet = await _fleet(pkg, stream_fn=_long_stream(120))
        out = []
        try:
            for prompt in ("list pods please", "get nodes now"):
                out.append((await fleet.generate(prompt,
                                                 max_tokens=32)).text)
            pieces = []
            async for p in fleet.generate_stream("migrate me",
                                                 max_tokens=100):
                pieces.append(p)
                if len(pieces) == 3:
                    victim = next(r for r in fleet.replicas if r.flights)
                    asyncio.create_task(victim.engine.stop())
            out.append("".join(pieces))
            h = fleet.fleet_health()
            out.append((h["migrations"], fleet._migrated_tokens > 0))
            idx = next(r.idx for r in fleet.replicas
                       if r.state == "active")
            await fleet.drain(idx)
            h = fleet.fleet_health()
            out.append((h["drains"], fleet.replicas[idx].eject_cause))
            await fleet.rejoin(idx)
            out.append(fleet.fleet_health()["rejoins"])
        finally:
            await fleet.stop()
        return out

    out = _both(scenario)
    assert out[3] == (1, True)


# ------------------------------------------------------------------ rollout

def _controller(pkg, fleet, **kw):
    return pkg.rollout.RolloutController(
        fleet, **{"canary_share": 0.25, "observe_secs": 0.2,
                  "burn_gate": 2.0, "drain_secs": 1.0, **kw})


async def _idle(ctl):
    deadline = time.monotonic() + LIMIT
    while ctl.active:
        assert time.monotonic() < deadline, f"rollout stuck in {ctl.state}"
        await asyncio.sleep(0.01)


def test_fake_swap_is_atomic_and_restorable_as_the_jax_fake():
    async def scenario(pkg):
        eng = pkg.fake.FakeChunkedEngine(chunk_len=2)
        out = []
        await eng.start()
        try:
            base = (await eng.generate("get pods", max_tokens=32)).text
            try:
                eng.swap_weights("/tmp/ckpt-v2")
            except Exception as e:   # noqa: BLE001
                out.append(_outcome(e))
        finally:
            await eng.stop()
        eng.faults = pkg.faults.FaultInjector.from_spec("checkpoint:corrupt")
        try:
            eng.swap_weights("/tmp/ckpt-v2")
        except Exception as e:       # noqa: BLE001
            out.append((type(e).__name__, eng.weights_version))
        out.append(eng.swap_weights("/tmp/ckpt-v2"))
        await eng.start()
        t2 = (await eng.generate("get pods", max_tokens=32)).text
        await eng.stop()
        eng.swap_weights(eng.checkpoint_path, version="fake-0")
        await eng.start()
        t1 = (await eng.generate("get pods", max_tokens=32)).text
        await eng.stop()
        out.append((t2 != base, t1 == base))
        dead = pkg.fake.FakeChunkedEngine(
            chunk_len=2, faults=pkg.faults.FaultInjector.from_spec(
                "swap:fail"))
        try:
            dead.swap_weights("/tmp/ckpt-v2")
        except Exception as e:       # noqa: BLE001
            out.append((type(e).__name__, dead.weights_version))
        return out

    out = _both(scenario)
    assert out[-2] == (True, True)


@pytest.mark.parametrize("drill", ["", "checkpoint:corrupt"],
                         ids=["promote", "checkpoint-corrupt"])
def test_rollout_over_fakes_matches_the_jax_fleet(drill):
    async def scenario(pkg):
        inj = pkg.faults.FaultInjector.from_spec(drill) if drill else None
        fleet = pkg.fleet.EngineFleet([pkg.fake.FakeChunkedEngine(
            chunk_len=2, faults=inj.for_replica(i) if inj else None)
            for i in range(2)])
        await fleet.start()
        ctl = _controller(pkg, fleet)
        try:
            before = (await fleet.generate("get pods", max_tokens=24)).text
            status = await ctl.start_rollout("/tmp/ckpt-v2")
            await _idle(ctl)
            after = (await fleet.generate("get pods", max_tokens=24)).text
            kinds = [e["type"] for e in ctl.events]
            return (status["target_version"], ctl.state,
                    ctl.last_rollback_cause,
                    sorted(set(ctl.replica_versions().values())),
                    after != before, kinds[0], kinds[-1],
                    ctl.rollouts_completed)
        finally:
            await fleet.stop()

    out = _both(scenario)
    assert out[1] == ("complete" if not drill else "rolled_back")


# --------------------------------------------------------------------- HTTP

_MASK = ("start_time", "end_time", "duration_ms", "decode_ms", "ttft_ms",
         "tokens_per_sec", "timings")


def _masked(body):
    if isinstance(body, dict):
        return {k: ("*" if k in _MASK else _masked(v))
                for k, v in body.items()}
    if isinstance(body, list):
        return [_masked(v) for v in body]
    return body


#: the /health fields both apps fill alike (the JAX app counts jax
#: devices, the port's app 1 for an engine without a device)
HEALTH_KEYS = ("status", "engine", "engine_ready", "model", "breaker",
               "degraded_fallback")


async def _http(pkg, env: dict, monkeypatch, requests) -> list:
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    cfg = pkg.config.ServiceConfig.from_env(env_file=None)
    engine = pkg.factory.build_engine(cfg)
    app = pkg.app.create_app(cfg, engine,
                             executor=pkg.executor.CommandExecutor(
                                 timeout=2.0))
    out = []
    async with TestClient(TestServer(app)) as c:
        for method, path, body in requests:
            r = await c.request(method, path, json=body)
            if r.headers.get("Content-Type", "").startswith(
                    "application/json"):
                data = _masked(await r.json())
                if path == "/health":
                    data = {k: data[k] for k in HEALTH_KEYS}
            else:
                data = await r.text()
                if path == "/metrics":
                    data = sorted(ln for ln in data.splitlines() if re.match(
                        r"(breaker_state|degraded_responses_total|"
                        r"http_requests_total)\b", ln))
            out.append((r.status, data))
    return out


HTTP_ENV = {"ENGINE": "fake", "MODEL_NAME": "toy-8m",
            "RATE_LIMIT": "1000/minute", "TORCH_DEVICE": "cpu"}
DRILL_ENV = {**HTTP_ENV, "DEGRADED_FALLBACK": "true",
             "BREAKER_THRESHOLD": "2",
             "FAULT_POINTS": "generate:error:1.0"}
QUERY = "/kubectl-command"


@pytest.mark.parametrize("name", ["serve", "drill"])
def test_http_app_under_engine_fake_answers_as_the_jax_app(name,
                                                           monkeypatch):
    """The app over ``ENGINE=fake`` built by each package's factory:
    commands, the cache hit, an unsafe request, the stream, /health and
    the metric families; then the verify recipe's drill, where every
    answer is a degraded 200 from the read-only rules and the breaker
    opens after two failures."""
    reqs = [("GET", "/health", None),
            ("POST", QUERY, {"query": "list all pods"}),
            ("POST", QUERY, {"query": "list all pods"}),
            ("POST", QUERY, {"query": "delete pod web-1"}),
            ("POST", QUERY + "/stream", {"query": "show deployments"}),
            ("POST", "/execute", {"execute": "kubectl get pods | x"}),
            ("GET", "/health", None),
            ("GET", "/metrics", None)]
    env = HTTP_ENV if name == "serve" else DRILL_ENV

    async def scenario(pkg):
        with monkeypatch.context() as m:
            return await _http(pkg, env, m, reqs)

    out = _both(scenario)
    assert out[0][0] == 200 and out[0][1]["engine"] == "fake"
    if name == "serve":
        assert out[1][1]["kubectl_command"] == "kubectl get pods"
        assert out[2][1]["from_cache"] is True
        assert out[3][1]["kubectl_command"] == "kubectl delete pod web-1"
    else:
        assert all(o[1]["degraded"] for o in out[1:4])
        assert out[6][1]["breaker"] == "open"


def test_port_fake_deployment_imports_no_jax():
    """A port process serving ``ENGINE=fake`` loads neither ``jax`` nor
    the JAX package (checked in a fresh interpreter)."""
    import subprocess
    import sys

    code = (
        "import asyncio, sys\n"
        "from aiohttp.test_utils import TestClient, TestServer\n"
        "from ai_agent_kubectl_tpu_torch.config import ServiceConfig\n"
        "from ai_agent_kubectl_tpu_torch.server.app import create_app\n"
        "from ai_agent_kubectl_tpu_torch.server.factory import "
        "build_engine\n"
        "async def go():\n"
        "    cfg = ServiceConfig(engine='fake', rate_limit='100/minute')\n"
        "    app = create_app(cfg, build_engine(cfg))\n"
        "    async with TestClient(TestServer(app)) as c:\n"
        "        r = await c.get('/health')\n"
        "        assert r.status == 200, r.status\n"
        "        r = await c.post('/kubectl-command', json={'query': "
        "'list pods'})\n"
        "        body = await r.json()\n"
        "        assert body['kubectl_command'] == 'kubectl get pods', body\n"
        "asyncio.run(go())\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'ai_agent_kubectl_tpu.')) or m == 'ai_agent_kubectl_tpu']\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
