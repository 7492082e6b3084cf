"""The port's HTTP contract against the JAX app's, scenario by scenario.

Each scenario of ``tests/test_api.py`` (and ``test_service_units.py``,
``test_executor.py``) whose route and feature the port serves runs
twice: against the port's app and against the JAX app, each built with
the same config and the same scripted stub engine (answering through its
own package's result and exception types). Every response is reduced to
its status, its body (timestamps and durations masked, ``timings`` to
its phase names) and the headers that matter (``Content-Type``,
``Retry-After``, ``X-RateLimit-*``, ``X-Request-ID`` — each request
sends one — and ``Server-Timing``'s phase names), plus the stub's call
count after each request; the two lists must be equal.

Scenarios: auth, rate limit, X-Forwarded-For untrusted and trusted, the
TTL cache and ``from_cache``, single flight (plain, stream, and the two
together), the degraded fallback and the breaker, the overload 503 with
``Retry-After``, every engine outcome's status, ``/execute`` with a fake
``kubectl`` on ``PATH`` (table, kubectl error, unsafe 400, timeout),
stream events, metrics names and label cardinality, and the OpenAPI
document per path. Below them, each copied module (TTL cache, single
flight, rate limiter, breaker, trace and flight recorder, table parser,
windowed rate, fallback rules) runs one script on an injected clock in
both packages, with equal outputs.

The last test mirrors ``tests/test_real_checkpoint_http.py``: a tiny
Llama checkpoint and the BPE asset served by the port's batched and
single-sequence engines, with greedy transcripts byte-identical to the
JAX batched engine's on the same file.
"""

import asyncio
import builtins
import os
import re
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine import protocol as jax_protocol
from ai_agent_kubectl_tpu.server.app import create_app as jax_create_app
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine import protocol as port_protocol
from ai_agent_kubectl_tpu_torch.server.app import create_app

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")


class StubEngine:
    """Scripted engine: each call takes the next outcome of ``script``
    (a text, or ``(exception name, message)`` raised from the package's
    protocol module or builtins), else answers ``default``. ``gate``
    holds every call until set; ``generate_stream`` yields the text in
    word pieces."""

    name = "stub"
    device = None

    def __init__(self, protocol, script=(), default="kubectl get pods",
                 gate=None):
        self.protocol = protocol
        self.script = list(script)
        self.default = default
        self.gate = gate
        self.calls = 0
        self.ready = True
        self.started = asyncio.Event()

    async def start(self):
        pass

    async def stop(self, drain_secs=0.0):
        self.ready = False

    async def _outcome(self):
        self.calls += 1
        self.started.set()
        if self.gate is not None:
            await asyncio.wait_for(self.gate.wait(), 30.0)
        out = self.script.pop(0) if self.script else self.default
        if isinstance(out, tuple):
            name, message = out
            exc = getattr(self.protocol, name, None) or getattr(builtins,
                                                                name)
            raise exc(message)
        return out

    async def generate(self, prompt, **kw):
        text = await self._outcome()
        return self.protocol.EngineResult(
            text=text, prompt_tokens=11, completion_tokens=3,
            queue_ms=1.0, prefill_ms=2.0, decode_ms=3.0, ttft_ms=4.0,
            engine=self.name)

    async def generate_stream(self, prompt, **kw):
        text = await self._outcome()
        for i, word in enumerate(text.split(" ")):
            yield word if i == 0 else " " + word


#: engine_metadata fields the rule-based fallback measures itself
FALLBACK_TIMES = ("decode_ms", "ttft_ms", "tokens_per_sec")


def _masked(body):
    if isinstance(body, dict):
        timed = body.get("engine") == "fallback-rules"
        out = {}
        for key, val in body.items():
            if key in ("start_time", "end_time", "duration_ms") or (
                    timed and key in FALLBACK_TIMES):
                out[key] = "*"
            elif key == "timings" and val is not None:
                out[key] = sorted(val)
            else:
                out[key] = _masked(val)
        return out
    if isinstance(body, list):
        return [_masked(v) for v in body]
    return body


HEADERS = ("Content-Type", "Retry-After", "X-RateLimit-Limit",
           "X-RateLimit-Remaining", "X-RateLimit-Reset", "X-Request-ID",
           "Cache-Control")
#: the /health fields the port fills (JAX counts its own devices and
#: reports its incident ring, which the port does not have)
HEALTH_KEYS = ("status", "engine", "engine_ready", "model", "breaker",
               "degraded_fallback", "kv_pool")


class Side:
    """One app under test and what its responses reduce to."""

    def __init__(self, client, engine):
        self.client = client
        self.engine = engine
        self.n = 0

    async def send(self, method, path, json=None, headers=None):
        self.n += 1
        hdrs = {"X-Request-ID": f"req-{self.n}", **(headers or {})}
        r = await self.client.request(method, path, json=json,
                                      headers=hdrs)
        return await self.reduce(r, path)

    async def reduce(self, r, path):
        ctype = r.headers.get("Content-Type", "")
        if ctype.startswith("application/json"):
            body = _masked(await r.json())
            if path == "/health":
                body = {k: body[k] for k in HEALTH_KEYS}
        else:
            body = await r.text()
        timing = r.headers.get("Server-Timing")
        return (r.status, body,
                {h: r.headers.get(h) for h in HEADERS},
                re.sub(r";dur=[0-9.]+", "", timing) if timing else None,
                self.engine.calls)

    async def post(self, query, path="/kubectl-command", **kw):
        return await self.send("POST", path, json={"query": query}, **kw)


async def run_both(scenario, cfg=None, script=(), gate=False,
                   default="kubectl get pods"):
    """Run ``scenario(side)`` against the port's app and the JAX app;
    assert both return the same list and return the port's."""
    cfg = cfg or {}
    outs = []
    for create, config, protocol in (
            (create_app, ServiceConfig(torch_device="cpu", **cfg),
             port_protocol),
            (jax_create_app, JaxServiceConfig(engine="fake", **cfg),
             jax_protocol)):
        engine = StubEngine(protocol, script, default,
                            asyncio.Event() if gate else None)
        async with TestClient(TestServer(create(config, engine))) as c:
            outs.append(await scenario(Side(c, engine)))
    assert outs[0] == outs[1]
    return outs[0]


# ------------------------------------------------------------- scenarios

async def test_auth():
    async def scenario(s):
        return [await s.post("list pods"),
                await s.post("list pods", headers={"X-API-Key": "wrong"}),
                await s.post("list pods", headers={"X-API-Key": "sekrit"}),
                await s.send("GET", "/health"),
                (await s.send("GET", "/metrics"))[0]]

    out = await run_both(scenario, {"api_auth_key": "sekrit"})
    assert [o[0] for o in out[:4]] == [401, 401, 200, 200] and out[4] == 200


async def test_rate_limit():
    async def scenario(s):
        return [await s.post("list pods") for _ in range(3)]

    out = await run_both(scenario, {"rate_limit": "2/minute"})
    assert [o[0] for o in out] == [200, 200, 429]
    assert out[2][2]["Retry-After"] is not None


@pytest.mark.parametrize("trusted", [False, True],
                         ids=["xff_untrusted", "xff_trusted"])
async def test_forwarded_for(trusted):
    async def scenario(s):
        return [await s.post("list pods",
                             headers={"X-Forwarded-For": f"{ip}, 10.0.0.1"})
                for ip in ("1.1.1.1", "2.2.2.2", "1.1.1.1")]

    out = await run_both(scenario, {"rate_limit": "1/minute",
                                    "trust_proxy_headers": trusted})
    assert [o[0] for o in out] == ([200, 200, 429] if trusted
                                   else [200, 429, 429])


async def test_cache_hit_and_sanitized_key():
    async def scenario(s):
        return [await s.post("list all pods"),
                await s.post("list\n\tall   pods"),
                await s.post("list all nodes")]

    out = await run_both(scenario)
    assert [o[1]["from_cache"] for o in out] == [False, True, False]
    assert out[-1][-1] == 2


@pytest.mark.parametrize("kind", ["plain", "stream", "mixed"])
async def test_single_flight(kind):
    """Concurrent identical requests coalesce onto one generation:
    non-streaming, streaming, and a non-streaming request arriving while
    an identical stream is in flight."""
    # Which request starts the flight is up to arrival order: every
    # request carries one X-Request-ID, and the answers are compared as
    # a multiset.
    same = {"X-Request-ID": "flight"}

    async def scenario(s):
        if kind == "mixed":
            first = asyncio.ensure_future(
                s.post("list all pods", path="/kubectl-command/stream"))
            await asyncio.wait_for(s.engine.started.wait(), 5.0)
            second = asyncio.ensure_future(s.post("list all pods"))
            await asyncio.sleep(0.05)
            s.engine.gate.set()
            return [await first, await second]
        path = ("/kubectl-command/stream" if kind == "stream"
                else "/kubectl-command")
        tasks = [asyncio.ensure_future(s.post("list all pods", path=path,
                                              headers=same))
                 for _ in range(5)]
        await asyncio.wait_for(s.engine.started.wait(), 5.0)
        await asyncio.sleep(0.05)
        s.engine.gate.set()
        outs = [await t for t in tasks]
        # arrival order differs between runs; the multiset is compared
        return sorted(outs, key=repr)

    out = await run_both(scenario, {"rate_limit": "100/minute"}, gate=True)
    assert all(o[0] == 200 for o in out) and out[-1][-1] == 1


async def test_degraded_fallback_and_breaker():
    async def scenario(s):
        out = [await s.post("list all pods"),
               await s.post("show the nodes"),
               await s.send("GET", "/health"),
               await s.post("get logs of web-1")]
        metrics = await s.client.get("/metrics")
        text = await metrics.text()
        out.append([line for line in text.splitlines()
                    if line.startswith(("breaker_state ",
                                        "degraded_responses_total "))])
        return out

    script = [("EngineUnavailable", "engine down")] * 2
    out = await run_both(scenario, {"degraded_fallback": True,
                                    "breaker_threshold": 2}, script=script)
    assert [o[1]["degraded"] for o in (out[0], out[1], out[3])] == [True] * 3
    assert out[0][1]["engine_metadata"]["engine"] == "fallback-rules"
    assert out[2][1]["breaker"] == "open"
    assert out[3][-1] == 2            # the open breaker spared the engine
    assert "breaker_state 2.0" in out[4]


async def test_breaker_opens_without_fallback():
    async def scenario(s):
        return [await s.post(f"list pods {i}") for i in range(4)] + [
            await s.send("GET", "/health")]

    out = await run_both(scenario, {"breaker_threshold": 2},
                         script=[("EngineUnavailable", "down")] * 2)
    assert [o[0] for o in out[:4]] == [503] * 4
    assert "circuit breaker open" in out[2][1]["detail"]
    assert out[3][-1] == 2 and out[4][1]["status"] == "degraded"


async def test_overload_sheds_with_retry_after():
    async def scenario(s):
        first = asyncio.ensure_future(s.post("list all pods"))
        await asyncio.wait_for(s.engine.started.wait(), 5.0)
        shed = await s.post("list all nodes")
        s.engine.gate.set()
        return [shed, await first]

    out = await run_both(scenario, {"max_inflight_requests": 1}, gate=True)
    assert out[0][0] == 503 and out[0][2]["Retry-After"] == "1"
    assert out[1][0] == 200


@pytest.mark.parametrize("outcome,status", [
    ("rm -rf /", 422), ("```bash\nkubectl get nodes -o wide\n```", 200),
    (("EngineUnavailable", "down"), 503),
    (("EngineOverloaded", "queue full"), 503),
    (("RequestQuarantined", "bad"), 410),
    (("GenerationTimeout", "slow"), 504),
    (("RuntimeError", "kaboom"), 500)],
    ids=["unsafe", "fenced", "unavailable", "overloaded", "quarantined",
         "timeout", "bug"])
async def test_engine_outcome_status(outcome, status):
    async def scenario(s):
        return [await s.post("list pods"),
                await s.post("ab"),
                await s.send("POST", "/kubectl-command", json={"q": "x"})]

    out = await run_both(scenario, script=[outcome])
    assert [o[0] for o in out] == [status, 400, 400]


@pytest.mark.parametrize("outcome,events", [
    ("kubectl get pods -o wide", ["done"]),
    ("kubectl get pods; rm -rf /", ["error"]),
    (("RuntimeError", "boom"), ["error"]),
    (("EngineUnavailable", "down"), ["error"])],
    ids=["done", "unsafe", "bug", "unavailable"])
async def test_stream_events(outcome, events):
    async def scenario(s):
        return [await s.post("wide pods", path="/kubectl-command/stream")]

    out = await run_both(scenario, script=[outcome])
    assert out[0][0] == 200
    assert re.findall(r"event: (\w+)", out[0][1]) == events


async def test_stream_degraded_event():
    async def scenario(s):
        return [await s.post("list all pods",
                             path="/kubectl-command/stream")]

    out = await run_both(scenario, {"degraded_fallback": True},
                         script=[("EngineUnavailable", "down")])
    assert re.findall(r"event: (\w+)", out[0][1]) == ["degraded", "done"]


@pytest.fixture
def kubectl_on_path(fake_kubectl, monkeypatch):
    monkeypatch.setenv("PATH", str(Path(fake_kubectl).parent)
                       + os.pathsep + os.environ.get("PATH", ""))


@pytest.mark.parametrize("mode,command,status", [
    ("table", "kubectl get pods", 200),
    ("json", "kubectl get pods -o json", 200),
    ("error", "kubectl get pods", 200),
    ("table", "kubectl get pods; ls", 400),
    ("slow", "kubectl get pods", 200)],
    ids=["table", "json", "kubectl_error", "unsafe", "timeout"])
async def test_execute(kubectl_on_path, monkeypatch, mode, command, status):
    monkeypatch.setenv("FAKE_KUBECTL_MODE", mode)
    monkeypatch.setenv("FAKE_KUBECTL_SLEEP", "5")

    async def scenario(s):
        return [await s.send("POST", "/execute",
                             json={"execute": command})]

    # A short timeout only where the run must time out: a loaded host
    # can take longer than that to start the fake kubectl.
    out = await run_both(scenario, {"execution_timeout":
                                    0.3 if mode == "slow" else 30.0})
    assert out[0][0] == status
    if mode == "timeout":
        assert out[0][1]["execution_error"]["type"] == "timeout"


def _families(text):
    return {f.name: f for f in text_string_to_metric_families(text)}


async def test_metrics_names_and_label_cardinality():
    """Every family the port exports exists in the JAX app's export with
    the same type, help and label names; the request, cache, rate-limit
    and breaker series hold the same values after the same traffic; and
    scanner 404s collapse into one ``unmatched`` handler label."""
    async def scenario(s):
        await s.post("list pods")
        await s.post("list pods")
        await s.post("rm everything")
        for path in ("/wp-admin.php", "/.env", "/random/deep/path-123"):
            await s.send("GET", path)
        await s.send("GET", "/health")
        return [await (await s.client.get("/metrics")).text()]

    texts = []

    async def capture(s):
        texts.append((await scenario(s))[0])
        return []

    await run_both(capture, {"rate_limit": "2/minute"},
                   default="rm -rf /")
    ours, theirs = _families(texts[0]), _families(texts[1])
    assert len(ours) >= 20
    for name, fam in ours.items():
        jfam = theirs[name]
        assert (fam.type, fam.documentation) == (jfam.type,
                                                 jfam.documentation), name
        assert ({frozenset(s.labels) for s in fam.samples}
                <= {frozenset(s.labels) for s in jfam.samples}
                or not fam.samples), name

    def values(fams, name):
        return sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                      for s in fams[name].samples
                      if not s.name.endswith("_created"))

    for name in ("http_requests", "response_cache_hits",
                 "response_cache_misses", "rate_limited",
                 "unsafe_commands", "breaker_state"):
        assert values(ours, name) == values(theirs, name), name
    handlers = {s.labels["handler"] for s in ours["http_requests"].samples}
    assert "unmatched" in handlers and "/health" in handlers
    assert not any("wp-admin" in h or "path-123" in h for h in handlers)


async def test_openapi_per_path():
    """The port documents every path the JAX document does (the routes
    it serves), each with the JAX document's methods, status codes,
    content types and schema references; the referenced schemas are the
    JAX ones (their descriptions are each package's own words); both are
    served without the key."""
    docs = []

    async def scenario(s):
        docs.append(await (await s.client.get("/openapi.json")).json())
        return [(await s.send("GET", "/openapi.json"))[0],
                (await s.send("GET", "/docs"))[0]]

    assert await run_both(scenario, {"api_auth_key": "k"}) == [200, 200]
    ours, theirs = docs

    def undescribed(obj):
        if isinstance(obj, dict):
            return {k: undescribed(v) for k, v in obj.items()
                    if k != "description"}
        if isinstance(obj, list):
            return [undescribed(v) for v in obj]
        return obj

    def shape(op):
        return {
            "body": undescribed(op.get("requestBody")),
            "responses": {code: r.get("content")
                          for code, r in op["responses"].items()},
        }

    assert set(ours["paths"]) == set(theirs["paths"])
    assert {"/kubectl-command", "/kubectl-command/stream", "/execute",
            "/health", "/metrics", "/admin/rollout"} <= set(ours["paths"])
    for path, item in ours["paths"].items():
        assert set(item) == set(theirs["paths"][path]), path
        for method, op in item.items():
            assert shape(op) == shape(theirs["paths"][path][method]), path
    for name, schema in ours["components"]["schemas"].items():
        assert undescribed(schema) == undescribed(
            theirs["components"]["schemas"][name]), name
    assert ours["info"]["title"] == theirs["info"]["title"]
    assert ours["security"] == theirs["security"]


# ------------------------------- the copied modules, unit by unit

def _both(name):
    """The port's module and the JAX package's of the same name."""
    import importlib

    return (importlib.import_module(f"ai_agent_kubectl_tpu_torch.{name}"),
            importlib.import_module(f"ai_agent_kubectl_tpu.{name}"))


def _clocked(cls, *args, **kw):
    clock = [0.0]
    return cls(*args, timer=lambda: clock[0], **kw), clock


def _ttl_script(mod):
    c, clock = _clocked(mod.TTLCache, 2, 10.0)
    out = []
    for op, key, at in [("put", "a", 0), ("get", "a", 9.9), ("get", "a", 10),
                        ("put", "a", 11), ("put", "b", 11), ("get", "a", 12),
                        ("put", "c", 12), ("get", "b", 12), ("get", "c", 13),
                        ("len", None, 30)]:
        clock[0] = at
        out.append(len(c) if op == "len" else
                   c.get(key) if op == "get" else c.put(key, f"v-{key}"))
    return out + [c.hits, c.misses, c.evictions]


def _limiter_script(mod):
    rl, clock = _clocked(mod.SlidingWindowLimiter, 3, 60.0)
    out = []
    for key, at in [("a", 0), ("a", 1), ("a", 2), ("a", 3), ("b", 3),
                    ("a", 60.01), ("a", 61.5)]:
        clock[0] = at
        allowed, remaining, retry = rl.check(key)
        out.append((allowed, remaining, round(retry, 6),
                    rl.headers(remaining, retry)))
    out.append([mod.client_key("9.9.9.9", xff, trust)
                for xff in (None, "1.1.1.1, 10.0.0.1", " , ")
                for trust in (False, True)])
    return out


def _breaker_script(mod):
    br, clock = _clocked(mod.CircuitBreaker, threshold=2, window_secs=30.0,
                         recovery_secs=15.0)
    out = []
    stale = token = br.begin()
    for step, at in [("fail", 0), ("fail", 1), ("begin", 2), ("begin", 16),
                     ("begin", 16.5), ("fail", 17), ("begin", 33),
                     ("ok", 33), ("stale_ok", 34), ("fail", 35),
                     ("begin", 36)]:
        clock[0] = at
        if step == "begin":
            token = br.begin()
            out.append(token)
        elif step == "fail":
            br.record_failure(br.begin() if br.state == "closed" else token)
        elif step == "ok":
            br.record_success(token)
        else:
            br.record_success(stale)      # a call from before the outage
        out.append((br.state, br.state_code, br.opens, br.recent_failures))
    return out + [mod.STATE_CODES]


def _trace_script(mod):
    t = mod.Trace("abc123", "POST", "/kubectl-command")
    t.add_span("queue_wait", t.t0, t.t0 + 0.0012)
    t.add_span("decode", t.t0 + 0.0012, t.t0 + 0.1)
    t.add_span("decode", t.t0 + 0.1, t.t0 + 0.2)
    t.event("cache: miss", slot=3)
    t.finish(status=200)
    d = t.to_dict()
    rec = mod.FlightRecorder(size=3)
    for i in range(5):
        r = mod.Trace(f"rid-{i}")
        r.finish(status=200 + i)
        rec.record(r)
    dup = mod.Trace("rid-4")
    dup.finish(status=500)
    rec.record(dup)
    return [t.server_timing(), sorted(t.phase_durations()),
            [(sp["phase"], sp["start_ms"], sp["end_ms"]) for sp in d["spans"]],
            [(e["message"], e["meta"]) for e in d["events"]],
            [mod.sanitize_request_id(x) for x in
             ("abc-DEF_1.2", None, "", "x" * 65, "evil\nheader", "späce")],
            len(mod.new_request_id()), mod.PHASES,
            [(e["request_id"], e["status"], e["n_spans"])
             for e in rec.list()], rec.recorded, len(rec)]


def _executor_script(mod):
    return [mod.parse_kubectl_stdout(text) for text in (
        "NAME       READY   STATUS    NOMINATED NODE\n"
        "web-1      1/1     Running   node a1\n"
        "db-0       1/1     Running   <none>\n",
        "pod/web created", '{"kind": "List", "items": []}',
        "some text\nthat is not a table", "", "[1, 2")]


def _windowed_script(mod):
    rate, clock = _clocked(mod.WindowedRate, window_secs=60.0)
    out = [rate.rate()]
    for count, dt in [(120, 0), (60, 30), (0, 31), (0, 120)]:
        clock[0] += dt
        rate.add(count)
        out.append(rate.rate())
    return out


UNIT_SCRIPTS = {
    "ttl_cache": ("server.cache", _ttl_script),
    "rate_limiter": ("server.ratelimit", _limiter_script),
    "breaker": ("server.breaker", _breaker_script),
    "trace_and_recorder": ("obs", _trace_script),
    "table_parser": ("server.executor", _executor_script),
    "windowed_rate": ("server.metrics", _windowed_script),
}


@pytest.mark.parametrize("name", sorted(UNIT_SCRIPTS))
def test_copied_module_behaves_as_the_jax_one(name):
    """The same operations on an injected clock give the same outputs
    from the port's copy and the JAX package's module."""
    module, script = UNIT_SCRIPTS[name]
    ours, theirs = _both(module)
    got = script(ours)
    assert got == script(theirs)
    assert got                                 # the script ran


@pytest.mark.parametrize("query", [
    "list all pods", "show the nodes please", "get deployments in prod",
    "show services", "list namespaces", "get logs of web-1",
    "logs for db-0 please", "describe pod api-7", "delete pod web-1",
    "scale deployment api to 5", "why is the sky blue"])
async def test_fallback_rules_match_the_jax_read_only_table(query):
    from ai_agent_kubectl_tpu.engine import fallback as jax_fallback
    from ai_agent_kubectl_tpu_torch.engine.fallback import FallbackEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt

    res = await FallbackEngine().generate(render_prompt(query))
    assert res.text == jax_fallback.rule_command(
        query, rules=jax_fallback.READ_ONLY_RULES)
    assert res.engine == "fallback-rules"
    assert not res.text.startswith(("kubectl delete", "kubectl scale"))


async def test_single_flight_coalesces_and_recovers_as_the_jax_one():
    """Five concurrent misses make one call in both packages; a failed
    computation is not cached and every waiter sees it."""
    outs = []
    for mod in _both("server.cache"):
        csf = mod.CachedSingleFlight(maxsize=10, ttl=100.0)
        calls = [0]
        gate = asyncio.Event()

        async def supplier():
            calls[0] += 1
            await asyncio.wait_for(gate.wait(), 30.0)
            return "kubectl get pods"

        tasks = [asyncio.ensure_future(csf.get_or_create("q", supplier))
                 for _ in range(5)]
        await asyncio.sleep(0.01)
        gate.set()
        results = await asyncio.gather(*tasks)

        async def boom():
            raise RuntimeError("no")

        with pytest.raises(RuntimeError):
            await csf.get_or_create("r", boom)
        value = await csf.get_or_create("r", supplier)
        outs.append((calls[0], sorted(results), value))
    assert outs[0] == outs[1]
    assert outs[0][0] == 2


# ---------------------------------------- a real checkpoint through HTTP

TOKENIZER_ASSET = (Path(__file__).resolve().parent.parent
                   / "ai_agent_kubectl_tpu_torch" / "assets"
                   / "tokenizer-k8s.json")
QUERIES = ["get pods", "list all services in kube-system"]


def _save_tiny_llama(path, vocab_size):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=vocab_size, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False)
    torch.manual_seed(7)
    transformers.LlamaForCausalLM(hf_cfg).eval().to(
        torch.float32).save_pretrained(path, safe_serialization=True)


async def _serve(engine, cfg, create):
    """Greedy transcripts of QUERIES through the engine, and the served
    statuses of the first query (plain and stream) over HTTP."""
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt

    async with TestClient(TestServer(create(cfg, engine))) as client:
        texts = []
        for q in QUERIES:
            res = await engine.generate(render_prompt(q), max_tokens=8,
                                        temperature=0.0)
            texts.append((res.text, res.prompt_tokens,
                          res.completion_tokens))
        r = await client.post("/kubectl-command",
                              json={"query": QUERIES[0]})
        s = await client.post("/kubectl-command/stream",
                              json={"query": QUERIES[1]})
        events = re.findall(r"event: (\w+)", await s.text())
        return texts, r.status, events, engine.weights_version


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "single"])
async def test_checkpoint_and_bpe_tokenizer_through_http(tmp_path,
                                                         batched):
    """MODEL_PATH + TOKENIZER_PATH resolved inside each engine's own
    startup: the port's transcripts on the loaded tiny Llama equal the
    JAX batched engine's byte for byte, and the HTTP routes answer."""
    from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
    from ai_agent_kubectl_tpu.models.config import ModelConfig as JaxMC
    from ai_agent_kubectl_tpu_torch.engine.batcher import \
        BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import HFTokenizer
    from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
    from ai_agent_kubectl_tpu_torch.models.config import ModelConfig

    vocab = HFTokenizer(TOKENIZER_ASSET, 1, (2,), 0).vocab_size
    _save_tiny_llama(tmp_path, vocab)
    shape = dict(name="tiny-llama-http", vocab_size=vocab, dim=64,
                 n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                 mlp_hidden=176, rope_theta=10000.0, rms_eps=1e-5,
                 bos_id=1, eos_ids=(2,), pad_id=0, max_seq_len=2048)
    common = dict(model_path=str(tmp_path),
                  tokenizer_path=str(TOKENIZER_ASSET), dtype="float32",
                  max_seq_len=256, prefill_buckets=(128,))
    jeng = BatchedJaxEngine(JaxMC(**shape), attn_impl="dense",
                            batch_size=2, chunk_len=4, **common)
    want = await _serve(jeng, JaxServiceConfig(engine="jax",
                                               max_new_tokens=8),
                        jax_create_app)
    if batched:
        ours = BatchedTorchEngine(ModelConfig(**shape), batch_size=2,
                                  chunk_len=4, device="cpu", **common)
    else:
        ours = TorchEngine(ModelConfig(**shape), device="cpu", **common)
    got = await _serve(ours, ServiceConfig(torch_device="cpu",
                                           max_new_tokens=8), create_app)
    assert isinstance(ours.tokenizer, HFTokenizer)
    assert got[0] == want[0]                   # transcripts, token counts
    assert got[1] == want[1] and got[1] in (200, 422)
    assert got[2] == want[2] and got[2][-1] in ("done", "error")
    assert got[3] == want[3]                   # X-Model-Version
