"""The port's ``/debug/*`` routes, ``/health`` sections and telemetry
metric families against the JAX app, on the CPU.

Both apps serve their real batched engine on toy-8m behind an API key
and a debug token. Every ``/debug/*`` route answers the JAX app's
statuses through the token matrix of the JAX ``tests/test_sentinel.py``
(401 without the key, 403 without or with a wrong token, the route's
own status with both) and, with both, the same JSON keys; the unknown
ids answer 404; an incident bundle carries the JAX bundle's keys.
``/health``'s ``slo``, ``steptime`` and ``incidents`` sections have the
JAX keys, and ``/metrics`` the JAX telemetry families. ``/debug/ledger``
answers 404 on both single-sequence engines. A ``/debug/profile``
capture on the port's CPU engine, taken while a request decodes, is a
trace directory ``attribute_trace`` parses.
"""

import asyncio

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.jax_engine import JaxEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.server.app import create_app as jax_create_app
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.obs.attribution import (attribute_trace,
                                                         validate_attribution)
from ai_agent_kubectl_tpu_torch.server.app import create_app

torch.set_num_threads(1)

COMMON = dict(dtype="float32", max_seq_len=64, prefill_buckets=(16,),
              prefix_cache=False)
CFG = dict(api_auth_key="api-key-1", debug_token="debug-token-1",
           rate_limit="1000/minute", max_new_tokens=6,
           sentinel_eval_secs=0.0)
KEY = {"X-API-Key": "api-key-1"}
BOTH = {"X-API-Key": "api-key-1", "X-Debug-Token": "debug-token-1"}

DEBUG_ROUTES = [
    ("GET", "/debug/requests"),
    ("GET", "/debug/requests/some-id"),
    ("GET", "/debug/chunks"),
    ("GET", "/debug/ledger"),
    ("GET", "/debug/incidents"),
    ("GET", "/debug/incidents/some-id"),
    ("POST", "/debug/profile?seconds=0.1"),
    ("POST", "/debug/trace?seconds=0.1"),
]
#: the telemetry families the port emits, each by its exposition name
TELEMETRY_FAMILIES = {
    "engine_batch_occupancy", "engine_queue_depth", "engine_kv_pages_used",
    "engine_kv_pages_total", "decode_pipe_occupancy", "decode_pipe_depth",
    "decode_device_active_slots", "wasted_decode_steps",
    "decode_chunks", "chunk_fetch_seconds", "goodput_steps",
    "goodput_ratio", "slo_burn_rate", "slo_error_budget_remaining",
    "slo_breaches", "step_time_seconds", "step_tokens_per_sec",
    "steptime_breach_trips", "incidents_captured", "incidents_suppressed",
}


def _keys(body):
    return sorted(body) if isinstance(body, dict) else type(body).__name__


def _shape(body):
    """A body's keys, and one level down for dict values."""
    if not isinstance(body, dict):
        return type(body).__name__
    return {k: _keys(v) for k, v in body.items()}


async def _drive(app):
    out = {}
    async with TestClient(TestServer(app)) as c:
        r = await c.post("/kubectl-command", json={"query": "list the pods"},
                         headers=KEY)
        rid = r.headers["X-Request-ID"]
        out["generate"] = r.status
        for method, path in DEBUG_ROUTES:
            req = getattr(c, method.lower())
            statuses = [(await req(path)).status,
                        (await req(path, headers=KEY)).status,
                        (await req(path, headers=dict(
                            KEY, **{"X-Debug-Token": "wrong"}))).status]
            r = await req(path, headers=BOTH)
            statuses.append(r.status)
            out[path.split("?")[0]] = (statuses, _keys(await r.json()))
        r = await c.get(f"/debug/requests/{rid}", headers=BOTH)
        out["request_detail"] = (r.status, _keys(await r.json()))
        chunks = await (await c.get("/debug/chunks", headers=BOTH)).json()
        out["chunk_events"] = sorted({(e["event"], tuple(sorted(e)))
                                      for e in chunks["events"]
                                      if e["event"] in ("dispatch",
                                                        "consume")})
        out["pipeline"] = sorted(chunks["pipeline"])
        ledger = await (await c.get("/debug/ledger", headers=BOTH)).json()
        out["ledger"] = _shape(ledger)
        svc = app["service"]
        bundle = svc.incidents.maybe_capture(
            "breaker_open", {"breaker": "open"}, svc._incident_bundle)
        r = await c.get(f"/debug/incidents/{bundle['id']}", headers=BOTH)
        out["incident"] = (r.status, _keys(await r.json()))
        listing = await (await c.get("/debug/incidents",
                                     headers=BOTH)).json()
        out["incident_list"] = [_keys(e) for e in listing["incidents"]]
        health = await (await c.get("/health")).json()
        out["health"] = {k: _keys(health[k])
                         for k in ("slo", "steptime", "incidents")}
        text = await (await c.get("/metrics")).text()
        out["families"] = {f.name for f in
                           text_string_to_metric_families(text)}
    return out


@pytest.fixture(scope="module")
def answers():
    """Both apps' answers over their real batched engines."""
    async def run():
        port = await _drive(
            create_app(ServiceConfig(torch_device="cpu", **CFG),
                       BatchedTorchEngine(get_config("toy-8m"),
                                          tokenizer=ByteTokenizer(),
                                          device="cpu", batch_size=2,
                                          chunk_len=4, chunk_pipe_depth=3,
                                          **COMMON)))
        jax_side = await _drive(
            jax_create_app(JaxServiceConfig(engine="fake", **CFG),
                           BatchedJaxEngine(jconfig.get_config("toy-8m"),
                                            tokenizer=JaxByteTokenizer(),
                                            compile_cache_dir="",
                                            chunk_pipe_depth=3,
                                            batch_size=2, chunk_len=4,
                                            **COMMON)))
        return port, jax_side

    return asyncio.run(run())


@pytest.mark.parametrize("method,path", DEBUG_ROUTES,
                         ids=[p.split("?")[0] for _, p in DEBUG_ROUTES])
def test_debug_route_answers_as_the_jax_app(answers, method, path):
    port, jax_side = answers
    key = path.split("?")[0]
    assert port[key] == jax_side[key]
    statuses, _ = port[key]
    assert statuses[:3] == [401, 403, 403]
    assert statuses[3] == (404 if key.endswith("some-id") else 200)


@pytest.mark.parametrize("what", ["request_detail", "chunk_events",
                                  "pipeline", "ledger", "incident",
                                  "incident_list", "health"])
def test_debug_bodies_and_health_sections_have_the_jax_keys(answers, what):
    port, jax_side = answers
    assert port["generate"] == jax_side["generate"]
    assert port[what] == jax_side[what]
    if what == "chunk_events":
        assert {e for e, _ in port[what]} >= {"dispatch", "consume"}
    if what == "incident":
        assert port[what][0] == 200 and "config_fingerprint" in port[what][1]


def test_metrics_have_the_jax_telemetry_families(answers):
    port, jax_side = answers
    assert TELEMETRY_FAMILIES <= port["families"]
    assert TELEMETRY_FAMILIES <= jax_side["families"]
    assert port["families"] <= jax_side["families"]


async def test_debug_ledger_answers_404_on_the_single_sequence_engines():
    outs = []
    for create, config, engine in (
            (create_app, ServiceConfig(torch_device="cpu", **CFG),
             TorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                         device="cpu", **COMMON)),
            (jax_create_app, JaxServiceConfig(engine="fake", **CFG),
             JaxEngine(jconfig.get_config("toy-8m"),
                       tokenizer=JaxByteTokenizer(), compile_cache_dir="",
                       **COMMON))):
        async with TestClient(TestServer(create(config, engine))) as c:
            r = await c.get("/debug/ledger", headers=BOTH)
            chunks = await c.get("/debug/chunks", headers=BOTH)
            outs.append((r.status, await r.json(), chunks.status,
                         await chunks.json()))
    assert outs[0] == outs[1]
    assert outs[0][0] == 404 and outs[0][2] == 200


async def test_debug_profile_on_a_cpu_engine_is_a_parsable_trace():
    """A capture while a request decodes: the trace directory holds the
    scheduler thread's scoped host ops, which attribution bills."""
    engine = BatchedTorchEngine(get_config("toy-8m"),
                                tokenizer=ByteTokenizer(), device="cpu",
                                batch_size=2, chunk_len=4, **COMMON)
    cfg = ServiceConfig(torch_device="cpu", **dict(CFG, max_new_tokens=48))
    async with TestClient(TestServer(create_app(cfg, engine))) as c:
        gen = asyncio.ensure_future(c.post(
            "/kubectl-command", json={"query": "show every node"},
            headers=KEY))
        r = await c.post("/debug/profile?seconds=0.5", headers=BOTH)
        body = await r.json()
        busy = await c.post("/debug/profile?seconds=0.1", headers=BOTH)
        await gen
    assert r.status == 200 and sorted(body) == ["seconds", "trace_dir"]
    assert busy.status in (200, 409)
    art = attribute_trace(body["trace_dir"], 1)
    validate_attribution(art)
    assert art["span_source"] == "host_ops" and art["n_device_spans"] > 0
    assert art["coverage_pct"] > 0
