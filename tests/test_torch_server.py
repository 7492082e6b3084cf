"""The port's server on the CPU: ``POST /kubectl-command`` and
``GET /health`` through the aiohttp test client, with ``toy-8m`` served
by the batched engine; the request pipeline's status decisions held
against the JAX service's output parser; auth and the default rate limit
answered as the JAX app answers them (the port once served requests
without the key and never rate-limited); and the config: the JAX knob
names it reads, and every JAX knob whose feature it does not serve
refused at boot."""

import re
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

from ai_agent_kubectl_tpu import config as jax_config
from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine import protocol as jax_protocol
from ai_agent_kubectl_tpu.server.app import create_app as jax_create_app
from ai_agent_kubectl_tpu.server.ratelimit import (
    SlidingWindowLimiter as JaxLimiter)

from ai_agent_kubectl_tpu.server.output_parser import (
    UnsafeCommandError as JaxUnsafe)
from ai_agent_kubectl_tpu.server.output_parser import (
    parse_llm_output as jax_parse)
from ai_agent_kubectl_tpu.server.schemas import (
    CommandResponse as JaxCommandResponse)
from ai_agent_kubectl_tpu_torch import config as port_config
from ai_agent_kubectl_tpu_torch.config import UNSERVED_KNOBS, ServiceConfig
from ai_agent_kubectl_tpu_torch.engine import protocol as port_protocol
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.protocol import (
    EngineOverloaded, EngineResult, EngineUnavailable, GenerationTimeout,
    RequestQuarantined)
from ai_agent_kubectl_tpu_torch.server.app import create_app
from ai_agent_kubectl_tpu_torch.server.ratelimit import SlidingWindowLimiter
from ai_agent_kubectl_tpu_torch.server.factory import (DegradedEngine,
                                                      build_engine)
from ai_agent_kubectl_tpu_torch.server.service import status_for_text
from test_torch_env import knob_env  # noqa: F401  (autouse)

TEXTS = ["kubectl get pods", "```bash\nkubectl get nodes -o wide\n```",
         "$ kubectl describe deploy web\nthis lists it", "rm -rf /",
         "kubectl get pods | grep web", "kubectl exec -it web -- sh",
         "", "kubectl get pods 'unclosed", "::::::::", "kubectl logs db-0"]


def _jax_status(text: str) -> int:
    try:
        jax_parse(text)
    except JaxUnsafe:
        return 422
    return 200


@pytest.mark.parametrize("text", TEXTS)
def test_status_decision_matches_jax_service(text):
    assert status_for_text(text) == _jax_status(text)


class ScriptedEngine:
    """Answers every prompt with one fixed text (or raises)."""

    name = "scripted"
    ready = True
    device = None

    def __init__(self, outcome):
        self.outcome = outcome

    async def start(self):
        pass

    async def stop(self, drain_secs=0.0):
        pass

    async def generate(self, prompt, **kw):
        if isinstance(self.outcome, BaseException):
            raise self.outcome
        return EngineResult(text=self.outcome, completion_tokens=3,
                            engine=self.name)


@pytest.mark.parametrize("outcome,status", [
    ("kubectl get pods", 200), ("rm -rf /", 422),
    (EngineOverloaded("full"), 503), (EngineUnavailable("down"), 503),
    (RequestQuarantined("bad"), 410), (GenerationTimeout("slow"), 504),
    (KeyError("bug"), 500)])
async def test_route_status_mapping(outcome, status):
    app = create_app(ServiceConfig(torch_device="cpu"),
                     ScriptedEngine(outcome))
    async with TestClient(TestServer(app)) as client:
        r = await client.post("/kubectl-command",
                              json={"query": "list pods"})
        body = await r.json()
        assert r.status == status, body
        if status == 200:
            assert set(body) == set(JaxCommandResponse.model_fields)
            assert body["kubectl_command"] == "kubectl get pods"
            assert body["engine_metadata"]["completion_tokens"] == 3
        else:
            assert set(body) == {"detail"}


async def test_server_with_batched_engine_on_cpu():
    cfg = ServiceConfig(torch_device="cpu", max_new_tokens=8,
                        max_seq_len=512, prefill_buckets="64,128")
    engine = build_engine(cfg)
    assert engine.name == "torch-batched"
    texts = []
    inner_generate = engine.generate

    async def recording(prompt, **kw):
        res = await inner_generate(prompt, **kw)
        texts.append(res.text)
        return res

    engine.generate = recording
    async with TestClient(TestServer(create_app(cfg, engine))) as client:
        r = await client.get("/health")
        health = await r.json()
        assert r.status == 200 and health["engine_ready"]
        assert health["devices"] == 1 and health["model"] == "toy-8m"
        assert health["kv_pool"]["attention_regime"] == "ragged"
        r = await client.post("/kubectl-command",
                              json={"query": "list all pods"})
        body = await r.json()
        assert r.status in (200, 422)
        assert r.status == _jax_status(texts[-1]), body
        for bad in ({"query": "ab"}, {"query": "  a   "}, {"q": "x"}):
            r = await client.post("/kubectl-command", json=bad)
            assert r.status == 400
            assert "detail" in await r.json()
        r = await client.post("/kubectl-command", data=b"not json")
        assert r.status == 400


async def test_degraded_engine_answers_503():
    """An engine that cannot be built (here: a model the registry does
    not know) leaves the server up but degraded: it answers 503 and its
    log says why."""
    cfg = ServiceConfig(torch_device="cpu", decode_batch_size=1,
                        model_name="no-such-model")
    engine = build_engine(cfg)
    assert isinstance(engine, DegradedEngine)
    assert "Unknown model 'no-such-model'" in engine.reason
    app = create_app(cfg, engine)
    async with TestClient(TestServer(app)) as client:
        r = await client.get("/health")
        assert r.status == 503
        r = await client.post("/kubectl-command",
                              json={"query": "list pods"})
        assert r.status == 503


def test_config_reads_the_jax_knob_names(monkeypatch):
    for key, val in {"ENGINE": "torch-batched", "TORCH_DEVICE": "cpu",
                     "MODEL_NAME": "gemma-2b-it", "DECODE_BATCH_SIZE": "4",
                     "KV_POOL_PAGE": "32", "PREFILL_BUCKETS": "128,64",
                     "RADIX_CACHE": "false", "MAX_NEW_TOKENS": "16",
                     "MODEL_PATH": "/ckpt", "API_AUTH_KEY": "sekrit",
                     "CACHE_MAXSIZE": "7", "CACHE_TTL": "45",
                     "RATE_LIMIT": "5 per 30 second",
                     "EXECUTION_TIMEOUT": "3", "TRUST_PROXY": "true",
                     "MAX_INFLIGHT_REQUESTS": "3",
                     "DEGRADED_FALLBACK": "true", "BREAKER_THRESHOLD": "2",
                     "BREAKER_WINDOW_SECS": "9",
                     "BREAKER_RECOVERY_SECS": "4",
                     "FLIGHT_RECORDER_SIZE": "16"}.items():
        monkeypatch.setenv(key, val)
    cfg = ServiceConfig.from_env()
    assert (cfg.engine, cfg.torch_device, cfg.model_name) == (
        "torch-batched", "cpu", "gemma-2b-it")
    assert cfg.decode_batch_size == 4 and cfg.kv_pool_page == 32
    assert cfg.prefill_bucket_list == (64, 128)
    assert not cfg.radix_cache and cfg.max_new_tokens == 16
    assert cfg.model_path == "/ckpt"
    assert cfg.auth_enabled and cfg.api_auth_key == "sekrit"
    assert (cfg.cache_maxsize, cfg.cache_ttl) == (7, 45.0)
    assert (cfg.rate_limit_count, cfg.rate_limit_window) == (5, 30.0)
    assert cfg.execution_timeout == 3.0 and cfg.trust_proxy_headers
    assert cfg.max_inflight_requests == 3 and cfg.degraded_fallback
    assert (cfg.breaker_threshold, cfg.breaker_window_secs,
            cfg.breaker_recovery_secs) == (2, 9.0, 4.0)
    assert cfg.flight_recorder_size == 16
    # TRUST_PROXY_HEADERS wins over its alias, as in the JAX package
    monkeypatch.setenv("TRUST_PROXY_HEADERS", "false")
    assert not ServiceConfig.from_env().trust_proxy_headers
    monkeypatch.setenv("RATE_LIMIT", "often")
    with pytest.raises(ValueError, match="rate limit"):
        ServiceConfig.from_env()
    monkeypatch.setenv("RATE_LIMIT", "10/minute")
    monkeypatch.setenv("KV_POOL", "false")
    monkeypatch.setenv("DECODE_ATTN", "paged")
    monkeypatch.setenv("KV_PAGE_SIZE", "64")
    cfg = ServiceConfig.from_env()
    assert not cfg.kv_pool and cfg.decode_attn == "paged"
    assert cfg.kv_page_size == 64
    monkeypatch.setenv("RAGGED_ATTENTION", "on")
    with pytest.raises(ValueError, match="KV_POOL"):
        ServiceConfig.from_env()
    monkeypatch.setenv("KV_POOL", "true")
    assert ServiceConfig.from_env().ragged_attention == "on"
    monkeypatch.setenv("DECODE_ATTN", "flash")
    with pytest.raises(ValueError, match="DECODE_ATTN"):
        ServiceConfig.from_env()


def test_config_defaults_match_the_jax_package():
    """The knobs both packages read start from the same defaults."""
    ours, theirs = ServiceConfig(), JaxServiceConfig()
    for name in ("api_auth_key", "cache_maxsize", "cache_ttl",
                 "llm_timeout", "execution_timeout", "rate_limit",
                 "trust_proxy_headers", "max_inflight_requests",
                 "degraded_fallback", "breaker_threshold",
                 "breaker_window_secs", "breaker_recovery_secs",
                 "flight_recorder_size", "max_queue_depth",
                 "rate_limit_count", "rate_limit_window",
                 "drain_timeout_secs", "max_new_tokens", "model_path"):
        assert getattr(ours, name) == getattr(theirs, name), name


#: the DCN and distributed knobs, refused until the port served them: a
#: value that asks for the feature, read into the field the JAX from_env
#: fills (MESH_SHAPE serves every axis: tests/test_torch_tp.py boots
#: them; the two-process runs are tests/test_torch_dcn.py's)
DCN_KNOBS = [
    ("DCN_MESH_SHAPE", "data:2", "dcn_mesh_shape"),
    ("DISTRIBUTED_INIT", "true", "distributed_init"),
    ("COORDINATOR_ADDRESS", "h:1", "coordinator_address"),
    ("NUM_PROCESSES", "2", "num_processes"),
    ("PROCESS_ID", "1", "process_id"),
]


@pytest.mark.parametrize("knob,value,field",
                         DCN_KNOBS + [("SPEC_DECODE", "true", None)])
def test_config_reads_the_dcn_knobs_as_the_jax_package(monkeypatch, knob,
                                                       value, field):
    """Each DCN knob parses into the JAX field's value (its default
    too); ``SPEC_DECODE`` with a DCN data axis refuses with the JAX
    message."""
    assert knob not in UNSERVED_KNOBS
    if field is None:
        monkeypatch.setenv("DCN_MESH_SHAPE", "dp=2")
        monkeypatch.setenv("SPEC_DRAFT_MODEL", "toy-8m")
        monkeypatch.setenv(knob, value)
        errors = []
        for cls in (ServiceConfig, JaxServiceConfig):
            with pytest.raises(ValueError) as e:
                cls.from_env()
            errors.append(str(e.value))
        assert errors[0] == errors[1]
        assert "DCN_MESH_SHAPE='dp=2'" in errors[0]
        return
    assert getattr(ServiceConfig.from_env(), field) == \
        getattr(JaxServiceConfig.from_env(), field)
    monkeypatch.setenv(knob, value)
    ours, theirs = ServiceConfig.from_env(), JaxServiceConfig.from_env()
    assert getattr(ours, field) == getattr(theirs, field)
    assert getattr(ours, field) != getattr(ServiceConfig(), field)


#: the fleet and rollout knobs, refused until the port served them: a
#: value that asks for the feature, read into the field the JAX from_env
#: fills, and a bad value, which both packages refuse with one message
#: (or, for the boolean, read alike)
FLEET_ROLLOUT_KNOBS = [
    ("FLEET_SIZE", "2", "fleet_size", "two"),
    ("FLEET_HEDGE_MS", "50", "fleet_hedge_ms", "soon"),
    ("FLEET_AFFINITY", "false", "fleet_affinity", "maybe"),
    ("FLEET_MIGRATION_BUDGET", "1", "fleet_migration_budget", "1.5"),
    ("FLEET_REJOIN_SECS", "5", "fleet_rejoin_secs", "later"),
    ("ROLLOUT_CANARY_SHARE", "0.5", "rollout_canary_share", "0.9"),
    ("ROLLOUT_OBSERVE_SECS", "5", "rollout_observe_secs", "-1"),
    ("ROLLOUT_BURN_GATE", "3", "rollout_burn_gate", "0.5"),
    ("ROLLOUT_STEPTIME_GATE", "2", "rollout_steptime_gate", "0.5"),
]


@pytest.mark.parametrize("knob,value,field,bad", FLEET_ROLLOUT_KNOBS)
def test_config_reads_the_fleet_and_rollout_knobs_as_the_jax_package(
        monkeypatch, knob, value, field, bad):
    assert knob not in UNSERVED_KNOBS
    assert getattr(ServiceConfig(), field) == getattr(JaxServiceConfig(),
                                                      field)
    monkeypatch.setenv(knob, value)
    ours, theirs = ServiceConfig.from_env(), JaxServiceConfig.from_env()
    assert getattr(ours, field) == getattr(theirs, field)
    assert getattr(ours, field) != getattr(ServiceConfig(), field)
    monkeypatch.setenv(knob, bad)
    outcomes = []
    for cls in (ServiceConfig, JaxServiceConfig):
        try:
            outcomes.append(("read", getattr(cls.from_env(), field)))
        except ValueError as e:
            outcomes.append(("refused", str(e)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("read" if knob == "FLEET_AFFINITY"
                              else "refused")


#: the grammar knobs, refused until the port served them: each value is
#: now read into the field the JAX from_env fills
GRAMMAR_KNOBS = [
    ("GRAMMAR_DECODE", "true", "grammar_decode", True),
    ("GRAMMAR_PROFILE", "ReadOnly", "grammar_profile", "readonly"),
    ("GRAMMAR_PROFILE", "permissive", "grammar_profile", "permissive"),
    ("GRAMMAR_FORCED_RUN_MIN", "8", "grammar_forced_run_min", 8),
]


@pytest.mark.parametrize("knob,value,field,want", GRAMMAR_KNOBS)
def test_config_reads_the_grammar_knobs_as_the_jax_package(
        monkeypatch, knob, value, field, want):
    assert knob not in UNSERVED_KNOBS
    assert getattr(ServiceConfig.from_env(), field) == \
        getattr(JaxServiceConfig.from_env(), field)
    monkeypatch.setenv(knob, value)
    ours, theirs = ServiceConfig.from_env(), JaxServiceConfig.from_env()
    assert getattr(ours, field) == want == getattr(theirs, field)


#: the decode pipeline's knobs, refused until the port served them: each
#: value is read into the field the JAX from_env fills (its default too)
PIPE_KNOBS = [
    ("CHUNK_PIPE_DEPTH", "1", "chunk_pipe_depth", 1),
    ("CHUNK_PIPE_DEPTH", "2", "chunk_pipe_depth", 2),
    ("CHUNK_PIPE_DEPTH", "", "chunk_pipe_depth", 3),
    ("DEVICE_TERMINATION", "false", "device_termination", False),
    ("DEVICE_TERMINATION", "", "device_termination", True),
]


@pytest.mark.parametrize("knob,value,field,want", PIPE_KNOBS)
def test_config_reads_the_pipe_knobs_as_the_jax_package(monkeypatch, knob,
                                                        value, field, want):
    assert knob not in UNSERVED_KNOBS
    monkeypatch.setenv(knob, value)
    ours, theirs = ServiceConfig.from_env(), JaxServiceConfig.from_env()
    assert getattr(ours, field) == want == getattr(theirs, field)


@pytest.mark.parametrize("feature", ["GRAMMAR_DECODE", "SPEC_DECODE"])
def test_host_scan_refuses_grammar_and_spec_with_the_jax_message(
        monkeypatch, feature):
    """Grammar and speculative decoding ride the chunk's carry: with
    DEVICE_TERMINATION=false both packages refuse to boot, with one
    message."""
    monkeypatch.setenv("DEVICE_TERMINATION", "false")
    monkeypatch.setenv(feature, "true")
    monkeypatch.setenv("DECODE_BATCH_SIZE", "4")
    errors = []
    for cls in (ServiceConfig, JaxServiceConfig):
        with pytest.raises(ValueError) as e:
            cls.from_env()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith(f"{feature} requires DEVICE_TERMINATION=true")


def test_batched_engine_serves_the_pipe_knobs(monkeypatch):
    """The factory's batched engine runs the depth and termination mode
    the config read, and ``stats()`` reports them."""
    monkeypatch.setenv("CHUNK_PIPE_DEPTH", "2")
    monkeypatch.setenv("DEVICE_TERMINATION", "false")
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DECODE_BATCH_SIZE", "4")
    eng = BatchedTorchEngine.from_config(ServiceConfig.from_env())
    assert (eng.chunk_pipe_depth, eng.device_termination) == (2, False)
    stats = eng.stats()
    assert (stats["pipe_depth"], stats["device_termination"]) == (2, False)


#: the containment and OpenAI knobs, refused until the port served them:
#: each value is now read into the field the JAX from_env fills
SERVED_SINCE_CONTAINMENT = [
    ("ENGINE_WATCHDOG_SECS", "30", "engine_watchdog_secs"),
    ("ENGINE_STARTUP_GRACE_SECS", "60", "engine_startup_grace_secs"),
    ("QUARANTINE_RETRY_BUDGET", "3", "quarantine_retry_budget"),
    ("ENGINE_RESET_MAX_PER_MIN", "2", "engine_reset_max_per_min"),
    ("FAULT_POINTS", "generate:error:1.0", "fault_points"),
    ("OPENAI_API_KEY", "sk-x", "openai_api_key"),
    ("OPENAI_MODEL", "gpt-4", "openai_model"),
    ("OPENAI_BASE_URL", "http://localhost:1", "openai_base_url"),
]


@pytest.mark.parametrize("knob,value,field", SERVED_SINCE_CONTAINMENT)
def test_config_reads_the_containment_and_openai_knobs(monkeypatch, knob,
                                                       value, field):
    monkeypatch.setenv(knob, value)
    assert knob not in UNSERVED_KNOBS
    ours, theirs = ServiceConfig.from_env(), JaxServiceConfig.from_env()
    assert getattr(ours, field) == getattr(theirs, field)
    assert str(getattr(ours, field)) in (value, f"{float(value)}"
                                         if value.isdigit() else value)


#: the QoS knobs the port reads (no longer refused), each with a value
#: that asks for the feature and the field it lands in
QOS_KNOBS = [
    ("TENANT_TIERS", "key1:background", "tenant_tiers", "key1:background"),
    ("QOS_DEFAULT_LANE", "batch", "qos_default_lane", "batch"),
    ("LANE_WEIGHTS", "interactive:4", "lane_weights", "interactive:4"),
    ("TENANT_MAX_QUEUE", "8", "tenant_max_queue", 8),
    ("QOS_SESSION_TOKEN_BUDGET", "100", "qos_session_token_budget", 100),
    ("PREEMPT_WAIT_MS", "100", "preempt_wait_ms", 100.0),
    ("PREEMPT_BUDGET", "5", "preempt_budget", 5),
    ("SLO_INTERACTIVE_MS", "500", "slo_interactive_ms", 500.0),
]


@pytest.mark.parametrize("knob,value,field,want", QOS_KNOBS)
def test_config_reads_the_qos_knobs_as_the_jax_package(monkeypatch, knob,
                                                       value, field, want):
    monkeypatch.setenv(knob, value)
    assert knob not in UNSERVED_KNOBS
    ours, theirs = ServiceConfig.from_env(), JaxServiceConfig.from_env()
    assert getattr(ours, field) == want == getattr(theirs, field)
    assert ours.tenant_tier_map == theirs.tenant_tier_map
    assert ours.lane_weight_map == theirs.lane_weight_map


#: the telemetry knobs the port reads (no longer refused), each with a
#: value that asks for something other than the default, and its field
TELEMETRY_KNOBS = [
    ("LEDGER_ENABLE", "false", "ledger_enable"),
    ("SLO_TTFT_MS", "800", "slo_ttft_ms"),
    ("SLO_SESSION_TTFT_MS", "900", "slo_session_ttft_ms"),
    ("SLO_WINDOWS", "60,600", "slo_windows"),
    ("SLO_OBJECTIVE", "0.9", "slo_objective"),
    ("PERF_BASELINES", "BASELINES", "perf_baselines"),
    ("SENTINEL_ENABLE", "false", "sentinel_enable"),
    ("SENTINEL_WINDOW", "64", "sentinel_window"),
    ("SENTINEL_FACTOR", "3", "sentinel_factor"),
    ("SENTINEL_MIN_SAMPLES", "4", "sentinel_min_samples"),
    ("SENTINEL_EVAL_SECS", "1", "sentinel_eval_secs"),
    ("INCIDENT_RING", "4", "incident_ring"),
    ("INCIDENT_COOLDOWN_SECS", "5", "incident_cooldown_secs"),
    ("INCIDENT_BURN_THRESHOLD", "5", "incident_burn_threshold"),
    ("INCIDENT_PROFILE_SECS", "2", "incident_profile_secs"),
    ("INCIDENT_THRASH_MIN_BLOCKS", "2", "incident_thrash_min_blocks"),
    ("DEBUG_TOKEN", "dbg", "debug_token"),
    ("LOG_FORMAT", "JSON", "log_format"),
]


def _baselines_file(tmp_path) -> str:
    path = tmp_path / "baselines.json"
    path.write_text('{"step_time_ms": {"decode": {"default": 25}}}')
    return str(path)


@pytest.mark.parametrize("knob,value,field", TELEMETRY_KNOBS)
def test_config_reads_the_telemetry_knobs_as_the_jax_package(
        monkeypatch, tmp_path, knob, value, field):
    """Each telemetry knob is read (no longer refused) into the field the
    JAX from_env fills, with the JAX default when unset."""
    assert knob not in UNSERVED_KNOBS
    assert getattr(ServiceConfig.from_env(), field) == \
        getattr(JaxServiceConfig.from_env(), field)
    if value == "BASELINES":
        value = _baselines_file(tmp_path)
    monkeypatch.setenv(knob, value)
    ours, theirs = ServiceConfig.from_env(), JaxServiceConfig.from_env()
    assert getattr(ours, field) == getattr(theirs, field)
    assert getattr(ours, field) != getattr(ServiceConfig(), field)


#: values the JAX validation refuses, with the message it raises
BAD_TELEMETRY = [
    ("SLO_WINDOWS", "600,60", "strictly ascending"),
    ("SLO_WINDOWS", "1,2,3,4,5", "at most 4 windows"),
    ("SLO_OBJECTIVE", "1.0", "SLO_OBJECTIVE must be in"),
    ("SLO_TTFT_MS", "-1", "SLO_TTFT_MS must be >= 0"),
    ("SLO_SESSION_TTFT_MS", "-5", "SLO_SESSION_TTFT_MS must be >= 0"),
    ("SENTINEL_WINDOW", "4", "SENTINEL_WINDOW must be >= 8"),
    ("SENTINEL_FACTOR", "0.5", "SENTINEL_FACTOR must be >= 1"),
    ("SENTINEL_MIN_SAMPLES", "0", "SENTINEL_MIN_SAMPLES must be >= 1"),
    ("SENTINEL_EVAL_SECS", "-1", "SENTINEL_EVAL_SECS must be >= 0"),
    ("INCIDENT_RING", "0", "INCIDENT_RING must be >= 1"),
    ("INCIDENT_COOLDOWN_SECS", "-1", "INCIDENT_COOLDOWN_SECS must be"),
    ("INCIDENT_BURN_THRESHOLD", "-2", "INCIDENT_BURN_THRESHOLD must be"),
    ("INCIDENT_PROFILE_SECS", "31", "INCIDENT_PROFILE_SECS must be in"),
    ("INCIDENT_THRASH_MIN_BLOCKS", "-1", "INCIDENT_THRASH_MIN_BLOCKS"),
    ("PERF_BASELINES", "/nonexistent/b.json", "failed to load"),
]


@pytest.mark.parametrize("knob,value,message", BAD_TELEMETRY)
def test_bad_telemetry_knobs_raise_the_jax_errors(monkeypatch, knob, value,
                                                  message):
    monkeypatch.setenv(knob, value)
    errors = []
    for cls in (ServiceConfig, JaxServiceConfig):
        with pytest.raises(ValueError, match=message) as exc:
            cls.from_env()
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("value", ["int8", "INT8", ""])
def test_config_reads_kv_quant_as_the_jax_package(monkeypatch, value):
    """KV_QUANT is read (no longer refused) into the field the JAX
    from_env fills, lowercased the same way; another value is refused
    with the JAX engine's message."""
    monkeypatch.setenv("KV_QUANT", value)
    assert "KV_QUANT" not in UNSERVED_KNOBS
    ours, theirs = ServiceConfig.from_env(), JaxServiceConfig.from_env()
    assert ours.kv_quant == theirs.kv_quant == value.lower()
    monkeypatch.setenv("KV_QUANT", "int4")
    with pytest.raises(ValueError,
                       match="KV_QUANT must be '' or 'int8', got 'int4'"):
        ServiceConfig.from_env()


@pytest.mark.parametrize("engine", ["jax", "jax-batched"])
def test_config_refuses_the_jax_packages_engines_by_name(monkeypatch,
                                                         engine):
    monkeypatch.setenv("ENGINE", engine)
    with pytest.raises(ValueError, match=f"ENGINE={engine} "):
        ServiceConfig.from_env()


def test_config_serves_engine_fake(monkeypatch):
    """ENGINE=fake, refused by name until the port served it, boots the
    port's rule-table engine, which has no device; the batcher's fault
    points are refused under it with the JAX factory's message."""
    from ai_agent_kubectl_tpu_torch.engine.fake import FakeEngine
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine

    monkeypatch.setenv("ENGINE", "fake")
    cfg = ServiceConfig.from_env()
    assert cfg.engine == JaxServiceConfig.from_env().engine == "fake"
    assert not cfg.batched_engine
    assert isinstance(build_engine(cfg), FakeEngine)
    monkeypatch.setenv("FAULT_POINTS", "admit:error:1.0")
    with pytest.raises(ValueError, match="only wired into the continuous"):
        build_engine(ServiceConfig.from_env())


def test_config_serves_engine_openai(monkeypatch):
    """ENGINE=openai, refused by name until the port served it, boots
    with the JAX package's OpenAI knobs."""
    monkeypatch.setenv("ENGINE", "openai")
    monkeypatch.setenv("OPENAI_API_KEY", "sk-x")
    cfg = ServiceConfig.from_env()
    assert (cfg.engine, cfg.openai_api_key, cfg.openai_model) == (
        "openai", "sk-x", JaxServiceConfig.from_env().openai_model)


def _knobs_read(module) -> set:
    """The environment variables a config module's from_env reads."""
    src = Path(module.__file__).read_text()
    body = src[src.index("def from_env"):]
    return set(re.findall(r'(?:_env_\w+|os\.getenv)\(\s*"([A-Z_]+)"',
                          body))


def test_every_jax_knob_is_read_or_refused():
    """Each knob the JAX ServiceConfig.from_env reads is read by the
    port's or refused by it; only COMPILE_CACHE_DIR has no counterpart
    (nothing compiles in eager PyTorch)."""
    jax_knobs = _knobs_read(jax_config)
    assert len(jax_knobs) > 100
    ours = _knobs_read(port_config) | set(UNSERVED_KNOBS)
    assert jax_knobs - ours == {"COMPILE_CACHE_DIR"}


# ----------------------------------------------------- auth and rate limit

class StubEngine:
    """Answers every prompt with "kubectl get pods", built against one
    package's protocol module so each app gets its own result type."""

    name = "stub"
    ready = True
    device = None

    def __init__(self, protocol):
        self.protocol = protocol
        self.calls = 0

    async def start(self):
        pass

    async def stop(self, drain_secs=0.0):
        pass

    async def generate(self, prompt, **kw):
        self.calls += 1
        return self.protocol.EngineResult(text="kubectl get pods",
                                          completion_tokens=3,
                                          engine=self.name)


def _masked(body):
    """A JSON body with its timestamps and durations masked."""
    if isinstance(body, dict):
        out = {}
        for key, val in body.items():
            if key in ("start_time", "end_time", "duration_ms"):
                out[key] = "*"
            elif key == "timings" and val is not None:
                out[key] = sorted(val)
            else:
                out[key] = _masked(val)
        return out
    return body


HEADERS = ("Content-Type", "Retry-After", "X-RateLimit-Limit",
           "X-RateLimit-Remaining", "X-RateLimit-Reset", "X-Request-ID")


async def _answers(app, requests):
    """(status, masked body, headers that matter) for each request."""
    out = []
    async with TestClient(TestServer(app)) as client:
        for headers, clock_at in requests:
            app["clock"][0] = clock_at
            r = await client.post("/kubectl-command",
                                  json={"query": "list pods"},
                                  headers=dict(headers,
                                               **{"X-Request-ID": "c1"}))
            out.append((r.status, _masked(await r.json()),
                        {h: r.headers.get(h) for h in HEADERS}))
    return out


def _apps(**cfg):
    """The port's app and the JAX app, the same config and stub engine,
    each rate limiter on an injected clock."""
    apps = []
    for create, config, protocol, limiter in (
            (create_app, ServiceConfig(torch_device="cpu", **cfg),
             port_protocol, SlidingWindowLimiter),
            (jax_create_app, JaxServiceConfig(engine="fake", **cfg),
             jax_protocol, JaxLimiter)):
        app = create(config, StubEngine(protocol))
        clock = [0.0]
        app["clock"] = clock
        app["service"].limiter = limiter(
            config.rate_limit_count, config.rate_limit_window,
            timer=lambda clock=clock: clock[0])
        apps.append(app)
    return apps


@pytest.mark.parametrize("headers,detail", [
    ({}, "Missing X-API-Key header"),
    ({"X-API-Key": "wrong"}, "Invalid API Key")], ids=["missing", "wrong"])
async def test_auth_answers_401_as_the_jax_app(headers, detail):
    port, jax_app = _apps(api_auth_key="s3cret")
    requests = [(headers, 0.0), ({"X-API-Key": "s3cret"}, 0.0)]
    ours = await _answers(port, requests)
    assert ours == await _answers(jax_app, requests)
    assert ours[0][:2] == (401, {"detail": detail})
    assert ours[1][0] == 200
    assert port["service"].engine.calls == 1


async def test_default_rate_limit_answers_429_as_the_jax_app():
    """RATE_LIMIT=10/minute at the defaults: the 11th request of one
    client within the minute gets 429 with Retry-After and the
    X-RateLimit headers; a minute later the client is served again."""
    port, jax_app = _apps()
    requests = [({}, 0.0)] * 10 + [({}, 30.0), ({}, 60.5)]
    ours = await _answers(port, requests)
    assert ours == await _answers(jax_app, requests)
    assert [st for st, _, _ in ours] == [200] * 10 + [429, 200]
    status, body, headers = ours[10]
    assert body == {"detail": "Rate limit exceeded: 10/minute"}
    assert headers["Retry-After"] == "30"
    assert (headers["X-RateLimit-Limit"], headers["X-RateLimit-Remaining"],
            headers["X-RateLimit-Reset"]) == ("10", "0", "30")
    assert [b["from_cache"] for _, b, _ in ours if "from_cache" in b] \
        == [False] + [True] * 10


# ------------------------------------------------- the two-tier host KV

#: HOST_KV_BLOCKS, refused until the port served it: each environment
#: is read into the field the JAX from_env fills, or refused with the
#: JAX error
HOST_KV_ENVS = [
    ({"HOST_KV_BLOCKS": "64"}, None),
    ({"HOST_KV_BLOCKS": "0"}, None),
    ({"HOST_KV_BLOCKS": "-1"}, "must be >= 0"),
    ({"HOST_KV_BLOCKS": "8", "KV_POOL": "false"}, "requires KV_POOL=true"),
    ({"HOST_KV_BLOCKS": "8", "RADIX_CACHE": "false"},
     "requires KV_POOL=true"),
]


@pytest.mark.parametrize("env,error", HOST_KV_ENVS)
def test_config_reads_host_kv_blocks_with_the_jax_errors(monkeypatch, env,
                                                         error):
    assert "HOST_KV_BLOCKS" not in UNSERVED_KNOBS
    for knob, value in env.items():
        monkeypatch.setenv(knob, value)
    if error is None:
        ours, theirs = ServiceConfig.from_env(), JaxServiceConfig.from_env()
        assert ours.host_kv_blocks == theirs.host_kv_blocks == int(
            env["HOST_KV_BLOCKS"])
        return
    errors = []
    for cls in (ServiceConfig, JaxServiceConfig):
        with pytest.raises(ValueError, match=error) as ei:
            cls.from_env()
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("engine,batch", [("torch", "1"), ("openai", "8")])
def test_config_refuses_host_kv_blocks_where_no_engine_serves_it(
        monkeypatch, engine, batch):
    """The JAX single-sequence engine ignores HOST_KV_BLOCKS; the port
    refuses it where no radix tree would demote to it."""
    for knob, value in (("HOST_KV_BLOCKS", "8"), ("ENGINE", engine),
                        ("DECODE_BATCH_SIZE", batch),
                        ("OPENAI_API_KEY", "sk-x")):
        monkeypatch.setenv(knob, value)
    with pytest.raises(ValueError, match="continuous-batching engine only"):
        ServiceConfig.from_env()


@pytest.mark.parametrize("spec", ["offload:fail", "onload:corrupt",
                                  "r0:offload:fail,onload:corrupt",
                                  "admit:error:1.0,r0:offload:fail"])
def test_factory_boots_the_host_tier_fault_points(spec):
    """offload and onload boot with the host tier on (the factory threads
    the one injector into the batcher) and are refused without it, where
    the drill could never fire."""
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine

    eng = build_engine(ServiceConfig(torch_device="cpu", host_kv_blocks=8,
                                     fault_points=spec))
    assert isinstance(eng, BatchedTorchEngine)
    assert eng.host_kv_blocks == 8
    assert eng.faults.offload_fail() == ("offload" in spec)
    with pytest.raises(ValueError, match="HOST_KV_BLOCKS>0"):
        build_engine(ServiceConfig(torch_device="cpu", fault_points=spec))


HOST_FAMILIES = ("kv_host_blocks", "kv_blocks_demoted_total",
                 "kv_blocks_onloaded_total", "kv_onload_fail_total",
                 "kv_host_blocks_dropped_total")


async def test_http_host_tier_surfaces_and_thrash_incident():
    """The service plane over the port's own engine: /health's kv_pool
    carries ``host_tier`` and ``starved_slots_total``, /metrics the five
    host-tier families (the counters equal the engine's totals), and a
    demote/onload churn read from the engine's own view files a
    ``host_tier_thrash`` incident at /debug/incidents."""
    from prometheus_client.parser import text_string_to_metric_families

    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.obs.incidents import TRIGGER_HOST_THRASH

    cfg = ServiceConfig(torch_device="cpu", rate_limit="10000/minute",
                        sentinel_eval_secs=0.0, incident_cooldown_secs=0.0,
                        incident_thrash_min_blocks=1, max_new_tokens=8,
                        host_kv_blocks=32)
    eng = BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                             device="cpu", dtype="float32", max_seq_len=192,
                             prefill_buckets=(32, 64), prefix_cache=False,
                             batch_size=2, chunk_len=4, host_kv_blocks=32)
    hdr = {"X-Session-ID": "agent-1"}
    q = {"query": "list all pods in the staging namespace right now"}
    async with TestClient(TestServer(create_app(cfg, eng))) as client:
        await client.post("/kubectl-command", json=q, headers=hdr)
        body = await (await client.get("/debug/incidents")).json()
        assert body["incidents"] == []
        assert eng._radix.evict_for(eng._pool.n_blocks)
        assert eng._host_store.used > 0
        await client.post("/kubectl-command", json=q, headers=hdr)
        assert eng._host_store.onloaded_total > 0
        body = await (await client.get("/debug/incidents")).json()
        assert body["captured_total"].get(TRIGGER_HOST_THRASH) == 1
        health = (await (await client.get("/health")).json())["kv_pool"]
        text = await (await client.get("/metrics")).text()
    host = health["host_tier"]
    assert health["starved_slots_total"] == 0
    assert host["capacity"] == 32
    assert host["demoted_total"] >= 1 and host["onloaded_total"] >= 1
    seen = {}
    for fam in text_string_to_metric_families(text):
        for smp in fam.samples:
            if smp.name.startswith(("kv_host_blocks", "kv_blocks_",
                                    "kv_onload_fail")):
                key = smp.name + "".join(
                    f"{{{k}={v}}}" for k, v in sorted(smp.labels.items()))
                seen[key] = smp.value
    assert {f for f in HOST_FAMILIES
            if any(k.startswith(f) for k in seen)} == set(HOST_FAMILIES)
    assert seen["kv_blocks_demoted_total"] == host["demoted_total"]
    assert seen["kv_blocks_onloaded_total"] == host["onloaded_total"]
    assert seen["kv_host_blocks{state=used}"] == host["used"]
    assert seen["kv_host_blocks{state=free}"] == host["free"]
    assert seen["kv_onload_fail_total{cause=corrupt}"] == 0
