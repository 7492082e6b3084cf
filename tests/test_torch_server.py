"""The port's lean server on the CPU: ``POST /kubectl-command`` and
``GET /health`` through the aiohttp test client, with ``toy-8m`` served
by the batched engine, and the request pipeline's status decisions held
against the JAX service's output parser."""

import pytest
from aiohttp.test_utils import TestClient, TestServer

from ai_agent_kubectl_tpu.server.output_parser import (
    UnsafeCommandError as JaxUnsafe)
from ai_agent_kubectl_tpu.server.output_parser import (
    parse_llm_output as jax_parse)
from ai_agent_kubectl_tpu.server.schemas import (
    CommandResponse as JaxCommandResponse)
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine.protocol import (
    EngineOverloaded, EngineResult, EngineUnavailable, GenerationTimeout,
    RequestQuarantined)
from ai_agent_kubectl_tpu_torch.server.app import create_app
from ai_agent_kubectl_tpu_torch.server.factory import (DegradedEngine,
                                                      build_engine)
from ai_agent_kubectl_tpu_torch.server.service import status_for_text

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
    """An engine that cannot be built (here: MODEL_PATH, whose checkpoint
    loader is not in the port yet) leaves the server up but degraded: it
    answers 503 and its log says why."""
    cfg = ServiceConfig(torch_device="cpu", decode_batch_size=1,
                        model_path="/nonexistent/checkpoint")
    engine = build_engine(cfg)
    assert isinstance(engine, DegradedEngine)
    assert "MODEL_PATH" in engine.reason
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
                     "RADIX_CACHE": "false", "MAX_NEW_TOKENS": "16"}.items():
        monkeypatch.setenv(key, val)
    cfg = ServiceConfig.from_env()
    assert (cfg.engine, cfg.torch_device, cfg.model_name) == (
        "torch-batched", "cpu", "gemma-2b-it")
    assert cfg.decode_batch_size == 4 and cfg.kv_pool_page == 32
    assert cfg.prefill_bucket_list == (64, 128)
    assert not cfg.radix_cache and cfg.max_new_tokens == 16
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


@pytest.mark.parametrize("knob,value", [("KV_QUANT", "int8"),
                                        ("SPEC_DECODE", "true"),
                                        ("FLEET_SIZE", "2")])
def test_config_refuses_knobs_the_port_does_not_serve(monkeypatch, knob,
                                                      value):
    monkeypatch.setenv(knob, value)
    with pytest.raises(ValueError, match=knob):
        ServiceConfig.from_env()
    monkeypatch.setenv(knob, {"KV_QUANT": "", "SPEC_DECODE": "false",
                              "FLEET_SIZE": "1"}[knob])
    assert ServiceConfig.from_env().engine == "torch"
