"""``ENGINE=openai`` in the port against the JAX package's, over a local
stub ChatCompletions server (no network).

- The engine: a completion, true SSE streaming (one piece per frame,
  keep-alives and empty frames tolerated) and the fallback when the
  upstream ignores ``stream: true`` — the JAX cases, run through both
  packages' engines, which must give the same results; an upstream error
  and a missing key raise ``EngineUnavailable`` in both.
- The wiring: ``ServiceConfig.from_env`` boots ``ENGINE=openai`` with
  the ``OPENAI_*`` knobs, the factory builds the engine from them, and
  the port's app serves a command through it over HTTP as the JAX app
  does; the missing-key warning is logged as the JAX package logs it.
"""

import json
import logging

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from ai_agent_kubectl_tpu import logging_setup as jax_logging
from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine import openai_compat as jax_openai
from ai_agent_kubectl_tpu.server.app import create_app as jax_create_app
from ai_agent_kubectl_tpu.server.factory import (
    build_engine as jax_build_engine)
from ai_agent_kubectl_tpu_torch import logging_setup as port_logging
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine import openai_compat as port_openai
from ai_agent_kubectl_tpu_torch.server.app import create_app
from ai_agent_kubectl_tpu_torch.server.factory import build_engine
from test_torch_env import knob_env  # noqa: F401  (autouse)

PACKAGES = {"jax": jax_openai, "port": port_openai}
PIECES = ["kubectl ", "get ", "pods ", "-n ", "staging"]


async def _stub_server(stream_pieces, streams=True, status=200):
    seen = []

    async def chat(request):
        body = await request.json()
        seen.append((request.headers.get("Authorization"), body))
        if status >= 400:
            return web.json_response({"error": "boom"}, status=status)
        if body.get("stream") and streams:
            resp = web.StreamResponse(
                status=200, headers={"Content-Type": "text/event-stream"})
            await resp.prepare(request)
            for piece in stream_pieces:
                frame = {"choices": [{"delta": {"content": piece}}]}
                await resp.write(f"data: {json.dumps(frame)}\n\n".encode())
            await resp.write(b": ping\n\n")
            await resp.write(b'data: {"choices": []}\n\n')
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp
        return web.json_response({
            "choices": [{"message": {"content": "".join(stream_pieces)}}],
            "usage": {"prompt_tokens": 5, "completion_tokens": 3},
        })

    app = web.Application()
    app.router.add_post("/chat/completions", chat)
    server = TestServer(app)
    await server.start_server()
    return server, seen


async def _both(fn, **stub):
    """``fn(engine)`` through each package's engine, each against a
    fresh stub; returns (port outcome, jax outcome, requests seen)."""
    outs = []
    for mod in (port_openai, jax_openai):
        server, seen = await _stub_server(PIECES, **stub)
        engine = mod.OpenAICompatEngine(
            api_key="test", model="gpt-4",
            base_url=str(server.make_url("/")), timeout=5.0)
        await engine.start()
        try:
            try:
                outs.append(("ok", await fn(engine)))
            except Exception as e:  # noqa: BLE001 - the outcome
                outs.append((type(e).__name__, str(e)[:40]))
        finally:
            await engine.stop()
            await server.close()
        outs[-1] = (outs[-1], seen)
    return outs


async def _complete(engine):
    r = await engine.generate("list pods", max_tokens=7)
    return (r.text, r.prompt_tokens, r.completion_tokens, r.engine)


async def _stream(engine):
    return [p async for p in engine.generate_stream("list pods")]


async def test_generate_via_stub_as_the_jax_engine():
    (port, seen_p), (jax_side, seen_j) = await _both(_complete)
    assert port == jax_side == ("ok", ("kubectl get pods -n staging", 5, 3,
                                       "openai"))
    assert seen_p == seen_j
    auth, body = seen_p[0]
    assert auth == "Bearer test"
    assert body == {"model": "gpt-4", "temperature": 0.0, "max_tokens": 7,
                    "messages": [{"role": "user", "content": "list pods"}]}


async def test_stream_yields_incremental_sse_pieces_as_the_jax_engine():
    (port, _), (jax_side, _) = await _both(_stream)
    assert port == jax_side == ("ok", PIECES)


async def test_stream_falls_back_when_upstream_does_not_stream():
    (port, _), (jax_side, _) = await _both(_stream, streams=False)
    assert port == jax_side == ("ok", ["kubectl get pods -n staging"])


@pytest.mark.parametrize("fn", [_complete, _stream])
async def test_upstream_error_is_engine_unavailable(fn):
    (port, _), (jax_side, _) = await _both(fn, status=502)
    assert port == jax_side
    assert port[0] == "EngineUnavailable"


@pytest.mark.parametrize("pkg", list(PACKAGES))
async def test_missing_key_is_not_ready(pkg):
    engine = PACKAGES[pkg].OpenAICompatEngine(api_key=None)
    await engine.start()
    try:
        assert not engine.ready
        with pytest.raises(Exception) as ei:
            await engine.generate("list pods")
        assert type(ei.value).__name__ == "EngineUnavailable"
    finally:
        await engine.stop()


def test_from_env_boots_engine_openai(monkeypatch):
    monkeypatch.setenv("ENGINE", "openai")
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    monkeypatch.setenv("OPENAI_MODEL", "gpt-4o")
    monkeypatch.setenv("OPENAI_BASE_URL", "http://127.0.0.1:9/v1")
    cfg = ServiceConfig.from_env(env_file=None)
    assert (cfg.engine, cfg.openai_api_key, cfg.openai_model,
            cfg.openai_base_url) == ("openai", "sk-test", "gpt-4o",
                                     "http://127.0.0.1:9/v1")
    engine = build_engine(cfg)
    assert isinstance(engine, port_openai.OpenAICompatEngine)
    assert (engine.api_key, engine.model, engine.base_url,
            engine.timeout) == ("sk-test", "gpt-4o",
                                "http://127.0.0.1:9/v1", cfg.llm_timeout)


async def test_the_app_serves_through_engine_openai_as_the_jax_app():
    """The factory's engine behind each package's app: a command over
    POST /kubectl-command, and the stream route's SSE, against the
    stub."""
    outs = []
    for create, build, config in (
            (create_app, build_engine, ServiceConfig),
            (jax_create_app, jax_build_engine, JaxServiceConfig)):
        server, seen = await _stub_server(["kubectl get pods"])
        cfg = config(engine="openai", openai_api_key="sk-test",
                     openai_base_url=str(server.make_url("/")),
                     rate_limit="1000/minute")
        engine = build(cfg)
        try:
            async with TestClient(TestServer(create(cfg, engine))) as c:
                r = await c.post("/kubectl-command",
                                 json={"query": "list all pods"})
                body = await r.json()
                s = await c.post("/kubectl-command/stream",
                                 json={"query": "show pods now"})
                stream = await s.text()
                h = await c.get("/health")
                health = await h.json()
            outs.append((r.status, body["kubectl_command"],
                         body["engine_metadata"]["engine"], s.status,
                         "event: done" in stream, h.status,
                         health["engine"], health["engine_ready"],
                         len(seen)))
        finally:
            await server.close()
    assert outs[0] == outs[1]
    assert outs[0][:3] == (200, "kubectl get pods", "openai")


@pytest.mark.parametrize("key", [None, "sk-test"])
def test_missing_key_warning_as_the_jax_package(caplog, key):
    logs = []
    for mod, config in ((port_logging, ServiceConfig(engine="openai",
                                                     openai_api_key=key,
                                                     api_auth_key="k",
                                                     debug_token="d")),
                        (jax_logging, JaxServiceConfig(engine="openai",
                                                       openai_api_key=key,
                                                       api_auth_key="k",
                                                       debug_token="d"))):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mod.startup_warnings(config)
        logs.append([(r.levelname, r.getMessage()) for r in caplog.records])
    assert logs[0] == logs[1]
    want = [("ERROR", "ENGINE=openai but OPENAI_API_KEY not set; engine "
             "will run degraded (503).")]
    assert logs[0] == (want if key is None else [])
