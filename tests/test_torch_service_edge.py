"""The service's edge against the JAX package's, on the CPU: the stream
route on a degraded engine, the ``.env`` file and the API document.

Each check runs the same input through both packages and asserts equal
behaviour:

- a stream on ``DegradedEngine("boom")`` gives the JAX app's SSE bytes,
  with ``DEGRADED_FALLBACK`` off (an ``engine unavailable`` frame) and on
  (the rule table's ``event: degraded``, then ``event: done``);
- ``load_env_file`` parses a file as the JAX loader does, and
  ``ServiceConfig.from_env()`` reads ``.env`` from the working directory
  before any knob: the process environment wins, ``API_AUTH_KEY`` from
  the file turns auth on, and a knob set only in the file is read or
  refused as one set in the environment;
- ``/openapi.json`` documents the JAX document's paths, methods,
  parameters, request bodies, status codes and component schemas, and
  every route the port's app registers.

The SIGTERM drain of the entry point is ``tests/test_torch_drain.py``'s.
``load_env_file`` writes into ``os.environ``: every read here runs
inside ``_env_kept``, which puts the environment back after it, and the
module imports ``knob_env``, so no knob from outside reaches it.
"""

import asyncio
import contextlib
import json
import os
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer
from test_torch_env import knob_env  # noqa: F401  (autouse)

from ai_agent_kubectl_tpu import config as jax_config
from ai_agent_kubectl_tpu.engine.fake import FakeEngine as JaxFakeEngine
from ai_agent_kubectl_tpu.server import app as jax_app
from ai_agent_kubectl_tpu.server import factory as jax_factory
from ai_agent_kubectl_tpu.server import openapi as jax_openapi
from ai_agent_kubectl_tpu_torch import config as port_config
from ai_agent_kubectl_tpu_torch.engine.fake import FakeEngine
from ai_agent_kubectl_tpu_torch.server import app as port_app
from ai_agent_kubectl_tpu_torch.server import factory as port_factory
from ai_agent_kubectl_tpu_torch.server import openapi as port_openapi

ROOT = Path(__file__).resolve().parents[1]
#: seconds any one app scenario may take
LIMIT = 30.0
PACKAGES = {"port": (port_config, port_app, port_factory),
            "jax": (jax_config, jax_app, jax_factory)}


@contextlib.contextmanager
def _env_kept():
    """The process environment as it was, after the block."""
    saved = dict(os.environ)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


# ------------------------------------------------------ the degraded stream

async def _degraded_answers(name: str, fallback: bool) -> dict:
    config, app_mod, factory = PACKAGES[name]
    cfg = config.ServiceConfig(rate_limit="1000/minute",
                               degraded_fallback=fallback)
    app = app_mod.create_app(cfg, factory.DegradedEngine("boom"))
    out = {}
    async with TestClient(TestServer(app)) as c:
        r = await c.post("/kubectl-command/stream",
                         json={"query": "list all pods"})
        out["stream"] = (r.status, r.headers["Content-Type"], await r.read())
        r = await c.post("/kubectl-command", json={"query": "list all pods"})
        body = await r.json()
        out["plain"] = (r.status, body.get("kubectl_command"),
                        body.get("degraded"), body.get("detail"))
    return out


@pytest.mark.parametrize("fallback", [False, True],
                         ids=["fallback_off", "fallback_on"])
def test_a_stream_on_a_degraded_engine_answers_as_the_jax_app(fallback):
    """Both apps on their own ``DegradedEngine("boom")``: the stream's SSE
    bytes are identical, and so are the non-streaming answers (503, or a
    degraded 200 from the rule table)."""
    async def go():
        return [await asyncio.wait_for(_degraded_answers(n, fallback), LIMIT)
                for n in ("port", "jax")]

    ours, theirs = asyncio.run(go())
    assert ours == theirs
    status, _, body = ours["stream"]
    assert status == 200
    if fallback:
        assert b"event: degraded\ndata: kubectl get pods" in body
        assert b"event: done" in body
        assert ours["plain"][:3] == (200, "kubectl get pods", True)
    else:
        assert b"event: error" in body and b"boom" in body
        assert b"internal error" not in body
        assert ours["plain"][0] == 503


# --------------------------------------------------------------- .env

ENV_FILES = {
    "plain": "CACHE_TTL=450\nMODEL_NAME=gemma-2b\n",
    "export_quotes_comments": (
        "# a comment line\n\n"
        "export CACHE_TTL=450\n"
        "RATE_LIMIT=\"25/minute\"\n"
        "API_AUTH_KEY='s3cret # not a comment'\n"
        "LOG_LEVEL=debug   # an inline comment\n"
        "EMPTY=\n"
        "no equals sign here\n"
        "=no key\n"
        "  SPACED_KEY  =  spaced value  \n"),
    "unterminated_quote": "A='abc\nB=\"x\"y\"\nC='\n",
}


@pytest.mark.parametrize("override", [False, True])
@pytest.mark.parametrize("name", sorted(ENV_FILES))
def test_load_env_file_parses_as_the_jax_loader(name, override, tmp_path):
    """The same file through both loaders: the same mapping returned and
    the same process environment after it, a variable already set kept
    unless ``override``."""
    path = tmp_path / ".env"
    path.write_text(ENV_FILES[name])
    seen = []
    for loader in (port_config.load_env_file, jax_config.load_env_file):
        with _env_kept():
            os.environ["CACHE_TTL"] = "111"
            parsed = loader(path, override=override)
            seen.append((parsed, dict(os.environ)))
    assert seen[0] == seen[1]
    parsed, env = seen[0]
    assert parsed
    if "CACHE_TTL" in parsed:
        assert env["CACHE_TTL"] == ("450" if override else "111")


def test_a_missing_env_file_is_not_an_error(tmp_path):
    with _env_kept():
        assert port_config.load_env_file(tmp_path / "absent") == {}
        assert port_config.ServiceConfig.from_env(
            env_file=tmp_path / "absent") == port_config.ServiceConfig()


#: a deployment's .env: a served knob, an export line, a quoted value, an
#: inline comment, the auth key and a knob the environment also sets
DEPLOY_ENV = (
    "ENGINE=fake\n"
    "CACHE_TTL=450\n"
    "export MAX_NEW_TOKENS=64\n"
    "RATE_LIMIT=\"25/minute\"\n"
    "LOG_LEVEL=debug   # the operator's note\n"
    "API_AUTH_KEY=s3cret\n"
    "CACHE_MAXSIZE=7\n")


def _shared_fields(cfg) -> dict:
    port_fields = set(port_config.ServiceConfig.__dataclass_fields__)
    jax_fields = set(jax_config.ServiceConfig.__dataclass_fields__)
    return {f: getattr(cfg, f) for f in sorted(port_fields & jax_fields)}


def _read(config, environ: dict, env_file=".env"):
    """``from_env`` of one package in a fresh copy of the environment
    (``environ`` added): its config, or the error it refuses with."""
    with _env_kept():
        os.environ.update(environ)
        try:
            return config.ServiceConfig.from_env(env_file=env_file)
        except ValueError as e:
            return e


def test_from_env_reads_dot_env_as_the_jax_package(tmp_path, monkeypatch):
    """``.env`` in the working directory reaches both configs alike, the
    environment winning over it; auth comes on from the file."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / ".env").write_text(DEPLOY_ENV)
    environ = {"CACHE_MAXSIZE": "9"}
    ours = _read(port_config, environ)
    theirs = _read(jax_config, environ)
    assert _shared_fields(ours) == _shared_fields(theirs)
    assert ours.auth_enabled and theirs.auth_enabled
    assert (ours.cache_ttl, ours.max_new_tokens, ours.rate_limit,
            ours.log_level, ours.engine) == (450.0, 64, "25/minute",
                                             "DEBUG", "fake")
    assert ours.cache_maxsize == 9            # the environment wins
    # env_file=None reads no file, as in the JAX package
    assert not _read(port_config, environ, env_file=None).auth_enabled
    assert "API_AUTH_KEY" not in os.environ


@pytest.mark.parametrize("line,refused_by", [
    ("ENGINE=jax", {"port"}),                  # the JAX engine, by name
    ("CACHE_TTL=soon", {"port", "jax"}),       # not a number
    ("GRAMMAR_DECODE=true\nDECODE_BATCH_SIZE=1\nENGINE=torch", {"port"}),
], ids=["jax_engine", "not_a_number", "grammar_on_one_slot"])
def test_a_knob_set_only_in_dot_env_is_refused_as_in_the_environment(
        line, refused_by, tmp_path, monkeypatch):
    """A knob from the file meets the same check, with the same message,
    as the same knob from the environment; the JAX package takes or
    refuses it as it does from the environment."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / ".env").write_text(line + "\n")
    from_env_vars = dict(kv.split("=", 1) for kv in line.split("\n"))
    for name, config in (("port", port_config), ("jax", jax_config)):
        from_file = _read(config, {})
        from_environ = _read(config, from_env_vars, env_file=None)
        assert isinstance(from_file, ValueError) == (name in refused_by)
        assert type(from_file) is type(from_environ)
        if isinstance(from_file, ValueError):
            assert str(from_file) == str(from_environ)
        else:
            assert from_file == from_environ


def test_the_env_sample_reads_alike_in_both_packages(tmp_path, monkeypatch):
    """The repo's ``.env-sample`` copied to ``.env`` (the README's
    quickstart) with ``ENGINE`` from the environment: every shared field
    equal. Its own ``ENGINE=jax`` is refused by the port by name."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / ".env").write_text((ROOT / ".env-sample").read_text())
    ours = _read(port_config, {"ENGINE": "fake"})
    theirs = _read(jax_config, {"ENGINE": "fake"})
    assert _shared_fields(ours) == _shared_fields(theirs)
    assert ours.model_name == "gemma-2b-it"
    refused = _read(port_config, {})
    assert isinstance(refused, ValueError)
    assert "ENGINE=jax" in str(refused)


# ---------------------------------------------------------- the API document

def _undescribed(obj):
    """``obj`` without its ``description`` texts (each package's own
    words)."""
    if isinstance(obj, dict):
        return {k: _undescribed(v) for k, v in obj.items()
                if k != "description"}
    if isinstance(obj, list):
        return [_undescribed(v) for v in obj]
    return obj


def _operations(doc: dict) -> dict:
    """path -> method -> (response codes, parameters, request body),
    descriptions aside."""
    return {path: {method: (sorted(op.get("responses", {})),
                            _undescribed(op.get("parameters")),
                            _undescribed(op.get("requestBody")))
                   for method, op in methods.items()}
            for path, methods in doc["paths"].items()}


def test_openapi_document_matches_the_jax_one():
    ours = port_openapi.build_openapi()
    theirs = jax_openapi.build_openapi()
    assert len(ours["paths"]) == 15
    assert _operations(ours) == _operations(theirs)
    assert _undescribed(ours["components"]) == \
        _undescribed(theirs["components"])
    assert ours["security"] == theirs["security"]
    text = json.dumps(ours)
    assert "TPU" not in text and "jax" not in text.lower()


def test_every_route_the_port_app_registers_is_documented():
    """The app's routes, apart from the two that serve the document
    itself, against the document it serves at /openapi.json."""
    cfg = port_config.ServiceConfig(engine="fake")
    app = port_app.create_app(cfg, FakeEngine())
    routes = {(r.resource.canonical, r.method.lower())
              for r in app.router.routes() if r.method != "HEAD"}
    routes -= {("/openapi.json", "get"), ("/docs", "get")}

    async def served():
        async with TestClient(TestServer(app)) as c:
            r = await c.get("/openapi.json")
            return await r.json()

    doc = asyncio.run(asyncio.wait_for(served(), LIMIT))
    documented = {(path, method) for path, methods in doc["paths"].items()
                  for method in methods}
    assert routes == documented
    jax_routes = {(r.resource.canonical, r.method.lower())
                  for r in jax_app.create_app(
                      jax_config.ServiceConfig(engine="fake"),
                      JaxFakeEngine()).router.routes()
                  if r.method != "HEAD"}
    assert routes | {("/openapi.json", "get"), ("/docs", "get")} \
        == jax_routes
