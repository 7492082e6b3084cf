"""The engine-protocol classes of the port against the JAX package's, by
name: each port class has every public method and property of its JAX
counterpart, so a caller that reaches a member of the JAX engine (the
app's stream route, the fleet's ``stream_events``) finds it in the port.
A member the port leaves out on purpose stands in ``EXEMPT`` with why.

Then the behaviour the check found missing: a fleet of single-sequence
engines streams token by token through ``TorchEngine.stream_events``, as
the JAX fleet streams through ``JaxEngine.stream_events``, where without
it the fleet fell back to ``generate`` and sent the whole text as one
piece.
"""

import asyncio
import importlib
import inspect

import pytest

from ai_agent_kubectl_tpu_torch.engine.fleet import EngineFleet
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
from ai_agent_kubectl_tpu_torch.models.config import get_config

#: (JAX module, JAX class, port module, port class), modules under each
#: package's root
PAIRS = [
    ("server.factory", "DegradedEngine", "server.factory", "DegradedEngine"),
    ("engine.fallback", "FallbackEngine", "engine.fallback",
     "FallbackEngine"),
    ("engine.openai_compat", "OpenAICompatEngine", "engine.openai_compat",
     "OpenAICompatEngine"),
    ("engine.fake", "FakeEngine", "engine.fake", "FakeEngine"),
    ("engine.fake", "FakeChunkedEngine", "engine.fake", "FakeChunkedEngine"),
    ("engine.fleet", "EngineFleet", "engine.fleet", "EngineFleet"),
    ("engine.jax_engine", "JaxEngine", "engine.torch_engine", "TorchEngine"),
    ("engine.batcher", "BatchedJaxEngine", "engine.batcher",
     "BatchedTorchEngine"),
]

#: (port class, member) -> why the port leaves it out
EXEMPT = {
    ("FallbackEngine", name): "the service's rule table behind generate(): "
    "in either package nothing starts, stops, polls or streams it"
    for name in ("start", "stop", "ready", "generate_stream")
}


def _members(cls) -> dict:
    """Public methods and properties of ``cls`` (its bases' included):
    name -> "property" or "method". Class constants and instance
    attributes are not part of the check."""
    out = {}
    for name in dir(cls):
        if name.startswith("_"):
            continue
        attr = inspect.getattr_static(cls, name)
        if isinstance(attr, property):
            out[name] = "property"
        elif isinstance(attr, (staticmethod, classmethod)) or \
                inspect.isfunction(attr):
            out[name] = "method"
    return out


@pytest.mark.parametrize("jax_mod,jax_cls,port_mod,port_cls", PAIRS,
                         ids=[p[3] for p in PAIRS])
def test_port_class_has_every_public_member_of_the_jax_class(
        jax_mod, jax_cls, port_mod, port_cls):
    theirs = _members(getattr(importlib.import_module(
        f"ai_agent_kubectl_tpu.{jax_mod}"), jax_cls))
    ours = _members(getattr(importlib.import_module(
        f"ai_agent_kubectl_tpu_torch.{port_mod}"), port_cls))
    missing = sorted(n for n in theirs if n not in ours
                     and (port_cls, n) not in EXEMPT)
    assert not missing, f"{port_cls} lacks {missing} of {jax_cls}"
    kinds = sorted(n for n in theirs if n in ours and ours[n] != theirs[n])
    assert not kinds, f"{port_cls}: method vs property differ for {kinds}"


def test_exemptions_name_members_the_port_really_lacks():
    """An exemption the port no longer needs is taken out of the list."""
    classes = {p[3]: getattr(importlib.import_module(
        f"ai_agent_kubectl_tpu_torch.{p[2]}"), p[3]) for p in PAIRS}
    for cls, name in EXEMPT:
        assert name not in _members(classes[cls]), (cls, name)


#: the single-sequence engine on toy-8m, float32 on the CPU (random
#: weights from seed 0: every replica holds the same)
SINGLE = dict(tokenizer=ByteTokenizer(), dtype="float32", max_seq_len=128,
              prefill_buckets=(32, 64), prefix_cache=False, device="cpu")
PROMPT = "list pods "


def test_a_fleet_of_single_sequence_engines_streams_token_by_token():
    """Two ``TorchEngine`` replicas behind ``EngineFleet``: the fleet's
    stream yields the pieces one replica streams alone (greedy), one by
    one."""
    cfg = get_config("toy-8m")

    async def go():
        alone = TorchEngine(cfg, **SINGLE)
        await alone.start()
        try:
            want = [p async for p in alone.generate_stream(
                PROMPT, max_tokens=12)]
        finally:
            await alone.stop()
        fleet = EngineFleet([TorchEngine(cfg, **SINGLE) for _ in range(2)],
                            affinity=False)
        await fleet.start()
        try:
            got = [p async for p in fleet.generate_stream(
                PROMPT, max_tokens=12)]
        finally:
            await fleet.stop()
        return want, got

    want, got = asyncio.run(asyncio.wait_for(go(), 120))
    assert len(want) > 1
    assert got == want
