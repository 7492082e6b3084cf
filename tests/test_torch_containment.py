"""The port's blast-radius containment against the JAX package's, on the
CPU (toy-8m, float32, 4 slots, chunk 4).

- **Fault C5**: the port quarantined a request the first time its health
  bit tripped, where the JAX engine replays it within its retry budget
  (``QUARANTINE_RETRY_BUDGET=1`` by default). A one-shot ``decode:nan``
  on one of four concurrent greedy requests in the pool (ragged regime)
  must leave every transcript byte-identical to the fault-free run and
  to the other package's, with the same containment counters.
- **The drills**, each through both engines on the same weights:
  persistent ``decode:nan`` at budgets 0, 1 and 2 (quarantine after
  budget + 1 trips, the same victim); ``decode:poison_step`` bisection
  with early unparking after ``PROBATION_CLEAN_CHUNKS`` (the same
  culprit, the same resets); ``scheduler:die``, plain and
  mid-admission; the dense ladder's one-shot ``decode:nan`` replay; a
  spent reset budget failing fast while the reset listener opens the
  breaker over HTTP; the watchdog (a hung chunk, the startup grace,
  recovery).
- **HTTP**: 410 on quarantine, the four containment families in
  ``/metrics`` and ``/health``'s ``last_reset`` against the JAX app.
- **Units**: the supervisor, the fault spec and the packed chunk's
  health lane, as the JAX tests run them, over both packages' modules;
  the new knobs read with the JAX errors, and the factory's refusals.

Transcripts are compared byte for byte, counters for equality.
"""

import asyncio
import gc
import importlib
import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine import containment as jax_containment
from ai_agent_kubectl_tpu.engine import protocol as jax_protocol
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.server.app import create_app as jax_create_app
from ai_agent_kubectl_tpu.testing import faults as jax_faults
from ai_agent_kubectl_tpu_torch.config import UNSERVED_KNOBS, ServiceConfig
from ai_agent_kubectl_tpu_torch.engine import containment as port_containment
from ai_agent_kubectl_tpu_torch.engine import protocol as port_protocol
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.server.app import create_app
from ai_agent_kubectl_tpu_torch.server.factory import build_engine
from ai_agent_kubectl_tpu_torch.testing import faults as port_faults
from test_torch_env import knob_env  # noqa: F401  (autouse)

torch.set_num_threads(1)

PACKAGES = {
    "jax": (jax_faults, jax_containment, jax_protocol),
    "port": (port_faults, port_containment, port_protocol),
}

COMMON = dict(dtype="float32", max_seq_len=64, prefill_buckets=(16,),
              prefix_cache=False, chunk_len=4, batch_size=4)
#: four greedy requests: unique short prompts (one prefill bucket holds
#: each prompt and every replay prefix), each with its own seed
PROMPTS = [f"pod q{i} " for i in range(4)]
TARGET = "pod q2 "
MAX_TOKENS = 20


def _jax_engine(faults=None, **kw):
    return BatchedJaxEngine(jconfig.get_config("toy-8m"),
                            tokenizer=JaxByteTokenizer(),
                            compile_cache_dir="", faults=faults,
                            **{"ragged_attention": "on", **COMMON, **kw})


def _port_engine(params, faults=None, **kw):
    return BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                              params=params, device="cpu", faults=faults,
                              **{**COMMON, **kw})


def _port_params(jax_eng):
    return params_from_jax(jax.tree.map(np.asarray, jax_eng.params),
                           get_config("toy-8m"))


async def _burst(eng, prompts=PROMPTS, max_tokens=MAX_TOKENS):
    """Every prompt at once; each outcome: the text or the exception."""
    res = await asyncio.gather(
        *[eng.generate(p, max_tokens=max_tokens, seed=100 + i)
          for i, p in enumerate(prompts)], return_exceptions=True)
    return {p: (r if isinstance(r, BaseException) else r.text)
            for p, r in zip(prompts, res)}


def _nan_once(inj, target, skip=2):
    """Arm ``decode:nan`` one-shot on ``target``: the (skip+1)-th dispatch
    that carries it NaNs its logits, then the point disarms (the JAX
    injector's persistent ``nan`` mode, released after one firing)."""
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


def _containment(eng) -> dict:
    c = eng.stats()["containment"]
    return {k: c[k] for k in ("resets", "quarantined", "health_trips",
                              "replayed_tokens", "replayed_requests")}


def _summary(out: dict) -> dict:
    return {p: (type(v).__name__ if isinstance(v, BaseException) else v)
            for p, v in out.items()}


def _books(eng) -> None:
    holders: dict = {}
    for slot in list(eng._slots) + list(eng._parked):
        if slot is not None and slot.blocks:
            for b in slot.blocks:
                holders[b] = holders.get(b, 0) + 1
    if eng._radix is not None:
        for b, n in eng._radix._held.items():
            holders[b] = holders.get(b, 0) + n
    eng._pool.check(holders)


async def _drill_both(arm, build_kw=None, prompts=PROMPTS,
                      max_tokens=MAX_TOKENS):
    """Fresh engines of both packages on the same weights: the
    fault-free burst, then ``arm(injector)`` and the burst again.
    Returns {package: (reference, drilled, containment, engine)}."""
    build_kw = build_kw or {}
    out = {}
    jinj = jax_faults.FaultInjector()
    jeng = _jax_engine(jinj, **build_kw)
    await jeng.start()
    try:
        params = _port_params(jeng)
        ref = await _burst(jeng, prompts, max_tokens)
        arm(jinj)
        got = await _burst(jeng, prompts, max_tokens)
        out["jax"] = (ref, got, _containment(jeng), jeng)
    finally:
        jinj.clear()
        await jeng.stop()
    pinj = port_faults.FaultInjector()
    peng = _port_engine(params, pinj, **build_kw)
    await peng.start()
    try:
        ref = await _burst(peng, prompts, max_tokens)
        arm(pinj)
        got = await _burst(peng, prompts, max_tokens)
        out["port"] = (ref, got, _containment(peng), peng)
        if peng.kv_pool:
            _books(peng)
    finally:
        pinj.clear()
        await peng.stop()
    return out


# ------------------------------------------------------------- fault C5

async def test_fault_c5_tripped_slot_replays_within_budget():
    """Fault C5: with the default QUARANTINE_RETRY_BUDGET=1 a one-shot
    health trip is replayed, not quarantined. The target and its three
    cohabitants complete with the fault-free transcripts in both
    packages, which agree with each other, and the containment counters
    are equal."""
    out = await _drill_both(lambda inj: _nan_once(inj, TARGET))
    (jref, jgot, jc, _), (pref, pgot, pc, peng) = out["jax"], out["port"]
    assert peng.supervisor.retry_budget == 1
    assert pref == jref
    assert not any(isinstance(v, BaseException) for v in pgot.values()), \
        pgot
    assert pgot == pref and jgot == jref
    assert pc["resets"] == jc["resets"] == {"slot_health": 1}
    assert pc["health_trips"] == jc["health_trips"] == 1
    assert pc["quarantined"] == jc["quarantined"] == {}
    # The trip hit the third chunk: every slot had 8 tokens, replayed.
    assert pc["replayed_tokens"] == jc["replayed_tokens"] == 32
    assert pc == jc


# ------------------------------------------------- module-scoped engines

@pytest.fixture(scope="module")
def engines():
    """One engine of each package on the same weights, each with its own
    injector, and the fault-free transcripts. Tests that change the
    supervisor's budget restore it."""
    jinj = jax_faults.FaultInjector()
    jeng = _jax_engine(jinj, max_seq_len=96)
    asyncio.run(jeng.start())
    pinj = port_faults.FaultInjector()
    peng = _port_engine(_port_params(jeng), pinj, max_seq_len=96)

    async def refs(eng):
        short = await _burst(eng)
        long = await _burst(eng, max_tokens=48)
        return short, long

    want = asyncio.run(refs(jeng))
    yield {"jax": (jeng, jinj), "port": (peng, pinj), "want": want}
    asyncio.run(jeng.stop())


async def _with(pair, fn):
    """Run ``fn(engine, injector)`` on a started engine (the port engine
    starts and stops here: an event loop per test)."""
    eng, inj = pair
    started = isinstance(eng, BatchedTorchEngine)
    if started:
        await eng.start()
    try:
        return await fn(eng, inj)
    finally:
        inj.clear()
        for name in ("decode_nan_slots",):
            inj.__dict__.pop(name, None)
        inj.target_substr = None
        if started:
            await eng.stop()


def _delta(before: dict, after: dict) -> dict:
    out = {}
    for k in ("resets", "quarantined"):
        out[k] = {c: after[k].get(c, 0) - before[k].get(c, 0)
                  for c in after[k] if after[k].get(c, 0)
                  != before[k].get(c, 0)}
    for k in ("health_trips", "replayed_tokens", "replayed_requests"):
        out[k] = after[k] - before[k]
    return out


@pytest.mark.parametrize("budget", [0, 1, 2])
async def test_persistent_nan_quarantines_after_budget_plus_one_trips(
        engines, budget):
    """A request whose every step NaNs is replayed ``budget`` times and
    quarantined at trip budget + 1 (410), never replayed forever; its
    cohabitants complete with their fault-free transcripts. Both
    packages name the same victim and count the same resets."""
    outs = {}
    for name in ("jax", "port"):
        async def drill(eng, inj):
            eng.supervisor.retry_budget = budget
            try:
                before = _containment(eng)
                inj.target_substr = TARGET
                inj.set("decode", "nan")
                got = await _burst(eng)
                return got, _delta(before, _containment(eng))
            finally:
                eng.supervisor.retry_budget = 1
        outs[name] = await _with(engines[name], drill)
    want = engines["want"][0]
    for name, (got, d) in outs.items():
        assert isinstance(got[TARGET], RequestQuarantinedTypes), (name, got)
        assert {p: v for p, v in got.items() if p != TARGET} == \
            {p: v for p, v in want.items() if p != TARGET}, name
        assert d["resets"] == {"slot_health": budget + 1}, (name, d)
        assert d["quarantined"] == {"slot_health": 1}, (name, d)
        assert d["health_trips"] == budget + 1, (name, d)
    assert _summary(outs["jax"][0]) == _summary(outs["port"][0])
    assert outs["jax"][1] == outs["port"][1]


RequestQuarantinedTypes = (jax_protocol.RequestQuarantined,
                           port_protocol.RequestQuarantined)


async def test_poison_step_bisection_isolates_the_culprit(engines):
    """decode:poison_step names no slot: bisection parks half the
    suspects, unparks them after PROBATION_CLEAN_CHUNKS clean chunks,
    narrows to the culprit and quarantines it (step_poison) past its
    budget; every innocent completes with its fault-free transcript. The
    same culprit and the same number of resets in both packages."""
    outs = {}
    for name in ("jax", "port"):
        async def drill(eng, inj):
            before = _containment(eng)
            unparks = []
            orig = eng._unpark_parked

            def unpark():
                unparks.append(len(eng._parked))
                orig()

            eng._unpark_parked = unpark
            try:
                inj.target_substr = "pod q3 "
                inj.set("decode", "poison_step")
                got = await _burst(eng, max_tokens=48)
            finally:
                del eng._unpark_parked
            return got, _delta(before, _containment(eng)), unparks
        outs[name] = await _with(engines[name], drill)
    want = engines["want"][1]
    for name, (got, d, unparks) in outs.items():
        assert isinstance(got["pod q3 "], RequestQuarantinedTypes), name
        assert {p: v for p, v in got.items() if p != "pod q3 "} == \
            {p: v for p, v in want.items() if p != "pod q3 "}, name
        assert d["quarantined"] == {"step_poison": 1}, (name, d)
        # Four suspects: 4 -> 2 -> 1, then the budgeted replay and the
        # confirmation; early unparking let the parked halves back in.
        assert 3 <= d["resets"]["scheduler_error"] <= 5, (name, d)
        assert unparks and all(n > 0 for n in unparks), (name, unparks)
    assert outs["jax"][1]["resets"] == outs["port"][1]["resets"]
    assert outs["jax"][1]["quarantined"] == outs["port"][1]["quarantined"]
    assert outs["jax"][2] == outs["port"][2]


#: eight greedy requests, the poison_step target third among them: the
#: card's serve_chaos drill (8 slots, its target the third of 8 queries)
PROMPTS8 = [f"pod q{i} " for i in range(8)]


async def test_poison_step_bisection_of_eight_suspects_matches_jax():
    """Eight slots, the culprit third: both packages take the same
    number of resets to isolate it, and that number is the one
    chip_smoke.py's serve_chaos drill holds the card to."""
    chip = importlib.import_module("chip_smoke")

    def arm(inj):
        inj.target_substr = PROMPTS8[2]
        inj.set("decode", "poison_step")

    out = await _drill_both(arm, build_kw=dict(batch_size=8,
                                               max_seq_len=96),
                            prompts=PROMPTS8, max_tokens=48)
    (jref, jgot, jc, _), (pref, pgot, pc, _) = out["jax"], out["port"]
    assert pref == jref
    for got, ref in ((jgot, jref), (pgot, pref)):
        assert isinstance(got[PROMPTS8[2]], RequestQuarantinedTypes)
        assert {p: v for p, v in got.items() if p != PROMPTS8[2]} == \
            {p: v for p, v in ref.items() if p != PROMPTS8[2]}
    assert pc["quarantined"] == jc["quarantined"] == {"step_poison": 1}
    assert pc["resets"] == jc["resets"] == {
        "scheduler_error": chip.CHAOS_POISON_RESETS}


@pytest.mark.parametrize("spec,point", [("admit:error", "admit"),
                                        ("scheduler:die", "scheduler")])
async def test_boot_armed_drill_meets_the_warm_up_as_in_jax(spec, point):
    """A drill armed at boot (FAULT_POINTS) is not shielded from start()'s
    warm-up generate, in either package: it fires there the same number
    of times and leaves the same resets; only tenant:flood is held back
    for the first real submission."""
    seen = {}
    jinj = jax_faults.FaultInjector.from_spec(spec)
    jeng = _jax_engine(jinj)
    await jeng.start()
    try:
        params = _port_params(jeng)
        for _ in range(400):         # the scheduler restart settles
            if jeng.ready:
                break
            await asyncio.sleep(0.01)
        seen["jax"] = (jinj.fired(point), _containment(jeng)["resets"])
        jinj.clear()
        want = (await jeng.generate(TARGET, max_tokens=4)).text
    finally:
        await jeng.stop()
    pinj = port_faults.FaultInjector.from_spec(spec)
    peng = _port_engine(params, pinj)
    await peng.start()
    try:
        for _ in range(400):
            if peng.ready:
                break
            await asyncio.sleep(0.01)
        seen["port"] = (pinj.fired(point), _containment(peng)["resets"])
        pinj.clear()
        got = (await peng.generate(TARGET, max_tokens=4)).text
    finally:
        await peng.stop()
    assert seen["jax"][0] >= 1
    assert seen["port"] == seen["jax"]
    assert got == want


async def test_scheduler_die_restarts_with_zero_dropped(engines):
    """Kill the scheduler thread mid-decode: the supervisor resets,
    replays the survivors and restarts the loop; every request completes
    with its fault-free transcript."""
    outs = {}
    for name in ("jax", "port"):
        async def drill(eng, inj):
            before = _containment(eng)
            task = asyncio.ensure_future(_burst(eng))
            for _ in range(2000):
                await asyncio.sleep(0.002)
                if any(s is not None and len(s.detok.ids) >= 1
                       for s in eng._slots):
                    break
            inj.set("scheduler", "die")
            got = await task
            for _ in range(400):     # the kill may land after the drain
                if _delta(before, _containment(eng))["resets"]:
                    break
                await asyncio.sleep(0.01)
            return got, _delta(before, _containment(eng))
        outs[name] = await _with(engines[name], drill)
    for name, (got, d) in outs.items():
        assert got == engines["want"][0], name
        assert d["resets"] == {"scheduler_death": 1}, (name, d)


async def test_scheduler_die_mid_admission_requeues_the_request(engines):
    """A BaseException inside an admission, after the request left the
    queue and before it reached a slot: the supervisor requeues it at
    the head, and it completes with its fault-free transcript."""
    admit_attr = {"jax": "_admit_one", "port": "_admit_fresh"}
    outs = {}
    for name in ("jax", "port"):
        async def drill(eng, inj):
            before = _containment(eng)
            real = getattr(eng, admit_attr[name])
            killed = []

            def admit_and_die(req):
                if req.prompt == TARGET and not killed:
                    killed.append(True)
                    raise inj_mod.SchedulerKilled("mid-admission death")
                return real(req)

            inj_mod = jax_faults if name == "jax" else port_faults
            setattr(eng, admit_attr[name], admit_and_die)
            try:
                r = await asyncio.wait_for(
                    eng.generate(TARGET, max_tokens=MAX_TOKENS, seed=102),
                    timeout=60)
            finally:
                delattr(eng, admit_attr[name])
            assert killed
            return r.text, _delta(before, _containment(eng))
        outs[name] = await _with(engines[name], drill)
    for name, (text, d) in outs.items():
        assert text == engines["want"][0][TARGET], name
        assert d["resets"] == {"scheduler_death": 1}, (name, d)


# ----------------------------------------------------- the dense ladder

async def test_dense_ladder_one_shot_nan_replays(engines):
    """KV_POOL=false: the replay prefills prompt + generated ids into the
    slot's dense rows (the flash prefill on the card), and every
    transcript equals the fault-free one and the JAX engine's."""
    out = await _drill_both(lambda inj: _nan_once(inj, TARGET),
                            build_kw=dict(kv_pool=False,
                                          ragged_attention="off"))
    (jref, jgot, jc, _), (pref, pgot, pc, _) = out["jax"], out["port"]
    assert pref == jref == engines["want"][0]
    assert pgot == pref and jgot == jref
    assert pc["resets"] == jc["resets"] == {"slot_health": 1}
    assert pc["health_trips"] == jc["health_trips"] == 1
    assert pc["replayed_requests"] == jc["replayed_requests"] == 4
    assert pc["replayed_tokens"] == jc["replayed_tokens"] > 0


# ------------------------------------------------------------------ HTTP

def _families(text: str) -> dict:
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name in ("engine_resets", "quarantined_requests",
                        "replayed_tokens", "slot_health_trips"):
            out[fam.name] = sorted(
                (s.name, tuple(sorted(s.labels.items())), s.value)
                for s in fam.samples if not s.name.endswith("_created"))
    return out


async def _apps(params, jinj, pinj, eng_kw, cfg_kw, script):
    """Both apps over their real batched engines; ``script(client)``
    returns what is compared."""
    outs = []
    for create, config, eng in (
            (create_app, ServiceConfig(torch_device="cpu",
                                       rate_limit="1000/minute", **cfg_kw),
             _port_engine(params, pinj, **eng_kw)),
            (jax_create_app, JaxServiceConfig(engine="fake",
                                              rate_limit="1000/minute",
                                              **cfg_kw),
             _jax_engine(jinj, **eng_kw))):
        async with TestClient(TestServer(create(config, eng))) as c:
            outs.append(await script(c, eng))
    return outs


async def test_quarantine_answers_410_with_metrics_and_health(engines):
    """A persistently poisoned query: 410 "Request quarantined" in both
    apps, the four containment families in /metrics with equal values,
    and /health's last_reset and last_reset_cause."""
    params = engines["port"][0].params
    jinj, pinj = jax_faults.FaultInjector(), port_faults.FaultInjector()

    async def script(c, eng):
        eng.faults.target_substr = "poisoned query"
        eng.faults.set("decode", "nan")
        r = await c.post("/kubectl-command",
                         json={"query": "poisoned query please"})
        body = await r.json()
        metrics = await (await c.get("/metrics")).text()
        health = await (await c.get("/health")).json()
        return (r.status, body["detail"], _families(metrics),
                health["last_reset_cause"], bool(health["last_reset"]))

    port, jax_side = await _apps(params, jinj, pinj, {},
                                 dict(max_new_tokens=8), script)
    assert port == jax_side
    status, detail, fams, cause, stamped = port
    assert status == 410 and detail.startswith("Request quarantined: ")
    assert set(fams) == {"engine_resets", "quarantined_requests",
                         "replayed_tokens", "slot_health_trips"}
    assert ("engine_resets_total", (("cause", "slot_health"),), 2.0) in \
        fams["engine_resets"]
    assert ("quarantined_requests_total", (("reason", "slot_health"),),
            1.0) in fams["quarantined_requests"]
    assert cause == "slot_health" and stamped


async def test_spent_reset_budget_fails_fast_and_opens_the_breaker(engines):
    """An untargeted poison_step storm at ENGINE_RESET_MAX_PER_MIN=2: two
    resets, then the engine fails the request fast instead of resetting
    again; every reset reported to the breaker, which opens. The same
    statuses, resets and /health in both apps."""
    params = engines["port"][0].params
    jinj, pinj = jax_faults.FaultInjector(), port_faults.FaultInjector()

    async def script(c, eng):
        assert eng.supervisor.on_reset is not None    # listener wired
        eng.faults.set("decode", "poison_step")     # every fetch poisons
        statuses = []
        t0 = time.monotonic()
        for i in range(4):
            r = await c.post("/kubectl-command",
                             json={"query": f"storm request {i}"})
            statuses.append(r.status)
        elapsed = time.monotonic() - t0
        health = await (await c.get("/health")).json()
        c_ = eng.stats()["containment"]
        return (statuses, health["breaker"], health["last_reset_cause"],
                c_["resets"], c_["budget_denials"] > 0, elapsed < 20.0)

    port, jax_side = await _apps(
        params, jinj, pinj,
        dict(quarantine_retry_budget=99, reset_max_per_min=2),
        dict(llm_timeout=30.0, breaker_threshold=3,
             breaker_window_secs=60.0), script)
    assert port == jax_side
    statuses, breaker, cause, resets, denied, fast = port
    assert statuses[0] == 503 and statuses[-1] == 503
    assert breaker == "open" and cause == "scheduler_error"
    assert resets == {"scheduler_error": 2} and denied and fast


async def test_hung_chunk_trips_watchdog_and_recovers(engines):
    """A hung chunk dispatch blocks the scheduler like a hung device:
    the watchdog fails the request with 503 within the limit plus one
    interval, /health turns not ready with the breaker open; once the
    hang is released the engine is ready again and serves."""
    params = engines["port"][0].params
    jinj, pinj = jax_faults.FaultInjector(), port_faults.FaultInjector()

    async def script(c, eng):
        inj = eng.faults
        warm = await c.post("/kubectl-command",
                            json={"query": "list pods warmup"})
        inj.set("chunk", "hang", 30.0)
        t0 = time.monotonic()
        r = await c.post("/kubectl-command",
                         json={"query": "describe pod hung-one"})
        elapsed = time.monotonic() - t0
        h = await c.get("/health")
        hung = (h.status, (await h.json())["breaker"])
        inj.release("chunk")
        for _ in range(100):
            h = await c.get("/health")
            if h.status == 200:
                break
            await asyncio.sleep(0.1)
        recovered = h.status
        await asyncio.sleep(0.2)      # the breaker's recovery window
        after = await c.post("/kubectl-command",
                             json={"query": "list pods after recovery"})
        health = await (await c.get("/health")).json()
        return (warm.status in (200, 422), r.status, elapsed < 10.0,
                hung, recovered, after.status in (200, 422),
                health["breaker"])

    port, jax_side = await _apps(
        params, jinj, pinj, dict(watchdog_secs=1.0),
        dict(max_new_tokens=8, llm_timeout=30.0, breaker_threshold=1,
             breaker_recovery_secs=0.1), script)
    assert port == jax_side
    assert port == (True, 503, True, (503, "open"), 200, True, "closed")


async def test_stopped_engine_is_freed_at_once(engines):
    """stop() joins the supervisor and watchdog threads as it joins the
    scheduler: once it returns no engine thread is alive, and the
    engine (its weights and KV on the card) is freed by the next
    collection, not by some later one after the threads' last poll."""
    peng = _port_engine(engines["port"][0].params, watchdog_secs=120.0)
    await peng.start()
    await peng.generate(TARGET, max_tokens=4)
    names = {t.name for t in peng._guards}
    assert names == {"torch-batcher-supervisor", "torch-batcher-watchdog"}
    await peng.stop()
    assert not any(t.name in names and t.is_alive()
                   for t in threading.enumerate())
    ref = weakref.ref(peng)
    del peng
    gc.collect()
    assert ref() is None


# -------------------------------------------------- the watchdog's rule

@pytest.mark.parametrize("pkg", ["jax", "port"])
async def test_watchdog_check_limit_and_startup_grace(pkg):
    """The watchdog's evaluation on an engine whose scheduler never ran:
    fresh progress never fires; a stale one fires only past the startup
    grace until the first entry is consumed, and while an admission
    runs; then at the watchdog limit, failing the active and the queued
    request (cancelled, an EngineUnavailable each) and marking the
    engine not ready. The JAX engine's rule, over both."""
    if pkg == "jax":
        eng = _jax_engine(None, watchdog_secs=5.0, startup_grace_secs=600.0)
        from ai_agent_kubectl_tpu.engine.batcher import _Request, _Slot
        from ai_agent_kubectl_tpu.engine.tokenizer import StreamDecoder
        protocol = jax_protocol
    else:
        eng = _port_engine({}, None, watchdog_secs=5.0,
                           startup_grace_secs=600.0)
        from ai_agent_kubectl_tpu_torch.engine.batcher import _Request, _Slot
        from ai_agent_kubectl_tpu_torch.engine.tokenizer import (
            StreamDecoder)
        protocol = port_protocol
    loop = asyncio.get_running_loop()

    def mk():
        return _Request(prompt_ids=[1, 2, 3], max_tokens=4, temperature=0.0,
                        deadline=None, loop=loop, out_queue=asyncio.Queue(),
                        cancel=threading.Event(), t_submit=time.monotonic())

    active, queued = mk(), mk()
    eng._slots = [None] * eng.batch_size
    eng._slots[0] = _Slot(req=active, detok=StreamDecoder(eng.tokenizer),
                          n_prompt=3, pos=3, queue_ms=0.0,
                          t_admit=time.monotonic())
    eng._inflight = [("chunk", None, [active] + [None] * 3)]
    eng._admissions.put(queued)
    eng._ready = True
    seen = []
    eng._last_progress = time.monotonic()
    seen.append(eng._watchdog_check())          # fresh: no
    eng._last_progress = time.monotonic() - 30.0
    eng._first_consumed = False
    seen.append(eng._watchdog_check())          # cold start: grace
    eng._first_consumed, eng._admitting = True, 1
    seen.append(eng._watchdog_check())          # admission: grace
    eng._admitting = 0
    seen.append(eng._watchdog_check())          # a real hang: fires
    assert seen == [False, False, False, True]
    assert not eng.ready
    assert active.cancel.is_set() and queued.cancel.is_set()
    await asyncio.sleep(0)
    for req in (active, queued):
        event, payload = req.out_queue.get_nowait()
        assert event == "error"
        assert isinstance(payload, protocol.EngineUnavailable)
    assert eng._slots[0] is not None    # the scheduler owns its slots


# ---------------------------------------------------------------- units

@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_fault_spec_parsing(pkg):
    faults = PACKAGES[pkg][0]
    inj = faults.FaultInjector.from_spec(
        "admit:error:0.5,chunk:hang,generate:delay:2.0")
    assert inj.has("admit") and inj.has("chunk") and inj.has("generate")
    assert inj._faults["admit"].mode == "error"
    assert inj._faults["admit"].rate == 0.5
    assert inj._faults["chunk"].mode == "hang"
    assert inj._faults["generate"].arg == 2.0
    assert faults.FaultInjector.from_spec("") is None
    assert faults.FaultInjector.from_spec("   ") is None
    for bad in ("admit", "admit:explode", "admit:error:1.5",
                "generate:delay", "generat:error:1.0", "chunk:delay:-5",
                "chunk:hang:-1", "generate:error:0.5,generate:delay:2.0",
                "admit:nan", "chunk:poison_step", "generate:die",
                "decode:error", "scheduler:hang", "decode:nan:1.5",
                "tenant:flood"):
        with pytest.raises(ValueError):
            faults.FaultInjector.from_spec(bad)
    inj = faults.FaultInjector.from_spec("decode:nan:0.5")
    assert inj._faults["decode"].rate == 0.5
    assert faults.FaultInjector.from_spec(
        "decode:poison_step")._faults["decode"].mode == "poison_step"
    assert faults.FaultInjector.from_spec(
        "r0:scheduler:die").scoped_replicas() == {0}


def test_fault_specs_parse_the_same_in_both_packages():
    assert port_faults.KNOWN_POINTS == jax_faults.KNOWN_POINTS
    specs = ["admit:error:0.25,decode:nan:0.5", "chunk:hang:3",
             "r0:scheduler:die,tenant:flood:4", "decode:poison_step",
             "generate:delay:0.5", "draft:die,swap:fail,onload:corrupt"]
    for spec in specs:
        a = port_faults.FaultInjector.from_spec(spec)
        b = jax_faults.FaultInjector.from_spec(spec)
        assert a.describe() == b.describe()
        assert ({p: (f.mode, f.arg, f.rate, f.replica)
                 for p, f in a._faults.items()}
                == {p: (f.mode, f.arg, f.rate, f.replica)
                    for p, f in b._faults.items()})


@pytest.mark.parametrize("pkg", list(PACKAGES))
async def test_fault_injector_modes(pkg):
    faults = PACKAGES[pkg][0]
    inj = faults.FaultInjector(seed=0)
    inj.set("generate", "error")
    with pytest.raises(faults.InjectedFault):
        await inj.acheck("generate")
    with pytest.raises(faults.InjectedFault):
        inj.check("generate")
    assert inj.fired("generate") == 2
    inj.set("generate", "error", 0.0)
    for _ in range(20):
        await inj.acheck("generate")
    assert inj.fired("generate") == 2
    inj.set("generate", "delay", 0.05)
    t0 = time.monotonic()
    await inj.acheck("generate")
    assert time.monotonic() - t0 >= 0.04
    inj.set("generate", "hang", 0.1)
    t0 = time.monotonic()
    await inj.acheck("generate")
    assert time.monotonic() - t0 >= 0.08
    inj.set("generate", "hang", 30.0)
    inj.release("generate")
    t0 = time.monotonic()
    await inj.acheck("generate")
    assert time.monotonic() - t0 < 0.05
    inj.clear()
    inj.check("anything")
    # decode targeting and the one-shot points
    inj.set("decode", "nan")
    assert inj.decode_nan_slots([None, "a", "b"]) == [1]
    inj.target_substr = "b"
    assert inj.decode_nan_slots([None, "a", "b"]) == [2]
    assert inj.decode_nan_slots(["a", None]) == []
    inj.set("decode", "poison_step")
    inj.poison_fetch(["a", None])
    with pytest.raises(faults.InjectedFault):
        inj.poison_fetch(["b", None])
    inj.set("scheduler", "die")
    with pytest.raises(faults.SchedulerKilled):
        inj.check_scheduler_die()
    inj.check_scheduler_die()
    assert inj.fired("scheduler") == 1
    inj.set("tenant", "flood", 3)
    assert inj.tenant_flood() == 3 and inj.tenant_flood() == 0


@pytest.mark.parametrize("pkg", list(PACKAGES))
async def test_rearming_hang_releases_old_waiter(pkg):
    inj = PACKAGES[pkg][0].FaultInjector()
    inj.set("chunk", "hang", 30.0)
    waited = []

    async def wait_old():
        t0 = time.monotonic()
        await inj.acheck("chunk")
        waited.append(time.monotonic() - t0)

    task = asyncio.create_task(wait_old())
    await asyncio.sleep(0.05)
    inj.set("chunk", "hang", 5.0)
    await asyncio.wait_for(task, timeout=2.0)
    assert waited and waited[0] < 1.0
    inj.clear()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_packed_chunk_health_lane_roundtrip(pkg):
    protocol = PACKAGES[pkg][2]
    n, c = 3, 4
    toks = np.arange(n * c, dtype=np.int32).reshape(n, c)
    done = np.array([True, False, False])
    lengths = np.array([7, 9, 2], np.int32)
    health = np.array([0, protocol.HEALTH_NONFINITE,
                       protocol.HEALTH_NONFINITE
                       | protocol.HEALTH_TOKEN_RANGE], np.int32)
    buf = protocol.pack_chunk(toks, done, lengths, 1, health=health)
    assert buf.shape == (protocol.packed_chunk_size(n, c),)
    res = protocol.unpack_chunk(buf, n, c)
    np.testing.assert_array_equal(res.health, health)
    np.testing.assert_array_equal(res.tokens, toks)
    assert res.n_alive == 1
    res2 = protocol.unpack_chunk(protocol.pack_chunk(toks, done, lengths, 1),
                                 n, c)
    assert not res2.health.any()
    assert protocol.describe_health(0) == "ok"
    assert protocol.describe_health(
        protocol.HEALTH_NONFINITE | protocol.HEALTH_TOKEN_RANGE) == \
        "nonfinite_logits|token_out_of_range"


class _Req:
    suspect_count = 0


def _supervisor_script(mod):
    clock = {"t": 1000.0}
    sup = mod.EngineSupervisor(retry_budget=1, max_resets_per_min=2,
                               timer=lambda: clock["t"])
    seen = []
    sup.on_reset = seen.append
    out = [sup.allow_reset()]
    sup.note_reset(mod.CAUSE_SLOT_HEALTH)
    sup.note_reset(mod.CAUSE_SCHEDULER_ERROR)
    out.append(sup.allow_reset())            # spent
    clock["t"] += 61.0
    out.append(sup.allow_reset())            # the minute rolled
    req = _Req()
    out += [sup.implicate(req), sup.implicate(req), req.suspect_count]
    out.append(mod.EngineSupervisor.split([1, 2, 3, 4, 5]))
    out.append(mod.EngineSupervisor.split([1]))
    sup.note_quarantine(mod.REASON_ISOLATED)
    sup.note_health_trips(2)
    sup.note_replay(7)
    sup.note_replay(-3)
    stats = sup.stats()
    stats.pop("last_reset_wall")
    out += [stats, seen, mod.PROBATION_CLEAN_CHUNKS,
            mod.EngineSupervisor(retry_budget=-1,
                                 max_resets_per_min=0).allow_reset()]
    return out


def test_supervisor_policy_matches_the_jax_one():
    assert (_supervisor_script(port_containment)
            == _supervisor_script(jax_containment))
    out = _supervisor_script(port_containment)
    assert out[:6] == [True, False, True, False, True, 2]


# ------------------------------------------------------ config, factory

@pytest.mark.parametrize("knob,value,field", [
    ("QUARANTINE_RETRY_BUDGET", "0", "quarantine_retry_budget"),
    ("QUARANTINE_RETRY_BUDGET", "3", "quarantine_retry_budget"),
    ("ENGINE_RESET_MAX_PER_MIN", "0", "engine_reset_max_per_min"),
    ("ENGINE_WATCHDOG_SECS", "0", "engine_watchdog_secs"),
    ("ENGINE_WATCHDOG_SECS", "4.5", "engine_watchdog_secs"),
    ("ENGINE_STARTUP_GRACE_SECS", "60", "engine_startup_grace_secs"),
    ("FAULT_POINTS", "decode:nan:0.5", "fault_points"),
    ("OPENAI_API_KEY", "sk-x", "openai_api_key"),
    ("OPENAI_MODEL", "gpt-4", "openai_model"),
    ("OPENAI_BASE_URL", "http://localhost:1/v1", "openai_base_url"),
])
def test_containment_and_openai_knobs_read_as_the_jax_package(
        monkeypatch, knob, value, field):
    monkeypatch.setenv(knob, value)
    assert knob not in UNSERVED_KNOBS
    ours = ServiceConfig.from_env(env_file=None)
    theirs = JaxServiceConfig.from_env(env_file=None)
    assert getattr(ours, field) == getattr(theirs, field) != \
        getattr(ServiceConfig(), field)


def test_containment_knob_defaults_match_the_jax_package():
    ours, theirs = ServiceConfig(), JaxServiceConfig()
    for name in ("quarantine_retry_budget", "engine_reset_max_per_min",
                 "engine_watchdog_secs", "engine_startup_grace_secs",
                 "fault_points", "openai_api_key", "openai_model",
                 "openai_base_url", "slot_health_check"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert "***" == ServiceConfig(
        openai_api_key="sk-secret").describe()["openai_api_key"]


@pytest.mark.parametrize("knob,value", [
    ("QUARANTINE_RETRY_BUDGET", "one"), ("ENGINE_RESET_MAX_PER_MIN", "2.5"),
    ("ENGINE_WATCHDOG_SECS", "soon"), ("ENGINE_STARTUP_GRACE_SECS", "x")])
def test_bad_containment_knobs_raise_the_jax_errors(monkeypatch, knob,
                                                    value):
    monkeypatch.setenv(knob, value)
    errors = []
    for cls in (ServiceConfig, JaxServiceConfig):
        with pytest.raises(ValueError) as ei:
            cls.from_env(env_file=None)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


def _port_cfg(**kw):
    return ServiceConfig(torch_device="cpu", **kw)


@pytest.mark.parametrize("spec,point,fire", [
    ("swap:fail", "swap", "swap_fail"),
    ("checkpoint:corrupt", "checkpoint", "checkpoint_corrupt")])
def test_factory_serves_the_swap_and_checkpoint_points(spec, point, fire):
    """The weight swap's points boot with the batched engine, whose swap
    fires them once; under the single-sequence engine they are refused
    with the JAX factory's message (the JAX factory refuses them under
    ENGINE=fake). The host tier's points:
    test_torch_server.py::test_factory_boots_the_host_tier_fault_points."""
    from ai_agent_kubectl_tpu.server.factory import (
        build_engine as jax_build_engine)

    eng = build_engine(_port_cfg(fault_points=spec))
    assert isinstance(eng, BatchedTorchEngine)
    assert getattr(eng.faults, fire)() and not getattr(eng.faults, fire)()
    errors = []
    with pytest.raises(ValueError) as ours:
        build_engine(_port_cfg(fault_points=spec, decode_batch_size=1))
    with pytest.raises(ValueError) as theirs:
        jax_build_engine(JaxServiceConfig(engine="fake", fault_points=spec))
    for e in (ours, theirs):
        errors.append(str(e.value).split(";")[0].split(" (ENGINE")[0])
    assert errors[0] == errors[1] == (
        f"FAULT_POINTS ['{point}'] are only wired into the "
        f"continuous-batching engine")


def test_factory_refuses_inert_drills_as_the_jax_factory():
    from ai_agent_kubectl_tpu.server.factory import (
        build_engine as jax_build_engine)

    with pytest.raises(ValueError) as ours:
        build_engine(_port_cfg(fault_points="admit:error:1.0",
                               decode_batch_size=1))
    with pytest.raises(ValueError) as theirs:
        jax_build_engine(JaxServiceConfig(engine="fake",
                                          fault_points="admit:error:1.0"))
    for e in (ours, theirs):
        assert str(e.value).startswith(
            "FAULT_POINTS ['admit'] are only wired into the "
            "continuous-batching engine")
    with pytest.raises(ValueError, match="only wired"):
        build_engine(_port_cfg(engine="openai",
                               fault_points="decode:nan"))
    with pytest.raises(ValueError, match=r"replica\(s\) \[1\] but "
                       r"FLEET_SIZE=1"):
        build_engine(_port_cfg(fault_points="r1:scheduler:die"))
    with pytest.raises(ValueError, match="cannot be replica"):
        build_engine(_port_cfg(fault_points="r0:generate:error"))
    with pytest.raises(ValueError):
        build_engine(_port_cfg(fault_points="generat:error:1.0"))


def test_factory_shares_one_injector_and_wraps_generate():
    eng = build_engine(_port_cfg(
        fault_points="admit:error:1.0,generate:error:1.0"))
    assert isinstance(eng, port_faults.ChaosEngine)
    assert isinstance(eng.inner, BatchedTorchEngine)
    assert eng.inner.faults is eng.faults
    assert eng.supervisor is eng.inner.supervisor   # passes through
    eng = build_engine(_port_cfg(fault_points="r0:scheduler:die"))
    assert isinstance(eng.faults, port_faults.ReplicaFaults)
    eng = build_engine(_port_cfg(fault_points="decode:poison_step",
                                 quarantine_retry_budget=3,
                                 engine_reset_max_per_min=5,
                                 engine_watchdog_secs=7.0,
                                 engine_startup_grace_secs=30.0))
    assert (eng.supervisor.retry_budget, eng.supervisor.max_resets_per_min,
            eng.watchdog_secs, eng.startup_grace_secs) == (3, 5, 7.0, 30.0)
    assert build_engine(_port_cfg()).faults is None
