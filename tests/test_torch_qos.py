"""The port's QoS ring against the JAX package's, on the CPU.

- **The queue policy**: ``QoSQueue``, ``BrownoutController``,
  ``SessionBudgets``, ``classify`` and the spec parsers of both packages
  run the scripts of the JAX ``tests/test_qos.py`` (classification, WDRR
  shares, tenant round robin, the tenant cap, displacement, expiry,
  ``requeue_head``, starvation, AIMD brownout) on one injected clock;
  pop orders, displaced requests, exceptions and snapshots must be
  equal.
- **Admission order (fault C2)**: both batched engines serve ``toy-8m``
  with one slot; tenant A queues six requests, then tenant B one, while
  A's first decodes. The port must seat them in the JAX engine's order,
  and at a full queue (depth 4) displace and shed the same requests
  with the same errors.
- **Preempt and resume**: the port's version of the JAX test of a
  preempted victim (``BG_REQS``, ``PROBE``, ``PREEMPT_WAIT_MS=15``), in
  each batched regime (pool + ragged, pool + paged decode, the dense
  ladder), with a greedy and with a sampled victim: every transcript,
  the victims' included, at temperature 0 and 0.9, must be
  byte-identical to the JAX engine's uncontended run of the same seeds.
  A spent preemption budget leaves the victim running; direct calls run
  in one interactive bucket and never preempt.
- **HTTP**: the tier clamp, the 429 of a tenant cap and the 503 of a
  full queue (with the engine's ``Retry-After``, on both routes), the
  400 of a grammar header, ``/health``'s ``qos`` section and the
  ``qos_*`` metric families must equal the JAX app's.
- **Knobs**: a bad ``TENANT_TIERS``, ``LANE_WEIGHTS``,
  ``QOS_DEFAULT_LANE`` or ``QOS_SESSION_TOKEN_BUDGET`` raises the JAX
  message.
"""

import asyncio
import queue as _queue
import threading
import types

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine import protocol as jax_protocol
from ai_agent_kubectl_tpu.engine import qos as jax_qos
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.server.app import create_app as jax_create_app
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine import protocol as port_protocol
from ai_agent_kubectl_tpu_torch.engine import qos as port_qos
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.obs import Trace, use_trace
from ai_agent_kubectl_tpu_torch.server.app import create_app
from test_torch_env import knob_env  # noqa: F401  (autouse)

# Tiny shapes: one intra-op thread is as fast, and spares the suite's
# other workers the cores that idle OpenMP threads spin on.
torch.set_num_threads(1)

PACKAGES = {"jax": jax_qos, "port": port_qos}


# ----------------------------------------------------- the queue policy

class Clock:
    """The injected ``time.monotonic`` of both qos modules."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def _req(tenant="anon", lane="interactive", deadline=None, name="",
         preempt_count=0):
    return types.SimpleNamespace(
        tenant=tenant, lane=lane, deadline=deadline,
        cancel=threading.Event(), preempt_t0=None, name=name,
        t_enqueue=0.0, preempt_count=preempt_count)


def _outcome(fn):
    """A call's value, or its exception's type, message and QoS
    attributes."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the exception is the outcome
        return (type(e).__name__, str(e), getattr(e, "tenant", None),
                getattr(e, "lane", None))


def _pops(q, n, **kw):
    out = []
    for _ in range(n):
        try:
            out.append(q.get_nowait(**kw).name)
        except _queue.Empty:
            out.append("Empty")
    return out


def _classify_script(mod, clock):
    tiers = {"key-batch": "batch", "10.0.0.9": "background"}
    cases = [("key-batch", "1.2.3.4", None), ("key-batch", None,
                                               "background"),
             ("key-batch", None, "interactive"), (None, "10.0.0.9",
                                                  "turbo"),
             (None, "8.8.8.8", None), (None, None, None),
             ("key-batch", None, " Batch ")]
    out = [tuple(vars(mod.classify(k, ip, p, tiers)).values())
           for k, ip, p in cases]
    out.append(tuple(vars(mod.classify(
        None, "8.8.8.8", "batch", tiers, "background",
        session=" s-1 ")).values()))
    return out


def _parser_script(mod, clock):
    specs = ["a:interactive, b:batch", "", "a:turbo", "nocolon",
             ":interactive", "ip:6:0:0:1:background"]
    weights = ["interactive:9", "", "interactive:0", "warp:3", "batch",
               "batch:2,background:3"]
    return ([_outcome(lambda s=s: mod.parse_tenant_tiers(s)) for s in specs]
            + [_outcome(lambda w=w: mod.parse_lane_weights(w))
               for w in weights])


def _wdrr_script(mod, clock):
    q = mod.QoSQueue(weights={"interactive": 8, "batch": 4,
                              "background": 1})
    for i in range(20):
        for lane, tag in (("interactive", "i"), ("batch", "b"),
                          ("background", "g")):
            q.put(_req(lane=lane, name=f"{tag}{i}"))
    return _pops(q, 40) + [q.qsize(), q.lane_depths()]


def _round_robin_script(mod, clock):
    q = mod.QoSQueue()
    for i in range(3):
        q.put(_req(tenant="A", name=f"A{i}"))
        q.put(_req(tenant="B", name=f"B{i}"))
    q.put(_req(tenant="C", lane="batch", name="C0"))
    return _pops(q, 8) + [q.stats()]


def _tenant_cap_script(mod, clock):
    q = mod.QoSQueue(tenant_cap=2)
    out = [_outcome(lambda: q.put(_req(tenant="flood"))) for _ in range(3)]
    out.append(_outcome(lambda: q.put(_req(tenant="quiet"))))
    out.append(q.qsize())
    # A requeued victim counts toward its tenant's cap.
    victim = _req(tenant="quiet", name="v", preempt_count=1)
    q.requeue_head(victim)
    out.append(_outcome(lambda: q.put(_req(tenant="quiet"))))
    return out + [q.tenant_depths()]


def _displacement_script(mod, clock):
    q = mod.QoSQueue(max_depth=4)
    out = []
    for i in range(4):
        q.put(_req(tenant="flood", lane="background", name=f"f{i}"))
    out.append(_outcome(lambda: q.put(_req(tenant="flood",
                                           lane="background"))))
    out.append([d.name for d in q.put(_req(tenant="quiet", name="q0"))])
    out.append([q.qsize(), q.displaced_total])
    q2 = mod.QoSQueue(max_depth=2)
    q2.put(_req(tenant="flood"))
    q2.put(_req(tenant="flood"))
    out.append(_outcome(lambda: q2.put(_req(tenant="quiet",
                                            lane="background"))))
    # A request admitted once (a preempted victim) is never displaced.
    q3 = mod.QoSQueue(max_depth=2)
    q3.put(_req(tenant="flood", lane="background", name="fresh"))
    q3.requeue_head(_req(tenant="flood", lane="background", name="victim",
                         preempt_count=1))
    out.append([d.name for d in q3.put(_req(tenant="quiet", name="q1"))])
    q4 = mod.QoSQueue(max_depth=2)
    for nm in ("v1", "v2"):
        q4.requeue_head(_req(tenant="flood", lane="background", name=nm,
                             preempt_count=1))
    out.append(_outcome(lambda: q4.put(_req(tenant="quiet", name="q2"))))
    return out + [_pops(q, 5), _pops(q3, 3)]


def _expiry_script(mod, clock):
    expired = []
    q = mod.QoSQueue(max_depth=3, on_expire=lambda r: expired.append(
        r.name))
    for i in range(3):
        q.put(_req(deadline=clock.now - 1.0, name=f"dead{i}"))
    out = [q.qsize(), [d.name for d in q.put(_req(name="live"))],
           q.expired_total, list(expired), _pops(q, 2)]
    victim = _req(deadline=clock.now - 0.5, name="v")
    victim.preempt_t0 = clock.now - 2.0    # paused longer than over
    q.put(victim)
    q._purge_locked(clock.now, force=True)
    out.append(q.qsize())
    clock.now += 5.0
    late = _req(deadline=clock.now + 1.0, name="late")
    q.put(late)
    clock.now += 2.0
    q._purge_locked(clock.now, force=True)
    cancelled = _req(name="gone")
    q.put(cancelled)
    cancelled.cancel.set()
    q._purge_locked(clock.now, force=True)
    return out + [q.qsize(), q.expired_total, list(expired), q.stats()]


def _requeue_script(mod, clock):
    q = mod.QoSQueue()
    q.put(_req(tenant="T", lane="background", name="first"))
    q.put(_req(tenant="T", lane="background", name="second"))
    q.requeue_head(_req(tenant="T", lane="background", name="victim"))
    q.put(_req(tenant="U", lane="batch", name="b0"))
    return [_pops(q, 1, min_lane="interactive"),
            _pops(q, 1, exclude_lanes=("batch",)),
            _pops(q, 1, min_lane="batch"), _pops(q, 3), q.empty()]


def _starved_script(mod, clock):
    q = mod.QoSQueue()
    q.put(_req(lane="interactive"))
    now = clock.now
    out = [q.starved_lane(now, 10.0), q.starved_lane(now + 11.0, 10.0),
           q.starved_lane(now + 11.0, 10.0, exclude=("interactive",))]
    q2 = mod.QoSQueue()
    old = _req(tenant="T", lane="batch", name="old")
    q2.put(old)
    old.t_enqueue -= 20.0
    clock.now += 1.0
    q2.requeue_head(_req(tenant="T", lane="batch", name="fresh"))
    q2.put(_req(tenant="T", lane="background", name="bg"))
    out.append(q2.starved_lane(clock.now, 10.0))
    out.append(q2.starved_lane(clock.now + 30.0, 10.0,
                               exclude=("batch",)))
    return out


def _brownout_script(mod, clock):
    b = mod.BrownoutController(slo_ms=100.0, eval_interval_secs=0.0)
    out = [b.level]
    now = clock.now
    for _ in range(6):
        b.note_queue_wait("interactive", 500.0, now=now)
        b.note_queue_wait("background", 1e9, now=now)
        out.append((b.maybe_eval(now), b.level, dict(b.shares),
                    b.lane_cap("background", 8), b.lane_cap("batch", 8),
                    b.lane_cap("interactive", 8)))
    later = now + 60.0
    while b.level:
        out.append((b.maybe_eval(later), b.level, dict(b.shares)))
    off = mod.BrownoutController(slo_ms=0.0)
    off.note_queue_wait("interactive", 1e9)
    out.append((off.maybe_eval(), off.level, b.transitions))
    gated = mod.BrownoutController(slo_ms=100.0)
    gated.note_queue_wait("interactive", 500.0)
    out.append((gated.maybe_eval(), gated.maybe_eval(), gated.level))
    return out


def _session_script(mod, clock):
    s = mod.SessionBudgets(10, max_sessions=2)
    out = [s.lane_for("t/a", "interactive")]
    s.charge("t/a", 6)
    out.append(s.lane_for("t/a", "interactive"))
    s.charge("t/a", 4)
    s.charge("", 100)
    out += [s.lane_for("t/a", "interactive"), s.lane_for("t/a", "batch"),
            s.lane_for("t/a", "background"), s.over("t/a")]
    s.charge("t/b", 1)
    s.charge("t/c", 1)
    out += [s.over("t/a"), s.snapshot()]
    off = mod.SessionBudgets(0)
    off.charge("t/a", 100)
    return out + [off.lane_for("t/a", "interactive"), off.snapshot()]


SCRIPTS = {
    "classify": _classify_script, "parsers": _parser_script,
    "wdrr": _wdrr_script, "round_robin": _round_robin_script,
    "tenant_cap": _tenant_cap_script, "displacement": _displacement_script,
    "expiry": _expiry_script, "requeue": _requeue_script,
    "starved": _starved_script, "brownout": _brownout_script,
    "session_budgets": _session_script,
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_queue_policy_behaves_as_the_jax_one(name, monkeypatch):
    outs = []
    for mod in PACKAGES.values():
        clock = Clock()
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(monotonic=clock.monotonic))
        outs.append(SCRIPTS[name](mod, clock))
    assert outs[0] == outs[1]


# ------------------------------------------------------------ the engines

COMMON = dict(dtype="float32", max_seq_len=64, prefill_buckets=(16,),
              prefix_cache=False, chunk_len=4)
#: (prompt, temperature, seed): two greedy and two sampled background
#: requests, so byte parity across a preemption also proves the seeded
#: stream's re-alignment at temperature > 0, and one interactive probe.
BG_REQS = [("bulk a ", 0.0, 101), ("bulk b ", 0.9, 202),
           ("bulk c ", 0.9, 303), ("bulk d ", 0.0, 404)]
PROBE = ("quick q ", 0.0, 505)
#: the order the background requests arrive in: the JAX test's (its
#: victim, the first seated, is greedy) and one that seats the two
#: sampled requests first (the victim samples)
ORDERS = {"greedy_victim": BG_REQS,
          "sampled_victim": [BG_REQS[1], BG_REQS[2], BG_REQS[0],
                             BG_REQS[3]]}
REGIMES = {
    "pool-ragged": {},
    "pool-paged": dict(ragged_attention="off", decode_attn="paged"),
    "dense-paged": dict(kv_pool=False, decode_attn="paged"),
}


def _jax_engine(**kw):
    return BatchedJaxEngine(jconfig.get_config("toy-8m"),
                            tokenizer=JaxByteTokenizer(),
                            compile_cache_dir="", **COMMON, **kw)


@pytest.fixture(scope="module")
def jax_baseline():
    """The JAX engine's uncontended transcripts (preemption off) and its
    parameters, which the port's engines serve."""
    eng = _jax_engine(batch_size=2, preempt_wait_ms=0.0)
    asyncio.run(eng.start())

    async def run():
        return {p: (await eng.generate(p, max_tokens=40, temperature=t,
                                       seed=s)).text
                for p, t, s in BG_REQS + [PROBE]}

    try:
        base = asyncio.run(run())
    finally:
        asyncio.run(eng.stop())
    params = params_from_jax(jax.tree.map(np.asarray, eng.params),
                             get_config("toy-8m"))
    return base, params


def _port_engine(params, **kw):
    return BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                              params=params, device="cpu", **COMMON, **kw)


def _books(eng) -> None:
    holders: dict = {}
    for slot in eng._slots:
        if slot is not None and slot.blocks:
            for b in slot.blocks:
                holders[b] = holders.get(b, 0) + 1
    for b, n in eng._radix._held.items():
        holders[b] = holders.get(b, 0) + n
    eng._pool.check(holders)


async def _seat_in_order(eng, qos, script):
    """Seat the first of ``script`` ((tenant, prompt) pairs) in the one
    slot, hold the scheduler, queue the rest in order, release it, and
    return each request's outcome in completion order (one slot: the
    admission order)."""
    hold, release = threading.Event(), threading.Event()
    admit = eng._admit_pending

    def gated():
        if hold.is_set() and any(s is not None for s in eng._slots):
            release.wait(30.0)
        admit()

    eng._admit_pending = gated
    done = []

    async def one(tenant, prompt):
        with qos.use_qos(qos.QoSContext(tenant=tenant, lane="interactive")):
            try:
                await eng.generate(prompt, max_tokens=6, seed=1)
                done.append((prompt, "ok"))
            except Exception as e:  # noqa: BLE001 - the outcome
                done.append((prompt, type(e).__name__, str(e)))

    hold.set()
    tasks = [asyncio.ensure_future(one(*script[0]))]
    for _ in range(3000):
        await asyncio.sleep(0.002)
        if any(s is not None for s in eng._slots):
            break
    for tenant, prompt in script[1:]:
        tasks.append(asyncio.ensure_future(one(tenant, prompt)))
        await asyncio.sleep(0.002)       # each put in turn
    release.set()
    await asyncio.gather(*tasks)
    eng._admit_pending = admit
    return done


async def test_admission_order_and_full_queue_shed_match_jax(jax_baseline):
    """Fault C2: the port admitted first-in first-out and shed whoever
    arrived at a full queue; the JAX engine schedules by tenant."""
    _, params = jax_baseline
    script = ([("A", f"tenant a {i}") for i in range(6)]
              + [("B", "tenant b 0")])
    full = ([("A", f"tenant a {i}") for i in range(5)]
            + [("B", "tenant b 0"), ("A", "tenant a 5")])
    outs = []
    for make, qos in ((lambda: _jax_engine(batch_size=1), jax_qos),
                      (lambda: _port_engine(params, batch_size=1),
                       port_qos)):
        eng = make()
        await eng.start()
        try:
            order = await _seat_in_order(eng, qos, script)
            eng._admissions.max_depth = 4
            shed = await _seat_in_order(eng, qos, full)
            stats = eng.stats()
        finally:
            await eng.stop()
        outs.append((order, shed, stats["queue_rejections"],
                     stats["qos"]["displaced"]))
    assert outs[0] == outs[1]
    order, shed, rejections, displaced = outs[1]
    # Tenant B is not seated behind all of A's queue, and at the full
    # queue A's newest is displaced for B while A's next arrival is shed.
    assert [p for p, *_ in order].index("tenant b 0") < 6
    assert ("tenant a 4", "EngineOverloaded") == shed[0][:2]
    assert rejections == 2 and displaced == 1


async def _contended(eng, order, tag_traces=None):
    """Background requests of tenant ``bulk`` fill both slots; once each
    slot has a token, the interactive probe arrives. Returns (probe,
    background results by prompt, trace events by prompt)."""
    traces = {}

    async def run_bg(p, t, s):
        tr = Trace(f"qos-{p.strip()}", "POST", "/t")
        traces[p] = tr
        with use_trace(tr), port_qos.use_qos(port_qos.QoSContext(
                tenant="bulk", lane="background")):
            return await eng.generate(p, max_tokens=40, temperature=t,
                                      seed=s)

    tasks = [asyncio.ensure_future(run_bg(*r)) for r in order]
    for _ in range(2000):
        await asyncio.sleep(0.005)
        if all(s is not None and len(s.detok.ids) > 0 for s in eng._slots):
            break
    else:
        pytest.fail("background never filled the slots")
    p, t, s = PROBE
    with port_qos.use_qos(port_qos.QoSContext(tenant="quiet",
                                              lane="interactive")):
        probe = await eng.generate(p, max_tokens=8, temperature=t, seed=s)
    results = dict(zip([r[0] for r in order], await asyncio.gather(*tasks)))
    events = {p: [m for _, m, _ in tr._events] for p, tr in traces.items()}
    return probe, results, events


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("regime", list(REGIMES))
async def test_preempted_victim_resumes_as_the_jax_engine(jax_baseline,
                                                          regime, order):
    want, params = jax_baseline
    eng = _port_engine(params, batch_size=2, preempt_wait_ms=15.0,
                       preempt_budget=2, **REGIMES[regime])
    await eng.start()
    try:
        probe, results, events = await _contended(eng, ORDERS[order])
        qos = eng.stats()["qos"]
        assert qos["preemptions"] >= 1 and qos["preempted_tokens"] > 0
        assert probe.text == want[PROBE[0]][:len(probe.text)]
        for p, r in results.items():
            assert r.text == want[p], \
                f"transcript changed across preemption for {p!r}"
        victims = [p for p, ev in events.items()
                   if any("preempted out of slot" in m for m in ev)]
        temps = dict((p, t) for p, t, _ in BG_REQS)
        assert victims and (order == "greedy_victim"
                            or any(temps[v] > 0 for v in victims))
        flat = [m for ev in events.values() for m in ev]
        assert any("replayed into slot" in m for m in flat)
        assert any("resuming after" in m for m in flat)
        assert eng.qos_health()["preemptions_total"] == qos["preemptions"]
        if eng.kv_pool:
            _books(eng)
    finally:
        await eng.stop()


async def test_spent_preempt_budget_leaves_the_victim_running(jax_baseline):
    want, params = jax_baseline
    eng = _port_engine(params, batch_size=2, preempt_wait_ms=15.0,
                       preempt_budget=0)
    await eng.start()
    try:
        probe, results, events = await _contended(eng, BG_REQS)
        assert eng.stats()["qos"]["preemptions"] == 0
        assert probe.text == want[PROBE[0]][:len(probe.text)]
        assert all(r.text == want[p] for p, r in results.items())
        assert not any("preempted" in m for ev in events.values()
                       for m in ev)
    finally:
        await eng.stop()


async def test_direct_calls_run_in_the_default_lane(jax_baseline):
    """No QoS context: one interactive anon bucket, as before the ring
    (and never a preemption)."""
    want, params = jax_baseline
    eng = _port_engine(params, batch_size=2, preempt_wait_ms=15.0)
    await eng.start()
    try:
        seen = []
        put = eng._admissions.put

        def recording(req):
            seen.append((req.tenant, req.lane))
            return put(req)

        eng._admissions.put = recording
        rs = await asyncio.gather(*[
            eng.generate(p, max_tokens=40, temperature=t, seed=s)
            for p, t, s in BG_REQS])
        assert [r.text for r in rs] == [want[p] for p, _, _ in BG_REQS]
        assert set(seen) == {("anon", "interactive")}
        qos = eng.stats()["qos"]
        assert qos["preemptions"] == 0
        assert qos["lane_occupancy"]["interactive"] == 0
        assert qos["lane_depth"] == {"background": 0, "batch": 0,
                                     "interactive": 0}
    finally:
        await eng.stop()


# -------------------------------------------------------------------- HTTP

class StubEngine:
    """Records each call's QoS context (from its own package) and
    answers the next outcome of ``script``: a text, or an exception."""

    name = "stub"
    ready = True
    device = None

    def __init__(self, protocol, qos, script=()):
        self.protocol, self.qos = protocol, qos
        self.script = list(script)
        self.seen = []

    async def start(self):
        pass

    async def stop(self, drain_secs=0.0):
        pass

    def _next(self):
        ctx = self.qos.current_qos()
        self.seen.append(None if ctx is None else tuple(vars(ctx).values()))
        out = self.script.pop(0) if self.script else "kubectl get pods"
        if isinstance(out, Exception):
            raise out
        return out

    async def generate(self, prompt, **kw):
        return self.protocol.EngineResult(text=self._next(),
                                          completion_tokens=3,
                                          engine=self.name)

    async def generate_stream(self, prompt, **kw):
        yield self._next()


def _sheds(protocol):
    return [protocol.TenantOverloaded(
        "tenant queue cap reached (3/3 queued for tenant 'x', lane "
        "interactive)", retry_after=7.0, tenant="x", lane="interactive"),
        protocol.EngineOverloaded("admission queue full (4/4)",
                                  retry_after=2.2)] * 2


async def _http_both(requests, cfg=None, script_fn=lambda p: ()):
    """Send ``requests`` ((method, path, json, headers)) to the port's
    app and the JAX app, each over a stub engine; return (answers,
    engine contexts) per app, the port's first."""
    outs = []
    for create, config, protocol, qos in (
            (create_app, ServiceConfig(torch_device="cpu",
                                       rate_limit="1000/minute",
                                       **(cfg or {})),
             port_protocol, port_qos),
            (jax_create_app, JaxServiceConfig(engine="fake",
                                              rate_limit="1000/minute",
                                              **(cfg or {})),
             jax_protocol, jax_qos)):
        engine = StubEngine(protocol, qos, script_fn(protocol))
        answers = []
        async with TestClient(TestServer(create(config, engine))) as c:
            for method, path, body, headers in requests:
                r = await c.request(method, path, json=body,
                                    headers=headers)
                if "stream" in path and r.status == 200:
                    body = await r.text()
                else:      # the body less its timestamps and durations
                    body = {k: v for k, v in (await r.json()).items()
                            if k not in ("metadata", "timings")}
                answers.append((r.status, body,
                                r.headers.get("Retry-After")))
        outs.append((answers, engine.seen))
    return outs


def _post(query, path="/kubectl-command", **headers):
    return ("POST", path, {"query": query}, headers)


async def test_tier_clamp_and_tenant_keys_as_the_jax_app():
    port, jax_side = await _http_both([
        _post("list pods one", **{"X-API-Key": "bulk-key",
                                  "X-Priority": "interactive"}),
        _post("list pods two", **{"X-API-Key": "bulk-key",
                                  "X-Priority": "background"}),
        _post("list pods three"),
        _post("list pods four", **{"X-API-Key": "spoofed-random-key"}),
        _post("list pods five", **{"X-Priority": "batch",
                                   "X-Session-ID": "s-9"}),
        _post("list pods six", path="/kubectl-command/stream",
              **{"X-API-Key": "bulk-key"}),
    ], cfg=dict(tenant_tiers="bulk-key:batch"))
    assert port == jax_side
    lanes = [ctx[1] for ctx in port[1]]
    assert lanes == ["batch", "background", "interactive", "interactive",
                     "batch", "batch"]


async def test_engine_sheds_answer_429_and_503_as_the_jax_app():
    reqs = [_post("list pods one"), _post("list pods two"),
            _post("list pods three", path="/kubectl-command/stream"),
            _post("list pods four", path="/kubectl-command/stream")]
    port, jax_side = await _http_both(reqs, script_fn=_sheds)
    assert port[0] == jax_side[0]
    (s429, body, retry), (s503, _, retry503) = port[0][:2]
    assert (s429, retry, s503, retry503) == (429, "7", 503, "3")
    assert body["detail"].startswith("Tenant over queue quota: ")


@pytest.mark.parametrize("header", ["X-Grammar-Profile", "X-Allowed-Verbs"])
async def test_grammar_headers_answer_400_as_the_jax_app(header):
    port, jax_side = await _http_both([
        _post("list pods", **{header: "readonly"}),
        _post("list pods", path="/kubectl-command/stream",
              **{header: "get"})])
    assert port[0] == jax_side[0]
    assert [a[0] for a in port[0]] == [400, 400]
    assert port[0][0][1] == {
        "detail": "grammar restrictions require GRAMMAR_DECODE=true"}
    assert port[1] == []


def _qos_families(text):
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name.endswith("_created"):
            continue
        if fam.name.startswith("qos_") or fam.name in ("queue_expired",
                                                      "queue_displaced"):
            out[fam.name] = sorted((s.name, tuple(sorted(s.labels.items())),
                                    s.value) for s in fam.samples
                                   if not s.name.endswith("_created"))
    return out


async def test_health_and_metrics_qos_sections_as_the_jax_app(jax_baseline):
    """Both apps over their real batched engines: the same requests,
    then ``/health``'s ``qos`` section and the ``qos_*`` families."""
    _, params = jax_baseline
    cfg = dict(rate_limit="1000/minute", max_new_tokens=6,
               tenant_tiers="bulk-key:background")
    outs = []
    for create, config, engine in (
            (create_app, ServiceConfig(torch_device="cpu", **cfg),
             _port_engine(params, batch_size=2)),
            (jax_create_app, JaxServiceConfig(engine="fake", **cfg),
             _jax_engine(batch_size=2))):
        async with TestClient(TestServer(create(config, engine))) as c:
            statuses = []
            for key in ("bulk-key", None, "bulk-key"):
                r = await c.post("/kubectl-command",
                                 json={"query": "list the pods"},
                                 headers={"X-API-Key": key} if key else {})
                statuses.append(r.status)
            health = await (await c.get("/health")).json()
            metrics = await (await c.get("/metrics")).text()
        outs.append((statuses, health["qos"], _qos_families(metrics)))
    assert outs[0] == outs[1]
    assert set(outs[0][2]) == {
        "qos_queue_depth", "qos_lane_occupancy", "qos_brownout_level",
        "qos_preemptions", "qos_preempted_tokens", "queue_expired",
        "queue_displaced"}
    assert outs[0][1]["lanes"] == {"background": 0, "batch": 0,
                                   "interactive": 0}


# -------------------------------------------------------------------- knobs

@pytest.mark.parametrize("knob,value", [
    ("TENANT_TIERS", "a:turbo"), ("TENANT_TIERS", "nocolon"),
    ("TENANT_TIERS", ":interactive"), ("LANE_WEIGHTS", "interactive:0"),
    ("LANE_WEIGHTS", "warp:3"), ("LANE_WEIGHTS", "batch"),
    ("QOS_DEFAULT_LANE", "turbo"), ("QOS_SESSION_TOKEN_BUDGET", "-1"),
])
def test_bad_qos_knobs_raise_the_jax_errors(monkeypatch, knob, value):
    monkeypatch.setenv(knob, value)
    errors = []
    for cls in (ServiceConfig, JaxServiceConfig):
        with pytest.raises(ValueError) as ei:
            cls.from_env(env_file=None)
        errors.append(str(ei.value))
    assert errors[0] == errors[1] and knob in errors[0]
