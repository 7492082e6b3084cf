"""The port's telemetry plane against the JAX package's, on the CPU.

- **The pure modules**: ``GoodputLedger``, ``SloEngine``,
  ``StepTimeSentinel``, ``IncidentManager``, ``load_baselines``,
  ``prefill_bucket`` and ``parse_slo_windows`` of both packages run the
  same seeded event scripts on one injected clock; every snapshot,
  return value and exception must be equal, exactly.
- **Fault C4**: the port's scheduler evaluated the brownout without the
  SLO engine's burn input. The example input (SLO_INTERACTIVE_MS=2000,
  objective 0.99, 96 interactive admissions that waited 100 ms and 4
  that waited 3000 ms: p95 100 ms, burn 4) runs through both engines'
  own ``_slo`` and ``_brownout`` and their worker loops' call: both trim
  the background share.
- **The engines**: ``BatchedTorchEngine`` against ``BatchedJaxEngine``
  at ``CHUNK_PIPE_DEPTH`` 1 and 3 on toy-8m, greedy, one slot: a
  background victim preempted at its fifth token by an interactive
  probe, and a request cancelled while a chunk is in flight. The
  ledger's delivered, preempted, replayed and wasted_masked steps per
  lane, the SLO sample counts per (slo, lane), the sentinel's prefill
  keys and its decode samples must be equal, the books balanced in both
  (a one-deep pipe records no decode sample in either engine).
- **Quarantine**: a tripped health bit bills the request's tokens as
  quarantine_burn, never delivered, and the books still balance.
- **Logs**: the JSON formatter stamps the JAX formatter's fields.
- **Attribution**: ``categorize`` maps every JAX scope keyword to the
  JAX category; ``attribute_trace`` on a synthetic torch Chrome trace
  gives the categories, gaps and coverage worked out by hand;
  ``run_attribution`` on the CPU validates with ``host_ops`` spans;
  ``scope`` is a shared no-op while no profiler runs.
"""

import asyncio
import json
import logging
import random
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu import logging_setup as jax_logging
from ai_agent_kubectl_tpu.engine import qos as jax_qos
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.obs import attribution as jax_attr
from ai_agent_kubectl_tpu.obs import incidents as jax_incidents
from ai_agent_kubectl_tpu.obs import ledger as jax_ledger
from ai_agent_kubectl_tpu.obs import slo as jax_slo
from ai_agent_kubectl_tpu.obs import steptime as jax_steptime
from ai_agent_kubectl_tpu.obs import trace as jax_trace
from ai_agent_kubectl_tpu_torch import logging_setup as port_logging
from ai_agent_kubectl_tpu_torch.engine import qos as port_qos
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.protocol import RequestQuarantined
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.obs import attribution as port_attr
from ai_agent_kubectl_tpu_torch.obs import incidents as port_incidents
from ai_agent_kubectl_tpu_torch.obs import ledger as port_ledger
from ai_agent_kubectl_tpu_torch.obs import profiler as port_profiler
from ai_agent_kubectl_tpu_torch.obs import slo as port_slo
from ai_agent_kubectl_tpu_torch.obs import steptime as port_steptime
from ai_agent_kubectl_tpu_torch.obs import trace as port_trace

torch.set_num_threads(1)


def _outcome(fn):
    """A call's value, or its exception's type and message."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the exception is the outcome
        return (type(e).__name__, str(e))


# ------------------------------------------------------- the pure modules

LANES = ("interactive", "batch", "background")


def _ledger_script(mod, tmp_path):
    rng = random.Random(7)
    led = mod.GoodputLedger(max_tenants=4)
    off = mod.GoodputLedger(enabled=False)
    for _ in range(300):
        cls = rng.choice(mod.LEDGER_CLASSES)
        n = rng.randint(-1, 9)
        lane = rng.choice(LANES)
        tenant = rng.choice([None, "", "key-a", "key-b", "10.0.0.1",
                             "key-c", "key-d", "key-e"])
        led.record(cls, n, lane=lane, tenant=tenant)
        off.record(cls, n, lane=lane, tenant=tenant)
    other = mod.GoodputLedger()
    other.record("delivered", 5, lane="batch", tenant="x")
    return [led.snapshot(), led.tenant_snapshot(), led.conservation(),
            off.snapshot(), mod.hash_tenant("secret-key"),
            mod.hash_tenant(None),
            _outcome(lambda: led.record("bogus", 1)),
            mod.merge_snapshots([led.snapshot(), other.snapshot(), None])]


def _slo_script(mod, tmp_path):
    rng = random.Random(11)
    eng = mod.SloEngine({"ttft": 500.0, "queue_wait": 200.0,
                         "session_ttft": 0.0},
                        objective=0.95, windows=(60, 600))
    out = []
    t = 5000.0
    for i in range(400):
        t += rng.random() * 4.0
        eng.note(rng.choice(["ttft", "queue_wait", "session_ttft"]),
                 rng.choice(LANES), rng.random() * 800.0, now=t)
        if i % 97 == 0:
            out.append(eng.snapshot(now=t))
            out.append(eng.fast_burn("queue_wait", "interactive", now=t))
    out += [eng.snapshot(now=t + 700.0),
            eng.fast_burn("ttft", "batch", now=t + 30.0),
            eng.fast_burn("session_ttft", "batch", now=t),
            _outcome(lambda: mod.SloEngine({}, objective=1.5)),
            mod.merge_snapshots([eng.snapshot(now=t), None,
                                 eng.snapshot(now=t + 100.0)]),
            mod.window_label(90), mod.window_label(7200)]
    return out


def _steptime_script(mod, tmp_path):
    rng = random.Random(3)
    base = {"decode": {"128": 4.0, "default": 6.0},
            "prefill": {"default": 20.0}}
    sen = mod.StepTimeSentinel(window=32, factor=2.0, min_samples=8,
                               baselines=base, min_breach_ms=1.0)
    out = []
    t = 100.0
    for i in range(240):
        t += 0.05
        phase = rng.choice(["decode", "prefill", "spec_verify"])
        bucket = rng.choice([128, 256, 64])
        slow = 5.0 if 120 <= i < 180 else 1.0
        sen.note(phase, bucket, rng.random() * 0.01 * slow,
                 steps=rng.randint(1, 8), tokens=rng.randint(0, 64), now=t)
        if i % 40 == 0:
            out.append(sen.snapshot(now=t))
    out.append(sen.snapshot(now=t))
    out.append(_outcome(lambda: sen.note("warmup", 1, 0.1)))
    calm = mod.StepTimeSentinel(window=16, min_samples=4)
    for i in range(12):
        calm.note("decode", 128, 0.004, now=200.0 + i)
    out.append(calm.snapshot(now=220.0))
    snaps = [sen.snapshot(now=t), calm.snapshot(now=220.0)]
    out.append(mod.merge_snapshots(snaps + [None]))
    out.append(mod.canary_vs_stable(snaps[0], [snaps[1]], min_samples=2))
    return out


def _incidents_script(mod, tmp_path, monkeypatch=None):
    clock = types.SimpleNamespace(now=50.0)
    fake_time = types.SimpleNamespace(
        monotonic=lambda: clock.now,
        time=lambda: 1_700_000_000.0 + clock.now,
        strftime=time.strftime,
        gmtime=lambda *a: time.gmtime(1_700_000_000))
    monkeypatch.setattr(mod, "time", fake_time)
    monkeypatch.setattr(mod, "_active_stamps", [])
    mgr = mod.IncidentManager(ring=3, cooldown_secs=10.0,
                              burn_threshold=2.0, thrash_min_blocks=2)
    views = [
        {"steptime": {"breaches": [{"phase": "decode"}], "trips_total": 1},
         "slo": None, "kv_pool": {"starved_slots_total": 0},
         "breaker": "closed", "quarantined_total": 3},
        {"steptime": {}, "slo": {"windows": ["5m"], "slos": {"ttft": {
            "lanes": {"interactive": {"windows": {
                "5m": {"total": 10, "burn_rate": 3.5}}}}}}},
         "kv_pool": {"starved_slots_total": 2, "free": 1,
                     "host_tier": {"demoted_total": 5,
                                   "onloaded_total": 5}},
         "grammar": {"dead_ends_total": {"decode": 1}},
         "breaker": "open", "quarantined_total": 4},
        {"steptime": {"breaches": [{"phase": "decode"}]},
         "kv_pool": {"starved_slots_total": 2,
                     "host_tier": {"demoted_total": 9,
                                   "onloaded_total": 8}},
         "breaker": "open", "quarantined_total": 4},
    ]
    out = []
    for i, v in enumerate(views):
        clock.now += 4.0 * (i + 1)
        out.append([(b["id"], b["trigger"], b["detail"], b["at"])
                    for b in mgr.evaluate(v, lambda: {"x": i})])
        out.append(mgr.snapshot())
        out.append(mod.current_incident_id(now=clock.now))
    out.append(mgr.list())
    out.append(mgr.get(mgr.list()[0]["id"]))
    out.append(_outcome(lambda: mgr.maybe_capture("bogus", {}, dict)))
    out.append(mod.current_incident_id(now=clock.now + 100.0))
    return out


def _baselines_script(mod, tmp_path):
    cases = {
        "ok": {"step_time_ms": {"decode": {"128": 5, "default": 7.5},
                                "prefill": {"default": "20"}},
               "source": "x"},
        "empty": {"step_time_ms": {}},
        "phase": {"step_time_ms": {"warmup": {"default": 1}}},
        "row": {"step_time_ms": {"decode": 5}},
        "nan": {"step_time_ms": {"decode": {"1": "fast"}}},
        "neg": {"step_time_ms": {"decode": {"1": 0}}},
    }
    out = []
    for name, body in cases.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(body))
        out.append(_outcome(lambda: mod.load_baselines(str(path))))
    out.append(_outcome(lambda: mod.load_baselines(
        str(tmp_path / "missing.json")))[0])
    return out


def _prefill_bucket_script(mod, tmp_path):
    return ([mod.prefill_bucket(n) for n in range(0, 1500, 37)]
            + [mod.prefill_bucket(n, (16, 48)) for n in (1, 16, 17, 49)]
            + [mod.prefill_bucket(9, ())])


def _windows_script(mod, tmp_path):
    specs = ["300,3600", " 60 , 600 ", "", "0,60", "60,30", "60,60",
             "1,2,3,4,5", "a,b", "86400"]
    return [_outcome(lambda s=s: mod.parse_slo_windows(s)) for s in specs]


MODULE_SCRIPTS = {
    "GoodputLedger": (_ledger_script, jax_ledger, port_ledger),
    "SloEngine": (_slo_script, jax_slo, port_slo),
    "StepTimeSentinel": (_steptime_script, jax_steptime, port_steptime),
    "IncidentManager": (_incidents_script, jax_incidents, port_incidents),
    "load_baselines": (_baselines_script, jax_steptime, port_steptime),
    "prefill_bucket": (_prefill_bucket_script, jax_steptime,
                       port_steptime),
    "parse_slo_windows": (_windows_script, jax_slo, port_slo),
}


@pytest.mark.parametrize("name", list(MODULE_SCRIPTS))
def test_pure_module_matches_the_jax_one(name, tmp_path, monkeypatch):
    script, jax_mod, port_mod = MODULE_SCRIPTS[name]
    kw = ({"monkeypatch": monkeypatch} if script is _incidents_script
          else {})
    outs = [script(mod, tmp_path, **kw) for mod in (jax_mod, port_mod)]
    assert outs[0] == outs[1]


# ----------------------------------------------------------- the engines

COMMON = dict(dtype="float32", max_seq_len=64, prefill_buckets=(16,),
              prefix_cache=False, chunk_len=4)
VICTIM = ("bulk a ", 101)     # greedy, background
PROBE = ("quick q ", 505)     # greedy, interactive
CANCELLED = ("bulk d ", 404)  # greedy, cancelled at its fifth token


def _jax_engine(depth=1, **kw):
    return BatchedJaxEngine(jconfig.get_config("toy-8m"),
                            tokenizer=JaxByteTokenizer(),
                            compile_cache_dir="", chunk_pipe_depth=depth,
                            **COMMON, **kw)


def _port_engine(params, depth=1, **kw):
    return BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                              params=params, device="cpu",
                              ragged_attention="off", chunk_pipe_depth=depth,
                              **COMMON, **kw)


@pytest.fixture(scope="module")
def jax_params():
    eng = _jax_engine(batch_size=1)
    asyncio.run(eng.start())
    asyncio.run(eng.stop())
    return params_from_jax(jax.tree.map(np.asarray, eng.params),
                           get_config("toy-8m"))


def _hook_preempt(eng, victim: str, ready: threading.Event):
    """Let ``_maybe_preempt`` act only once the victim holds its fifth
    token and the probe has queued past PREEMPT_WAIT_MS; the scheduler
    waits there for it, so the victim is preempted at exactly five
    tokens in both engines."""
    orig = eng._maybe_preempt
    state = {"done": False}

    def hooked():
        slot = eng._slots[0]
        if (state["done"] or slot is None
                or list(slot.req.prompt_ids) != eng.tokenizer.encode(victim)):
            return orig()
        if len(slot.detok.ids) < 5:
            return False
        ready.wait(30.0)
        time.sleep(0.05)              # past PREEMPT_WAIT_MS
        state["done"] = True
        return orig()

    eng._maybe_preempt = hooked


def _hook_cancel(eng, target: str):
    """Cancel the target at its fifth token while a chunk is in flight
    for it (a host-only finish at the same scheduler point in both)."""
    orig = eng._sweep_finishes

    def hooked():
        slot = eng._slots[0]
        if (slot is not None
                and list(slot.req.prompt_ids) == eng.tokenizer.encode(target)
                and slot.decode_chunks_inflight > 0
                and len(slot.detok.ids) >= 5):
            slot.req.cancel.set()
        orig()

    eng._sweep_finishes = hooked


def _books(eng):
    ledger = eng.ledger_snapshot()
    slo = eng.stats()["slo"]
    samples = {(s, lane): row["samples_total"]
               for s, body in slo["slos"].items()
               for lane, row in body["lanes"].items()}
    return ledger, samples


async def _flood(eng, qos):
    ready = threading.Event()
    _hook_preempt(eng, VICTIM[0], ready)
    _hook_cancel(eng, CANCELLED[0])
    ledger0, slo0 = _books(eng)

    async def run(prompt, seed, lane, tenant):
        with qos.use_qos(qos.QoSContext(tenant=tenant, lane=lane)):
            return await eng.generate(prompt, max_tokens=24, seed=seed)

    async def quiet():
        # At depth 3 the chunks dispatched past a drain stay in flight
        # until the idle scheduler prunes them, and a dispatch with one
        # still in flight takes a step-time sample: start each request
        # from an empty pipe, so both engines sample alike.
        deadline = time.monotonic() + 60.0
        while eng._inflight:
            assert time.monotonic() < deadline, "the pipe never emptied"
            await asyncio.sleep(0.002)

    await quiet()
    victim = asyncio.ensure_future(run(*VICTIM, "background", "bulk"))
    for _ in range(3000):
        await asyncio.sleep(0.002)
        if eng._slots[0] is not None:
            break
    probe = asyncio.ensure_future(run(*PROBE, "interactive", "quiet"))
    for _ in range(3000):
        await asyncio.sleep(0.002)
        if eng._admissions.qsize() >= 1:
            break
    ready.set()
    results = [await victim, await probe]
    await quiet()
    results.append(await run(*CANCELLED, "interactive", "quiet"))
    ledger1, slo1 = _books(eng)
    rows = {lane: {cls: row[cls] - ledger0["lanes"].get(lane, {}).get(
        cls, 0) for cls in ("delivered", "preempted", "replayed",
                            "wasted_masked", "quarantine_burn")}
            for lane, row in ledger1["lanes"].items()}
    samples = {k: v - slo0.get(k, 0) for k, v in slo1.items()}
    digests = eng.steptime_health()["digests"]
    return dict(
        texts=[r.text for r in results],
        finish=[r.finish_reason for r in results],
        rows=rows, samples=samples,
        conservation=ledger1["conservation"]["balanced"],
        prefill_keys=sorted(k for k in digests if k.startswith("prefill/")),
        decode_count=sum(d["count"] for k, d in digests.items()
                         if k.startswith("decode/")),
        preemptions=eng.stats()["qos"]["preemptions"],
        wasted=eng.stats()["wasted_decode_steps"])


async def _books_both(jax_params, depth):
    outs = []
    kw = dict(batch_size=1, preempt_wait_ms=15.0, slo_ttft_ms=5000.0,
              slo_interactive_ms=2000.0)
    for make, qos in ((lambda: _jax_engine(depth, **kw), jax_qos),
                      (lambda: _port_engine(jax_params, depth, **kw),
                       port_qos)):
        eng = make()
        await eng.start()
        try:
            outs.append(await _flood(eng, qos))
        finally:
            await eng.stop()
    jax_out, port_out = outs
    assert jax_out["preemptions"] == port_out["preemptions"] == 1
    assert port_out["finish"][2] == jax_out["finish"][2] == "abort"
    for key in ("texts", "rows", "samples", "prefill_keys", "decode_count",
                "wasted"):
        assert port_out[key] == jax_out[key], key
    assert port_out["rows"]["background"]["preempted"] == 5
    assert jax_out["conservation"] and port_out["conservation"]
    return port_out


async def test_engine_books_match_the_jax_engine_at_pipe_depth_one(
        jax_params):
    port_out = await _books_both(jax_params, 1)
    assert port_out["rows"]["interactive"]["wasted_masked"] == 4
    assert port_out["wasted"] == 4
    # The sentinel samples a dispatch-to-dispatch interval only while a
    # chunk is still in flight at the next dispatch: never at depth 1.
    assert port_out["decode_count"] == 0


async def test_engine_books_match_the_jax_engine_at_pipe_depth_three(
        jax_params):
    """The same drill with chunks in flight: the victim leaves with its
    in-flight chunks billed as waste, the cancelled request likewise,
    and the sentinel samples the decode intervals the JAX engine
    samples."""
    port_out = await _books_both(jax_params, 3)
    assert port_out["wasted"] > 4
    assert port_out["decode_count"] > 0


def test_fault_c4_brownout_reads_the_slo_burn_rate(jax_params):
    """C4: SLO_INTERACTIVE_MS=2000, objective 0.99; 96 interactive
    admissions waited 100 ms and 4 waited 3000 ms. The p95 (100 ms) is
    under the target but the fast-window burn is 4: the JAX engine's
    worker loop trims the background share, and the port's must too
    (the parent's left every share at 1.0)."""
    waits = [100.0] * 96 + [3000.0] * 4
    outs = []
    for make, lane in ((lambda: _jax_engine(batch_size=1,
                                            slo_interactive_ms=2000.0),
                        jax_qos.LANE_INTERACTIVE),
                       (lambda: _port_engine(jax_params, batch_size=1,
                                             slo_interactive_ms=2000.0),
                        port_qos.LANE_INTERACTIVE)):
        eng = make()
        asyncio.run(eng.start())
        try:
            assert eng._brownout.slo_ms == 2000.0
            now = time.monotonic()
            for w in waits:
                eng._brownout.note_queue_wait(lane, w, now=now)
                eng._slo.note("queue_wait", lane, w, now=now)
            p95 = eng._brownout._p95_locked(time.monotonic())
            burn = eng._slo.fast_burn("queue_wait", lane)
            deadline = time.monotonic() + 10.0
            while (eng._brownout.transitions == 0
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            shares = dict(eng._brownout.shares)
        finally:
            asyncio.run(eng.stop())
        outs.append((p95, burn, shares))
    for p95, burn, shares in outs:
        assert p95 == 100.0 and burn > 1.0
        assert shares["background"] <= 0.5 and shares["batch"] == 1.0
    assert outs[0][2] == outs[1][2]


async def test_health_tripped_request_bills_quarantine_burn(jax_params):
    """A health-tripped request past its retry budget (0 here: quarantine
    on the first trip) ends with RequestQuarantined: its generated
    tokens bill quarantine_burn (the JAX containment pass's class for a
    terminal quarantine), not delivered, and the books balance."""
    eng = _port_engine(jax_params, batch_size=1, quarantine_retry_budget=0)
    await eng.start()
    try:
        orig = eng._sample
        calls = {"n": 0}

        def poisoned(step_logits, ngen, live):
            tok = orig(step_logits, ngen, live)
            calls["n"] += 1
            if calls["n"] == 3:      # the third decode step of the chunk
                tok = torch.full_like(tok, eng.model_cfg.vocab_size + 7)
            return tok

        before = eng.ledger_snapshot()["classes"]
        eng._sample = poisoned
        with pytest.raises(RequestQuarantined):
            await eng.generate("bulk a ", max_tokens=24, seed=101)
        eng._sample = orig
        snap = eng.ledger_snapshot()
        burned = (snap["classes"]["quarantine_burn"]
                  - before["quarantine_burn"])
        # The poisoned chunk emits nothing (its clean rows included, as
        # in the JAX containment pass): the first token is what burned.
        assert burned == 1
        assert snap["classes"]["delivered"] == before["delivered"]
        assert snap["conservation"]["balanced"]
        assert any(e["event"] == "health_trip" for e in eng._chunk_log)
    finally:
        await eng.stop()


# ------------------------------------------------------------------ logs

def _log_line(mod, trace_mod, qos_mod, incident_mod, monkeypatch):
    monkeypatch.setattr(incident_mod, "_active_stamps", [])
    incident_mod._note_incident("inc-000001-001",
                                until=time.monotonic() + 60.0)
    record = logging.LogRecord("test.logger", logging.WARNING, __file__, 1,
                               "served %s", ("q1",), None)
    with trace_mod.use_trace(trace_mod.Trace("rid-json-1")), \
            qos_mod.use_qos(qos_mod.QoSContext(tenant="secret-api-key",
                                               lane="batch")):
        assert mod.RequestIdFilter().filter(record)
    entry = json.loads(mod.JsonFormatter().format(record))
    bare = logging.LogRecord("x", logging.INFO, __file__, 1, "no ctx", (),
                             None)
    monkeypatch.setattr(incident_mod, "_active_stamps", [])
    mod.RequestIdFilter().filter(bare)
    bare_entry = json.loads(mod.JsonFormatter().format(bare))
    for e in (entry, bare_entry):
        e.pop("ts")
    text = mod.TextFormatter().format(record)
    return entry, bare_entry, text.split(" - ", 1)[1]


def test_json_log_lines_carry_the_jax_fields(monkeypatch):
    jax_line = _log_line(jax_logging, jax_trace, jax_qos, jax_incidents,
                         monkeypatch)
    port_line = _log_line(port_logging, port_trace, port_qos,
                          port_incidents, monkeypatch)
    assert port_line == jax_line
    entry = port_line[0]
    assert entry["request_id"] == "rid-json-1"
    assert entry["tenant"] == port_ledger.hash_tenant("secret-api-key")
    assert entry["incident_id"] == "inc-000001-001"
    root = logging.getLogger()
    handlers = list(root.handlers)
    try:
        logger = port_logging.setup_logging("INFO", "json")
        assert logger.name == "ai_agent_kubectl_tpu_torch"
        assert any(isinstance(h.formatter, port_logging.JsonFormatter)
                   for h in root.handlers)
    finally:
        root.handlers[:] = handlers


# ----------------------------------------------------------- attribution

def test_categorize_maps_every_jax_scope_keyword_as_the_jax_package():
    keys = [k for _, ks in jax_attr._SCOPE_RULES for k in ks]
    assert len(keys) > 15
    for k in keys:
        for text in (k, f"jit(step)/while/body/{k}/fusion.3",
                     f"decode/{k} void some_kernel<float>"):
            assert port_attr.categorize(text) == jax_attr.categorize(text)
    assert port_attr.CATEGORIES == jax_attr.CATEGORIES
    assert port_attr.SCHEMA_ID == jax_attr.SCHEMA_ID


def _ev(cat, name, ts, dur, pid=0, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid}


def test_attribute_trace_bills_a_synthetic_torch_trace(tmp_path):
    """Kernels under nested gpu_user_annotation ranges bill by the
    innermost scope; an uncovered ragged kernel, a cuBLAS GEMM and a
    memcpy by their names; the idle gap is ``gaps``. The window is 0 to
    100 us over 2 steps; worked out by hand below."""
    events = [
        _ev("gpu_user_annotation", "mlp", 0, 30),
        _ev("gpu_user_annotation", "attn_norm", 0, 10),   # nested inside
        _ev("kernel", "void rms_kernel<bf16>", 0, 8),      # attn_norm
        _ev("kernel", "nvjet_hsh_128x256_gemm", 12, 15),   # mlp
        _ev("gpu_user_annotation", "attention", 40, 10),
        _ev("kernel", "void ragged_mma_kernel<256>", 40, 10),  # attention
        _ev("kernel", "void ragged_combine_kernel<256>", 55, 5),  # uncovered
        _ev("kernel", "sm90_xmma_gemm_bf16bf16_f32", 60, 10),  # uncovered
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 70, 5),
        _ev("kernel", "void at::native::reduce_kernel<512>", 90, 10),
        # host-side events are not device spans
        _ev("cpu_op", "aten::mm", 0, 50, pid=1, tid=1),
        _ev("user_annotation", "mlp", 0, 50, pid=1, tid=1),
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
    ]
    (tmp_path / "trace.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    art = port_attr.attribute_trace(str(tmp_path), 2)
    port_attr.validate_attribution(art)
    cats = {c["name"]: c["ms_per_step"] for c in art["categories"]}
    assert art["span_source"] == "cuda_device"
    assert art["n_device_spans"] == 7
    # busy = 8+15+10+5+10+5+10 = 63 us of the 100 us window
    assert art["device_busy_ms_total"] == 0.063
    assert cats["norm_rope_residual"] == 0.004   # 8 us / 2 steps
    assert cats["weight_gemms"] == 0.0125        # (15 + 10) / 2
    assert cats["attention"] == 0.0075           # (10 + 5) / 2
    assert cats["data_movement"] == 0.0025       # the memcpy
    assert cats["other_device"] == 0.005         # the reduce
    assert cats["gaps"] == 0.0185                # 37 us idle
    assert art["coverage_pct"] == 53.0           # 53 recognized us
    top = {c["name"]: [o["name"] for o in c["top_ops"]]
           for c in art["categories"]}
    assert top["attention"] == ["void ragged_mma_kernel<256>",
                                "void ragged_combine_kernel<256>"]
    table = port_attr.render_markdown(art).splitlines()
    assert table[3].startswith("| attention | 0.007")
    assert "ragged_mma_kernel 0.005, ragged_combine_kernel 0.003" in table[3]


def _launch(corr, ts, pid=1, tid=5):
    return dict(_ev("cuda_runtime", "cudaLaunchKernel", ts, 3, pid, tid),
                args={"correlation": corr})


def _kernel(corr, name, ts, dur):
    return dict(_ev("kernel", name, ts, dur), args={"correlation": corr})


def test_device_spans_bill_to_the_scope_that_launched_them(tmp_path):
    """A span bills to the host ranges open at its launch call (same
    ``correlation``), not to the gpu_user_annotation ranges that cover
    it on the card: there one copy stamped ahead of its stream's order
    (rope's, at 1000 us) stretches the rope range over both of mlp's
    GEMMs, as a capture on the card showed. A span whose launch is not
    in the trace still takes the card's ranges."""
    gemm = "nvjet_tst_128x8_64x12_2x1_v_bz_NNT"
    events = [
        _ev("user_annotation", "mlp", 0, 100, pid=1, tid=5),
        _launch(1, 10), _launch(2, 20),
        _ev("user_annotation", "rope", 100, 100, pid=1, tid=5),
        _launch(3, 110), _launch(4, 150),
        _launch(5, 210),                                   # no scope
        _ev("user_annotation", "attention", 220, 40, pid=1, tid=5),
        _launch(6, 230),
        _kernel(3, "void at::native::unrolled_elementwise_kernel<copy>",
                1000, 2),
        _kernel(1, gemm, 1010, 20),
        _kernel(2, gemm, 1040, 20),
        _kernel(4, "void at::native::elementwise_kernel<mul>", 1100, 2),
        _kernel(5, "void at::native::vectorized_elementwise_kernel<add>",
                1110, 2),
        _kernel(6, "void ragged_mma_kernel<256>", 1120, 5),
        _kernel(99, "void rms_kernel<bf16>", 1200, 5),     # no launch
        _ev("gpu_user_annotation", "rope", 1000, 102),
        _ev("gpu_user_annotation", "mlp", 1010, 50),
        _ev("gpu_user_annotation", "attention", 1120, 5),
        _ev("gpu_user_annotation", "attn_norm", 1195, 15),
    ]
    spans, source = port_attr._select_spans(events)
    assert source == "cuda_device"
    billed = [(op.split("<")[0].split("::")[-1], port_attr.categorize(text))
              for _, _, text, op in spans]
    assert billed == [
        ("unrolled_elementwise_kernel", "norm_rope_residual"),
        (gemm, "weight_gemms"), (gemm, "weight_gemms"),
        ("elementwise_kernel", "norm_rope_residual"),
        ("vectorized_elementwise_kernel", "data_movement"),
        ("void ragged_mma_kernel", "attention"),
        ("void rms_kernel", "norm_rope_residual")]
    # Without the launch calls, the card's stretched rope range takes
    # the GEMMs.
    bare = [e for e in events if e["cat"] != "cuda_runtime"]
    spans, _ = port_attr._select_spans(bare)
    assert {port_attr.categorize(text) for _, _, text, op in spans
            if op == gemm} == {"norm_rope_residual"}
    (tmp_path / "trace.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    art = port_attr.attribute_trace(str(tmp_path), 1)
    port_attr.validate_attribution(art)
    cats = {c["name"]: c["ms_per_step"] for c in art["categories"]}
    assert cats["weight_gemms"] == 0.04


def test_run_attribution_on_the_cpu_validates():
    t0 = time.monotonic()
    art = port_attr.run_attribution(
        model="toy-8m", quant="", dtype="float32", batch_size=2,
        chunk_len=4, max_seq=64, reps=2, device="cpu")
    assert time.monotonic() - t0 < 20.0
    port_attr.validate_attribution(art)
    assert art["span_source"] == "host_ops"
    assert art["steps_measured"] == 8
    cats = {c["name"]: c for c in art["categories"]}
    for name in ("weight_gemms", "attention", "lm_head_sampling",
                 "kv_write_splice", "norm_rope_residual"):
        assert cats[name]["ms_per_step"] > 0, name
    assert cats["other_device"]["ms_per_step"] == 0
    assert port_attr.main(["--dryrun"]) == 0


def test_validate_attribution_accepts_the_port_span_sources():
    art = {"schema": port_attr.SCHEMA_ID, "steps_measured": 1,
           "n_device_spans": 0, "wall_ms_total": 0.0,
           "device_busy_ms_total": 0.0, "step_ms": 0.0,
           "coverage_pct": 0.0, "unattributed_ms_per_step": 0.0,
           "categories": [{"name": c, "ms_per_step": 0.0,
                           "pct_of_step": 0.0, "top_ops": []}
                          for c in port_attr.CATEGORIES]}
    for source in ("cuda_device", "host_ops", "tpu_device"):
        port_attr.validate_attribution(dict(art, span_source=source))
    with pytest.raises(ValueError, match="span_source"):
        port_attr.validate_attribution(dict(art, span_source="gpu"))
    bad = dict(art, span_source="cuda_device", wall_ms_total=1.0)
    with pytest.raises(ValueError, match="sums to"):
        port_attr.validate_attribution(bad)


def test_scope_is_a_shared_noop_without_a_profiler():
    assert port_profiler.scope("mlp") is port_profiler.scope("attention")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with port_profiler.scope("qkv_proj"):
            torch.ones(4) @ torch.ones(4)
    names = {e.name for e in prof.events()}
    assert "qkv_proj" in names
    assert port_profiler.clamp_seconds(100) == port_profiler.MAX_SECONDS
    assert port_profiler.clamp_seconds(0) == port_profiler.MIN_SECONDS
