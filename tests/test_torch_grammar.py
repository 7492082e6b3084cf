"""Grammar-constrained decoding in the port against the JAX package's, on
the CPU (toy-8m, float32, ``ByteTokenizer``, 4 slots, chunk 4; both
engines at ``chunk_pipe_depth=3``, the JAX default, wherever counters are
compared).

- **The copied ``constrain/``**: the same grammar hash and equal
  ``tok_class``, ``class_ok``, ``class_next``, ``forced_tok`` and
  ``forced_eos`` for the default, readonly and permissive profiles and an
  allowed-verbs variant, over ``ByteTokenizer`` and over the BPE asset at
  toy-8m's vocabulary (whose per-id bytes must be the JAX tokenizer's).
- **Masked sampling**: ``sample_tokens_seeded(mask=)`` bit-equal to the
  JAX sampler, greedy and at temperature 0.9, with top-k and top-p, under
  masks that exclude the unmasked winner and masks that leave fewer legal
  tokens than ``top_k`` keeps.
- **The engine against ``BatchedJaxEngine``** on the same weights, in the
  three regimes (ragged; ``RAGGED_ATTENTION=off``; ``KV_POOL=false``), at
  temperature 0 and seeded 0.9: byte-identical transcripts, every one in
  grammar, equal ``grammar_health()`` totals and balanced pool books.
  Bursts are two requests, so both engines consume an eager admission's
  first token before they dispatch behind it; the chunks in flight
  shorten the fast-forwards alike in both.
- Fast-forward on against off at depths 1 and 3, and the permissive
  profile against the grammar off: byte-identical, fewer masked steps
  with it on (at depth 1 mid-stream splices too; at depth 3 the chunks in
  flight cover every run past the admission's).
- A dead end from an off-grammar resume prefix, a one-shot ``decode:nan``
  on a grammar request and a preempted grammar request, against the JAX
  engine.
- HTTP: the port's app and engine against the JAX app and engine (the
  readonly tenant, the headers, the cache scope, ``/health``'s grammar
  section and the ``grammar_*`` families), the header validation against
  the JAX app over stub engines, and the knobs.

Transcripts are compared byte for byte, counters for equality.
"""

import asyncio
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from ai_agent_kubectl_tpu import constrain as jax_constrain
from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.constrain import fsm as jax_fsm
from ai_agent_kubectl_tpu.engine import protocol as jax_protocol
from ai_agent_kubectl_tpu.engine import qos as jax_qos
from ai_agent_kubectl_tpu.engine import sampling as jax_sampling
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.engine.tokenizer import (
    HFTokenizer as JaxHFTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.server.app import create_app as jax_create_app
from ai_agent_kubectl_tpu_torch import constrain as port_constrain
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.constrain import fsm as port_fsm
from ai_agent_kubectl_tpu_torch.engine import protocol as port_protocol
from ai_agent_kubectl_tpu_torch.engine import qos as port_qos
from ai_agent_kubectl_tpu_torch.engine import sampling
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.tokenizer import (ByteTokenizer,
                                                         HFTokenizer)
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.server.app import create_app
from ai_agent_kubectl_tpu_torch.server.safety import unsafe_reason
from ai_agent_kubectl_tpu_torch.testing import faults as port_faults
from test_torch_env import knob_env  # noqa: F401  (autouse)

torch.set_num_threads(1)

TOY = get_config("toy-8m")
JAX_ASSET = "ai_agent_kubectl_tpu/assets/tokenizer-k8s.json"
PORT_ASSET = "ai_agent_kubectl_tpu_torch/assets/tokenizer-k8s.json"

# ------------------------------------------------------------ the tables

VARIANT_VERBS = frozenset({"get", "describe"})


def _tokenizers(kind):
    if kind == "byte":
        return JaxByteTokenizer(), ByteTokenizer()
    return (JaxHFTokenizer(JAX_ASSET, TOY.bos_id, TOY.eos_ids, TOY.pad_id),
            HFTokenizer(PORT_ASSET, TOY.bos_id, TOY.eos_ids, TOY.pad_id))


def _runtime(pkg, tok, profile):
    """The runtime of ``profile`` and the pid of the profile's FSM: the
    base, or the allowed-verbs variant installed into the default one."""
    base = "default" if profile == "variant" else profile
    rt = pkg.GrammarRuntime(tok, TOY.vocab_size, TOY.eos_ids, profile=base)
    pid = 0
    if profile == "variant":
        pid = rt.resolve(ctx=pkg.GrammarContext(allowed_verbs=VARIANT_VERBS))
    return rt, pid


@pytest.mark.parametrize("profile",
                         ["default", "readonly", "permissive", "variant"])
@pytest.mark.parametrize("kind", ["byte", "bpe"])
def test_tables_equal_the_jax_ones(kind, profile):
    """The port's copy compiles the same FSM as the JAX package's, and
    stacks the same device tables."""
    jtok, ptok = _tokenizers(kind)
    (jrt, jpid), (prt, ppid) = (_runtime(jax_constrain, jtok, profile),
                                _runtime(port_constrain, ptok, profile))
    assert jpid == ppid and jrt.version == prt.version
    jf, pf = jrt.fsm(jpid), prt.fsm(ppid)
    assert pf.grammar_hash == jf.grammar_hash
    for name in ("tok_class", "class_ok", "class_next", "accept",
                 "forced_tok", "forced_eos"):
        np.testing.assert_array_equal(getattr(pf, name), getattr(jf, name),
                                      err_msg=name)
    _, *jt = jrt.snapshot_tables()
    _, *pt = prt.snapshot_tables()
    for a, b in zip(pt, jt):
        np.testing.assert_array_equal(a, b)
    assert prt.health() == jrt.health()
    if profile != "permissive":
        assert pf.n_states > 100 and pf.forced_tok.max() >= 0


@pytest.mark.parametrize("kind", ["byte", "bpe"])
def test_token_bytes_equal_the_jax_tokenizers(kind):
    """What the FSM compiles from: every id's bytes, as the port's
    tokenizer decodes them, equal the JAX tokenizer's."""
    jtok, ptok = _tokenizers(kind)
    want = jax_fsm.token_byte_table(jtok, TOY.vocab_size)
    got = port_fsm.token_byte_table(ptok, TOY.vocab_size)
    assert got == want
    assert sum(b is not None for b in got) > 200


def test_safety_cross_check_reads_the_ports_safety_ring(monkeypatch):
    from ai_agent_kubectl_tpu_torch.server import safety

    port_constrain.assert_safety_consistent()
    monkeypatch.setattr(safety, "BLOCKED_VERBS",
                        tuple(safety.BLOCKED_VERBS) + ("get",))
    with pytest.raises(RuntimeError, match="safety-blocked"):
        port_constrain.assert_safety_consistent()


# ------------------------------------------------------------- sampling

SEEDS = np.array([0, 1, 7, 42, 101, 2 ** 31 - 1], np.int32)


def _masked_case(kind):
    """Six rows of logits over 300 ids, mixed greedy and sampled rows, and
    a mask that excludes each row's unmasked winner ("exclude") or keeps
    only three ids ("few")."""
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((6, 300)) * 3.0).astype(np.float32)
    mask = rng.random((6, 300)) < 0.4
    winners = logits.argmax(-1)
    mask[np.arange(6), winners] = False
    if kind == "few":
        mask[:] = False
        for r in range(6):
            mask[r, rng.choice(300, 3, replace=False)] = True
    ngen = np.array([0, 3, 9, 17, 30, 2], np.int32)
    return logits, mask, ngen


@pytest.mark.parametrize("mask_kind", ["exclude", "few"])
@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (8, 1.0), (0, 0.8),
                                         (20, 0.9)])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_masked_sampling_is_bit_equal_to_the_jax_sampler(temperature, top_k,
                                                         top_p, mask_kind):
    logits, mask, ngen = _masked_case(mask_kind)
    temps = np.full((6,), temperature, np.float32)
    temps[1] = 0.0                          # a greedy row among them
    want = np.asarray(jax_sampling.sample_tokens_seeded(
        jnp.asarray(logits), jnp.asarray(SEEDS), jnp.asarray(ngen),
        jnp.asarray(temps), top_k=top_k, top_p=top_p,
        mask=jnp.asarray(mask)))
    got = sampling.sample_tokens_seeded(
        torch.from_numpy(logits), torch.from_numpy(SEEDS),
        torch.from_numpy(ngen), torch.from_numpy(temps), top_k=top_k,
        top_p=top_p, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert mask[np.arange(6), got.numpy()].all()
    # The greedy path alone (the batcher's all-greedy shortcut).
    greedy = sampling.greedy_tokens(sampling.apply_mask(
        torch.from_numpy(logits), torch.from_numpy(mask)))
    np.testing.assert_array_equal(
        greedy.numpy(), np.where(mask, logits, -np.inf).argmax(-1))


# ------------------------------------------------------------ the engines

COMMON = dict(dtype="float32", max_seq_len=64, prefill_buckets=(16,),
              prefix_cache=False, chunk_len=4, batch_size=4)
#: the three regimes, as each package spells them
REGIMES = {
    "ragged": ({"ragged_attention": "on"}, {}),
    "paged": ({"ragged_attention": "off"},
              {"ragged_attention": "off", "decode_attn": "paged"}),
    "dense": ({"kv_pool": False}, {"kv_pool": False,
                                   "decode_attn": "paged"}),
}
#: (prompt, temperature, seed) bursts of two: greedy, then seeded 0.9
#: (seed 11 walks "cluster-info" into a free name, seed 7 "patch hpa")
BURSTS = [[("pod q0 ", 0.0, 1), ("bulk b ", 0.0, 1)],
          [("pod q0 ", 0.9, 11), ("bulk a ", 0.9, 7)]]
MAX_TOKENS = 24
#: background requests for the preemption drill and the probe
BG_REQS = [("bulk a ", 0.9, 11), ("bulk b ", 0.9, 12),
           ("bulk c ", 0.9, 13), ("bulk d ", 0.9, 14)]
PROBE = ("quick q ", 0.0, 505)
#: an off-grammar resume prefix: its replay lands in the DEAD state
OFF_GRAMMAR = "not kubectl at all"
COUNTERS = ("forced_tokens_total", "masked_steps_total",
            "fast_forward_splices_total", "dead_ends_total")


def _jax_engine(regime="ragged", **kw):
    return BatchedJaxEngine(jconfig.get_config("toy-8m"),
                            tokenizer=JaxByteTokenizer(),
                            compile_cache_dir="", chunk_pipe_depth=3,
                            grammar_decode=True,
                            **{**COMMON, **REGIMES[regime][0], **kw})


def _port_engine(params, regime="ragged", **kw):
    kw.setdefault("grammar_decode", True)
    kw.setdefault("chunk_pipe_depth", 3)
    return BatchedTorchEngine(TOY, tokenizer=ByteTokenizer(), params=params,
                              device="cpu",
                              **{**COMMON, **REGIMES[regime][1], **kw})


def _counters(eng, since=None) -> dict:
    """The grammar totals, or their growth ``since`` an earlier reading
    (start()'s warm-up request decodes under the grammar too)."""
    g = eng.grammar_health()
    now = {k: g[k] for k in COUNTERS}
    if since is None:
        return now
    out = {k: now[k] - since[k] for k in COUNTERS[:3]}
    out["dead_ends_total"] = {
        c: n - since["dead_ends_total"].get(c, 0)
        for c, n in now["dead_ends_total"].items()
        if n != since["dead_ends_total"].get(c, 0)}
    return out


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


def _ids(text: str) -> list:
    """A transcript's ids (ByteTokenizer: one id a byte, exactly)."""
    return ByteTokenizer().encode(text, add_bos=False)


async def _until(cond, what: str, limit: float = 60.0) -> None:
    """Poll ``cond`` until it holds, failing the test with ``what`` when
    it has not within ``limit`` seconds: a scheduler thread that lost a
    race must fail its test, not hang the run."""
    deadline = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < deadline, (
            f"{what} within {limit:.0f} s")
        await asyncio.sleep(0.002)


async def _quiet(eng) -> None:
    """Wait until the scheduler idles: the chunks dispatched past the
    last request's end count against the depth until the idle scheduler
    prunes them, so a request that arrives before that boards later
    chunks. Its next idle pop (reached only with nothing in flight and
    no live slot) comes after the turn that pruned them, its books
    included."""
    q = eng._admissions
    get, idle = q.get, threading.Event()

    def watched(*args, **kw):
        idle.set()
        return get(*args, **kw)

    q.get = watched
    try:
        await _until(idle.is_set, "the scheduler never went idle")
    finally:
        q.__dict__.pop("get", None)


async def _together(eng, calls) -> list:
    """``calls`` (each a function giving one request's coroutine) sent at
    once from an idle scheduler that is held at its next pop until every
    one is queued: the burst then boards the same chunks in both engines
    however the threads are scheduled."""
    await _quiet(eng)
    q = eng._admissions
    pops = {name: getattr(q, name) for name in ("get", "get_nowait")}
    opened, held = threading.Event(), threading.Event()

    def hold(pop):
        def call(*args, **kw):
            held.set()
            opened.wait(10.0)
            return pop(*args, **kw)
        return call

    for name, pop in pops.items():
        setattr(q, name, hold(pop))
    try:
        await _until(held.is_set, "the scheduler never reached its next pop")
        tasks = [asyncio.ensure_future(call()) for call in calls]
        await _until(lambda: q.qsize() >= len(calls),
                     "the burst was never wholly queued")
        opened.set()
        return await asyncio.gather(*tasks)
    finally:
        opened.set()
        for name in pops:
            q.__dict__.pop(name, None)


async def _bursts(eng, bursts=BURSTS):
    """Each burst's requests at once; the transcripts by (prompt, temp)."""
    out = {}
    for burst in bursts:
        res = await _together(eng, [
            (lambda p=p, t=t, s=s: eng.generate(
                p, max_tokens=MAX_TOKENS, temperature=t, seed=s))
            for p, t, s in burst])
        for (p, t, _), r in zip(burst, res):
            out[(p, t)] = r.text
    return out


def _containment(eng) -> dict:
    c = eng.stats()["containment"]
    return {k: c[k] for k in ("resets", "quarantined", "health_trips")}


async def _dead_end(eng, submit):
    """``submit()`` must end in a quarantine; returns the containment and
    grammar dead-end deltas it caused."""
    c0, d0 = _containment(eng), dict(eng.grammar_health()["dead_ends_total"])
    with pytest.raises(Exception) as exc:
        await submit()
    assert type(exc.value).__name__ == "RequestQuarantined"
    c1, d1 = _containment(eng), eng.grammar_health()["dead_ends_total"]
    delta = {k: {n: v - c0[k].get(n, 0) for n, v in c1[k].items()
                 if v != c0[k].get(n, 0)} for k in ("resets", "quarantined")}
    delta["health_trips"] = c1["health_trips"] - c0["health_trips"]
    delta["dead_ends"] = {n: v - d0.get(n, 0) for n, v in d1.items()}
    return delta


async def _jax_dead_end(eng):
    async def submit():
        async for _ in eng.stream_events(
                "dead q ", max_tokens=MAX_TOKENS, seed=3,
                resume_ids=eng.tokenizer.encode(OFF_GRAMMAR, add_bos=False)):
            pass
    return await _dead_end(eng, submit)


async def _port_dead_end(eng):
    """The port has no cross-replica import: the off-grammar prefix is set
    on the request as it enters the queue (what a preemption leaves
    there), so its admission replays it."""
    put = eng._admissions.put
    ids = eng.tokenizer.encode(OFF_GRAMMAR, add_bos=False)

    def with_prefix(req):
        eng._admissions.put = put
        req.resume_ids = list(ids)
        return put(req)

    eng._admissions.put = with_prefix
    return await _dead_end(
        eng, lambda: eng.generate("dead q ", max_tokens=MAX_TOKENS, seed=3))


#: HTTP traffic: (query, headers), each sent to both apps in turn
HTTP_REQS = [
    ("list the pods", {}),
    ("list the pods", {"X-API-Key": "bg-key"}),       # cache scope: a miss
    ("list the pods", {"X-API-Key": "bg-key"}),       # then a hit
    ("drain the node", {"X-API-Key": "bg-key"}),      # readonly clamp
    ("show the pods", {"X-Grammar-Profile": "readonly"}),
    ("show the nodes", {"X-Allowed-Verbs": "get,describe"}),
    ("do things", {"X-Allowed-Verbs": "get,frobnicate"}),
    ("do things", {"X-Grammar-Profile": "yolo"}),
    ("do things", {"X-Grammar-Profile": "readonly",
                   "X-Allowed-Verbs": "delete"}),
]
HTTP_CFG = dict(grammar_decode=True, rate_limit="1000/minute",
                max_new_tokens=MAX_TOKENS,
                tenant_tiers="bg-key:background,hi-key:interactive")


def _grammar_families(text: str) -> dict:
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name.startswith("grammar_"):
            for s in fam.samples:
                if not s.name.endswith("_created"):
                    out[s.name + "".join(
                        f"{{{k}={v}}}" for k, v in sorted(s.labels.items()))
                        ] = s.value
    return out


async def _http(app, engine):
    """HTTP_REQS through ``app``: each (status, command or detail,
    from_cache), then /health's grammar section and the grammar
    families of /metrics."""
    answers = []
    async with TestClient(TestServer(app)) as client:
        for query, headers in HTTP_REQS:
            r = await client.post("/kubectl-command", json={"query": query},
                                  headers=headers)
            body = await r.json()
            answers.append((r.status, body.get("kubectl_command",
                                               body.get("detail")),
                            body.get("from_cache")))
        health = await (await client.get("/health")).json()
        metrics = _grammar_families(await (await client.get("/metrics")
                                           ).text())
    return answers, health["grammar"], metrics


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX side, once: each regime's bursts and counters, the
    uncontended background-lane transcripts the preemption drill resumes
    to, the dead end's containment deltas and the HTTP traffic (ragged
    engine), and the parameters every port engine serves."""
    out = {"bursts": {}, "counters": {}}

    async def run():
        for regime in REGIMES:
            eng = _jax_engine(regime)
            if regime != "ragged":
                await eng.start()
                try:
                    c0 = _counters(eng)
                    out["bursts"][regime] = await _bursts(eng)
                    out["counters"][regime] = _counters(eng, c0)
                finally:
                    await eng.stop()
                continue
            app = jax_create_app(JaxServiceConfig(engine="fake",
                                                  **HTTP_CFG), eng)
            out["http"] = await _http(app, eng)
            await eng.start()          # the client's cleanup stopped it
            try:
                c0 = _counters(eng)
                out["bursts"][regime] = await _bursts(eng)
                out["counters"][regime] = _counters(eng, c0)
                with jax_qos.use_qos(jax_qos.QoSContext(tenant="bulk",
                                                        lane="background")):
                    out["bg"] = {p: (await eng.generate(
                        p, max_tokens=40, temperature=t, seed=s)).text
                        for p, t, s in BG_REQS}
                out["dead_end"] = await _jax_dead_end(eng)
                out["params"] = params_from_jax(
                    jax.tree.map(np.asarray, eng.params), TOY)
            finally:
                await eng.stop()

    asyncio.run(run())
    return out


@pytest.mark.parametrize("regime", list(REGIMES))
async def test_engine_matches_the_jax_engine(jax_ref, regime):
    """Byte-identical transcripts (greedy and seeded 0.9), every one in
    grammar, the same grammar counters, and balanced pool books."""
    eng = _port_engine(jax_ref["params"], regime)
    await eng.start()
    try:
        c0 = _counters(eng)
        got = await _bursts(eng)
        counters = _counters(eng, c0)
        if eng.kv_pool:
            _books(eng)
    finally:
        await eng.stop()
    assert got == jax_ref["bursts"][regime]
    assert counters == jax_ref["counters"][regime]
    assert counters["masked_steps_total"] > 0
    if regime != "dense":      # the dense ladder only masks
        assert counters["forced_tokens_total"] >= 8 * len(got)
    g = eng._grammar
    for text in got.values():
        assert g.in_grammar(0, _ids(text))
        assert text.startswith("kubectl ") and unsafe_reason(text) is None


@pytest.mark.parametrize("depth", [1, 3])
async def test_fast_forward_on_and_off_are_byte_identical(jax_ref, depth):
    """Four requests at once in the ragged regime: the admission splice
    and the mid-stream fast-forward (GRAMMAR_FORCED_RUN_MIN=2) against
    masked step-by-step decode of the same runs (10**6): the same
    transcripts, strictly fewer masked steps with it on. At depth 1 runs
    splice mid-stream too; at depth 3 the two chunks in flight (8 tokens)
    already decode every later run, so only the admission splices."""
    burst = [BURSTS[0] + BURSTS[1]]
    out = {}
    for name, run_min in (("on", 2), ("off", 10 ** 6)):
        eng = _port_engine(jax_ref["params"],
                           grammar_forced_run_min=run_min,
                           chunk_pipe_depth=depth)
        await eng.start()
        try:
            c0 = _counters(eng)
            out[name] = (await _bursts(eng, burst), _counters(eng, c0))
            _books(eng)
        finally:
            await eng.stop()
    (on, c_on), (off, c_off) = out["on"], out["off"]
    assert on == off
    assert c_off["fast_forward_splices_total"] == 0
    if depth == 1:
        assert c_on["fast_forward_splices_total"] > len(on)  # mid-stream
    else:
        assert c_on["fast_forward_splices_total"] == len(on)
    assert c_on["masked_steps_total"] < c_off["masked_steps_total"]
    assert (c_on["masked_steps_total"] + c_on["forced_tokens_total"]
            == c_off["masked_steps_total"])


async def test_permissive_profile_equals_the_grammar_off(jax_ref):
    """GRAMMAR_PROFILE=permissive runs the whole plumbing (mask, state
    word, forced-run checks) over the unconstrained language: the same
    transcripts as GRAMMAR_DECODE=false."""
    out = {}
    for name, kw in (("permissive", dict(grammar_profile="permissive")),
                     ("off", dict(grammar_decode=False))):
        eng = _port_engine(jax_ref["params"], **kw)
        await eng.start()
        try:
            c0 = eng.grammar_health() and _counters(eng)
            out[name] = await _bursts(eng)
            out[name + "_counters"] = c0 and _counters(eng, c0)
        finally:
            await eng.stop()
    assert out["permissive"] == out["off"]
    assert out["off_counters"] is None
    c = out["permissive_counters"]
    assert c["masked_steps_total"] > 0 and c["dead_ends_total"] == {}
    assert c["forced_tokens_total"] == c["fast_forward_splices_total"] == 0


async def test_dead_end_replays_then_quarantines_as_the_jax_engine(jax_ref):
    """An off-grammar resume prefix replays into the DEAD state: the slot
    freezes on the grammar health bit before it emits anything, replays
    once within QUARANTINE_RETRY_BUDGET=1, trips again and is
    quarantined (410), with the JAX engine's counters."""
    eng = _port_engine(jax_ref["params"])
    await eng.start()
    try:
        got = await _port_dead_end(eng)
        # The engine serves on afterwards.
        after = await _bursts(eng, BURSTS[:1])
    finally:
        await eng.stop()
    assert got == jax_ref["dead_end"]
    assert got["dead_ends"] == {"decode": 2}
    assert got["quarantined"] == {"slot_health": 1}
    assert after == {k: v for k, v in jax_ref["bursts"]["ragged"].items()
                     if k[1] == 0.0}


async def test_one_shot_nan_on_a_grammar_request_replays(jax_ref):
    """A one-shot decode:nan on the two requests of one prompt in their
    second chunk (the sampled one's comes after a mid-stream splice):
    both are replayed with their FSM states re-derived from the emitted
    ids, and every transcript equals the fault-free one."""
    inj = port_faults.FaultInjector()
    eng = _port_engine(jax_ref["params"], faults=inj)
    burst = [BURSTS[0] + BURSTS[1]]
    await eng.start()
    try:
        want = await _bursts(eng, burst)
        seen = {"n": 0}
        orig = inj.decode_nan_slots

        def once(prompts, replica=None):
            hits = orig(prompts, replica)
            if hits:
                seen["n"] += 1
                if seen["n"] <= 1:
                    return []
                inj.release("decode")
            return hits

        inj.decode_nan_slots = once
        inj.target_substr = "pod q0 "
        inj.set("decode", "nan")
        got = await _bursts(eng, burst)
        c = _containment(eng)
        _books(eng)
    finally:
        await eng.stop()
    assert c["resets"] == {"slot_health": 1} and c["quarantined"] == {}
    assert got == want


async def test_preempted_grammar_request_resumes_in_grammar(jax_ref):
    """Two slots of background (readonly-clamped) sampled requests; an
    interactive probe preempts one, which resumes from its generated ids
    with its FSM state re-derived: every transcript is in the readonly
    grammar and equals the JAX engine's uncontended one."""
    eng = _port_engine(jax_ref["params"], batch_size=2, preempt_wait_ms=15.0)
    await eng.start()
    try:
        async def run_bg(p, t, s):
            with port_qos.use_qos(port_qos.QoSContext(tenant="bulk",
                                                      lane="background")):
                return await eng.generate(p, max_tokens=40, temperature=t,
                                          seed=s)

        tasks = [asyncio.ensure_future(run_bg(*r)) for r in BG_REQS]
        for _ in range(2000):
            await asyncio.sleep(0.005)
            if all(s is not None and len(s.detok.ids) > 8
                   for s in eng._slots):
                break
        p, t, s = PROBE
        with port_qos.use_qos(port_qos.QoSContext(tenant="quiet",
                                                  lane="interactive")):
            probe = await eng.generate(p, max_tokens=8, temperature=t,
                                       seed=s)
        res = await asyncio.gather(*tasks)
        preemptions = eng.stats()["qos"]["preemptions"]
        _books(eng)
    finally:
        await eng.stop()
    assert preemptions >= 1
    readonly = eng._grammar.resolve(lane="background")
    assert readonly != 0
    for (p, _, _), r in zip(BG_REQS, res):
        assert r.text == jax_ref["bg"][p], p
        assert eng._grammar.in_grammar(readonly, r.token_ids)
    assert eng._grammar.in_grammar(0, probe.token_ids)


# ------------------------------------------------------------------ HTTP

async def test_http_matches_the_jax_app(jax_ref):
    """The port's app and engine against the JAX app and engine, the same
    traffic: statuses and commands equal (the background tenant clamped
    to readonly verbs, the narrowed request to its verbs, the 400s with
    the JAX details), the cache scoped by grammar identity (the
    background tenant misses the default profile's cached answer, then
    hits its own), /health's grammar section and the grammar families of
    /metrics equal, and those families equal /health's totals."""
    eng = _port_engine(jax_ref["params"])
    app = create_app(ServiceConfig(torch_device="cpu", **HTTP_CFG), eng)
    got = await _http(app, eng)
    want = jax_ref["http"]
    assert got[0] == want[0]
    answers = got[0]
    assert [a[0] for a in answers] == [200] * 6 + [400] * 3
    assert [a[2] for a in answers[:3]] == [False, False, True]
    ro = set(port_constrain.READONLY_VERBS)
    for status, cmd, _ in answers[1:5]:
        assert cmd.split()[1] in ro, cmd
    assert answers[5][1].split()[1] in VARIANT_VERBS
    assert got[1] == want[1]
    health = got[1]
    assert health["enabled"] and health["variants"] == 3
    assert got[2] == want[2]
    assert got[2]["grammar_forced_tokens_total"] == \
        health["forced_tokens_total"] > 0
    assert got[2]["grammar_masked_steps_total"] == \
        health["masked_steps_total"] > 0


class StubEngine:
    """Answers every prompt with a mutating command and records the
    grammar context its package's contextvar carried."""

    name = "stub"
    ready = True
    device = None

    def __init__(self, protocol, grammar):
        self.protocol, self.grammar = protocol, grammar
        self.seen = []

    async def start(self):
        pass

    async def stop(self, drain_secs=0.0):
        pass

    async def generate(self, prompt, **kw):
        ctx = self.grammar.current_grammar()
        self.seen.append(None if ctx is None else (
            ctx.profile, sorted(ctx.allowed_verbs or ())))
        return self.protocol.EngineResult(text="kubectl delete pods web-1",
                                          completion_tokens=5,
                                          engine=self.name)


#: (config, headers): the header cases of the JAX grammar tests
HEADER_CASES = {
    "off": ({}, {"X-Allowed-Verbs": "get"}),
    "unknown_profile": ({"grammar_decode": True},
                        {"X-Grammar-Profile": "yolo"}),
    "unknown_verb": ({"grammar_decode": True},
                     {"X-Allowed-Verbs": "get,frobnicate"}),
    "narrowing": ({"grammar_decode": True},
                  {"X-Allowed-Verbs": " Get , logs "}),
    "readonly_ask": ({"grammar_decode": True},
                     {"X-Grammar-Profile": "ReadOnly"}),
    "outside_clamp": ({"grammar_decode": True},
                      {"X-Grammar-Profile": "readonly",
                       "X-Allowed-Verbs": "get,delete"}),
    "background_clamp": ({"grammar_decode": True,
                          "tenant_tiers": "bg-key:background"},
                         {"X-API-Key": "bg-key",
                          "X-Allowed-Verbs": "scale"}),
    "permissive": ({"grammar_decode": True,
                    "grammar_profile": "permissive"},
                   {"X-Allowed-Verbs": "get"}),
}


@pytest.mark.parametrize("case", list(HEADER_CASES))
async def test_grammar_headers_as_the_jax_app(case):
    """Each header case through both apps over stub engines: the same
    status and body, and the same grammar context reaching the engine
    (none for a refused request)."""
    cfg, headers = HEADER_CASES[case]
    outs = []
    for create, config, protocol, grammar in (
            (create_app, ServiceConfig(torch_device="cpu",
                                       rate_limit="1000/minute", **cfg),
             port_protocol, port_constrain),
            (jax_create_app, JaxServiceConfig(engine="fake",
                                              rate_limit="1000/minute",
                                              **cfg),
             jax_protocol, jax_constrain)):
        engine = StubEngine(protocol, grammar)
        async with TestClient(TestServer(create(config, engine))) as c:
            r = await c.post("/kubectl-command", json={"query": "do it"},
                             headers=headers)
            body = {k: v for k, v in (await r.json()).items()
                    if k not in ("metadata", "timings")}
            outs.append((r.status, body, engine.seen))
    assert outs[0] == outs[1]
    status = outs[0][0]
    assert status == (200 if case in ("narrowing", "readonly_ask")
                      else 400)


@pytest.mark.parametrize("profile", ["default", "readonly", "permissive"])
def test_cache_scope_equals_the_jax_one(profile):
    """The response-cache key suffix of every (lane, request) pair: the
    clamped profile and the sorted allowed verbs, as the JAX package's."""
    for lane in (None, "interactive", "batch", "background"):
        for ask, verbs in ((None, None), ("readonly", None),
                           (None, frozenset({"logs", "get"}))):
            args = [(lane, pkg.GrammarContext(profile=ask,
                                              allowed_verbs=verbs))
                    for pkg in (port_constrain, jax_constrain)]
            got = port_constrain.cache_scope(profile, *args[0])
            assert got == jax_constrain.cache_scope(profile, *args[1])
            assert got.startswith("\x00grammar:")


# ---------------------------------------------------------------- knobs

@pytest.mark.parametrize("knob,value,message", [
    ("GRAMMAR_PROFILE", "bogus", "GRAMMAR_PROFILE must be one of"),
    ("GRAMMAR_FORCED_RUN_MIN", "0", "GRAMMAR_FORCED_RUN_MIN must be >= 1"),
])
def test_bad_grammar_knobs_raise_the_jax_errors(monkeypatch, knob, value,
                                                message):
    monkeypatch.setenv(knob, value)
    errors = []
    for cls in (ServiceConfig, JaxServiceConfig):
        with pytest.raises(ValueError, match=message) as exc:
            cls.from_env(env_file=None)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("env", [
    {"DECODE_BATCH_SIZE": "1"},
    {"ENGINE": "openai", "OPENAI_API_KEY": "sk-x"},
], ids=["single_sequence", "openai"])
def test_grammar_refused_where_no_engine_would_enforce_it(monkeypatch, env):
    """The JAX single-sequence engine ignores GRAMMAR_DECODE=true; the
    port refuses it at boot where the engine built would not enforce it,
    and serves it on the batched engines."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("GRAMMAR_DECODE", "true")
    with pytest.raises(ValueError, match="GRAMMAR_DECODE=true is enforced"):
        ServiceConfig.from_env(env_file=None)
    monkeypatch.setenv("GRAMMAR_DECODE", "false")
    ServiceConfig.from_env(env_file=None)
    monkeypatch.setenv("GRAMMAR_DECODE", "true")
    monkeypatch.setenv("ENGINE", "torch-batched")
    assert ServiceConfig.from_env(env_file=None).grammar_decode


def test_batched_engine_from_config_serves_the_grammar_knobs():
    cfg = ServiceConfig(torch_device="cpu", grammar_decode=True,
                        grammar_profile="readonly",
                        grammar_forced_run_min=6)
    eng = BatchedTorchEngine.from_config(cfg)
    assert (eng.grammar_decode, eng.grammar_profile,
            eng.grammar_forced_run_min) == (True, "readonly", 6)
    assert eng.grammar_health() is None        # compiled at start
    off = BatchedTorchEngine.from_config(ServiceConfig(torch_device="cpu"))
    assert off.grammar_decode is False
    # The runtime's thread discipline: a consistent snapshot under the
    # install lock, stamped with its version.
    rt = port_constrain.GrammarRuntime(ByteTokenizer(), TOY.vocab_size,
                                       TOY.eos_ids)
    assert isinstance(rt._lock, type(threading.Lock()))
    v0 = rt.snapshot_tables()[0]
    rt.resolve(ctx=port_constrain.GrammarContext(
        allowed_verbs=frozenset({"get"})))
    assert rt.snapshot_tables()[0] == v0 + 1
