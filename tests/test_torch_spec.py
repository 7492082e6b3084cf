"""Speculative decoding in the port against the JAX package's, on the CPU
(toy-8m, float32, ``ByteTokenizer``, 4 slots, chunk 4; both engines at
``chunk_pipe_depth=3``, the JAX default, the target's and the draft's
parameters carried across by ``params_from_jax``).

- **The packed buffer's v3 lanes**: the port's ``pack_chunk`` over torch
  tensors gives the JAX function's bytes; both unpack alike.
- **The engine against ``BatchedJaxEngine``** with a draft that disagrees
  (seed 1234), in the ragged regime (``RAGGED_ATTENTION=on``) and the
  gather regime (``off``: ``DECODE_ATTN=paged`` resolves to gather under
  spec), at k in {2, 4}, requests sent one at a time, greedy and seeded
  0.9: byte-identical transcripts, equal drafted and accepted totals, the
  ledger's draft_rejected equal to their difference, balanced books.
- Spec on against spec off, bursts at once in both regimes; an identical
  draft (the target's own weights) accepting as the JAX engine does;
  spec under ``GRAMMAR_DECODE``; a generation that runs into the
  capacity sweep (cut where the JAX engine cuts it); a one-shot
  ``decode:nan`` mid-verify (every request replays, through the draft's
  re-prefill, to its spec-off transcript); a preempted spec request
  resuming to the JAX engine's uncontended transcript; ``draft:die``
  degrading to plain chunks.
- The draft from ``SPEC_DRAFT_PATH`` (a toy safetensors checkpoint), the
  knobs' JAX errors and the boot refusals, the factory's ``draft`` point,
  and ``/health``'s spec section and the ``spec_*`` families of
  ``/metrics``, under the JAX names.

Transcripts are compared byte for byte, counters for equality.
"""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine import protocol as jax_protocol
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine import protocol as port_protocol
from ai_agent_kubectl_tpu_torch.engine import qos as port_qos
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.obs.ledger import CLASS_DRAFT_REJECTED
from ai_agent_kubectl_tpu_torch.server.app import create_app
from ai_agent_kubectl_tpu_torch.server.factory import build_engine
from ai_agent_kubectl_tpu_torch.testing import faults as port_faults
from test_torch_env import knob_env  # noqa: F401  (autouse)

safetensors_torch = pytest.importorskip("safetensors.torch")

torch.set_num_threads(1)

TOY = get_config("toy-8m")
COMMON = dict(dtype="float32", max_seq_len=64, prefill_buckets=(16,),
              prefix_cache=False, chunk_len=4, batch_size=4,
              chunk_pipe_depth=3)
#: the two pool regimes, as each package spells them
REGIMES = {
    "ragged": ({"ragged_attention": "on"}, {}),
    "gather": ({"ragged_attention": "off"},
               {"ragged_attention": "off", "decode_attn": "paged"}),
}
CASES = [(r, k) for r in REGIMES for k in (2, 4)]
#: a draft that disagrees with the target (a different random init)
DRAFT_SEED = 1234
#: (prompt, temperature, seed): greedy and seeded 0.9
REQS = [("pod q0 ", 0.0, 1), ("bulk b ", 0.0, 2), ("pod q1 ", 0.9, 11),
        ("bulk a ", 0.9, 7)]
MAX_TOKENS = 24
#: the identical-draft run (the JAX suite's shape: k=3, chunk 8, greedy)
SAME_K, SAME_CHUNK = 3, 8
SAME_REQS = [("list pods", 0.0, 1), ("get nodes", 0.0, 2),
             ("pod q2 ", 0.0, 3)]
#: a generation whose budget fills the span: prompt + max_tokens equals
#: MAX_SEQ_LEN, so it meets the capacity sweep
CAP_REQ = ("cap ", 0.9, 5)
CAP_TOKENS = 59
#: background requests for the preemption drill, and the probe
BG_REQS = [("bulk a ", 0.9, 11), ("bulk b ", 0.9, 12),
           ("bulk c ", 0.9, 13), ("bulk d ", 0.9, 14)]
PROBE = ("quick q ", 0.0, 505)
GRAMMAR_REQS = [("pod q0 ", 0.0, 1), ("bulk b ", 0.9, 7),
                ("pod q1 ", 0.9, 11)]
SPEC_KEYS = ("drafted_tokens_total", "accepted_tokens_total")


def _jax_engine(regime="ragged", k=2, **kw):
    return BatchedJaxEngine(
        jconfig.get_config("toy-8m"), tokenizer=JaxByteTokenizer(),
        compile_cache_dir="", spec_decode=True,
        spec_draft_k=k, spec_draft_model="toy-8m",
        **{"spec_draft_seed": DRAFT_SEED, **COMMON, **REGIMES[regime][0],
           **kw})


def _port_engine(params, draft=None, regime="ragged", k=2, **kw):
    """A port engine on ``params``; speculative with ``draft``'s
    parameters unless ``draft`` is None."""
    spec = {} if draft is None else dict(
        spec_decode=True, spec_draft_k=k, spec_draft_model="toy-8m",
        spec_draft_params=draft)
    return BatchedTorchEngine(TOY, tokenizer=ByteTokenizer(), params=params,
                              device="cpu", **{**COMMON, **REGIMES[regime][1],
                                               **spec, **kw})


def _spec_delta(eng, since):
    now = eng.spec_health()
    return {k: now[k] - since[k] for k in SPEC_KEYS}


async def _empty_pipe(eng) -> None:
    """Wait for the engine's pipe to empty (the chunks past a drain are
    pruned by the idle scheduler), failing the test after 60 s."""
    deadline = time.monotonic() + 60.0
    while eng._inflight:
        assert time.monotonic() < deadline, "the pipe never emptied"
        await asyncio.sleep(0.002)


async def _one_by_one(eng, reqs=REQS, max_tokens=MAX_TOKENS):
    """Each request alone, from an empty pipe (the chunks dispatched past
    the last request's end count against the depth until the idle
    scheduler prunes them, and shift which chunks a request boards, so
    the fast-forward's splices and with them the spec totals); the
    transcripts and the spec totals' growth (start()'s warm-up drafts
    too)."""
    h0 = eng.spec_health()
    out = {}
    for p, t, s in reqs:
        await _empty_pipe(eng)
        r = await eng.generate(p, max_tokens=max_tokens, temperature=t,
                               seed=s)
        out[(p, t)] = r.text
    return out, (None if h0 is None else _spec_delta(eng, h0))


async def _burst(eng, reqs=REQS, max_tokens=MAX_TOKENS):
    res = await asyncio.gather(*[
        eng.generate(p, max_tokens=max_tokens, temperature=t, seed=s)
        for p, t, s in reqs])
    return {(p, t): r.text for (p, t, _), r in zip(reqs, res)}


def _books(eng) -> None:
    """The pool's refcounts against every holder, and the ledger's
    conservation with draft_rejected = drafted - accepted."""
    holders: dict = {}
    for slot in list(eng._slots) + list(eng._parked):
        if slot is not None and slot.blocks:
            for b in slot.blocks:
                holders[b] = holders.get(b, 0) + 1
    if eng._radix is not None:
        for b, n in eng._radix._held.items():
            holders[b] = holders.get(b, 0) + n
    eng._pool.check(holders)
    snap = eng.ledger_snapshot()
    assert snap["conservation"]["balanced"]
    h = eng.spec_health()
    if h is not None:
        assert snap["classes"][CLASS_DRAFT_REJECTED] == (
            h["drafted_tokens_total"] - h["accepted_tokens_total"])


def _tree(jax_tree):
    return params_from_jax(jax.tree.map(np.asarray, jax_tree), TOY)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX side, once: each case's transcripts and spec totals (the
    ragged k=2 engine also serves the preemption drill's uncontended
    transcripts, the ragged k=4 one the capacity request), the identical
    draft's run, the grammar run, the spec_health keys, and the target's
    and the draft's parameters."""
    out = {"runs": {}}

    async def run():
        for regime, k in CASES:
            eng = _jax_engine(regime, k)
            await eng.start()
            try:
                out["runs"][(regime, k)] = await _one_by_one(eng)
                if (regime, k) == ("ragged", 2):
                    out["params"] = _tree(eng.params)
                    out["draft"] = _tree(eng._draft_params)
                    out["health_keys"] = sorted(eng.spec_health())
                    out["bg"] = {p: (await eng.generate(
                        p, max_tokens=40, temperature=t, seed=s)).text
                        for p, t, s in BG_REQS}
                if (regime, k) == ("ragged", 4):
                    # The capacity request at the depth the engine was
                    # built with and at depth 1 (the loop reads the depth
                    # each turn; the pipe is empty between the two).
                    out["cap"] = {}
                    for depth in (3, 1):
                        await _empty_pipe(eng)
                        eng.chunk_pipe_depth = depth
                        p, t, s = CAP_REQ
                        r = await eng.generate(p, max_tokens=CAP_TOKENS,
                                               temperature=t, seed=s)
                        out["cap"][depth] = (r.text, r.completion_tokens,
                                             r.finish_reason)
            finally:
                await eng.stop()
        eng = _jax_engine(k=SAME_K, chunk_len=SAME_CHUNK, spec_draft_seed=0)
        await eng.start()
        try:
            out["same"] = (await _one_by_one(eng, SAME_REQS),
                           eng.spec_health()["acceptance_ratio"])
        finally:
            await eng.stop()
        eng = _jax_engine(grammar_decode=True)
        await eng.start()
        try:
            g0 = eng.grammar_health()
            out["grammar"] = await _one_by_one(eng, GRAMMAR_REQS)
            g1 = eng.grammar_health()
            out["grammar_counters"] = {
                c: g1[c] - g0[c] for c in ("forced_tokens_total",
                                           "masked_steps_total")}
        finally:
            await eng.stop()

    asyncio.run(run())
    return out


# --------------------------------------------------------- the protocol

def test_packed_v3_lanes_equal_the_jax_buffer():
    """The drafted/accepted lanes ride the same buffer in both packages,
    built on the device by the port's engine (``xp=torch``)."""
    n, c = 4, 5
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (n, c)).astype(np.int32)
    done = np.array([True, False, True, False])
    lengths = np.array([5, 2, 1, 9], np.int32)
    health = np.array([0, 0, 2, 0], np.int32)
    drafted = np.array([8, 4, 0, 4], np.int32)
    accepted = np.array([5, 0, 0, 3], np.int32)
    want = jax_protocol.pack_chunk(toks, done, lengths, 2, health=health,
                                   drafted=drafted, accepted=accepted)
    got = port_protocol.pack_chunk(
        torch.from_numpy(toks), torch.from_numpy(done),
        torch.from_numpy(lengths), torch.tensor(2),
        health=torch.from_numpy(health), drafted=torch.from_numpy(drafted),
        accepted=torch.from_numpy(accepted), xp=torch)
    np.testing.assert_array_equal(got.numpy(), want)
    a = port_protocol.unpack_chunk(got.numpy(), n, c, spec=True)
    b = jax_protocol.unpack_chunk(want, n, c, spec=True)
    for name in ("tokens", "done", "lengths", "health", "drafted",
                 "accepted"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.n_alive == b.n_alive == 2
    with pytest.raises(ValueError):
        port_protocol.unpack_chunk(got.numpy(), n, c)


# ---------------------------------------------------------- the engines

@pytest.mark.parametrize("regime,k", CASES)
async def test_engine_matches_the_jax_engine(jax_ref, regime, k):
    """Byte-identical transcripts and equal drafted/accepted totals,
    requests sent one at a time; draft_rejected balances the ledger."""
    eng = _port_engine(jax_ref["params"], jax_ref["draft"], regime, k)
    await eng.start()
    try:
        got = await _one_by_one(eng)
        regime_seen = eng._attention_regime
        _books(eng)
    finally:
        await eng.stop()
    assert regime_seen == regime
    assert got == jax_ref["runs"][(regime, k)]
    assert got[1]["drafted_tokens_total"] > 0


@pytest.mark.parametrize("regime", list(REGIMES))
async def test_spec_on_equals_spec_off(jax_ref, regime):
    """The four requests at once (admissions staged together in the
    ragged regime): spec on at k=4 against spec off, byte-identical, and
    each a verify forward's target window at q_len k+1."""
    out = {}
    for name, draft in (("on", jax_ref["draft"]), ("off", None)):
        eng = _port_engine(jax_ref["params"], draft, regime, k=4)
        await eng.start()
        try:
            out[name] = await _burst(eng)
            out[name + "_verify"] = eng.verify_steps
            _books(eng)
        finally:
            await eng.stop()
    assert out["on"] == out["off"]
    assert out["on_verify"] > 0 and out["off_verify"] == 0


async def test_identical_draft_accepts_as_the_jax_engine(jax_ref):
    """Draft = target: the accept path fires (ratio above 0.3, the JAX
    suite's bar), with the JAX engine's totals and transcripts."""
    eng = _port_engine(jax_ref["params"], jax_ref["params"], k=SAME_K,
                       chunk_len=SAME_CHUNK)
    await eng.start()
    try:
        got = await _one_by_one(eng, SAME_REQS)
        ratio = eng.spec_health()["acceptance_ratio"]
        _books(eng)
    finally:
        await eng.stop()
    (want, want_ratio) = jax_ref["same"]
    assert got == want
    assert ratio == want_ratio and ratio > 0.3


async def test_spec_with_grammar_matches_the_jax_engine(jax_ref):
    """Spec under the grammar: the draft masked by the same tables and
    walking its own FSM state; transcripts, spec totals and the grammar
    counters equal the JAX engine's, every transcript in grammar."""
    eng = _port_engine(jax_ref["params"], jax_ref["draft"],
                       grammar_decode=True)
    await eng.start()
    try:
        g0 = eng.grammar_health()
        got = await _one_by_one(eng, GRAMMAR_REQS)
        g1 = eng.grammar_health()
        _books(eng)
    finally:
        await eng.stop()
    assert got == jax_ref["grammar"]
    assert {c: g1[c] - g0[c] for c in jax_ref["grammar_counters"]} == \
        jax_ref["grammar_counters"]
    for text in got[0].values():
        ids = ByteTokenizer().encode(text, add_bos=False)
        assert eng._grammar.in_grammar(0, ids) and text.startswith("kubectl")


@pytest.mark.parametrize("depth", [1, 3])
async def test_capacity_sweep_matches_the_jax_engine(jax_ref, depth):
    """A sampled generation whose budget fills MAX_SEQ_LEN, at k=4 (the
    widest row), runs into the capacity sweep: the consume re-syncs the
    position bound from the slot's anchors, so the sweep retires the
    slot only once a dispatched row could pass MAX_SEQ_LEN, within one
    row of the budget at depth 1, and one more row (k + 2 tokens in the
    ragged regime) for each further chunk in flight at depth 3 (without
    the re-sync the bound grows a whole row a chunk and retires it after
    about a fifth of it). The transcript equals the JAX engine's at the
    same depth, token count and finish reason included, and is a prefix
    of spec off's, which the plain chunk's narrower row carries a little
    further (ROADMAP section C records the difference, the JAX engine's
    own)."""
    p, t, s = CAP_REQ
    out = {}
    for name, draft in (("on", jax_ref["draft"]), ("off", None)):
        eng = _port_engine(jax_ref["params"], draft, k=4,
                           chunk_pipe_depth=depth)
        await eng.start()
        try:
            r = await eng.generate(p, max_tokens=CAP_TOKENS, temperature=t,
                                   seed=s)
            out[name] = (r.text, r.completion_tokens, r.finish_reason)
            n_prompt = r.prompt_tokens
            _books(eng)
        finally:
            await eng.stop()
    assert n_prompt + CAP_TOKENS == COMMON["max_seq_len"]
    assert out["on"] == jax_ref["cap"][depth]
    text, n, finish = out["on"]
    assert finish == "length" and n < CAP_TOKENS
    assert CAP_TOKENS - 5 - (depth - 1) * (4 + 2) < n
    assert out["off"][1:] == (CAP_TOKENS, "length")
    assert out["off"][0].startswith(text)


async def test_one_shot_nan_mid_verify_replays_to_spec_off(jax_ref):
    """A one-shot decode:nan on one request in its second spec chunk: the
    slot trips mid-verify, the decode state resets (the draft's cache
    with it), every request replays through the draft's re-prefill, and
    every transcript equals spec off; the books and the ledger (drafted
    and rejected proposals billed before the trip) balance."""
    inj = port_faults.FaultInjector()
    eng = _port_engine(jax_ref["params"], jax_ref["draft"], faults=inj)
    off = _port_engine(jax_ref["params"])
    await off.start()
    try:
        want = await _burst(off, [(p, t, s) for p, t, s in REQS])
    finally:
        await off.stop()
    await eng.start()
    try:
        prefills = []
        inner = eng._draft_prefill_slot

        def counting(slot_idx, ids, start=0):
            prefills.append(slot_idx)
            return inner(slot_idx, ids, start)

        eng._draft_prefill_slot = counting
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
        inj.target_substr = "pod q1 "
        inj.set("decode", "nan")
        got = await _burst(eng)
        c = eng.stats()["containment"]
        _books(eng)
    finally:
        await eng.stop()
    assert c["resets"] == {"slot_health": 1} and c["quarantined"] == {}
    assert c["replayed_tokens"] > 0
    assert len(prefills) > len(REQS)          # admissions, then replays
    assert got == want


async def test_preempted_spec_request_resumes_as_the_jax_engine(jax_ref):
    """Two slots of sampled background requests; an interactive probe
    preempts one, which resumes from its generated ids (the draft's rows
    re-prefilled): every transcript equals the JAX engine's uncontended
    one."""
    eng = _port_engine(jax_ref["params"], jax_ref["draft"], batch_size=2,
                       preempt_wait_ms=15.0)
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
            await eng.generate(p, max_tokens=8, temperature=t, seed=s)
        res = await asyncio.gather(*tasks)
        preemptions = eng.stats()["qos"]["preemptions"]
        _books(eng)
    finally:
        await eng.stop()
    assert preemptions >= 1
    for (p, _, _), r in zip(BG_REQS, res):
        assert r.text == jax_ref["bg"][p], p


async def test_draft_die_degrades_to_plain_decode(jax_ref):
    """draft:die at the first chunk after start: the engine flips to
    plain chunks, transcripts equal spec off, /health says degraded
    once, and later traffic is served."""
    inj = port_faults.FaultInjector()
    eng = _port_engine(jax_ref["params"], jax_ref["draft"], faults=inj)
    off = _port_engine(jax_ref["params"])
    await off.start()
    try:
        want = await _burst(off)
    finally:
        await off.stop()
    await eng.start()
    try:
        assert eng.spec_health()["active"]
        inj.set("draft", "die")
        got = await _burst(eng)
        h = eng.spec_health()
        verify0 = eng.verify_steps
        again = await _burst(eng)
        verify1 = eng.verify_steps
        _books(eng)
    finally:
        await eng.stop()
    assert got == want and again == want
    assert inj.fired("draft") == 1
    assert not h["active"] and h["degraded_total"] == 1 and h["enabled"]
    assert verify1 == verify0


def _save_draft(params, path) -> None:
    """The port's parameter tree as an HF safetensors checkpoint (the
    inverse of ``convert_hf_checkpoint``'s key map)."""
    lay = params["layers"]
    out = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": params["final_norm"]}
    for i in range(TOY.n_layers):
        pre = f"model.layers.{i}."
        out[pre + "input_layernorm.weight"] = lay["attn_norm"][i]
        out[pre + "post_attention_layernorm.weight"] = lay["mlp_norm"][i]
        for leaf, part in (("wq", "self_attn.q_proj"),
                           ("wk", "self_attn.k_proj"),
                           ("wv", "self_attn.v_proj"),
                           ("wo", "self_attn.o_proj"),
                           ("w_gate", "mlp.gate_proj"),
                           ("w_up", "mlp.up_proj"),
                           ("w_down", "mlp.down_proj")):
            out[pre + part + ".weight"] = lay[leaf][i].T
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"].T
    safetensors_torch.save_file(
        {k: v.contiguous() for k, v in out.items()}, str(path))


async def test_draft_path_loads_a_safetensors_draft(jax_ref, tmp_path):
    """SPEC_DRAFT_PATH: the draft read from a checkpoint at the engine
    dtype, unquantized under QUANT=int8 (only the target is quantized),
    equal leaf for leaf to the tree written; the transcripts equal the
    JAX engine's with that draft, and so do the spec totals."""
    path = tmp_path / "draft.safetensors"
    _save_draft(jax_ref["draft"], path)
    eng = BatchedTorchEngine(
        TOY, tokenizer=ByteTokenizer(), params=jax_ref["params"],
        device="cpu", spec_decode=True, spec_draft_k=2,
        spec_draft_model="toy-8m", spec_draft_path=str(path), **COMMON)
    await eng.start()
    try:
        got = await _one_by_one(eng)
        draft = eng._draft_params
    finally:
        await eng.stop()
    assert got == jax_ref["runs"][("ragged", 2)]
    want = jax_ref["draft"]
    for name, leaf in want["layers"].items():
        assert torch.equal(draft["layers"][name], leaf), name
    for name in ("embed", "final_norm", "lm_head"):
        if name in want:
            assert torch.equal(draft[name], want[name]), name
    q = BatchedTorchEngine(
        TOY, tokenizer=ByteTokenizer(), device="cpu", quant="int8",
        spec_decode=True, spec_draft_model="toy-8m",
        spec_draft_path=str(path), **COMMON)
    q._load()
    q._spec_load()
    assert q._draft_params["layers"]["wq"].dtype == torch.float32
    assert type(q.params["layers"]["wq"]).__name__ == "QuantInt8"


# ------------------------------------------------------------ the knobs

#: knob values the JAX config refuses, each with its message
BAD_KNOBS = [
    {"SPEC_DECODE": "true", "SPEC_DRAFT_K": "0"},
    {"SPEC_DECODE": "true", "SPEC_DRAFT_MODEL": "no-such-model"},
    {"SPEC_DECODE": "true", "SPEC_DRAFT_MODEL": "gemma-2b-it"},
    {"SPEC_DECODE": "true", "DEVICE_TERMINATION": "false"},
]


@pytest.mark.parametrize("env", BAD_KNOBS)
def test_bad_spec_knobs_raise_the_jax_errors(monkeypatch, env):
    # The target is toy-8m whatever an earlier test in this process left
    # in the environment (the JAX from_env also reads a .env file).
    monkeypatch.setenv("MODEL_NAME", "toy-8m")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    errors = []
    for cls in (ServiceConfig, JaxServiceConfig):
        with pytest.raises(ValueError) as ei:
            cls.from_env(env_file=None)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


#: the spec knobs, refused until the port served them: each value is now
#: read into the field the JAX from_env fills
SPEC_KNOBS = [
    ("SPEC_DECODE", "true", "spec_decode", True),
    ("SPEC_DRAFT_K", "2", "spec_draft_k", 2),
    ("SPEC_DRAFT_MODEL", "toy-8m", "spec_draft_model", "toy-8m"),
    ("SPEC_DRAFT_PATH", "/draft", "spec_draft_path", "/draft"),
]


@pytest.mark.parametrize("knob,value,field,want", SPEC_KNOBS)
def test_config_reads_the_spec_knobs_as_the_jax_package(
        monkeypatch, knob, value, field, want):
    assert getattr(ServiceConfig.from_env(env_file=None), field) == \
        getattr(JaxServiceConfig.from_env(env_file=None), field)
    monkeypatch.setenv("SPEC_DRAFT_MODEL", "toy-8m")
    monkeypatch.setenv(knob, value)
    ours = ServiceConfig.from_env(env_file=None)
    theirs = JaxServiceConfig.from_env(env_file=None)
    assert getattr(ours, field) == want == getattr(theirs, field)


@pytest.mark.parametrize("env", [
    {"ENGINE": "torch", "DECODE_BATCH_SIZE": "1"},
    {"ENGINE": "openai"},
    {"KV_POOL": "false"},
])
def test_spec_refused_where_no_engine_would_run_it(monkeypatch, env):
    """Where the port would serve plain decode behind SPEC_DECODE=true,
    it refuses to boot; the batched pool engine boots."""
    monkeypatch.setenv("SPEC_DRAFT_MODEL", "toy-8m")
    monkeypatch.setenv("SPEC_DECODE", "true")
    assert ServiceConfig.from_env(env_file=None).spec_decode
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="SPEC_DECODE=true"):
        ServiceConfig.from_env(env_file=None)


def test_engine_constructor_validates_the_spec_knobs():
    with pytest.raises(ValueError, match="SPEC_DRAFT_K"):
        BatchedTorchEngine(TOY, device="cpu", spec_decode=True,
                           spec_draft_k=0)
    with pytest.raises(ValueError, match="KV pool"):
        BatchedTorchEngine(TOY, device="cpu", spec_decode=True,
                           kv_pool=False)


def test_factory_wires_the_knobs_and_the_draft_point():
    """from_config carries the four knobs; draft:die is accepted with
    SPEC_DECODE=true and refused without it (it could never fire)."""
    cfg = ServiceConfig(torch_device="cpu", spec_decode=True,
                        spec_draft_model="toy-8m", spec_draft_k=3,
                        spec_draft_path="/d", fault_points="draft:die")
    eng = build_engine(cfg)
    assert isinstance(eng, BatchedTorchEngine)
    assert (eng.spec_decode, eng.spec_draft_k, eng.spec_draft_model,
            eng.spec_draft_path) == (True, 3, "toy-8m", "/d")
    assert eng.faults.has("draft")
    with pytest.raises(ValueError, match="SPEC_DECODE=true"):
        build_engine(ServiceConfig(torch_device="cpu",
                                   fault_points="draft:die"))


# ----------------------------------------------------------------- HTTP

def _spec_families(text: str) -> dict:
    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name.startswith("spec_") or (
                    s.name == "goodput_steps_total"
                    and s.labels.get("class") == CLASS_DRAFT_REJECTED):
                out[s.name + "".join(f"{{{k}={v}}}" for k, v in
                                     sorted(s.labels.items()))] = s.value
    return out


async def test_health_and_metrics_carry_the_spec_section(jax_ref):
    """/health's spec section has the JAX keys and the engine's totals;
    the spec_* families of /metrics equal them, and the ledger's
    draft_rejected lane their difference."""
    eng = _port_engine(jax_ref["params"], jax_ref["draft"])
    cfg = ServiceConfig(torch_device="cpu", rate_limit="1000/minute",
                        spec_decode=True, spec_draft_model="toy-8m",
                        max_new_tokens=MAX_TOKENS)
    app = create_app(cfg, eng)
    async with TestClient(TestServer(app)) as client:
        for q in ("list the pods", "show the nodes"):
            r = await client.post("/kubectl-command", json={"query": q})
            assert r.status in (200, 422)
        health = (await (await client.get("/health")).json())["spec"]
        fams = _spec_families(await (await client.get("/metrics")).text())
    assert sorted(health) == jax_ref["health_keys"]
    assert health["enabled"] and health["active"] and health["k"] == 2
    drafted = health["drafted_tokens_total"]
    accepted = health["accepted_tokens_total"]
    assert drafted > 0
    assert fams["spec_drafted_tokens_total"] == drafted
    assert fams["spec_accepted_tokens_total"] == accepted
    assert fams["spec_acceptance_ratio"] == pytest.approx(accepted / drafted)
    rejected = [v for k, v in fams.items() if k.startswith("goodput_")]
    assert sum(rejected) == drafted - accepted
