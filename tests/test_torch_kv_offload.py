"""The port's two-tier host KV against the JAX package's, on the CPU
(toy-8m, float32, ``ByteTokenizer``, 4 slots, chunk 4; both engines at
``chunk_pipe_depth=3``, the JAX default, the JAX engines in the ragged
regime, the port's on the JAX engine's weights through
``params_from_jax``).

- **Fault C7**: the port's batcher never counted a starved slot, so
  ``pool_exhausted`` could not fire. A pool too small for two slots'
  budgets, through both engines on the same weights and traffic: equal
  ``starved_slots_total`` in each engine's own ``kv_pool_health()``, and
  the port's ``IncidentManager`` fires ``pool_exhausted`` from each.
- **The host store and the radix tree's demote/promote**: the same
  operation sequences through both packages' ``HostBlockStore`` and
  ``RadixCache`` give equal stats and books.
- **The engine against ``BatchedJaxEngine``**: a demoted chain returns
  (turn 2 = turn 1's prompt + answer + a follow-up) with byte-identical
  transcripts at temperature 0 and seeded 0.9, equal host-tier counters,
  a payload as long as the JAX engine's (bf16 and ``KV_QUANT=int8``'s
  ``q`` and ``s`` leaves), and a turn 2 equal to a ``HOST_KV_BLOCKS=0``
  engine's cold re-prefill; ``onload:corrupt`` and ``offload:fail``
  parity; a ``decode:nan`` reset rebuilding both tiers; session budgets;
  speculative decoding with the host tier on.

Transcripts are compared byte for byte, counters for equality.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.engine import kv_pool as jax_kv_pool
from ai_agent_kubectl_tpu.engine import qos as jax_qos
from ai_agent_kubectl_tpu.engine import radix_cache as jax_radix
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.protocol import (
    RequestQuarantined as JaxRequestQuarantined)
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.testing import faults as jax_faults
from ai_agent_kubectl_tpu_torch.engine import kv_pool as port_kv_pool
from ai_agent_kubectl_tpu_torch.engine import qos as port_qos
from ai_agent_kubectl_tpu_torch.engine import radix_cache as port_radix
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.protocol import RequestQuarantined
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.obs.incidents import (TRIGGER_POOL,
                                                      IncidentManager)
from ai_agent_kubectl_tpu_torch.testing import faults as port_faults

torch.set_num_threads(1)

TOY = get_config("toy-8m")
COMMON = dict(dtype="float32", max_seq_len=192, prefill_buckets=(32, 64),
              prefix_cache=False, batch_size=4, chunk_len=4,
              kv_pool_page=16, chunk_pipe_depth=3)
HOST = 16
PROMPT = ("inspect deployment rollout status verbose {seed} across the "
          "staging cluster now")
TURNS = ((0.0, 0), (0.9, 77))
MAX_TOKENS = 12
#: the two packages' modules the unit sequences run through
MODULES = {"jax": (jax_kv_pool, jax_radix, jax_faults, jax_qos),
           "port": (port_kv_pool, port_radix, port_faults, port_qos)}


def _jax_engine(faults=None, **kw):
    return BatchedJaxEngine(jconfig.get_config("toy-8m"),
                            tokenizer=JaxByteTokenizer(),
                            compile_cache_dir="", faults=faults,
                            **{"ragged_attention": "on", **COMMON, **kw})


def _port_engine(params, faults=None, **kw):
    return BatchedTorchEngine(TOY, tokenizer=ByteTokenizer(), params=params,
                              device="cpu", faults=faults,
                              **{**COMMON, **kw})


def _params(jeng):
    return params_from_jax(jax.tree.map(np.asarray, jeng.params), TOY)


def _holders(eng) -> dict:
    holders: dict = {}
    for slot in list(eng._slots) + list(eng._parked):
        if slot is not None:
            for b in slot.blocks or ():
                holders[b] = holders.get(b, 0) + 1
    if eng._radix is not None:
        for b, n in eng._radix._held.items():
            holders[b] = holders.get(b, 0) + n
    return holders


def _assert_books(eng) -> None:
    """Both tiers balance exactly: device refcounts against the slots'
    and the tree's holds, every resident host page held by one node."""
    cached = eng._radix.cached_blocks() if eng._radix is not None else ()
    assert eng._pool.stats(cached).live == 0
    host = eng._host_store
    eng._pool.check(_holders(eng), host=host,
                    host_holders=(eng._radix.host_holders()
                                  if host is not None else None))


async def _session(eng, temp, seed, *, arm=None):
    """Turn 1, its chain evicted (demoted with the host tier on), then
    turn 2 = turn 1's prompt + answer + a follow-up (``arm(eng)`` first,
    when given). Returns the transcripts, the onloads and radix hits
    turn 2 took, and the host stats after each step."""
    prompt = PROMPT.format(seed=seed)
    r1 = await eng.generate(prompt, max_tokens=MAX_TOKENS,
                            temperature=temp, seed=seed)
    assert eng._radix.cached_block_count() > 0
    assert eng._radix.evict_for(eng._pool.n_blocks)
    demoted = eng._host_store.stats() if eng._host_store else None
    if arm is not None:
        arm(eng)
    h2 = prompt + r1.text + " and then?"
    hits0 = eng._radix.hit_tokens_total
    on0 = eng._host_store.onloaded_total if eng._host_store else 0
    r2 = await eng.generate(h2, max_tokens=MAX_TOKENS, temperature=temp,
                            seed=seed)
    on1 = eng._host_store.onloaded_total if eng._host_store else 0
    return {"texts": (r1.text, r2.text),
            "finish": (r1.finish_reason, r2.finish_reason),
            "degraded": (r1.degraded, r2.degraded),
            "onloaded": on1 - on0,
            "hits": eng._radix.hit_tokens_total - hits0,
            "after_demote": demoted,
            "host": eng._host_store.stats() if eng._host_store else None,
            "prompt_tokens": len(prompt)}


async def _both(build_kw=None, *, jax_only_kw=None, run=None, faults=False):
    """Fresh engines of both packages on the same weights (the port's
    from the JAX engine's), each through ``run(engine, injector)``.
    Returns {package: (result, engine)} with the engines stopped."""
    build_kw = build_kw or {}
    out = {}
    jinj = jax_faults.FaultInjector() if faults else None
    jeng = _jax_engine(jinj, **build_kw, **(jax_only_kw or {}))
    await jeng.start()
    try:
        params = _params(jeng)
        out["jax"] = (await run(jeng, jinj), jeng)
    finally:
        await jeng.stop()
    pinj = port_faults.FaultInjector() if faults else None
    peng = _port_engine(params, pinj, **build_kw)
    await peng.start()
    try:
        out["port"] = (await run(peng, pinj), peng)
    finally:
        await peng.stop()
    out["params"] = params
    return out


# ------------------------------------------------------------- fault C7

#: the starving geometry: the smallest pool both engines accept (one
#: full-length sequence's pages: 64 positions of 16, plus the JAX
#: engine's chunk of slack) shared by two slots whose budgets each need
#: four, no radix tree to give blocks back
STARVE = dict(max_seq_len=64, prefill_buckets=(16,), batch_size=2,
              kv_pool_blocks=5, radix_cache=False)
STARVE_REQS = [("pod q0 ", 1), ("pod q1 ", 2)]


async def test_fault_c7_starved_slots_are_counted_and_fire_pool_exhausted():
    """Fault C7: two slots whose budgets need eight blocks of a
    five-block pool. Both engines truncate the same slot at the same length, report
    the same ``starved_slots_total`` in their own ``kv_pool_health()``,
    and the port's incident manager fires ``pool_exhausted`` from
    either view."""
    async def run(eng, _inj):
        before = eng.kv_pool_health()
        res = await asyncio.gather(*[
            eng.generate(p, max_tokens=40, seed=s) for p, s in STARVE_REQS])
        return before, eng.kv_pool_health(), [
            (r.text, r.finish_reason, r.degraded) for r in res]

    out = await _both(STARVE, run=run)
    (jb, jh, jres), jeng = out["jax"]
    (pb, ph, pres), peng = out["port"]
    assert pb["starved_slots_total"] == jb["starved_slots_total"] == 0
    assert ph["starved_slots_total"] == jh["starved_slots_total"] >= 1
    assert pres == jres
    assert any(degraded for _, _, degraded in pres)
    for before, after in ((jb, jh), (pb, ph)):
        mgr = IncidentManager(ring=4, cooldown_secs=0.0)
        assert mgr.evaluate({"kv_pool": before}, dict) == []
        fired = mgr.evaluate({"kv_pool": after}, dict)
        assert [b["trigger"] for b in fired] == [TRIGGER_POOL]
        assert fired[0]["detail"]["new_starved_slots"] == \
            after["starved_slots_total"]
    _assert_books(peng)


async def test_starved_count_survives_a_containment_reset():
    """The starved-slot count is the engine's, not the pool's: a reset
    rebuilds the pool and keeps it, as in the JAX engine."""
    async def run(eng, inj):
        await asyncio.gather(*[eng.generate(p, max_tokens=40, seed=s)
                               for p, s in STARVE_REQS])
        n = eng.kv_pool_health()["starved_slots_total"]
        inj.target_substr = "poison"
        inj.set("decode", "nan")
        err = None
        try:
            await eng.generate("poison me", max_tokens=8)
        except Exception as e:   # the quarantine, type checked below
            err = e
        inj.clear()
        return n, eng.kv_pool_health()["starved_slots_total"], err

    out = await _both(STARVE, run=run, faults=True)
    (jn, jafter, jerr), _ = out["jax"]
    (pn, pafter, perr), peng = out["port"]
    assert isinstance(jerr, JaxRequestQuarantined)
    assert isinstance(perr, RequestQuarantined)
    assert peng.supervisor.stats()["resets"]
    assert pn == jn >= 1 and pafter == jafter == pn


# ------------------------------------------------------ host store units

def _store_script(mod):
    kv_pool = mod[0]
    out = []
    store = kv_pool.HostBlockStore(2)
    a = store.put(np.arange(8, dtype=np.int64))
    out.append((a, store.used, store.demoted_total,
                store.verify(a, store.get(a))))
    bad = store.get(a).copy()
    bad[0] ^= 0xFF
    out.append(store.verify(a, bad))
    b = store.put(np.arange(4, dtype=np.int64))
    for fn in (lambda: store.put(np.arange(2)),
               lambda: store.check({a: 1}),
               lambda: store.check({a: 2, b: 1})):
        try:
            fn()
            out.append("ok")
        except (RuntimeError, AssertionError) as e:
            out.append((type(e).__name__, str(e)))
    store.check({a: 1, b: 1})
    store.free(a)
    for fn in (lambda: store.free(a), lambda: store.get(a),
               lambda: store.note_onload_fail("gamma-ray")):
        try:
            fn()
            out.append("ok")
        except (RuntimeError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    store.note_onload_fail("corrupt")
    store.note_dropped(2)
    nxt = kv_pool.HostBlockStore(3)
    nxt.carry_counters(store)
    out.append((store.stats(), nxt.stats()))
    store.free(b)
    store.check({})
    return out


def test_host_store_matches_the_jax_store():
    assert _store_script(MODULES["port"]) == _store_script(MODULES["jax"])
    assert (port_kv_pool.HostBlockStore.ONLOAD_FAIL_CAUSES
            == jax_kv_pool.HostBlockStore.ONLOAD_FAIL_CAUSES)


def _radix_round_trip(mod):
    kv_pool, radix, _, _ = mod
    pool = kv_pool.BlockPool(16, 4)
    store = kv_pool.HostBlockStore(8)
    rad = radix.RadixCache(pool, max_blocks=8, host_store=store)
    ids = list(range(12))
    blocks = pool.alloc(3)
    rad.insert(ids, blocks)
    pool.decref(blocks)
    out = [rad.evict_for(16), pool.free_count, store.stats(),
           rad.host_resident_blocks(), rad.evicted_blocks_total]
    pool.check({}, host=store, host_holders=rad.host_holders())
    mr = rad.match(ids + [99])
    out += [mr.n_tokens, store.stats()]
    pool.decref(mr.blocks)
    pool.check({b: 1 for b in rad.cached_blocks()}, host=store,
               host_holders=rad.host_holders())
    rad.clear()
    pool.check({}, host=store, host_holders=rad.host_holders())
    return out + [store.stats(), rad.stats()]


def _radix_lru(mod):
    kv_pool, radix, _, _ = mod
    pool = kv_pool.BlockPool(16, 4)
    store = kv_pool.HostBlockStore(1)
    rad = radix.RadixCache(pool, max_blocks=8, host_store=store)
    out = []
    for chain in ([1, 2, 3, 4], [5, 6, 7, 8]):
        b = pool.alloc(1)
        rad.insert(chain, b)
        pool.decref(b)
    out += [rad.evict_for(16), store.stats()]
    mr = rad.match([5, 6, 7, 8, 9])
    out.append(mr.n_tokens)
    pool.decref(mr.blocks)
    c = pool.alloc(1)
    rad.insert([9, 9, 9, 9], c)
    pool.decref(c)
    mr2 = rad.match([5, 6, 7, 8])
    pool.decref(mr2.blocks)
    out += [rad.evict_for(16), store.stats()]
    mr3 = rad.match([5, 6, 7, 8, 0])
    out.append(mr3.n_tokens)
    pool.decref(mr3.blocks)
    rad.clear()
    pool.check({}, host=store, host_holders=rad.host_holders())
    return out + [store.stats()]


def _radix_corrupt(mod):
    kv_pool, radix, faults, _ = mod
    inj = faults.FaultInjector()
    pool = kv_pool.BlockPool(16, 4)
    store = kv_pool.HostBlockStore(8)
    rad = radix.RadixCache(pool, max_blocks=8, host_store=store, faults=inj)
    ids = list(range(8))
    blocks = pool.alloc(2)
    rad.insert(ids, blocks)
    pool.decref(blocks)
    out = [rad.evict_for(16), store.used]
    inj.set("onload", "corrupt")
    mr = rad.match(ids + [42])
    out += [mr.n_tokens, list(mr.blocks), store.stats(),
            rad.host_resident_blocks()]
    pool.check({}, host=store, host_holders=rad.host_holders())
    b2 = pool.alloc(2)
    rad.insert(ids, b2)
    pool.decref(b2)
    out.append(rad.evict_for(16))
    mr2 = rad.match(ids + [42])
    out += [mr2.n_tokens, store.stats()]
    pool.decref(mr2.blocks)
    return out


def _radix_offload_fail(mod):
    kv_pool, radix, faults, _ = mod
    inj = faults.FaultInjector()
    inj.set("offload", "fail")
    pool = kv_pool.BlockPool(8, 4)
    store = kv_pool.HostBlockStore(4)
    rad = radix.RadixCache(pool, max_blocks=4, host_store=store, faults=inj)
    pool0 = kv_pool.BlockPool(8, 4)
    rad0 = radix.RadixCache(pool0, max_blocks=4)
    out = []
    for p, r in ((pool, rad), (pool0, rad0)):
        b = p.alloc(2)
        r.insert([1, 2, 3, 4, 5, 6], b)
        p.decref(b)
        out += [r.evict_for(8), p.free_count, r.node_count(),
                r.evicted_blocks_total]
    pool.check({}, host=store, host_holders=rad.host_holders())
    return out + [store.stats()]


@pytest.mark.parametrize("script", [_radix_round_trip, _radix_lru,
                                    _radix_corrupt, _radix_offload_fail])
def test_radix_demote_and_promote_match_the_jax_tree(script):
    port, ref = script(MODULES["port"]), script(MODULES["jax"])
    assert port == ref
    assert port


def _budgets(mod):
    qos = mod[3]
    sb = qos.SessionBudgets(10, max_sessions=2)
    out = []
    sb.charge("t/a", 6)
    out += [sb.over("t/a"), sb.lane_for("t/a", qos.LANE_INTERACTIVE)]
    sb.charge("t/a", 5)
    out += [sb.over("t/a"), sb.lane_for("t/a", qos.LANE_INTERACTIVE),
            sb.lane_for("t/a", qos.LANE_BACKGROUND), sb.demoted_total]
    sb.charge("t/b", 1)
    sb.charge("t/c", 1)
    out += [sb.evicted_total, sb.over("t/a"), sb.snapshot()]
    return out


def test_session_budgets_charge_demotes_as_the_jax_budgets():
    assert _budgets(MODULES["port"]) == _budgets(MODULES["jax"])


async def test_session_budget_demotes_returning_turns_in_both_engines():
    """Delivered tokens charge the namespaced session at finish; once
    over budget, the next turn runs in the background lane. Both engines
    give the same snapshot and transcripts, with the host tier on."""
    async def run(eng, _inj):
        qos = jax_qos if isinstance(eng, BatchedJaxEngine) else port_qos
        ctx = qos.QoSContext(tenant="acme", lane=qos.LANE_INTERACTIVE,
                             session="acme/agent-1")
        texts = []
        with qos.use_qos(ctx):
            for p in ("first turn spends the budget",
                      "second turn is demoted"):
                texts.append((await eng.generate(p, max_tokens=8)).text)
        over = eng._session_budgets.over("acme/agent-1")
        return texts, over, eng.qos_health()["session_budgets"]

    out = await _both({"host_kv_blocks": HOST, "session_token_budget": 2},
                      run=run)
    (jt, jover, jsnap), _ = out["jax"]
    (pt, pover, psnap), _ = out["port"]
    assert pt == jt and pover and jover
    assert psnap == jsnap
    assert psnap["demoted_total"] >= 1


# ----------------------------------------------- the engine against JAX

@pytest.mark.parametrize("kv_quant", ["", "int8"])
async def test_demoted_chain_returns_as_the_jax_engine(kv_quant):
    """THE round trip: turn 1's chain demoted to host RAM (real KV bytes),
    turn 2 served by onloaded pages. Greedy and seeded 0.9: transcripts
    byte-identical to the JAX engine's and to a HOST_KV_BLOCKS=0 engine's
    cold re-prefill; equal host counters; radix hits on turn 2 cover
    turn 1's full prompt pages; the payload as long as the JAX
    engine's."""
    async def run(eng, _inj):
        res = [await _session(eng, t, s) for t, s in TURNS]
        _assert_books(eng)
        chain = eng._radix.cached_blocks()
        block = min(chain)
        return res, eng._pool_offload_block(block).size

    kw = {"host_kv_blocks": HOST, "kv_quant": kv_quant}
    jkw = {"ragged_attention": "off"} if kv_quant else None
    out = await _both(kw, jax_only_kw=jkw, run=run)
    (jres, jlen), _ = out["jax"]
    (pres, plen), peng = out["port"]
    assert plen == jlen
    L, KV, hd, page = TOY.n_layers, TOY.n_kv_heads, TOY.head_dim, 16
    leaf = (L * page * KV * (hd + 4) if kv_quant
            else L * page * KV * hd * 4)
    assert plen == 2 * leaf
    for p, j in zip(pres, jres):
        assert p["texts"] == j["texts"]
        for key in ("onloaded", "hits", "after_demote", "host"):
            assert p[key] == j[key], key
        assert p["onloaded"] > 0 and p["after_demote"]["used"] > 0
        assert p["hits"] >= (p["prompt_tokens"] // 16) * 16
    cold = _port_engine(out["params"], kv_quant=kv_quant)
    await cold.start()
    try:
        for (t, s), p in zip(TURNS, pres):
            c = await _session(cold, t, s)
            assert c["texts"] == p["texts"], (t, s)
            assert c["onloaded"] == 0
    finally:
        await cold.stop()


@pytest.mark.parametrize("kv_quant", ["", "int8"])
async def test_payload_layout_matches_the_jax_engine_in_bf16(kv_quant):
    """At bfloat16 (numpy has no such dtype: the port views the block as
    bytes on the device) a block's payload is as long as the JAX
    engine's: k then v, and under int8 each leaf's q then s. Onloading a
    block's payload into another block copies it bit for bit."""
    kw = dict(COMMON, dtype="bfloat16", host_kv_blocks=4, kv_quant=kv_quant,
              max_seq_len=64, prefill_buckets=(16,))
    jeng = BatchedJaxEngine(jconfig.get_config("toy-8m"),
                            tokenizer=JaxByteTokenizer(),
                            compile_cache_dir="", **kw)
    await jeng.start()
    try:
        await jeng.generate("pod q0 and friends", max_tokens=4)
        jlen = jeng._pool_offload_block(0).size
    finally:
        await jeng.stop()
    peng = BatchedTorchEngine(TOY, tokenizer=ByteTokenizer(), device="cpu",
                              **kw)
    await peng.start()
    try:
        await peng.generate("pod q0 and friends", max_tokens=4)
        src = peng._pool_offload_block(0)
        assert src.dtype == np.uint8 and src.size == jlen
        dst = peng._pool.n_blocks - 1
        peng._pool_onload_block(dst, src)
        assert np.array_equal(peng._pool_offload_block(dst), src)
        for leaf in peng._kv_leaves():
            assert torch.equal(leaf[:, dst].view(torch.uint8),
                               leaf[:, 0].view(torch.uint8))
        with pytest.raises(ValueError, match="payload"):
            peng._pool_onload_block(dst, src[:-1])
    finally:
        await peng.stop()


async def test_onload_corrupt_falls_back_to_prefill_as_the_jax_engine():
    """``onload:corrupt``: the demote-time CRC catches the page, the
    tainted subtree drops and the request completes through the suffix
    prefill: no failure, transcripts as the JAX engine's and as the
    fault-free round trip's, one counted corrupt onload."""
    def arm(eng):
        eng.faults.set("onload", "corrupt")

    async def run(eng, _inj):
        clean = await _session(eng, 0.0, 5)
        bad = await _session(eng, 0.0, 5, arm=arm)
        _assert_books(eng)
        return clean, bad

    out = await _both({"host_kv_blocks": HOST}, run=run, faults=True)
    (jclean, jbad), _ = out["jax"]
    (pclean, pbad), _ = out["port"]
    assert pbad["texts"] == jbad["texts"] == pclean["texts"]
    assert pbad["finish"] == jbad["finish"]
    assert not any(pbad["degraded"])
    assert pbad["host"] == jbad["host"]
    assert pbad["host"]["onload_fail_total"]["corrupt"] == 1
    assert pbad["hits"] == jbad["hits"] < pclean["hits"]


async def test_offload_fail_leaves_the_device_tier_as_host_off():
    """``offload:fail`` on the eviction: the device tier ends where a
    HOST_KV_BLOCKS=0 engine's does after the same traffic, in both
    packages, and the second turn serves as cold."""
    async def run(eng, inj):
        prompt = PROMPT.format(seed=9)
        r1 = await eng.generate(prompt, max_tokens=MAX_TOKENS)
        if inj is not None:
            inj.set("offload", "fail")
        assert eng._radix.evict_for(eng._pool.n_blocks)
        # (the JAX pool holds a chunk of slack more: compare what is used)
        state = (eng._pool.n_blocks - eng._pool.free_count,
                 eng._radix.node_count(), eng._radix.evicted_blocks_total)
        r2 = await eng.generate(prompt + r1.text + " and then?",
                                max_tokens=MAX_TOKENS)
        store = eng._host_store
        return (state, (r1.text, r2.text),
                store.stats() if store is not None else None)

    out = await _both({"host_kv_blocks": HOST}, run=run, faults=True)
    (jstate, jtexts, jhost), _ = out["jax"]
    (pstate, ptexts, phost), _ = out["port"]
    assert pstate == jstate and ptexts == jtexts and phost == jhost
    assert phost["offload_fail_total"] == 1
    off = _port_engine(out["params"])
    await off.start()
    try:
        ostate, otexts, ohost = await run(off, None)
    finally:
        await off.stop()
    assert ohost is None
    # The first demote failed and fell back to the drop; the rest of the
    # chain then demoted as usual, so the device tier is host-off's.
    assert pstate[0] == ostate[0] and ptexts == otexts


async def test_decode_nan_reset_rebuilds_both_tiers_as_the_jax_engine():
    """A decode:nan quarantine with a populated host tier: the reset
    rebuilds BOTH tiers empty (the host payloads were gathered from the
    condemned device world), the counters carry, the books balance, and
    both packages agree."""
    async def run(eng, inj):
        inj.set("decode", "nan")
        inj.target_substr = "poison target"
        await eng.generate("warm this chain before the poison lands",
                           max_tokens=8)
        assert eng._radix.evict_for(eng._pool.n_blocks)
        store0 = eng._host_store
        before = store0.stats()
        assert before["used"] > 0
        err = None
        try:
            await eng.generate("poison target x", max_tokens=8)
        except Exception as e:   # the quarantine, type checked below
            err = e
        inj.clear()
        assert eng._host_store is not store0
        after = eng._host_store.stats()
        _assert_books(eng)
        return before, after, type(err).__name__

    out = await _both({"host_kv_blocks": HOST}, run=run, faults=True)
    (jb, ja, jerr), _ = out["jax"]
    (pb, pa, perr), peng = out["port"]
    assert perr == jerr == "RequestQuarantined"
    assert pb == jb and pa == ja
    assert pa["used"] == 0 and pa["demoted_total"] == pb["demoted_total"]
    assert peng.supervisor.stats()["resets"].get("slot_health", 0) >= 1


async def test_spec_decode_with_the_host_tier_on():
    """Speculative decoding over onloaded pages: the draft re-prefills
    the whole span at admission (promoted pages included), so turn 2's
    transcripts and drafted/accepted totals equal the JAX engine's."""
    spec = dict(spec_decode=True, spec_draft_k=2, spec_draft_model="toy-8m")

    async def run(eng, _inj):
        res = [await _session(eng, t, s) for t, s in TURNS]
        _assert_books(eng)
        h = eng.spec_health()
        return res, (h["drafted_tokens_total"], h["accepted_tokens_total"])

    async def jrun(eng, inj):
        out = await run(eng, inj)
        draft[0] = params_from_jax(
            jax.tree.map(np.asarray, eng._draft_params), TOY)
        return out

    draft = [None]
    jeng = _jax_engine(host_kv_blocks=HOST, spec_draft_seed=1234, **spec)
    await jeng.start()
    try:
        params = _params(jeng)
        jres, jtot = await jrun(jeng, None)
    finally:
        await jeng.stop()
    peng = _port_engine(params, host_kv_blocks=HOST,
                        spec_draft_params=draft[0], **spec)
    await peng.start()
    try:
        pres, ptot = await run(peng, None)
    finally:
        await peng.stop()
    assert ptot == jtot and ptot[0] > 0
    for p, j in zip(pres, jres):
        assert p["texts"] == j["texts"]
        assert p["onloaded"] == j["onloaded"] > 0
        assert p["host"] == j["host"]


def test_engine_refuses_the_host_tier_without_the_tree():
    """The JAX engine quietly builds no store without the pool and the
    radix tree; the port refuses, with the JAX config's message."""
    for kw in ({"kv_pool": False}, {"radix_cache": False}):
        with pytest.raises(ValueError, match="HOST_KV_BLOCKS requires"):
            _port_engine(None, host_kv_blocks=4, **kw)
