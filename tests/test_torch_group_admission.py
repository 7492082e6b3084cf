"""Group admission on the dense KV ladder: the port against the JAX
package on the CPU.

With ``KV_POOL=false`` and the system-prompt prefix cache, the prefix
hits of one admission pass that share a ``(suffix bucket, kv_limit)``
shape are admitted as one group: the prefix spliced into ``kpad``
suffix-depth scratch rows, one forward over ``[kpad, sbucket]``, each
row's first token drawn at generation index 0 of its seed, and the rows
scattered into their slots (padding rows dropped). The KV helpers
(``kv_set_slots``, ``kv_update_slice``, ``kv_broadcast_rows``) are held
against the JAX ones on the same numpy inputs; the scratch budget's
arithmetic (``_scratch_row_bytes``, the per-depth kpad caps) against the
JAX engine's on toy-8m, Llama-3-8B and Gemma-7B (no weights); and two
bursts (four greedy requests, three seeded ones at temperature 0.9
padded to kpad 4) through ``BatchedTorchEngine``'s group path against
``BatchedJaxEngine``'s (its admission warm joined) and the port's own
single admissions (``ADMIT_SCRATCH_MB=1`` caps every kpad to 0), in the
model dtype and with ``KV_QUANT=int8``. A burst is held at the idle
scheduler's pop until every request is queued, so both engines admit it
in one pass.
"""

import asyncio
import queue
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
from ai_agent_kubectl_tpu.engine.prompts import (
    render_prompt as jax_render_prompt)
from ai_agent_kubectl_tpu.engine.tokenizer import (
    ByteTokenizer as JaxByteTokenizer)
from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.ops import quant as jquant
from ai_agent_kubectl_tpu_torch.config import UNSERVED_KNOBS, ServiceConfig
from ai_agent_kubectl_tpu_torch.engine import batcher as port_batcher
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.ops import quant as tquant
from test_torch_env import knob_env  # noqa: F401  (autouse)

torch.set_num_threads(1)

#: the JAX suite's shapes: the byte-tokenized system prompt (273 tokens)
#: fits one 512 prefill, a 64-token suffix bucket gives kv_limit 384 and
#: a 512 bucket overflows max_seq, so every prefix hit of a short query
#: shares one group shape.
COMMON = dict(dtype="float32", max_seq_len=512, prefill_buckets=(64, 512),
              batch_size=4, chunk_len=4, kv_pool=False)
GREEDY = [(f"list pods in namespace team-{i}", 0.0, 0) for i in range(4)]
SEEDED = [(f"show deployments in zone {z}", 0.9, 11 + i)
          for i, z in enumerate("abc")]
MAX_TOKENS = 12
LIMIT = 60.0


# ------------------------------------------------------------- KV helpers

def _leaf(rng, shape, quant):
    if quant:
        return (rng.integers(-127, 127, shape, np.int8),
                rng.normal(size=shape[:-1]).astype(np.float32))
    return rng.normal(size=shape).astype(np.float32)


def _kv(leaf, jax_side):
    if isinstance(leaf, tuple):
        q, s = leaf
        if jax_side:
            return jquant.QuantKV(q=jnp.asarray(q), s=jnp.asarray(s))
        return tquant.QuantKV(q=torch.from_numpy(q.copy()),
                              s=torch.from_numpy(s.copy()))
    return jnp.asarray(leaf) if jax_side else torch.from_numpy(leaf.copy())


def _np(kv):
    leaves = (kv.q, kv.s) if hasattr(kv, "q") else (kv,)
    return [np.asarray(x) for x in leaves]


@pytest.mark.parametrize("case", [
    # (dst shape, src shape, slots, int8 KV)
    ((2, 4, 8, 3, 5), (2, 2, 5, 3, 5), [1, 4], False),   # shallow, pad
    ((1, 2, 4, 1, 2), (1, 1, 4, 1, 2), [0], False),       # full depth
    ((2, 3, 8, 2, 4), (2, 2, 6, 2, 4), [2, 3], True),     # QuantKV, pad
    ((2, 4, 8, 2, 4), (2, 4, 3, 2, 4), [3, 0, 4, 4], False),  # two pads
], ids=["shallow", "full-depth", "quantkv", "half-padding"])
def test_kv_set_slots_matches_the_jax_scatter(case):
    """The port's in-place row scatter against the JAX ``mode="drop"``
    scatter: a shallow source writes only its depth, the tail and the
    other slots stay, and every row whose slot is the batch size (the
    group's padding) is dropped, never raised on."""
    dshape, sshape, slots, quant = case
    rng = np.random.default_rng(len(slots))
    dst, src = _leaf(rng, dshape, quant), _leaf(rng, sshape, quant)
    want = jquant.kv_set_slots(_kv(dst, True), _kv(src, True),
                               jnp.asarray(slots, jnp.int32))
    got = tquant.kv_set_slots(_kv(dst, False), _kv(src, False),
                              np.asarray(slots))
    for a, b in zip(_np(got), _np(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "quantkv"])
def test_prefix_splice_matches_the_jax_helpers(quant):
    """``kv_update_slice(scratch, kv_broadcast_rows(prefix, kpad))``: the
    resident prefix broadcast into kpad scratch rows, as the JAX group's
    splice program writes it."""
    rng = np.random.default_rng(7)
    scratch = _leaf(rng, (2, 4, 12, 2, 4), quant)
    prefix = _leaf(rng, (2, 1, 5, 2, 4), quant)
    want = jquant.kv_update_slice(
        _kv(scratch, True), jquant.kv_broadcast_rows(_kv(prefix, True), 4))
    got = tquant.kv_update_slice(
        _kv(scratch, False), tquant.kv_broadcast_rows(_kv(prefix, False), 4))
    for a, b in zip(_np(got), _np(want)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- the scratch budget

@pytest.mark.parametrize("model", ["toy-8m", "llama-3-8b-instruct",
                                   "gemma-7b-it"])
@pytest.mark.parametrize("kv_quant", ["", "int8"])
@pytest.mark.parametrize("mb", [0, 1, 64, 512])
def test_scratch_row_bytes_and_caps_match_the_jax_engine(model, kv_quant,
                                                         mb):
    """The budget arithmetic on the real geometries, without weights:
    one scratch row's bytes at each depth and the per-depth kpad caps
    equal the JAX engine's, in bf16 and with int8 KV."""
    kw = dict(dtype="bfloat16", max_seq_len=1024, batch_size=16,
              kv_pool=False, kv_quant=kv_quant, admit_scratch_mb=mb)
    jeng = BatchedJaxEngine(jconfig.get_config(model), compile_cache_dir="",
                            **kw)
    teng = BatchedTorchEngine(get_config(model), device="cpu", **kw)
    depths = [128, 384, 640, 1024]
    jeng._cap_admit_kpads(depths)
    teng._cap_admit_kpads(depths)
    assert teng.admit_kpads == jeng.admit_kpads == (2, 4, 8, 16)
    for d in depths:
        assert teng._scratch_row_bytes(d) == jeng._scratch_row_bytes(d)
        assert teng.admit_kpads_for(d) == jeng.admit_kpads_for(d)
    assert teng._admit_kpad_caps == jeng._admit_kpad_caps


@pytest.mark.parametrize("kw", [dict(kv_pool=True, batch_size=8),
                                dict(kv_pool=False, batch_size=1),
                                dict(kv_pool=False, batch_size=6)],
                         ids=["pool", "one-slot", "six-slots"])
def test_group_sizes_follow_the_jax_structure(kw):
    """No group under the pool (no scratch to stage) nor at one slot;
    otherwise the kpads that fit the batch."""
    jeng = BatchedJaxEngine(jconfig.get_config("toy-8m"),
                            compile_cache_dir="", **kw)
    # The JAX engine resolves its pool at start (no mesh: the knob).
    jeng._use_pool = jeng.kv_pool
    teng = BatchedTorchEngine(get_config("toy-8m"), device="cpu", **kw)
    assert teng.admit_kpads == jeng.admit_kpads


@pytest.mark.parametrize("raw", ["256", "0", "-3", "lots", ""])
def test_admit_scratch_mb_read_as_the_jax_package(monkeypatch, raw):
    """``ADMIT_SCRATCH_MB`` is served: read into the field the JAX
    ``from_env`` fills (default 512), a value that does not parse
    refused with the JAX error, and a negative budget read as given and
    clamped to 0 (uncapped) by both engines."""
    assert "ADMIT_SCRATCH_MB" not in UNSERVED_KNOBS
    monkeypatch.setenv("MODEL_NAME", "toy-8m")
    monkeypatch.setenv("ADMIT_SCRATCH_MB", raw)
    outcomes = []
    for cls in (ServiceConfig, JaxServiceConfig):
        try:
            outcomes.append(
                ("read", cls.from_env(env_file=None).admit_scratch_mb))
        except ValueError as e:
            outcomes.append(("refused", str(e)))
    assert outcomes[0] == outcomes[1]
    if raw == "lots":
        assert outcomes[0][0] == "refused"
        return
    assert outcomes[0] == ("read", int(raw) if raw else 512)
    eng = BatchedTorchEngine.from_config(ServiceConfig(
        torch_device="cpu", kv_pool=False,
        admit_scratch_mb=ServiceConfig.from_env(
            env_file=None).admit_scratch_mb))
    assert eng.admit_scratch_mb == max(0, int(raw) if raw else 512)


# ---------------------------------------------------------------- bursts

def _record_ids(eng) -> dict:
    """Each finished request's token ids by prompt ids (the JAX engine's
    results carry only text): the engine's ``_finish`` wrapped."""
    done: dict = {}
    finish = eng._finish

    def recording(slot_idx, *args, **kw):
        slot = eng._slots[slot_idx]
        if slot is not None:
            done[tuple(slot.req.prompt_ids)] = list(slot.detok.ids)
        return finish(slot_idx, *args, **kw)

    eng._finish = recording
    return done


async def _until(cond, what: str) -> None:
    deadline = time.monotonic() + LIMIT
    while not cond():
        assert time.monotonic() < deadline, f"{what} within {LIMIT:.0f} s"
        await asyncio.sleep(0.002)


async def _burst(eng, render, reqs) -> list:
    """``reqs`` sent at once to an idle scheduler whose next pop is held
    until all are queued and then comes back empty, so the pass after it
    pops the whole burst: one group in either engine. Returns each
    request's token ids, in order."""
    done = _record_ids(eng)
    q = eng._admissions
    held, opened = threading.Event(), threading.Event()

    def hold(*args, **kw):
        held.set()
        opened.wait(LIMIT)
        raise queue.Empty

    q.get = hold
    try:
        await _until(held.is_set, "the scheduler never went idle")
        prompts = [render(p) for p, _, _ in reqs]
        tasks = [asyncio.ensure_future(eng.generate(
            p, max_tokens=MAX_TOKENS, temperature=t, seed=s))
            for p, (_, t, s) in zip(prompts, reqs)]
        await _until(lambda: q.qsize() >= len(reqs),
                     "the burst was never wholly queued")
        q.__dict__.pop("get", None)
        opened.set()
        await asyncio.wait_for(asyncio.gather(*tasks), LIMIT)
    finally:
        q.__dict__.pop("get", None)
        opened.set()
        eng.__dict__.pop("_finish", None)
    return [done[tuple(eng.tokenizer.encode(p))] for p in prompts]


def _books(eng) -> dict:
    """The dense ladder's books after a burst: every slot free, and the
    stats' page counters (the same keys in both packages)."""
    assert all(s is None for s in eng._slots)
    st = eng.stats()
    return {k: st[k] for k in ("kv_pages_used", "kv_pages_total")}


def _keys(eng, render) -> list:
    """The group key the engine gives a prefix hit, its resume and a
    query that misses the prefix."""
    hit = eng.tokenizer.encode(render("get nodes"))
    reqs = [SimpleNamespace(prompt_ids=hit, max_tokens=MAX_TOKENS,
                            resume_ids=None, gpid=-1),
            SimpleNamespace(prompt_ids=hit, max_tokens=MAX_TOKENS,
                            resume_ids=[5, 6], gpid=-1),
            SimpleNamespace(prompt_ids=eng.tokenizer.encode("get nodes"),
                            max_tokens=MAX_TOKENS, resume_ids=None, gpid=-1)]
    return [eng._suffix_group_key(r) for r in reqs]


async def _jax_run(kv_quant: str) -> dict:
    jeng = BatchedJaxEngine(jconfig.get_config("toy-8m"),
                            tokenizer=JaxByteTokenizer(),
                            compile_cache_dir="", kv_quant=kv_quant,
                            **COMMON)
    await jeng.start()
    try:
        # The group path runs only once the background admission warm
        # has compiled its shape and released the scratch lock.
        jeng._batch_warm_thread.join(120.0)
        assert not jeng._batch_warm_thread.is_alive(), (
            "the JAX engine's admission warm never finished")
        g0 = jeng._group_admitted
        greedy = await _burst(jeng, jax_render_prompt, GREEDY)
        g1 = jeng._group_admitted
        seeded = await _burst(jeng, jax_render_prompt, SEEDED)
        return dict(greedy=greedy, seeded=seeded,
                    groups=(g1 - g0, jeng._group_admitted - g1),
                    books=_books(jeng), keys=_keys(jeng, jax_render_prompt),
                    params=jax.tree.map(np.asarray, jeng.params))
    finally:
        await jeng.stop()


@pytest.fixture(scope="module")
def jax_runs():
    """Both bursts through the JAX engine's group path, once per KV
    mode, with the weights the port engines then serve."""
    return {q: asyncio.run(_jax_run(q)) for q in ("", "int8")}


async def _port_run(params, kv_quant: str, **kw) -> dict:
    eng = BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                             params=params, device="cpu", kv_quant=kv_quant,
                             **COMMON, **kw)
    await eng.start()
    try:
        g0 = eng._group_admitted
        greedy = await _burst(eng, render_prompt, GREEDY)
        g1 = eng._group_admitted
        seeded = await _burst(eng, render_prompt, SEEDED)
        return dict(greedy=greedy, seeded=seeded,
                    groups=(g1 - g0, eng._group_admitted - g1),
                    books=_books(eng), keys=_keys(eng, render_prompt))
    finally:
        await eng.stop()


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["model-dtype",
                                                        "int8-kv"])
def test_group_bursts_match_the_jax_group_path_and_single_admission(
        jax_runs, kv_quant, monkeypatch):
    """Four greedy prefix hits (kpad 4) and three seeded ones at 0.9
    (padded to kpad 4): the port's group transcripts equal the JAX
    group's and the port's own single admissions' token for token, each
    burst is one group in both engines (one forward over [4, 64] in the
    port's group path) and none in the capped engine, and the books
    balance."""
    ref = jax_runs[kv_quant]
    params = params_from_jax(ref["params"], get_config("toy-8m"))
    shapes = []
    fwd = port_batcher.forward

    def spy(params_, cfg, tokens, *args, **kw):
        shapes.append(tuple(tokens.shape))
        return fwd(params_, cfg, tokens, *args, **kw)

    monkeypatch.setattr(port_batcher, "forward", spy)
    grouped = asyncio.run(_port_run(params, kv_quant))
    assert shapes.count((4, 64)) == 2, shapes
    # The single-admission reference: a budget that caps every kpad to 0
    # in the model dtype; under int8 KV (a row is a quarter the bytes, so
    # 1 MB still fits kpad 2) the group sizes are emptied instead.
    single_kw = {"admit_scratch_mb": 1} if not kv_quant else {}
    if kv_quant:
        monkeypatch.setattr(BatchedTorchEngine, "ADMIT_KPADS", ())
    shapes.clear()
    single = asyncio.run(_port_run(params, kv_quant, **single_kw))
    assert (4, 64) not in shapes
    assert grouped["greedy"] == ref["greedy"] == single["greedy"]
    assert grouped["seeded"] == ref["seeded"] == single["seeded"]
    assert all(0 < len(ids) <= MAX_TOKENS
               for ids in grouped["greedy"] + grouped["seeded"])
    assert grouped["groups"] == ref["groups"] == (1, 1)
    assert single["groups"] == (0, 0)
    assert grouped["books"] == single["books"] == ref["books"]
    assert ref["books"]["kv_pages_used"] == 0
    assert grouped["keys"] == ref["keys"]
    assert grouped["keys"][0] == (64, 384) and grouped["keys"][1:] == [
        None, None]


async def test_grammar_requests_take_the_single_path():
    """Under ``GRAMMAR_DECODE`` a prefix hit with a grammar samples its
    first token masked, so a burst of them is admitted singly (no group)
    and every request is served."""
    eng = BatchedTorchEngine(get_config("toy-8m"), tokenizer=ByteTokenizer(),
                             device="cpu", grammar_decode=True, **COMMON)
    await eng.start()
    try:
        ids = await _burst(eng, render_prompt, GREEDY)
        assert eng._group_admitted == 0
        assert all(ids)
        req = SimpleNamespace(prompt_ids=eng.tokenizer.encode(
            render_prompt("get pods")), max_tokens=8, resume_ids=None,
            gpid=0)
        assert eng._suffix_group_key(req) is None
        req.gpid = -1
        assert eng._suffix_group_key(req) == (64, 384)
    finally:
        await eng.stop()
