"""The port's weight swap and zero-downtime rollout (``engine/rollout.py``,
``TorchEngine.swap_weights``, ``/admin/rollout``) against the JAX
package's, on the CPU.

- **Fault C8**: without ``MODEL_PATH`` the port stamped the raw sentinel
  (``dev:toy-8m:seed=0``) as its weights version and recorded no
  checkpoint path; the JAX engine stamps ``checkpoint_version`` of
  ``dev:<model>:seed=<n>:quant=<q>`` and records the sentinel. Equal
  stamps for quant "", int8 and int4, and for ``MODEL_PATH``.
- **The swap**: a tiny HF checkpoint swapped in and rolled back in both
  packages gives equal transcripts at each step; a rollback onto the
  dev sentinel restores the first transcript byte for byte; a radix hit
  on the preloaded system prompt, a host-tier onload and a dense prefix
  hit after a swap give a fresh engine's transcript on the new weights
  (no KV of the old weights survives the restart); a swap on a running
  engine and a tree that does not fit are refused with the JAX messages.
- **The state machine** (mirroring ``tests/test_rollout.py``) over
  toy-8m fleets of ``BatchedTorchEngine``: the version table, the
  version filter and the canary accumulator, an established stream that
  never splices across versions, the happy path, the burn gate (fed
  before the observe window opens, so the first gate poll breaches),
  ``swap:fail``, ``checkpoint:corrupt``, abort, and the ``FLEET_SIZE=1``
  in-place swap with priced 503s over HTTP against the JAX app.
- **HTTP**: ``/admin/rollout`` statuses, bodies' keys, ``/health``'s
  ``rollout`` and ``fleet`` keys and the three ``rollout_*`` families
  against the JAX app over a fleet of its fake engines.

No assertion waits on a wall-clock race; every async test runs under
its own timeout. Two JAX engines: one ``JaxEngine`` whose ``_load`` is
stamped three times, and one ``BatchedJaxEngine`` on the checkpoints.
"""

import asyncio
import threading
import time
import zlib

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from ai_agent_kubectl_tpu.config import ServiceConfig as JaxServiceConfig
from ai_agent_kubectl_tpu.engine import rollout as jax_rollout
from ai_agent_kubectl_tpu.engine.fake import FakeChunkedEngine
from ai_agent_kubectl_tpu.engine.fleet import EngineFleet as JaxEngineFleet
from ai_agent_kubectl_tpu.server.app import create_app as jax_create_app
from ai_agent_kubectl_tpu.testing.faults import (
    FaultInjector as JaxFaultInjector)
from ai_agent_kubectl_tpu_torch.config import ServiceConfig
from ai_agent_kubectl_tpu_torch.engine import rollout as port_rollout
from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
from ai_agent_kubectl_tpu_torch.engine.fleet import EngineFleet
from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
from ai_agent_kubectl_tpu_torch.engine.protocol import EngineUnavailable
from ai_agent_kubectl_tpu_torch.engine.rollout import (
    CAUSE_ABORTED, CAUSE_BURN_GATE, CAUSE_CHECKPOINT_CORRUPT,
    CAUSE_SWAP_FAILED, STATE_COMPLETE, STATE_OBSERVING, STATE_ROLLED_BACK,
    CheckpointCorrupt, RolloutController, RolloutError, SwapFailed,
    checkpoint_version)
from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.obs.slo import SLO_TTFT
from ai_agent_kubectl_tpu_torch.server.app import create_app
from ai_agent_kubectl_tpu_torch.testing.faults import FaultInjector

torch.set_num_threads(1)

TOY = get_config("toy-8m")
SMALL = dict(dtype="float32", max_seq_len=64, prefill_buckets=(16,),
             prefix_cache=False, batch_size=2, chunk_len=4)
V1 = "dev:toy-8m:seed=0:quant="
V2 = "dev:toy-8m:seed=1:quant="
V3 = "dev:toy-8m:seed=2:quant="
LIMIT = 60.0


def _run(coro):
    """One scenario under its own timeout."""
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


def _engine(faults=None, **kw):
    return BatchedTorchEngine(TOY, tokenizer=ByteTokenizer(), device="cpu",
                              faults=faults, **{**SMALL, **kw})


async def _fleet(n=2, faults=None, fleet_kw=None, **kw):
    fleet = EngineFleet(
        [_engine(faults.for_replica(i) if faults is not None else None,
                 **kw) for i in range(n)],
        **(fleet_kw or {}))
    await fleet.start()
    return fleet


def _controller(engine, **kw):
    return RolloutController(engine, **{"canary_share": 0.25,
                                        "observe_secs": 0.2,
                                        "burn_gate": 2.0,
                                        "drain_secs": 2.0, **kw})


async def _poll(cond, what: str) -> None:
    """Poll ``cond`` until it holds, failing the test with ``what`` when
    it has not within ``LIMIT`` seconds (a lost race must fail, not hang
    the run)."""
    deadline = time.monotonic() + LIMIT
    while not cond():
        assert time.monotonic() < deadline, f"{what} within {LIMIT:.0f} s"
        await asyncio.sleep(0.005)


async def _idle(ctl):
    await _poll(lambda: not ctl.active, "the rollout never ended")


async def _until(ctl, state):
    def reached():
        if ctl.state == state:
            return True
        assert ctl.active, f"rollout ended in {ctl.state}"
        return False

    await _poll(reached, f"the rollout never reached {state}")


async def _text(eng, prompt="pod alpha ", **kw):
    return (await eng.generate(prompt, max_tokens=24, **kw)).text


# --------------------------------------------------------------- C8 first


@pytest.fixture(scope="module")
def jax_stamps():
    """One JaxEngine's _load stamps for quant "", int8 and int4: the
    version and the checkpoint path, as the JAX package records them.
    The engine is handed (placeholder, already quantized) parameters, so
    _load draws nothing: the JAX engine stamps caller-supplied weights
    exactly as it stamps its random init."""
    from ai_agent_kubectl_tpu.engine.jax_engine import JaxEngine
    from ai_agent_kubectl_tpu.engine.tokenizer import ByteTokenizer as JBT
    from ai_agent_kubectl_tpu.models import config as jconfig

    jeng = JaxEngine(jconfig.get_config("toy-8m"), tokenizer=JBT(),
                     dtype="float32", compile_cache_dir="")
    out = {}
    for quant in ("", "int8", "int4"):
        jeng.quant, jeng.params, jeng._quantized = quant, {}, True
        jeng.weights_version, jeng.checkpoint_path = "", None
        jeng._load()
        out[quant] = (jeng.weights_version, jeng.checkpoint_path)
    return out


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_fault_c8_dev_version_equals_the_jax_stamp(jax_stamps, quant):
    eng = _engine(quant=quant)
    eng._load()
    assert (eng.weights_version, eng.checkpoint_path) == jax_stamps[quant]
    assert eng.checkpoint_path == f"dev:toy-8m:seed=0:quant={quant}"
    assert len(eng.weights_version) == 12
    # Caller-supplied parameters are stamped too, as in the JAX engine.
    other = _engine(quant=quant, params=eng.params)
    other._load()
    assert other.weights_version == eng.weights_version


def test_rollout_module_is_the_jax_one():
    assert port_rollout.ROLLOUT_STATES == jax_rollout.ROLLOUT_STATES
    assert port_rollout.ROLLBACK_CAUSES == jax_rollout.ROLLBACK_CAUSES
    for path in ("", None, "/nope/a", V1, "dev:toy-8m:seed=0"):
        assert checkpoint_version(path) == jax_rollout.checkpoint_version(
            path)
    snap = {"windows": ["5m", "1h"], "slos": {"ttft": {"lanes": {
        "interactive": {"windows": {
            "5m": {"total": 10, "breaching": 5, "burn_rate": 50.0},
            "1h": {"total": 10, "breaching": 5, "burn_rate": 50.0}}}}}}}
    for s in (None, {}, snap):
        assert (port_rollout.fast_burn_from_snapshot(s)
                == jax_rollout.fast_burn_from_snapshot(s))
    for cls in ("RolloutError", "CheckpointCorrupt", "SwapFailed"):
        assert [c.__name__ for c in getattr(port_rollout, cls).__mro__[:3]] \
            == [c.__name__ for c in getattr(jax_rollout, cls).__mro__[:3]]


# ------------------------------------------------------------- the swap


def _save_toy_checkpoint(path, seed):
    """toy-8m's weights in the HF safetensors layout (Llama names, an
    untied head), drawn from ``seed``: a checkpoint both packages load
    through MODEL_PATH."""
    from safetensors.torch import save_file

    c = TOY
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen) * shape[-1] ** -0.5

    d, H, KV, hd, F_ = c.dim, c.n_heads, c.n_kv_heads, c.head_dim, \
        c.mlp_hidden
    tensors = {"model.embed_tokens.weight": draw(c.vocab_size, d),
               "model.norm.weight": torch.ones(d),
               "lm_head.weight": draw(c.vocab_size, d)}
    for i in range(c.n_layers):
        p = f"model.layers.{i}."
        tensors.update({
            p + "input_layernorm.weight": torch.ones(d),
            p + "post_attention_layernorm.weight": torch.ones(d),
            p + "self_attn.q_proj.weight": draw(H * hd, d),
            p + "self_attn.k_proj.weight": draw(KV * hd, d),
            p + "self_attn.v_proj.weight": draw(KV * hd, d),
            p + "self_attn.o_proj.weight": draw(d, H * hd),
            p + "mlp.gate_proj.weight": draw(F_, d),
            p + "mlp.up_proj.weight": draw(F_, d),
            p + "mlp.down_proj.weight": draw(d, F_)})
    path.mkdir()
    save_file(tensors, str(path / "model.safetensors"))


async def _swap_script(eng, paths, query):
    """The checkpoint at paths[0] served, then each later path swapped in
    (stop, swap, start): (weights version, checkpoint path, transcript)
    at each step."""
    out = []
    await eng.start()
    try:
        for i, path in enumerate(paths):
            if i:
                await eng.stop()
                eng.swap_weights(path)
                await eng.start()
            r = await eng.generate(query, max_tokens=8)
            out.append((eng.weights_version, eng.checkpoint_path, r.text,
                        r.weights_version))
    finally:
        await eng.stop()
    return out


def test_hf_checkpoint_swap_and_rollback_equal_the_jax_engine(tmp_path):
    """MODEL_PATH served, a second checkpoint swapped in, the first
    swapped back: at every step both packages stamp one version and
    give one transcript; the swap changes it, the rollback restores it."""
    from ai_agent_kubectl_tpu.engine.batcher import BatchedJaxEngine
    from ai_agent_kubectl_tpu.engine.tokenizer import ByteTokenizer as JBT
    from ai_agent_kubectl_tpu.models import config as jconfig

    a, b = tmp_path / "a", tmp_path / "b"
    _save_toy_checkpoint(a, 7)
    _save_toy_checkpoint(b, 8)
    common = dict(SMALL, model_path=str(a))
    paths = [str(a), str(b), str(a)]
    query = "list all services"
    jeng = BatchedJaxEngine(jconfig.get_config("toy-8m"), tokenizer=JBT(),
                            compile_cache_dir="", ragged_attention="on",
                            **common)
    want = asyncio.run(_swap_script(jeng, paths, query))
    ours = BatchedTorchEngine(TOY, tokenizer=ByteTokenizer(), device="cpu",
                              **common)
    got = _run(_swap_script(ours, paths, query))
    assert got == want
    assert got[0][0] == checkpoint_version(str(a)) == got[2][0]
    assert got[1][0] == checkpoint_version(str(b))
    assert got[1][2] != got[0][2] and got[2][2] == got[0][2]


def test_dev_sentinel_rollback_is_byte_identical():
    async def go():
        eng = _engine()
        await eng.start()
        v1, t1 = eng.weights_version, await _text(eng)
        assert eng.checkpoint_path == V1
        # A swap on a running engine is refused (drain first).
        with pytest.raises(RolloutError, match="stopped"):
            eng.swap_weights(V2)
        await eng.stop()
        v2 = eng.swap_weights(V2)
        assert v2 == checkpoint_version(V2) != v1
        await eng.start()
        t2 = await _text(eng)
        assert t2 != t1
        await eng.stop()
        assert eng.swap_weights(V1, version=v1) == v1
        await eng.start()
        try:
            assert await _text(eng) == t1
            assert (await eng.generate("x y", max_tokens=2)
                    ).weights_version == v1
        finally:
            await eng.stop()
        # A restart keeps the version a swap stamped.
        eng.swap_weights(V2)
        await eng.start()
        await eng.stop()
        assert eng.weights_version == v2 and eng.checkpoint_path == V2

    _run(go())


def test_swap_refuses_a_mismatched_tree_with_the_jax_message(tmp_path):
    wrong_path = str(tmp_path / "wrong-model")

    async def go():
        eng = _engine()
        await eng.start()
        t1 = await _text(eng)
        v1 = eng.weights_version
        await eng.stop()
        wrong = _engine(quant="int8")
        wrong._load()
        eng._load_swap_params = lambda path: wrong.params
        with pytest.raises(CheckpointCorrupt) as ei:
            eng.swap_weights(wrong_path)
        assert str(ei.value) == (
            f"checkpoint {wrong_path!r} does not match the serving "
            f"model's parameter tree (toy-8m, quant=-)")
        del eng._load_swap_params
        # A checkpoint that fails to load keeps the old weights too.
        with pytest.raises(CheckpointCorrupt, match="failed to load"):
            eng.swap_weights(str(__file__))
        with pytest.raises(CheckpointCorrupt,
                           match="swap needs a checkpoint path"):
            eng.swap_weights("  ")
        assert eng.weights_version == v1
        # An absent path that is no dev sentinel random-inits keyed on
        # the crc32 of the path.
        absent = str(tmp_path / "absent")
        want = eng._random_params(zlib.crc32(absent.encode()) & 0x7FFFFFFF)
        got = eng._load_swap_params(absent)
        assert all(torch.equal(got[k], want[k]) for k in want
                   if k != "layers")
        assert all(torch.equal(got["layers"][k], want["layers"][k])
                   for k in want["layers"])
        del got, want
        await eng.start()
        try:
            assert await _text(eng) == t1
        finally:
            await eng.stop()

    _run(go())


#: the engine regimes a swap must rebuild: the pool's radix tree with
#: the preloaded system prompt; the host tier behind it; the dense
#: ladder's prefix cache
REGIMES = {
    "radix": dict(prefix_cache=True, radix_lru_blocks=40),
    "host": dict(prefix_cache=True, radix_lru_blocks=40,
                 host_kv_blocks=64),
    "dense": dict(prefix_cache=True, kv_pool=False),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_swap_leaves_no_kv_of_the_old_weights(regime):
    """Cached KV of the old weights (the preloaded system prompt, a
    demoted chain, the dense prefix) read after a swap would give a
    transcript of neither version: the swapped engine's must equal a
    fresh engine's on the new weights."""
    kw = dict(REGIMES[regime], max_seq_len=512, prefill_buckets=(64,),
              batch_size=2)
    prompt = render_prompt("show the pods of the web deployment")

    async def serve(eng):
        r = await eng.generate(prompt, max_tokens=12)
        assert r.prefix_cache_hit
        if regime != "host":
            return r.text
        # A chain cached under these weights, demoted to the host tier
        # and onloaded back for the same prompt.
        assert eng._radix.evict_for(eng._pool.n_blocks)
        on0 = eng._host_store.onloaded_total
        again = await eng.generate(prompt, max_tokens=12)
        assert eng._host_store.onloaded_total > on0
        assert again.text == r.text
        return r.text

    async def go():
        eng = _engine(**kw)
        await eng.start()
        t1 = await serve(eng)
        if regime == "host":
            assert eng._radix.evict_for(eng._pool.n_blocks)
            assert eng._host_store.stats()["used"] > 0
        await eng.stop()
        eng.swap_weights(V2)
        await eng.start()
        try:
            if regime == "host":
                assert eng._host_store.stats()["used"] == 0
            got = await serve(eng)
        finally:
            await eng.stop()
        fresh = _engine(seed=1, **kw)
        await fresh.start()
        try:
            want = await serve(fresh)
        finally:
            await fresh.stop()
        assert got == want != t1

    _run(go())


# ---------------------------------------------------- the state machine


def test_fleet_version_table_and_facade():
    async def go():
        fleet = await _fleet(2)
        v1 = checkpoint_version(V1)
        try:
            fh = fleet.fleet_health()
            assert fh["weights_version"] == v1
            assert fh["versions"] == {v1: 2} and fh["canary"] is None
            await fleet.drain(1)
            v2 = fleet.replicas[1].engine.swap_weights("/x/v2")
            await fleet.rejoin(1)
            fh = fleet.fleet_health()
            assert fh["versions"] == {v1: 1, v2: 1}
            vers = {r["replica"]: r["weights_version"]
                    for r in fleet.stats()["fleet"]["replicas"]}
            assert vers == {0: v1, 1: v2}
        finally:
            await fleet.stop()

    _run(go())


def test_route_version_filter_and_canary_accumulator():
    async def go():
        fleet = await _fleet(3, fleet_kw={"affinity": False})
        v1 = checkpoint_version(V1)
        try:
            fleet.replicas[2].engine.weights_version = "v2"
            assert fleet._route("q", version="v2").idx == 2
            assert fleet._route("q", version=v1).idx in (0, 1)
            assert fleet._route("q", version="v3") is None
            fleet.set_canary(2, 0.25)
            picks = [fleet._route(f"q{i}").idx for i in range(20)]
            assert picks.count(2) == 5
            assert fleet._route("q", version="v2").idx == 2
            fleet.clear_canary()
            assert all(fleet._route("q").idx == 0 for _ in range(8))
        finally:
            await fleet.stop()

    _run(go())


class _Hold:
    """Holds an engine's scheduler before its first chunk dispatch after
    two chunks were read until ``release``: its request is in flight, with
    tokens delivered, by construction."""

    def __init__(self, eng):
        self.reached, self.opened = threading.Event(), threading.Event()
        base = eng._chunks_consumed
        real = type(eng)._dispatch_chunk.__get__(eng)

        def dispatch():
            if (eng._chunks_consumed - base >= 2
                    and not self.opened.is_set()):
                self.reached.set()
                self.opened.wait(LIMIT)
                if not eng._running:
                    return
            real()

        eng._dispatch_chunk = dispatch

    async def wait(self):
        await _poll(self.reached.is_set,
                    "the held engine never read two chunks")


def test_established_stream_never_splices_across_versions():
    """The serving replica dies mid-stream while the only sibling runs
    other weights: the stream fails with the pinning error and keeps the
    bytes it had, never a cross-version splice."""
    async def go():
        fleet = await _fleet(2, fleet_kw={"affinity": False})
        try:
            await fleet.drain(1)
            fleet.replicas[1].engine.swap_weights(V2)
            await fleet.rejoin(1)
            hold = _Hold(fleet.replicas[0].engine)

            async def consume():
                async for _ in fleet.generate_stream(
                        "pod alpha ", max_tokens=40):
                    pass

            task = asyncio.create_task(consume())
            await hold.wait()
            stop = asyncio.create_task(fleet.replicas[0].engine.stop())
            await asyncio.sleep(0.02)
            hold.opened.set()
            await stop
            with pytest.raises(EngineUnavailable,
                               match="no replica serves weights"):
                await task
            assert fleet._migrations == 1
        finally:
            await fleet.stop()

    _run(go())


def test_rollout_happy_path_promotes_whole_fleet():
    async def go():
        fleet = await _fleet(2)
        ctl = _controller(fleet)
        try:
            before = await _text(fleet)
            status = await ctl.start_rollout(V2)
            v2 = status["target_version"]
            assert v2 == checkpoint_version(V2)
            await _idle(ctl)
            assert ctl.state == STATE_COMPLETE
            assert set(ctl.replica_versions().values()) == {v2}
            assert fleet.weights_version == v2
            after = await fleet.generate("pod alpha ", max_tokens=24)
            assert after.weights_version == v2 and after.text != before
            kinds = [e["type"] for e in ctl.events]
            for k in ("drain", "swap", "warmup", "rejoin", "observe",
                      "promote", "rollout_complete"):
                assert k in kinds
            assert ctl.rollouts_completed == 1
            assert fleet._canary_idx is None
            with pytest.raises(RolloutError, match="already serves"):
                await ctl.start_rollout(V2)
            await ctl.start_rollout(V1)
            with pytest.raises(RolloutError, match="already in progress"):
                await ctl.start_rollout(V3)
            await _idle(ctl)
            assert await _text(fleet) == before
        finally:
            await fleet.stop()

    _run(go())


def test_rollout_burn_breach_rolls_back():
    """The canary's TTFT samples breach before the observe window opens
    (the SLO engine survives the swap's restart), so the first gate poll
    rolls back: no race against the window."""
    async def go():
        fleet = await _fleet(2, slo_ttft_ms=10.0)
        ctl = _controller(fleet, observe_secs=LIMIT)
        try:
            before = await _text(fleet)
            for _ in range(30):
                fleet.replicas[1].engine._slo.note(SLO_TTFT, "interactive",
                                                   1.0)
            for _ in range(50):
                fleet.replicas[0].engine._slo.note(SLO_TTFT, "interactive",
                                                   500.0)
            await ctl.start_rollout(V2)
            await _idle(ctl)
            assert ctl.canary_idx == 0
            assert ctl.state == STATE_ROLLED_BACK
            assert ctl.last_rollback_cause == CAUSE_BURN_GATE
            assert ctl.rollbacks == {CAUSE_BURN_GATE: 1}
            assert ctl.last_gate["cause"] == CAUSE_BURN_GATE
            assert set(ctl.replica_versions().values()) == {
                checkpoint_version(V1)}
            assert await _text(fleet) == before
            assert fleet.ledger_snapshot()["conservation"]["balanced"]
            assert fleet._canary_idx is None
        finally:
            await fleet.stop()

    _run(go())


def test_rollout_swap_fail_replica_stays_ejected():
    async def go():
        fleet = await _fleet(2, faults=FaultInjector.from_spec(
            "r0:swap:fail"))
        ctl = _controller(fleet)
        try:
            await ctl.start_rollout(V2)
            await _idle(ctl)
            assert ctl.state == STATE_ROLLED_BACK
            assert ctl.last_rollback_cause == CAUSE_SWAP_FAILED
            assert ctl.last_error.startswith(f"{SwapFailed.__name__}: ")
            rep = fleet.replicas[0]
            assert rep.state == "ejected" and rep.eject_cause == "swap_failed"
            assert rep.engine.params is None
            assert rep.engine.weights_version == ""
            assert rep.engine.checkpoint_path is None
            r = await fleet.generate("pod alpha ", max_tokens=8)
            assert r.weights_version == checkpoint_version(V1)
        finally:
            await fleet.stop()

    _run(go())


def test_rollout_checkpoint_corrupt_restores_prior():
    async def go():
        fleet = await _fleet(2, faults=FaultInjector.from_spec(
            "checkpoint:corrupt"))
        ctl = _controller(fleet)
        try:
            before = await _text(fleet)
            await ctl.start_rollout(V2)
            await _idle(ctl)
            assert ctl.state == STATE_ROLLED_BACK
            assert ctl.last_rollback_cause == CAUSE_CHECKPOINT_CORRUPT
            assert set(ctl.replica_versions().values()) == {
                checkpoint_version(V1)}
            assert all(rep.state == "active" for rep in fleet.replicas)
            assert await _text(fleet) == before
        finally:
            await fleet.stop()

    _run(go())


def test_rollout_abort_rolls_back():
    async def go():
        fleet = await _fleet(2)
        ctl = _controller(fleet, observe_secs=LIMIT)
        try:
            before = await _text(fleet)
            await ctl.start_rollout(V2)
            await _until(ctl, STATE_OBSERVING)
            status = await ctl.abort()
            assert status["state"] == STATE_ROLLED_BACK
            assert ctl.last_rollback_cause == CAUSE_ABORTED
            assert set(ctl.replica_versions().values()) == {
                checkpoint_version(V1)}
            with pytest.raises(RolloutError, match="no rollout"):
                await ctl.abort()
            assert await _text(fleet) == before
        finally:
            await fleet.stop()

    _run(go())


def _hold_swap(eng):
    """Blocks the engine's swap (it runs on a worker thread) until the
    returned event is set."""
    gate = threading.Event()
    real = eng.swap_weights

    def swap_weights(path, **kw):
        gate.wait(LIMIT)
        return real(path, **kw)

    eng.swap_weights = swap_weights
    return gate


async def _inplace_http(client, svc, gate, swapping) -> list:
    """FLEET_SIZE=1: start a rollout over HTTP, ask while the swap holds
    the only engine (a priced 503), then let it finish."""
    out = []
    r = await client.post("/admin/rollout",
                          json={"checkpoint": V2})
    out.append(r.status)
    await _poll(lambda: swapping() or not svc.rollout.active,
                "the rollout never reached its swap")
    assert svc.rollout.active
    r = await client.post("/kubectl-command",
                          json={"query": "list pods while swapping"})
    out.append((r.status, r.headers.get("Retry-After"),
                (await r.json())["detail"].split(":")[0]))
    gate.set()
    await _poll(lambda: not svc.rollout.active,
                "the rollout never finished after its swap")
    status = await (await client.get("/admin/rollout")).json()
    out.append((status["state"], [e["type"] for e in status["events"]],
                next(e for e in status["events"]
                     if e["type"] == "promote")["note"]))
    return out


def test_single_replica_inplace_swap_priced_503_as_the_jax_app():
    """The in-place swap of a lone engine: the request in flight when the
    rollout starts finishes on the old weights within the drain budget,
    a request during the swap gets the JAX app's priced 503, and the
    canary gate is skipped (no stable cohort)."""
    async def go():
        jeng = FakeChunkedEngine(chunk_len=2)
        jgate = _hold_swap(jeng)
        jcfg = JaxServiceConfig(engine="fake", model_name="toy-8m",
                                rate_limit="1000/minute",
                                rollout_observe_secs=0.2)
        async with TestClient(TestServer(jax_create_app(jcfg, jeng))) as c:
            want = await _inplace_http(c, c.app["service"], jgate,
                                       lambda: not jeng.ready)
        eng = _engine()
        gate = _hold_swap(eng)
        cfg = ServiceConfig(torch_device="cpu", rate_limit="1000/minute",
                            rollout_observe_secs=0.2, max_new_tokens=8)
        async with TestClient(TestServer(create_app(cfg, eng))) as c:
            ref = _engine()
            await ref.start()
            base = await _text(ref)
            await ref.stop()
            hold = _Hold(eng)
            inflight = asyncio.create_task(_text(eng))
            await hold.wait()
            task = asyncio.create_task(_inplace_http(
                c, c.app["service"], gate, lambda: not eng.ready))
            await _poll(lambda: c.app["service"].rollout.active,
                        "the rollout never started")
            hold.opened.set()
            got = await task
            assert await inflight == base
            assert eng.weights_version == checkpoint_version(V2)
            assert await _text(eng) != base
        assert got == want
        assert got[1] == (503, "5", "Engine not available")
        assert got[2][0] == STATE_COMPLETE
        assert "single replica" in got[2][2]

    _run(go())


# ------------------------------------------------------------ HTTP surface


ROLLOUT_FAMILIES = ("rollout_state", "rollout_replicas", "rollout_rollbacks")


def _rollout_families(text: str) -> dict:
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name in ROLLOUT_FAMILIES:
            out[fam.name] = (fam.type, fam.documentation, sorted(
                (s.name, tuple(sorted(
                    (k, "*" if k == "version" else v)
                    for k, v in s.labels.items())), s.value)
                for s in fam.samples if not s.name.endswith("_created")))
    return out


def _shape(body) -> list:
    return sorted(body) if isinstance(body, dict) else body


async def _admin_script(client, svc, token: dict) -> list:
    out = []
    r = await client.get("/health")
    body = await r.json()
    out.append((r.status, _shape(body["rollout"]), _shape(body["fleet"]),
                body["rollout"]["state"],
                sorted(body["rollout"]["replica_versions"]),
                len(body["fleet"]["versions"])))
    out.append(_rollout_families(await (await client.get("/metrics")).text()))
    out.append((await client.post("/admin/rollout",
                                  json={"checkpoint": V3})).status)
    out.append((await client.get("/admin/rollout")).status)
    for body in ({}, {"checkpoint": 3}, {"checkpoint": "  "}):
        r = await client.post("/admin/rollout", json=body, headers=token)
        out.append((r.status, (await r.json())["detail"]))
    r = await client.post("/admin/rollout", data="nope", headers=token)
    out.append((r.status, (await r.json())["detail"]))
    r = await client.post("/admin/rollout",
                          json={"checkpoint": V2}, headers=token)
    started = await r.json()
    out.append((r.status, _shape(started), started["state"] in (
        "draining", "swapping", "warming", "observing")))
    r = await client.post("/admin/rollout",
                          json={"checkpoint": V3}, headers=token)
    out.append(r.status)
    await _poll(lambda: not svc.rollout.active, "the rollout never ended")
    r = await client.get("/admin/rollout", headers=token)
    status = await r.json()
    out.append((r.status, _shape(status), status["state"],
                status["last_rollback_cause"], status["rollbacks_total"],
                [e["type"] for e in status["events"]][:3]))
    r = await client.post("/admin/rollout/abort", headers=token)
    out.append((r.status, (await r.json())["detail"]))
    health = await (await client.get("/health")).json()
    out.append((health["rollout"]["state"],
                health["rollout"]["rollbacks_total"],
                len(set(health["rollout"]["replica_versions"].values()))))
    out.append(_rollout_families(await (await client.get("/metrics")).text()))
    return out


def test_admin_rollout_statuses_health_and_families_equal_the_jax_app():
    """The same script against both apps, each over a two-replica fleet
    whose checkpoint loads fail (checkpoint:corrupt): the token gate
    (403), bad bodies (400), 202, 409 while one runs, the rolled-back
    status, 409 on an idle abort, /health's rollout and fleet keys and
    the rollout_* families."""
    async def go():
        outs = []
        inj = JaxFaultInjector.from_spec("checkpoint:corrupt")
        jfleet = JaxEngineFleet(
            [FakeChunkedEngine(chunk_len=2, faults=inj.for_replica(i))
             for i in range(2)])
        jcfg = JaxServiceConfig(engine="fake", model_name="toy-8m",
                                rate_limit="1000/minute",
                                debug_token="s3cret",
                                rollout_observe_secs=0.2)
        async with TestClient(TestServer(jax_create_app(jcfg, jfleet))) \
                as c:
            outs.append(await _admin_script(c, c.app["service"],
                                            {"X-Debug-Token": "s3cret"}))
        pfleet = EngineFleet([_engine(FaultInjector.from_spec(
            "checkpoint:corrupt").for_replica(i)) for i in range(2)])
        pcfg = ServiceConfig(torch_device="cpu", rate_limit="1000/minute",
                             debug_token="s3cret", rollout_observe_secs=0.2)
        async with TestClient(TestServer(create_app(pcfg, pfleet))) as c:
            outs.append(await _admin_script(c, c.app["service"],
                                            {"X-Debug-Token": "s3cret"}))
        assert outs[0] == outs[1]
        assert outs[0][2:4] == [403, 403]
        assert outs[0][-4][2:4] == ("rolled_back", "checkpoint_corrupt")
        assert ('rollout_rollbacks_total', (('cause', 'checkpoint_corrupt'),),
                1.0) in outs[0][-1]["rollout_rollbacks"][2]

    _run(go())


def test_admin_rollout_404_without_swap_support():
    """An engine without swap_weights: /admin/rollout is 404 and /health's
    rollout section null, as in the JAX app."""
    class NoSwap:
        name, ready, device, weights_version = "stub", True, None, "w-1"

        async def start(self):
            pass

        async def stop(self, drain_secs=0.0):
            pass

    async def go():
        outs = []
        for app in (jax_create_app(JaxServiceConfig(engine="fake"),
                                   NoSwap()),
                    create_app(ServiceConfig(torch_device="cpu"),
                               NoSwap())):
            async with TestClient(TestServer(app)) as c:
                a = await c.post("/admin/rollout",
                                 json={"checkpoint": V3})
                b = await c.get("/admin/rollout")
                d = await c.post("/admin/rollout/abort")
                h = await c.get("/health")
                outs.append((a.status, (await a.json())["detail"],
                             b.status, d.status,
                             (await h.json())["rollout"],
                             h.headers.get("X-Model-Version")))
        assert outs[0] == outs[1]
        assert outs[0][0] == 404 and outs[0][-1] == "w-1"

    _run(go())
