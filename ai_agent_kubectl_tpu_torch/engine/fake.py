"""FakeEngine — deterministic engine for tests (``ENGINE=fake``), a copy of
the JAX package's ``engine/fake.py``.

Maps a handful of natural-language patterns to canned kubectl commands and
supports scripted responses/latency/failures so API tests can exercise every
status code without a model, a device or network. Nothing here imports
torch: the fake deployment touches no device.

``FakeChunkedEngine`` (further down) is the decode-PIPELINE fake: a pure-
numpy twin of the batcher's chunked scheduler that serves deterministic
token streams through the SAME packed-chunk contract
(protocol.pack_chunk/unpack_chunk/consume_chunk_row) and a
CHUNK_PIPE_DEPTH-deep speculative pipeline — so depth sweeps, device-side
termination semantics, wasted-step accounting, and disconnect aborts are
testable in milliseconds, without a model engine start.
"""

from __future__ import annotations

import asyncio
import dataclasses
import queue as _queue
import time
import zlib
from collections import deque
from typing import AsyncIterator, Callable, Dict, List, Optional

import numpy as np

from ..obs.ledger import (CLASS_DELIVERED, CLASS_DRAFT_REJECTED,
                          CLASS_HEDGE_LOSER, CLASS_PREEMPTED,
                          CLASS_QUARANTINE_BURN, CLASS_REPLAYED,
                          CLASS_WASTED_MASKED, GoodputLedger)
from ..obs.slo import (SLO_QUEUE_WAIT, SLO_SESSION_TTFT, SLO_TTFT,
                       SloEngine)
from ..obs.steptime import (PHASE_DECODE, PHASE_PREFILL,
                            PHASE_SPEC_VERIFY, StepTimeSentinel,
                            prefill_bucket)
from ..obs.trace import current_trace
from .containment import (CAUSE_SCHEDULER_DEATH, CAUSE_SCHEDULER_ERROR,
                          CAUSE_SLOT_HEALTH, PROBATION_CLEAN_CHUNKS,
                          REASON_HEALTH, REASON_ISOLATED, EngineSupervisor)
from .fallback import extract_query, rule_command  # rules promoted there
from .kv_pool import (BlockPool, HostBlockStore, PoolExhausted,
                      alloc_with_evict, map_prefix, pages_for)
from .radix_cache import RadixCache
from .protocol import (HEALTH_GRAMMAR_DEAD, HEALTH_NONFINITE,
                       EngineOverloaded, EngineResult, EngineUnavailable,
                       GenerationTimeout, RequestExport,
                       RequestQuarantined, consume_chunk_row, pack_chunk,
                       scan_chunk_row, unpack_chunk)
from .qos import (ANON_TENANT, LANE_BACKGROUND, LANE_BATCH, LANE_INTERACTIVE,
                  LANES, BrownoutController, QoSQueue, SessionBudgets,
                  current_qos, lane_rank)


class FakeEngine:
    """Deterministic pattern-matching engine.

    Test hooks:
    - ``scripted``: queue of exact responses returned before rule matching
      (use to inject unsafe output, fences, etc.)
    - ``delay``: per-call artificial latency (exercises the 504 path)
    - ``fail_with``: exception raised on next generate (exercises 500/503)
    """

    name = "fake"
    #: rule-table "weights" never change — one constant version keeps
    #: /health and X-Model-Version uniform across engine kinds.
    weights_version = "fake-rules-0"

    def __init__(self, delay: float = 0.0):
        self.delay = delay
        self.scripted: List[str] = []
        self.fail_with: Optional[BaseException] = None
        self.calls = 0
        self._ready = False

    @property
    def ready(self) -> bool:
        return self._ready

    async def start(self) -> None:
        self._ready = True

    async def stop(self, drain_secs: float = 0.0) -> None:
        self._ready = False

    def _answer(self, prompt: str) -> str:
        return rule_command(extract_query(prompt))

    async def generate(
        self,
        prompt: str,
        *,
        max_tokens: int = 128,
        temperature: float = 0.0,
        timeout: Optional[float] = None,
    ) -> EngineResult:
        if not self._ready:
            raise EngineUnavailable("FakeEngine not started")
        self.calls += 1
        if self.fail_with is not None:
            exc, self.fail_with = self.fail_with, None
            raise exc
        if self.delay:
            if timeout is not None and self.delay >= timeout:
                await asyncio.sleep(timeout)
                raise GenerationTimeout(f"generation exceeded {timeout}s")
            await asyncio.sleep(self.delay)
        text = self.scripted.pop(0) if self.scripted else self._answer(prompt)
        n_completion = max(len(text.split()), 1)
        return EngineResult(
            text=text,
            prompt_tokens=len(prompt.split()),
            completion_tokens=n_completion,
            decode_ms=self.delay * 1000.0,
            ttft_ms=self.delay * 1000.0,
            engine=self.name,
        )

    async def generate_stream(
        self,
        prompt: str,
        *,
        max_tokens: int = 128,
        temperature: float = 0.0,
        timeout: Optional[float] = None,
    ) -> AsyncIterator[str]:
        result = await self.generate(
            prompt, max_tokens=max_tokens, temperature=temperature, timeout=timeout
        )
        for i, word in enumerate(result.text.split(" ")):
            yield word if i == 0 else " " + word


# ---------------------------------------------------------------------------
# FakeChunkedEngine — the decode-pipeline fake
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _FakeReq:
    prompt: str
    max_tokens: int
    deadline: Optional[float]
    out_queue: asyncio.Queue
    cancel: asyncio.Event
    stream: List[int]             # scripted token ids (ends in EOS)
    seed: int = 0                 # per-request sampling seed (recorded for
                                  # replay parity with the real contract)
    suspect_count: int = 0        # quarantine implications (containment)
    suspect: bool = False         # in the standing bisection pool
    resume_ids: Optional[List[int]] = None   # fleet migration import
    export: Optional[RequestExport] = None   # live generated-ids view
    # QoS ring — mirror of the batcher's _Request fields so
    # the fair-share queue, preemption, and brownout are testable on
    # the fake in milliseconds.
    tenant: str = ANON_TENANT
    lane: str = LANE_INTERACTIVE
    t_submit: float = 0.0
    t_enqueue: float = 0.0
    preempt_count: int = 0
    preempt_t0: Optional[float] = None
    # True once the resume prefix's text has reached the client (set by
    # preemption — the fake's pieces are always fully emitted, so
    # suppression is whole-prefix; fleet migrations leave it False and
    # the relay suppresses by length instead).
    resume_emitted: bool = False
    # Request-lifecycle trace (obs/trace.py), captured from the
    # submitting coroutine's context — the fake runs on the event loop,
    # so the same contextvar leg the batcher's async side uses works
    # directly. Lets preempt/resume span links land on the stitched
    # /debug/requests timeline in fake-engine tests too.
    trace: Optional[object] = None
    # Goodput ledger + SLO — mirrors of the batcher's fields:
    # tokens already billed delivered (fleet imports start at the prefix
    # the donor billed), why the next resume re-splice exists ("preempt"
    # bills preempted, else replayed), the first-token stamp that
    # survives preempt/resume, and the fleet-import TTFT exemption.
    ledger_delivered: int = 0
    resume_cause: str = ""
    t_first0: Optional[float] = None
    ttft_exempt: bool = False
    # Block-paged KV pool mirror: the prompt's token ids in
    # the fake's word-token encoding — the radix-chain key. Completion
    # pieces render as "t<id>" words, which encode back to the SAME ids,
    # so a re-sent multi-turn history radix-matches exactly like real
    # tokenization does.
    prompt_ids: List[int] = dataclasses.field(default_factory=list)
    # Grammar-constrained decoding mirror: the resolved
    # grammar profile id (-1 = unconstrained).
    gpid: int = -1
    # Session plane: the namespaced session id (empty =
    # sessionless) and whether admission radix-matched at least one full
    # page — the gate on the turn-N TTFT SLO (only returning warm turns
    # price the two-tier cache).
    session: str = ""
    radix_warm: bool = False


@dataclasses.dataclass
class _FakeSlot:
    req: _FakeReq
    emitted: List[int]            # host-consumed completion tokens
    dev_idx: int                  # device cursor into the stream
    dev_ngen: int                 # device cumulative completion count
    dev_active: bool              # device-resident live mask entry
    last_tok: int                 # device carry token (garbage repeats)
    decode_chunks_inflight: int = 0
    t_first: Optional[float] = None   # first token emitted (TTFT SLO)
    # KV pool mirror: this slot's mapped pool blocks (page order), the
    # admitted prompt ids (radix-chain basis), and the starvation flag
    # (pool exhausted even after eviction -> finish at current length).
    blocks: List[int] = dataclasses.field(default_factory=list)
    pool_ids: List[int] = dataclasses.field(default_factory=list)
    pool_starved: bool = False
    # Grammar mirror: ``gs`` = host-truth FSM state over the
    # CONSUMED stream, ``dev_gs`` = the device twin's speculative state
    # (advanced at dispatch, exactly like dev_idx/dev_ngen), and the
    # count of in-flight chunks a forced-run splice superseded.
    gs: int = 0
    dev_gs: int = 0
    stale_chunks: int = 0


class FakeChunkedEngine:
    """Numpy twin of ``BatchedTorchEngine``'s packed-chunk pipeline.

    The "device" is a scripted next-token stream per request (derived
    deterministically from the prompt unless ``stream_fn`` overrides it);
    dispatching a chunk advances device-side state speculatively exactly
    like the engine's device carry does, packs the result through
    ``protocol.pack_chunk``, and the consume path runs the SAME
    ``consume_chunk_row`` / ``scan_chunk_row`` the real scheduler runs —
    identical termination semantics by construction, which is what makes
    the depth-sweep and done-mask parity suites meaningful.
    """

    name = "fake-chunked"

    def __init__(self, *, batch_size: int = 4, chunk_len: int = 4,
                 chunk_pipe_depth: int = 3, eos_ids=(2,),
                 device_termination: bool = True,
                 slot_health_check: bool = True,
                 quarantine_retry_budget: int = 1,
                 reset_max_per_min: int = 60,
                 max_queue_depth: int = 0,
                 tenant_max_queue: int = 0,
                 lane_weights: Optional[Dict[str, int]] = None,
                 preempt_wait_ms: float = 0.0,
                 preempt_budget: int = 2,
                 slo_interactive_ms: float = 0.0,
                 ledger_enable: bool = True,
                 slo_ttft_ms: float = 0.0,
                 slo_windows: tuple = (300, 3600),
                 slo_objective: float = 0.99,
                 kv_pool: bool = True,
                 kv_pool_page: int = 16,
                 kv_pool_blocks: int = 0,
                 radix_cache: bool = True,
                 radix_lru_blocks: int = 0,
                 host_kv_blocks: int = 0,
                 slo_session_ttft_ms: float = 0.0,
                 session_token_budget: int = 0,
                 ragged_attention: str = "auto",
                 grammar_decode: bool = False,
                 grammar_profile: str = "default",
                 grammar_forced_run_min: int = 4,
                 spec_decode: bool = False,
                 spec_draft_k: int = 4,
                 spec_fake_miss: int = 3,
                 sentinel_enable: bool = True,
                 sentinel_window: int = 256,
                 sentinel_factor: float = 2.0,
                 sentinel_min_samples: int = 16,
                 perf_baselines=None,
                 max_seq_len: int = 256,
                 faults=None,
                 weights_version: str = "fake-0",
                 stream_fn: Optional[Callable[[str], List[int]]] = None):
        if chunk_pipe_depth < 1:
            raise ValueError("chunk_pipe_depth must be >= 1")
        # Weight rollout: the fake's "weights" are the
        # keystream its scripted tokens derive from — _default_stream
        # folds the version in (the default keeps historical streams
        # byte-identical), so a version swap genuinely changes outputs
        # while two same-version replicas stay byte-identical, exactly
        # the property the fleet's version-pinned failover rests on.
        self.weights_version = str(weights_version)
        # A restorable "checkpoint" from the first breath: a rollback
        # must have something to swap back TO even for an engine that
        # never loaded from disk (swap_weights honours the version
        # override, so restoring this sentinel restores version and
        # therefore the exact byte streams).
        self.checkpoint_path: Optional[str] = (
            f"fake:initial:{self.weights_version}")
        self.batch_size = batch_size
        self.chunk_len = chunk_len
        self.chunk_pipe_depth = chunk_pipe_depth
        self.eos_ids = tuple(eos_ids)
        self.device_termination = device_termination
        self.stream_fn = stream_fn or self._default_stream
        self._ready = False
        self._slots: List[Optional[_FakeSlot]] = [None] * batch_size
        self._inflight: List[tuple] = []   # ("chunk", packed, snapshot)
        # QoS ring — same fair-share queue + brownout +
        # preemption policy objects the batcher runs, over the fake's
        # numpy state, so the fairness/preemption matrix is testable in
        # milliseconds. Defaults (unbounded queue, preemption off) keep
        # pre-QoS tests byte-identical.
        self.max_queue_depth = max(0, max_queue_depth)
        self.preempt_wait_ms = max(0.0, preempt_wait_ms)
        self.preempt_budget = max(0, preempt_budget)
        self._brownout = BrownoutController(slo_interactive_ms)
        # Telemetry plane — same goodput ledger + SLO burn
        # engine the batcher runs, over the fake's numpy state, so the
        # conservation invariant is assertable in milliseconds.
        self.ledger = GoodputLedger(enabled=ledger_enable)
        self._slo = SloEngine(
            {SLO_TTFT: slo_ttft_ms, SLO_QUEUE_WAIT: slo_interactive_ms,
             SLO_SESSION_TTFT: slo_session_ttft_ms},
            objective=slo_objective, windows=tuple(slo_windows))
        # Per-session token budgets: charged at delivery,
        # read at classification — both engines share the policy object
        # type so budget semantics can't diverge.
        self._session_budgets = SessionBudgets(session_token_budget)
        # Perf-regression sentinel — the SAME StepTimeSentinel
        # the batcher runs, fed by the same dispatch-interval scheme, so
        # the whole sentinel → trigger → incident chain runs in tier-1:
        # a chunk-path delay fault stretches dispatch intervals exactly
        # like a slow device. The fake's μs-scale steps mean only the
        # self-calibrated envelope is meaningful here; decode samples
        # key by the batch rung (the fake has no KV bucket ladder).
        self._steptime = StepTimeSentinel(
            enabled=sentinel_enable, window=sentinel_window,
            factor=sentinel_factor, min_samples=sentinel_min_samples,
            baselines=perf_baselines)
        self._steptime_pending = None
        self._steptime_consumed = False
        self._preemptions = 0
        self._preempted_tokens = 0
        self._preempt_times: deque = deque(maxlen=512)
        self._preempt_for_lane: Optional[str] = None
        self._queue: QoSQueue = QoSQueue(
            max_depth=self.max_queue_depth,
            tenant_cap=max(0, tenant_max_queue),
            weights=lane_weights,
            on_expire=self._expire_queued)
        self._task: Optional[asyncio.Task] = None
        self._monitor: Optional[asyncio.Task] = None
        #: testing/faults.py injector (decode / scheduler points).
        self.faults = faults
        # Fault containment — the numpy twin of the batcher's
        # inner ring: same supervisor policy object, same health lane in
        # the packed buffer, same quarantine/bisect/reset-replay flow,
        # so the recovery matrix is testable in milliseconds.
        self.slot_health_check = slot_health_check
        self.supervisor = EngineSupervisor(
            retry_budget=quarantine_retry_budget,
            max_resets_per_min=reset_max_per_min)
        self._parked: List[_FakeSlot] = []
        self._probation_clean = 0  # clean chunks consumed this probation
        # Mirrors of the batcher's pipeline counters (stats() parity).
        self._wasted_steps = 0
        self._fetches = 0
        self._chunks_dispatched = 0
        self._chunks_consumed = 0
        self._chunks_pruned = 0
        self._last_n_alive = 0
        # Chunk-event ring (mirror of the batcher's): /debug/chunks and
        # the incident bundles read it, so the evidence chain runs in
        # tier-1 on the fake too.
        self._chunk_log: deque = deque(maxlen=512)
        # Block-paged KV pool mirror: the SAME BlockPool /
        # RadixCache objects and the SAME kv_pool.map_prefix admission
        # path the batcher runs — the fake's KV is fictional (scripted
        # streams), but every alloc/incref/decref/COW/insert/evict is
        # real, so the leak and sharing invariants run in tier-1 on CPU
        # against production refcount code.
        self.kv_pool = bool(kv_pool)
        self.kv_pool_page = max(1, kv_pool_page)
        self.radix_cache = bool(radix_cache)
        self.radix_lru_blocks = max(0, radix_lru_blocks)
        self.max_seq_len = max(chunk_len + 1, max_seq_len)
        self._pool_max_pages = pages_for(self.max_seq_len + chunk_len,
                                         self.kv_pool_page)
        self._pool_n_blocks = (max(0, kv_pool_blocks)
                               or batch_size * self._pool_max_pages)
        # Two-tier KV: host-RAM capacity behind the radix
        # tree; 0 keeps the single-tier world byte-identical.
        self.host_kv_blocks = max(0, host_kv_blocks)
        self._pool: Optional[BlockPool] = None
        self._radix: Optional[RadixCache] = None
        self._host_store: Optional[HostBlockStore] = None
        self._pool_starved = 0
        if self.kv_pool:
            self._pool_reset()
        # Ragged paged attention mirror: the fake has no
        # kernels, so this mirrors the SCHEDULER policy only — "on"
        # defers the admission's first sampled token to the next chunk
        # (the batcher's staged-admission prologue), so the deferral
        # bookkeeping (TTFT catch at consume, budget/EOS-at-first edges,
        # grammar first-pick in-chunk) runs in tier-1. "auto" resolves
        # off here — the real auto gate needs a device.
        if ragged_attention not in ("auto", "on", "off"):
            raise ValueError(
                f"RAGGED_ATTENTION must be auto|on|off, "
                f"got {ragged_attention!r}")
        self.ragged_attention = ragged_attention
        self._use_ragged = (ragged_attention == "on" and self.kv_pool
                            and self.device_termination)
        self._attention_regime = ("ragged" if self._use_ragged
                                  else "paged" if self.kv_pool
                                  else "dense")
        # Admission width of staged (deferred-first-token) admissions
        # since the last dispatch — keys that dispatch's sentinel
        # sample as a ragged prefill phase (mirror of the batcher).
        self._pending_adm_w = 0
        # Grammar-constrained decoding mirror: the SAME
        # GrammarRuntime/TokenFSM compile the batcher runs, built
        # against the ByteTokenizer the fake's grammar streams use
        # (token ids 3..258 = UTF-8 bytes), stepped host-side per
        # scripted token — the tier-1 home of the grammar invariants
        # (never an off-grammar token, dead ends trip the health lane,
        # forced splices keep the pool books balanced).
        if grammar_decode and not device_termination:
            raise ValueError("GRAMMAR_DECODE requires DEVICE_TERMINATION")
        self.grammar_decode = bool(grammar_decode)
        self.grammar_forced_run_min = max(1, grammar_forced_run_min)
        self._grammar = None
        if self.grammar_decode:
            from ..constrain import GrammarRuntime
            from .tokenizer import ByteTokenizer

            tok = ByteTokenizer()
            self._grammar = GrammarRuntime(
                tok, tok.vocab_size, self.eos_ids,
                profile=grammar_profile,
                forced_run_min=self.grammar_forced_run_min)
        self._grammar_forced = 0
        self._grammar_masked = 0
        self._grammar_dead_ends: Dict[str, int] = {}
        self._grammar_ff_splices = 0
        # Speculative decoding mirror: the fake's "draft
        # model" is a deterministic oracle that predicts the scripted
        # stream's next token except at miss indices
        # (``spec_fake_miss`` = every ~Nth draft is wrong; 0 = a
        # perfect draft) — so the accept/reject machinery, the packed
        # v3 lanes, the draft_rejected billing, and the draft:die
        # degradation all run in tier-1 with a dialable acceptance
        # rate, while spec on/off byte-identity stays structural (the
        # emitted tokens are the scripted stream either way, which is
        # exactly the real engine's exact-match-verification
        # guarantee).
        if spec_decode and not device_termination:
            raise ValueError("SPEC_DECODE requires DEVICE_TERMINATION")
        if spec_decode and spec_draft_k < 1:
            raise ValueError(
                f"SPEC_DRAFT_K must be >= 1, got {spec_draft_k}")
        self.spec_decode = bool(spec_decode)
        self.spec_draft_k = int(spec_draft_k)
        self.spec_fake_miss = max(0, int(spec_fake_miss))
        self._use_spec = self.spec_decode
        self._spec_live = self.spec_decode
        self._spec_steps = (max(1, chunk_len // (spec_draft_k + 1))
                            if self.spec_decode else 0)
        self._chunk_tokens = (self._spec_steps * (spec_draft_k + 1)
                              if self.spec_decode else chunk_len)
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_degraded = 0
        # Surface parity: the fake has no mesh, so its draft
        # world is never sharded and never in the gather fallback.
        self._draft_sharded = False
        self._draft_kv_fallback = False

    # ----------------------------------- speculative decoding (mirror)

    def _spec_active(self) -> bool:
        return self._use_spec and self._spec_live

    def _chunk_waste_bound(self) -> int:
        """Mirror of the batcher's: per-in-flight-chunk bound on counted
        steps for the preempt/disconnect waste caps (spec chunks are
        ``_chunk_tokens`` wide, possibly > chunk_len)."""
        if self._use_spec:
            return max(self.chunk_len, self._chunk_tokens)
        return self.chunk_len

    def _spec_miss(self, req: _FakeReq, idx: int) -> bool:
        """Deterministic draft-miss oracle: does the fake's draft model
        mispredict the scripted stream at index ``idx``? Keyed on
        (seed, idx) so replays/preemptions reproduce the same
        acceptance pattern the original run had."""
        if self.spec_fake_miss <= 0:
            return False
        return (idx * 2654435761 + req.seed) % self.spec_fake_miss == 0

    def spec_health(self) -> Optional[dict]:
        """Cheap speculative-decode view for /health (mirror of the
        batcher's)."""
        if not self.spec_decode:
            return None
        drafted = self._spec_drafted
        return {
            "enabled": self.spec_decode,
            "active": self._spec_active(),
            "draft_model": "fake-draft",
            "k": self.spec_draft_k,
            "verify_steps_per_chunk": self._spec_steps,
            "drafted_tokens_total": drafted,
            "accepted_tokens_total": self._spec_accepted,
            "acceptance_ratio": (round(self._spec_accepted / drafted, 4)
                                 if drafted else None),
            "degraded_total": self._spec_degraded,
            "draft_sharded": self._draft_sharded,
            "draft_kv_fallback": self._draft_kv_fallback,
        }

    # ------------------------------------- block-paged KV pool (mirror)

    def _pool_reset(self) -> None:
        """(Re-)build the allocator world — the fake analog of the
        batcher's pool rebuild on a containment reset: every cached
        block's (fictional) KV is invalid, so ownership restarts empty
        and replays re-allocate. Cumulative counters carry over (the
        /metrics delta-mirror must never see totals go backwards)."""
        prev_pool, prev_radix = self._pool, self._radix
        prev_store = self._host_store
        self._pool = BlockPool(self._pool_n_blocks, self.kv_pool_page)
        # Two-tier rebuild: a containment reset condemns the
        # host tier too — its payloads were captured from the poisoned
        # device world — so BOTH tiers restart empty; cumulative demote/
        # onload counters carry like the pool's.
        self._host_store = (HostBlockStore(self.host_kv_blocks)
                            if self.host_kv_blocks > 0 and self.radix_cache
                            else None)
        self._radix = (RadixCache(self._pool,
                                  max_blocks=self.radix_lru_blocks,
                                  host_store=self._host_store,
                                  faults=self.faults)
                       if self.radix_cache else None)
        if prev_pool is not None:
            self._pool.carry_counters(prev_pool)
        if prev_radix is not None and self._radix is not None:
            self._radix.carry_counters(prev_radix)
        if prev_store is not None and self._host_store is not None:
            self._host_store.carry_counters(prev_store)

    @staticmethod
    def _prompt_token_ids(prompt: str) -> List[int]:
        """Word-token encoding with the completion round-trip property:
        the fake's completion pieces are "t<id>" words, which encode
        back to exactly ``id`` — so a multi-turn prompt that re-sends
        prompt + completion text extends the cached chain's ids
        verbatim, and the radix tree matches the whole history (the
        real tokenizer gives the batcher the same property)."""
        out = []
        for w in prompt.split():
            if len(w) > 1 and w[0] == "t" and w[1:].isdigit():
                out.append(int(w[1:]))
            else:
                out.append(
                    1_000_000
                    + zlib.crc32(w.encode("utf-8", "surrogatepass"))
                    % 1_000_000)
        return out

    def _pool_map_prefix(self, ids: List[int], match_all: bool = False):
        """kv_pool.map_prefix — the batcher's exact admission path; the
        COW callback is None because only the accounting is real here
        (the copy itself is device work)."""
        return map_prefix(self._pool, self._radix, ids,
                          match_all=match_all, cow=None)

    def _pool_seat(self, req: _FakeReq, g: int) -> tuple:
        """Allocate one seating's chain: the replay basis is
        prompt + emitted[:-1] (the rows a real device has verifiably
        written). Returns (blocks, pool_ids); raises PoolExhausted with
        refs released."""
        if self._pool is None:
            return [], []
        basis = list(req.prompt_ids)
        gen = list(req.resume_ids or [])[:g]
        chain = basis + (gen[:-1] if gen else [])
        blocks, m = self._pool_map_prefix(chain, match_all=bool(gen))
        # Session SLO gate: a seating that radix-matched at
        # least one full page is a warm re-admission — the only kind the
        # turn-N TTFT SLO judges (onload-served pages count here too:
        # map_prefix's match promoted them before recording the hit).
        req.radix_warm = m >= self.kv_pool_page
        return blocks, basis

    def _pool_ensure_coverage(self, slot: _FakeSlot,
                              chunk_tokens: Optional[int] = None) -> bool:
        """Grow the slot's chain to cover the next chunk's writes
        (mirror of the batcher's dispatch-time growth; starvation
        truncates the request at its current length, never corrupts).
        ``chunk_tokens`` is the dispatching chunk's own token capacity
        (wider under speculative decode)."""
        if self._pool is None or slot.pool_starved:
            return not slot.pool_starved
        target = min(len(slot.pool_ids) + slot.dev_ngen
                     + (chunk_tokens or self.chunk_len),
                     len(slot.pool_ids) + slot.req.max_tokens)
        need = pages_for(target, self.kv_pool_page)
        while len(slot.blocks) < need:
            b = alloc_with_evict(self._pool, self._radix, 1)
            if b is None:
                slot.pool_starved = True
                self._pool_starved += 1
                return False
            slot.blocks.extend(b)
            if slot.req.export is not None:
                slot.req.export.blocks = list(slot.blocks)
        return True

    def _pool_release_slot(self, slot: _FakeSlot,
                           cache_chain: bool = True) -> None:
        """Mirror of the batcher's release: clean finishes insert the
        verified chain (prompt + emitted[:-1]) into the radix tree
        first — completion feeds sharing — then the slot's refs drop
        (shared blocks decay to cached, private ones free)."""
        if self._pool is None or not slot.blocks:
            slot.blocks = []
            return
        if cache_chain and self._radix is not None and slot.pool_ids:
            chain = slot.pool_ids + (slot.emitted[:-1] if slot.emitted
                                     else [])
            chain = chain[:len(slot.blocks) * self.kv_pool_page]
            try:
                self._radix.insert(chain, slot.blocks)
            except Exception:  # pragma: no cover - defensive
                pass
        self._pool.decref(slot.blocks)
        slot.blocks = []

    def kv_pool_health(self) -> Optional[dict]:
        """Cheap pool view for /health (mirror of the batcher's)."""
        if self._pool is None:
            return None
        cached = (self._radix.cached_blocks() if self._radix is not None
                  else ())
        body = self._pool.stats(cached).as_dict()
        body["starved_slots_total"] = self._pool_starved
        body["radix"] = (self._radix.stats() if self._radix is not None
                         else None)
        if self._host_store is not None:
            body["host_tier"] = self._host_store.stats()
        # Surface parity: the regime actually serving decode
        # attention (policy mirror — the fake has no kernels).
        body["attention_regime"] = self._attention_regime
        return body

    # ------------------------------- grammar-constrained decode

    def _grammar_pick(self, gs: int, raw: int) -> Optional[int]:
        """The fake's 'renormalized draw': the scripted token when it is
        grammar-legal from ``gs``, else the deterministic fallback —
        lowest legal non-EOS token (EOS only when it is the sole legal
        move). None = dead end (no legal token at all); the caller
        freezes the slot on HEALTH_GRAMMAR_DEAD exactly like the jitted
        scan."""
        allowed = self._grammar.allowed_np(gs)
        if 0 <= raw < allowed.shape[0] and allowed[raw]:
            return raw
        legal = np.nonzero(allowed)[0]
        if legal.size == 0:
            return None
        non_eos = [int(t) for t in legal if int(t) not in self.eos_ids]
        return non_eos[0] if non_eos else int(legal[0])

    def _grammar_note_dead_end(self, cause: str) -> None:
        self._grammar_dead_ends[cause] = \
            self._grammar_dead_ends.get(cause, 0) + 1

    def _grammar_consume(self, slot: _FakeSlot, new_ids) -> None:
        for t in new_ids:
            slot.gs = self._grammar.advance(slot.gs, int(t))
        self._grammar_masked += len(new_ids)

    def _grammar_fast_forward(self, idx: int, slot: _FakeSlot) -> None:
        """Forced-run fast-forward, numpy twin of the batcher's: splice
        the single-successor chain in one step, mark the superseded
        in-flight chunks stale, re-derive the device cursors at the
        post-run indices (the scripted stream's entries for those
        indices were going to be coerced to exactly these tokens — the
        same singleton-support argument that makes the real splice
        byte-identical to masked step-by-step decode)."""
        if (self._grammar is None or slot.req.gpid < 0
                or slot.pool_starved):
            return
        req = slot.req
        g = len(slot.emitted)
        cap = req.max_tokens - g
        if cap <= 0:
            return
        run, ends_eos, end_gs = self._grammar.forced_run(slot.gs, cap)
        covered = slot.decode_chunks_inflight * (
            self._chunk_tokens if self._spec_active() else self.chunk_len)
        net = len(run) - covered
        if net < self.grammar_forced_run_min and not (
                ends_eos and run and net > 0):
            return
        slot.emitted.extend(run)
        slot.gs = end_gs
        slot.dev_gs = end_gs
        slot.dev_idx = len(slot.emitted)
        slot.dev_ngen = len(slot.emitted)
        slot.last_tok = run[-1]
        if req.export is not None:
            req.export.ids = list(slot.emitted)
        self._grammar_forced += len(run)
        self._grammar_ff_splices += 1
        if slot.decode_chunks_inflight > 0:
            self._bill_waste(min(covered, cap), req)
            slot.stale_chunks += slot.decode_chunks_inflight
        if self._pool is not None:
            self._pool_ensure_coverage(slot)
        req.out_queue.put_nowait(
            ("token", self._piece(run, g)))
        if req.trace is not None:
            req.trace.event(
                f"grammar: forced run of {len(run)} tokens spliced")
        if len(slot.emitted) >= req.max_tokens:
            self._finish(idx, "length")
            return
        if ends_eos:
            self._finish(idx, "stop")
            return
        slot.dev_active = True

    def grammar_health(self) -> Optional[dict]:
        if self._grammar is None:
            return None
        body = dict(self._grammar.health())
        body["forced_tokens_total"] = self._grammar_forced
        body["masked_steps_total"] = self._grammar_masked
        body["fast_forward_splices_total"] = self._grammar_ff_splices
        body["dead_ends_total"] = dict(self._grammar_dead_ends)
        return body

    # ----------------------------------------------------------- streams

    def _default_stream(self, prompt: str) -> List[int]:
        """Deterministic ragged stream: 3-25 tokens drawn from a crc32
        keystream (values kept clear of the EOS ids), EOS-terminated.
        The keystream is keyed on (weights version, prompt) — swapped
        "weights" really do change the transcript — with the default
        version keeping the historical prompt-only keying so every
        pre-rollout byte expectation holds verbatim."""
        key = (prompt if self.weights_version == "fake-0"
               else f"{self.weights_version}|{prompt}")
        h = zlib.crc32(key.encode())
        n = 3 + h % 23
        lo = max(self.eos_ids) + 1
        return [lo + ((h >> (i % 24)) + 7 * i) % 211
                for i in range(n)] + [self.eos_ids[0]]

    def _stream_at(self, stream: List[int], idx: int) -> int:
        """Past-the-end reads repeat EOS — the 'garbage' a real model
        decodes after termination collapses to EOS here, which the legacy
        host scan treats exactly like the batched engine treats its garbage
        (discarded after the terminating token)."""
        return stream[idx] if idx < len(stream) else self.eos_ids[0]

    # ---------------------------------------------------------- lifecycle

    @property
    def ready(self) -> bool:
        return self._ready

    async def start(self) -> None:
        self._ready = True
        self._task = asyncio.create_task(self._loop())
        self._monitor = asyncio.create_task(self._supervise())

    async def stop(self, drain_secs: float = 0.0) -> None:
        if drain_secs > 0:
            deadline = time.monotonic() + drain_secs
            self._ready = False     # no new admissions
            while time.monotonic() < deadline:
                if not (self._queue or self._inflight or self._parked
                        or any(self._slots)):
                    break
                await asyncio.sleep(0.01)
        self._ready = False
        for task_attr in ("_task", "_monitor"):
            task = getattr(self, task_attr)
            if task is not None:
                task.cancel()
                try:
                    await task
                except BaseException:
                    # CancelledError normally; a SchedulerKilled drill
                    # corpse surfaces here too — both are expected.
                    pass
                setattr(self, task_attr, None)
        for slot in self._slots:
            if slot is not None:
                self._pool_release_slot(slot, cache_chain=False)
                slot.req.out_queue.put_nowait(
                    ("error", EngineUnavailable("engine stopped")))
        self._slots = [None] * self.batch_size
        for slot in self._parked:
            slot.req.out_queue.put_nowait(
                ("error", EngineUnavailable("engine stopped")))
        self._parked.clear()
        for req in self._queue.drain():
            req.out_queue.put_nowait(
                ("error", EngineUnavailable("engine stopped")))
        self._inflight.clear()

    def swap_weights(self, path: str, *, version: Optional[str] = None
                     ) -> str:
        """Weight-swap mirror of the batcher's: requires a
        stopped (drained) engine, is atomic under the
        ``checkpoint:corrupt`` drill (the prior version stays armed),
        dies attributably under ``swap:fail``, and rebuilds the KV-pool
        world exactly like a containment reset — so the rollout state
        machine, version-pinned failover, and rollback books are all
        testable in tier-1 milliseconds."""
        from .rollout import (CheckpointCorrupt, RolloutError, SwapFailed,
                              checkpoint_version)

        if self._ready:
            raise RolloutError(
                "swap_weights requires a stopped (drained) engine")
        version = version or checkpoint_version(path)
        if self.faults is not None \
                and hasattr(self.faults, "checkpoint_corrupt") \
                and self.faults.checkpoint_corrupt():
            raise CheckpointCorrupt(
                f"checkpoint {path!r} failed integrity validation "
                f"(injected checkpoint:corrupt drill)")
        if self.faults is not None \
                and hasattr(self.faults, "swap_fail") \
                and self.faults.swap_fail():
            # Mid-swap death: the old "weights" are gone — serving this
            # replica again without a successful re-swap would serve
            # unknown bytes, so it stays down (cause swap_failed) and
            # both stamps clear together (batcher mirror).
            self.weights_version = ""
            self.checkpoint_path = None
            raise SwapFailed(
                "injected swap:fail — replica died mid-swap")
        self.weights_version = version
        self.checkpoint_path = str(path)
        if self._pool is not None:
            # New weights invalidate every cached block's (fictional)
            # KV — the ownership world restarts empty, like a reset.
            self._pool_reset()
        return version

    def set_reset_listener(self, fn) -> None:
        """Wire engine resets to the service layer (the breaker) —
        same hook the batcher exposes."""
        self.supervisor.on_reset = fn

    def stats(self) -> dict:
        return {
            "batch_occupancy": sum(s is not None for s in self._slots),
            "queue_depth": self._queue.qsize(),
            "qos": dict(self._queue.stats(),
                        lane_occupancy=self.lane_occupancy(),
                        preemptions=self._preemptions,
                        preempted_tokens=self._preempted_tokens,
                        brownout_level=self._brownout.level,
                        brownout_transitions=self._brownout.transitions,
                        lane_shares={
                            k: round(v, 4)
                            for k, v in self._brownout.shares.items()}),
            "pipe_depth": self.chunk_pipe_depth,
            "pipe_inflight": len(self._inflight),
            "device_active_slots": self._last_n_alive,
            "device_termination": self.device_termination,
            "wasted_decode_steps": self._wasted_steps,
            "chunks_dispatched": self._chunks_dispatched,
            "chunks_consumed": self._chunks_consumed,
            "chunks_pruned": self._chunks_pruned,
            "fetches": self._fetches,
            "containment": dict(self.supervisor.stats(),
                                parked=len(self._parked),
                                slot_health_check=self.slot_health_check),
            "kv_pool": self.kv_pool_health(),
            "ledger": self.ledger.snapshot(),
            "slo": self._slo.snapshot(),
            "grammar": self.grammar_health(),
            "spec": self.spec_health(),
            "steptime": self._steptime.snapshot(),
        }

    def steptime_health(self) -> dict:
        """Cheap step-time sentinel view (mirror of the batcher's)."""
        return self._steptime.snapshot()

    # ------------------------------------------ telemetry plane

    def _bill_waste(self, n: int, req: Optional[_FakeReq]) -> None:
        """Mirror of the batcher's: one call site bills the legacy
        wasted-steps counter AND the ledger's wasted_masked class."""
        if n <= 0:
            return
        self._wasted_steps += n
        lane = getattr(req, "lane", LANE_INTERACTIVE) if req is not None \
            else LANE_INTERACTIVE
        tenant = getattr(req, "tenant", None) if req is not None else None
        self.ledger.record(CLASS_WASTED_MASKED, n, lane=lane, tenant=tenant)

    def slo_health(self) -> dict:
        return self._slo.snapshot()

    def ledger_snapshot(self) -> dict:
        snap = self.ledger.snapshot()
        snap["tenants"] = self.ledger.tenant_snapshot()
        snap["conservation"] = self.ledger.conservation()
        return snap

    # ---------------------------------------------------------- scheduler

    async def _loop(self) -> None:
        while True:
            try:
                progressed = self._tick()
            except Exception as e:
                # A poisoned step, not a dead engine: quarantine/bisect +
                # reset-and-replay, exactly like the batcher's widened
                # scheduler except. SchedulerKilled (a BaseException)
                # deliberately escapes — the task dies and _supervise
                # restarts it.
                self._contain_poisoned_step(CAUSE_SCHEDULER_ERROR, error=e)
                progressed = True
            await asyncio.sleep(0 if progressed else 0.001)

    async def _supervise(self) -> None:
        """Scheduler-death recovery (the async twin of the batcher's
        _supervise_scheduler thread): when the loop task dies of an
        uncatchable fault, reset, replay survivors, restart the loop —
        queued requests sit untouched in self._queue throughout."""
        while True:
            await asyncio.sleep(0.005)
            task = self._task
            if task is None or not task.done() or not self._ready:
                continue
            task.exception()   # retrieve (the corpse is expected)
            survivors = [s for s in self._slots if s is not None]
            self._slots = [None] * self.batch_size
            self._inflight.clear()
            if self._pool is not None:
                self._pool_reset()
                for s in survivors + self._parked:
                    s.blocks = []
                    s.pool_starved = False
            if not self.supervisor.allow_reset():
                self._ready = False
                err = EngineUnavailable(
                    "scheduler dead; engine reset budget exhausted")
                for slot in survivors + self._parked:
                    slot.req.out_queue.put_nowait(("error", err))
                self._parked.clear()
                for req in self._queue.drain():
                    req.out_queue.put_nowait(("error", err))
                return
            self.supervisor.note_reset(CAUSE_SCHEDULER_DEATH)
            for slot in survivors:
                self._replay_slot(slot)
            self._task = asyncio.create_task(self._loop())

    def _tick(self) -> bool:
        if self.faults is not None:
            self.faults.check_scheduler_die()
        self._sweep()
        if (self._parked and not self._inflight
                and all(s is None for s in self._slots)):
            # Probe group drained clean: unpark the held half (they
            # resume from their generated-so-far prefixes). Long probes
            # are exonerated earlier, in _consume_oldest.
            self._unpark_parked()
            return True
        # QoS ring: brownout evaluation + preemptive decode (mirror of
        # the batcher's worker-loop placement — the freed slot is handed
        # to the starved lane by the _admit_pending call right below).
        self._brownout.maybe_eval(
            burn_fn=lambda: self._slo.fast_burn(
                SLO_QUEUE_WAIT, LANE_INTERACTIVE))
        self._maybe_preempt()
        self._admit_pending()
        self._prune_dead_chunks()
        n_active = sum(s is not None for s in self._slots)
        if n_active and len(self._inflight) < self.chunk_pipe_depth:
            self._dispatch_chunk()
            return True
        if self._inflight:
            self._consume_oldest()
            return True
        return False

    def _sweep(self) -> None:
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if slot.req.cancel.is_set():
                self._finish(i, "abort", wasted_inflight=True)
            elif (slot.req.deadline is not None
                  and time.monotonic() > slot.req.deadline):
                self._finish(i, "timeout",
                             error=GenerationTimeout("generation timeout"),
                             wasted_inflight=True)
            elif slot.pool_starved and slot.decode_chunks_inflight == 0:
                self._finish(i, "length")

    # --------------------------------------------- QoS ring

    def lane_occupancy(self) -> Dict[str, int]:
        """Slots held per lane (mirror of the batcher's — the fleet's
        lane-aware router reads this)."""
        counts = {lane: 0 for lane in LANES}
        for s in self._slots:
            if s is not None:
                lane = getattr(s.req, "lane", LANE_INTERACTIVE)
                counts[lane if lane in LANES else LANE_INTERACTIVE] += 1
        return counts

    def _capped_lanes(self, counts: Dict[str, int]) -> tuple:
        capped = []
        for lane in (LANE_BACKGROUND, LANE_BATCH):
            cap = self._brownout.lane_cap(lane, self.batch_size)
            if cap < self.batch_size and counts.get(lane, 0) >= cap:
                capped.append(lane)
        return tuple(capped)

    def _expire_queued(self, req: _FakeReq) -> None:
        req.out_queue.put_nowait(
            ("error", GenerationTimeout("deadline expired while queued")))

    def _credit_preempt_wait(self, req: _FakeReq) -> None:
        t0 = req.preempt_t0
        if t0 is None:
            return
        req.preempt_t0 = None
        if req.deadline is not None:
            req.deadline += time.monotonic() - t0

    def _maybe_preempt(self) -> bool:
        """Mirror of the batcher's preemptive decode over the fake's
        scripted streams: export the cheapest lower-lane victim, free
        its slot for the starved lane, replay bit-identically later
        (the scripted stream IS the seeded-sampling determinism)."""
        if self.preempt_wait_ms <= 0 or self._parked:
            return False
        if any(s is None for s in self._slots):
            return False
        now = time.monotonic()
        lane = self._queue.starved_lane(
            now, self.preempt_wait_ms / 1000.0,
            exclude=self._capped_lanes(self.lane_occupancy()))
        if lane is None:
            return False
        rank = lane_rank(lane)
        victims = [
            (i, s) for i, s in enumerate(self._slots)
            if s is not None
            and lane_rank(getattr(s.req, "lane", LANE_INTERACTIVE)) < rank
            and s.req.preempt_count < self.preempt_budget
        ]
        if not victims:
            return False
        idx, _ = min(victims, key=lambda t: (lane_rank(t[1].req.lane),
                                             len(t[1].emitted)))
        self._preempt_slot(idx, lane)
        self._preempt_for_lane = lane
        return True

    def _preempt_slot(self, idx: int, for_lane: str) -> None:
        slot = self._slots[idx]
        self._slots[idx] = None
        req = slot.req
        req.preempt_count += 1
        req.preempt_t0 = time.monotonic()
        req.resume_ids = list(slot.emitted)
        req.resume_emitted = True    # fake pieces are always fully emitted
        # Mirror the batcher: no cause marker when nothing was generated
        # (the fresh re-admission path never consumes it).
        req.resume_cause = "preempt" if slot.emitted else ""
        if req.export is not None:
            req.export.ids = list(slot.emitted)
        if self.device_termination and slot.decode_chunks_inflight > 0:
            remaining = max(0, req.max_tokens - len(slot.emitted))
            self._bill_waste(min(
                slot.decode_chunks_inflight * self._chunk_waste_bound(),
                remaining), req)
        self._preemptions += 1
        self._preempted_tokens += len(slot.emitted)
        self._preempt_times.append(req.preempt_t0)
        if req.trace is not None:
            req.trace.link("preempted", from_slot=idx,
                           tokens=len(slot.emitted), for_lane=for_lane,
                           lane=req.lane)
        # Pool mirror: cache the victim's chain so its resume re-maps
        # shared blocks instead of re-prefilling.
        self._pool_release_slot(slot, cache_chain=True)
        self._queue.requeue_head(req)

    def _inject_flood(self, n: int) -> None:
        """tenant:flood:<n> drill — synthetic background-tenant burst
        (mirror of the batcher's)."""
        from ..testing.faults import FLOOD_LANE, FLOOD_TENANT

        now = time.monotonic()
        for i in range(n):
            prompt = f"tenant flood drill {i}"
            req = _FakeReq(
                prompt=prompt,
                prompt_ids=self._prompt_token_ids(prompt),
                max_tokens=32,
                deadline=now + 30.0,
                out_queue=asyncio.Queue(),
                cancel=asyncio.Event(),
                stream=list(self.stream_fn(prompt)),
                seed=i,
                tenant=FLOOD_TENANT,
                lane=FLOOD_LANE,
                t_submit=now,
            )
            try:
                self._queue.put(req)
            except EngineOverloaded:
                break

    def qos_health(self) -> dict:
        now = time.monotonic()
        return {
            "lanes": self._queue.lane_depths(),
            "brownout_level": self._brownout.level,
            "lane_shares": {k: round(v, 4)
                            for k, v in self._brownout.shares.items()},
            "preemptions_total": self._preemptions,
            "preemptions_last_60s": sum(
                1 for t in list(self._preempt_times) if t >= now - 60.0),
            "queue_expired_total": self._queue.expired_total,
            "queue_displaced_total": self._queue.displaced_total,
            "session_budgets": self._session_budgets.snapshot(),
        }

    def _admit_pending(self) -> None:
        if self._parked:
            # Bisection probation (mirror of the batcher): no new
            # admissions may join a suspect batch; queued requests wait
            # and are never dropped.
            return
        counts = self.lane_occupancy()
        prefer, self._preempt_for_lane = self._preempt_for_lane, None
        while None in self._slots:
            try:
                req = self._queue.get_nowait(
                    exclude_lanes=self._capped_lanes(counts),
                    min_lane=prefer)
            except _queue.Empty:
                if prefer is None:
                    break
                prefer = None
                continue
            prefer = None
            if req.cancel.is_set():
                continue
            self._credit_preempt_wait(req)
            t_adm0 = time.monotonic()
            lane = req.lane if req.lane in LANES else LANE_INTERACTIVE
            counts[lane] += 1
            if req.t_submit:
                wait_ms = (time.monotonic() - req.t_submit) * 1000.0
                self._brownout.note_queue_wait(lane, wait_ms)
                # Mirror the batcher: resumes (preemption returns, fleet
                # imports) are NOT fresh queue waits — their wall since
                # t_submit includes time spent decoding.
                if not req.resume_ids:
                    self._slo.note(SLO_QUEUE_WAIT, lane, wait_ms)
            i = self._slots.index(None)
            if req.resume_ids:
                # Cross-replica import (fleet migration) or preemption
                # resume: re-seat from the portable generated prefix —
                # device cursors resume at g. The prefix TEXT is
                # re-emitted only for migrations (the fleet relay
                # suppresses it); a preempted victim's client already
                # has it (resume_emitted). Pool mirror: the replay basis
                # (prompt + prefix[:-1]) radix-matches the chain the
                # preemption cached, so a resume re-MAPS shared blocks
                # instead of re-prefilling (kv_pool.map_prefix).
                g = len(req.resume_ids)
                try:
                    blocks, basis = self._pool_seat(req, g)
                except PoolExhausted:
                    req.out_queue.put_nowait(("error", EngineUnavailable(
                        "admission failed: kv pool exhausted")))
                    continue
                gs_r = 0
                if self._grammar is not None and req.gpid >= 0:
                    # Re-derive the FSM state from the imported prefix
                    # (mirror of the batcher's replay re-arm).
                    gs_r = self._grammar.run(req.gpid, req.resume_ids)
                slot = _FakeSlot(
                    req=req, emitted=list(req.resume_ids), dev_idx=g,
                    dev_ngen=g,
                    dev_active=(g < req.max_tokens
                                if self.device_termination else True),
                    last_tok=req.resume_ids[-1],
                    t_first=time.monotonic(),
                    blocks=blocks, pool_ids=basis,
                    gs=gs_r, dev_gs=gs_r)
                if req.export is not None and blocks:
                    req.export.blocks = list(blocks)
                if not req.resume_emitted:
                    req.out_queue.put_nowait(
                        ("token", self._piece(slot.emitted, 0)))
                req.resume_emitted = True
                if req.export is not None:
                    req.export.ids = list(slot.emitted)
                # Ledger: the resume re-derives g tokens (mirror of the
                # batcher's _replay_slot billing — preemption resumes
                # bill preempted, migration imports bill replayed). A
                # budget-spent import never re-splices, so it bills
                # nothing — same as the batcher's early finish.
                cls = (CLASS_PREEMPTED if req.resume_cause == "preempt"
                       else CLASS_REPLAYED)
                req.resume_cause = ""
                if g < req.max_tokens:
                    self.ledger.record(cls, g, lane=lane,
                                       tenant=req.tenant)
                    if req.trace is not None:
                        req.trace.link("resumed", slot=i, tokens=g)
                self._slots[i] = slot
                if g >= req.max_tokens:
                    self._finish(i, "length")
                continue
            # Admission "prefill": the stream's first token is emitted
            # immediately (the batcher pipelines it as a "first" entry;
            # collapsing that here keeps the fake synchronous without
            # changing chunk semantics). Grammar mirror: the first
            # token is the masked pick from the START state — or, when
            # the START state's forced chain clears the net-win bar
            # (it always does on a fresh slot: nothing is in flight),
            # the whole run splices at admission exactly like the
            # batcher rides it on the prompt prefill.
            grammar_on = self._grammar is not None and req.gpid >= 0
            run: List[int] = []
            ends_eos = False
            gs0 = -1
            if grammar_on:
                gs0 = self._grammar.start_state(req.gpid)
                run, ends_eos, gs_end = self._grammar.forced_run(
                    gs0, req.max_tokens)
                if len(run) >= self.grammar_forced_run_min or (
                        ends_eos and run):
                    gs0 = gs_end
                else:
                    run, ends_eos = [], False
            if run:
                emitted0 = list(run)
            elif self._use_ragged:
                # Ragged admission mirror: the first SAMPLED
                # token is NOT picked here — the next chunk's first row
                # emits stream[0] (through the same in-chunk grammar
                # pick / EOS / budget folds every decode step runs), so
                # the slot seats with an empty transcript and TTFT rides
                # the consume path's first-token catch.
                emitted0 = []
            else:
                first = req.stream[0]
                if grammar_on:
                    picked = self._grammar_pick(gs0, first)
                    if picked is None:   # structurally unreachable
                        self._grammar_note_dead_end("admission")
                        req.out_queue.put_nowait(
                            ("error", EngineUnavailable(
                                "grammar dead end at admission")))
                        continue
                    first = picked
                if first in self.eos_ids:
                    req.out_queue.put_nowait(
                        ("done", self._result(req, [], "stop")))
                    continue
                emitted0 = [first]
                if grammar_on:
                    gs0 = self._grammar.advance(gs0, first)
                    self._grammar_masked += 1
            try:
                blocks, basis = self._pool_seat(req, 0)
            except PoolExhausted:
                req.out_queue.put_nowait(("error", EngineUnavailable(
                    "admission failed: kv pool exhausted")))
                continue
            slot = _FakeSlot(req=req, emitted=emitted0,
                             dev_idx=len(emitted0),
                             dev_ngen=len(emitted0),
                             dev_active=req.max_tokens > len(emitted0),
                             last_tok=emitted0[-1] if emitted0 else 0,
                             t_first=(time.monotonic() if emitted0
                                      else None),
                             blocks=blocks, pool_ids=basis,
                             gs=gs0, dev_gs=gs0)
            if req.export is not None and blocks:
                req.export.blocks = list(blocks)
            if req.t_first0 is None:
                req.t_first0 = slot.t_first
            if not self.device_termination:
                slot.dev_active = True
            self._slots[i] = slot
            if self._use_ragged:
                # Ragged admission: the prefill "program" rides the next
                # chunk — that dispatch's sentinel sample is a PREFILL
                # phase keyed by the admission width, not a decode
                # sample (mirror of the batcher's mixed-chunk keying).
                self._pending_adm_w = max(
                    self._pending_adm_w,
                    prefill_bucket(len(req.prompt_ids)))
            else:
                # Sentinel prefill sample (mirror of the batcher's
                # admission→first-token measurement; the fake's
                # "prefill" is host work, μs-scale — the self-calibrated
                # envelope makes it a meaningful regression signal
                # regardless).
                self._steptime.note(
                    PHASE_PREFILL, prefill_bucket(len(req.prompt_ids)),
                    time.monotonic() - t_adm0,
                    tokens=len(req.prompt_ids))
            if req.export is not None:
                req.export.ids = list(slot.emitted)
            if emitted0:
                req.out_queue.put_nowait(
                    ("token", self._piece(emitted0, 0)))
            if run:
                self._grammar_forced += len(run)
                self._grammar_ff_splices += 1
                if self._pool is not None:
                    self._pool_ensure_coverage(slot)
            if len(slot.emitted) >= req.max_tokens:
                self._finish(i, "length")
            elif run and ends_eos:
                self._finish(i, "stop")

    def _dispatch_chunk(self) -> None:
        """The 'device': advance every live slot's stream cursor by up to
        chunk_len steps, folding EOS/budget termination into the live
        mask exactly like the jitted scan does, and pack one buffer.
        decode:nan corruption mirrors the jitted detection: the corrupt
        slot's health bit sets, its row repeats the carry token, and
        (device termination) it freezes before counting anything.

        Speculative decode: a spec chunk runs
        ``_spec_steps`` draft/verify windows instead — each window
        emits 1..k+1 tokens depending on where the deterministic
        draft-miss oracle first disagrees with the scripted stream —
        and packs the wider row plus the v3 drafted/accepted lanes.
        The EMITTED tokens are the scripted stream either way (the
        exact-match-verification guarantee), so spec on/off transcripts
        are byte-identical by construction here too."""
        if self.faults is not None:
            # Chunk-path fault seam (mirror of the batcher's): a delay/
            # hang here stalls the dispatch loop exactly like a slow
            # device dispatch — the step-time sentinel drill's
            # injection point.
            self.faults.check("chunk")
        if (self._spec_active() and self.faults is not None
                and self.faults.draft_die()):
            # draft:die — the draft engine is gone; degrade to plain
            # decode mid-stream without failing anything (mirror of
            # the batcher).
            self._spec_live = False
            self._spec_degraded += 1
        spec = self._spec_active() and self.device_termination
        # Step-time sentinel sample (mirror of the batcher's gating): a
        # dispatch interval counts only when a consume happened since
        # the previous dispatch AND the pipe never emptied.
        now = time.monotonic()
        pend = self._steptime_pending
        if pend is not None and self._steptime_consumed and self._inflight:
            t0, phase0, bucket0, (steps0, toks0) = pend
            self._steptime.note(phase0, bucket0, now - t0,
                                steps=steps0, tokens=toks0, now=now)
        n_live = sum(s is not None for s in self._slots)
        ct0 = self._chunk_tokens if spec else self.chunk_len
        # Ragged admission: a chunk carrying a staged
        # admission is a PREFILL-phase sample keyed by the admission
        # width, so mixed chunks never pollute the decode digests
        # (mirror of the batcher's keying).
        adm_w, self._pending_adm_w = self._pending_adm_w, 0
        self._steptime_pending = (
            now,
            PHASE_PREFILL if adm_w else (
                PHASE_SPEC_VERIFY if spec else PHASE_DECODE),
            adm_w if adm_w else self.batch_size, (ct0, ct0 * n_live))
        self._steptime_consumed = False
        N = self.batch_size
        C = self._chunk_tokens if spec else self.chunk_len
        toks = np.zeros((N, C), np.int32)
        done = np.zeros((N,), bool)
        lengths = np.zeros((N,), np.int32)
        health = np.zeros((N,), np.int32)
        drafted = np.zeros((N,), np.int32)
        accepted = np.zeros((N,), np.int32)
        corrupt: set = set()
        if self.faults is not None:
            corrupt = set(self.faults.decode_nan_slots(
                [s.req.prompt if s is not None else None
                 for s in self._slots]))
        snapshot: List[Optional[_FakeReq]] = [None] * N
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if (self._pool is not None
                    and not self._pool_ensure_coverage(slot, C)):
                # Pool starved even after radix eviction: the slot is
                # excluded from this chunk and finishes at its current
                # length once its in-flight chunks drain (mirror of the
                # batcher's exhausted-slot handling).
                continue
            snapshot[i] = slot.req
            slot.decode_chunks_inflight += 1
            live = slot.dev_active
            if i in corrupt and self.slot_health_check and (
                    live or not self.device_termination):
                health[i] = HEALTH_NONFINITE
                if self.device_termination:
                    # Frozen at detection: carry token repeats, nothing
                    # is counted — live_lengths stay at the pre-chunk
                    # value, like the jitted scan's in-chunk freeze.
                    toks[i, :] = slot.last_tok
                    done[i] = True
                    slot.dev_active = False
                    lengths[i] = slot.dev_ngen
                    continue
            grammar_on = (self._grammar is not None
                          and slot.req.gpid >= 0)
            if spec:
                self._spec_slot_rows(i, slot, toks, done, lengths,
                                     health, drafted, accepted,
                                     grammar_on, live)
                continue
            for step in range(C):
                if self.device_termination:
                    if not live:
                        toks[i, step] = slot.last_tok
                        continue
                    nxt = self._stream_at(slot.req.stream, slot.dev_idx)
                    if grammar_on:
                        # Grammar mirror: the scripted token passes
                        # only if legal from the device FSM state; an
                        # illegal one renormalizes to the deterministic
                        # fallback; NO legal token = dead end — freeze
                        # on the grammar health bit exactly like the
                        # jitted scan (nothing from this state is ever
                        # emitted).
                        picked = self._grammar_pick(slot.dev_gs, nxt)
                        if picked is None:
                            health[i] |= HEALTH_GRAMMAR_DEAD
                            toks[i, step:] = slot.last_tok
                            live = False
                            break
                        nxt = picked
                    toks[i, step] = nxt
                    slot.last_tok = nxt
                    if nxt in self.eos_ids:
                        live = False
                        continue
                    if grammar_on:
                        slot.dev_gs = self._grammar.advance(
                            slot.dev_gs, nxt)
                    slot.dev_idx += 1
                    slot.dev_ngen += 1
                    if slot.dev_ngen >= slot.req.max_tokens:
                        live = False
                else:
                    # Legacy: the device decodes the full chunk blind.
                    nxt = self._stream_at(slot.req.stream, slot.dev_idx)
                    toks[i, step] = nxt
                    slot.last_tok = nxt
                    slot.dev_idx += 1
                    slot.dev_ngen += 1
            if self.device_termination:
                done[i] = not live
                slot.dev_active = live
            lengths[i] = slot.dev_ngen
        n_alive = sum(
            1 for s in self._slots if s is not None and s.dev_active
        ) if self.device_termination else sum(
            s is not None for s in self._slots)
        packed = pack_chunk(toks, done, lengths, n_alive, health=health,
                            drafted=drafted if spec else None,
                            accepted=accepted if spec else None)
        self._inflight.append(("chunk", packed, snapshot, C, spec))
        self._chunks_dispatched += 1
        self._chunk_log.append({
            "t": time.time(), "event": "dispatch",
            "slots": sum(s is not None for s in snapshot),
            "pipe": len(self._inflight),
        })

    def _spec_slot_rows(self, i: int, slot: _FakeSlot, toks, done,
                        lengths, health, drafted, accepted,
                        grammar_on: bool, live: bool) -> None:
        """One slot's speculative chunk: ``_spec_steps`` windows of
        (carry + k drafts), each accepting tokens until the draft-miss
        oracle first disagrees — the same per-position termination /
        grammar / EOS fold as the plain loop, writing compacted rows
        through a cursor exactly like the jitted spec scan."""
        K = self.spec_draft_k
        toks[i, :] = slot.last_tok      # garbage-by-contract fill
        cur = 0
        for _it in range(self._spec_steps):
            if not live:
                break
            drafted[i] += K
            idx0 = slot.dev_idx
            for j in range(K + 1):
                if j >= 1 and self._spec_miss(slot.req, idx0 + j - 1):
                    # Draft j-1 mispredicted: this window's later
                    # positions were conditioned on the wrong token —
                    # dead for the window, re-drafted next one.
                    break
                nxt = self._stream_at(slot.req.stream, slot.dev_idx)
                if grammar_on:
                    picked = self._grammar_pick(slot.dev_gs, nxt)
                    if picked is None:
                        health[i] |= HEALTH_GRAMMAR_DEAD
                        live = False
                        break
                    nxt = picked
                toks[i, cur] = nxt
                slot.last_tok = nxt
                if nxt in self.eos_ids:
                    live = False
                    break
                if grammar_on:
                    slot.dev_gs = self._grammar.advance(slot.dev_gs,
                                                        nxt)
                slot.dev_idx += 1
                slot.dev_ngen += 1
                cur += 1
                if j >= 1:
                    accepted[i] += 1
                if slot.dev_ngen >= slot.req.max_tokens:
                    live = False
                    break
        done[i] = not live
        slot.dev_active = live
        lengths[i] = slot.dev_ngen

    def _prune_dead_chunks(self) -> None:
        while self._inflight:
            snapshot = self._inflight[0][2]
            live = any(
                snap is not None and self._slots[i] is not None
                and self._slots[i].req is snap
                for i, snap in enumerate(snapshot)
            )
            if live:
                return
            entry = self._inflight.pop(0)
            if not self.device_termination:
                # Mirror the batcher: pruned legacy chunks executed a full
                # chunk of garbage per dispatched slot.
                for snap in entry[2]:
                    if snap is not None:
                        self._bill_waste(self.chunk_len, snap)
            self._chunks_pruned += 1

    def _consume_oldest(self) -> None:
        _, packed, snapshot, ct, is_spec = self._inflight.pop(0)
        if self.faults is not None:
            # decode:poison_step — step-wide fault from the fetch, routed
            # into the bisecting containment by the loop's except.
            self.faults.poison_fetch(
                [r.prompt if r is not None else None for r in snapshot])
        self._fetches += 1          # the single fetch per chunk
        res = unpack_chunk(packed, self.batch_size, ct, spec=is_spec)
        self._chunks_consumed += 1
        self._steptime_consumed = True   # arms the next dispatch's sample
        self._chunk_log.append({
            "t": time.time(), "event": "consume", "n_alive": res.n_alive,
            "pipe": len(self._inflight),
        })
        self._last_n_alive = res.n_alive
        # Speculative accounting (mirror of the batcher): acceptance
        # counters + the draft_rejected waste class, billed BEFORE the
        # health-trip early return so the books balance under drills.
        if is_spec and res.drafted is not None:
            for i in range(self.batch_size):
                req_i = snapshot[i]
                if req_i is None:
                    continue
                d, a = int(res.drafted[i]), int(res.accepted[i])
                if d <= 0:
                    continue
                self._spec_drafted += d
                self._spec_accepted += a
                if d > a:
                    self.ledger.record(
                        CLASS_DRAFT_REJECTED, d - a,
                        lane=getattr(req_i, "lane", LANE_INTERACTIVE),
                        tenant=req_i.tenant)
        # Slot-health quarantine: nothing from a poisoned chunk is
        # emitted; replay regenerates the innocents bit-identically.
        tripped = [
            i for i in range(self.batch_size)
            if int(res.health[i]) and snapshot[i] is not None
            and self._slots[i] is not None
            and self._slots[i].req is snapshot[i]
        ]
        if tripped:
            self.supervisor.note_health_trips(len(tripped))
            for i in tripped:
                if int(res.health[i]) & HEALTH_GRAMMAR_DEAD:
                    self._grammar_note_dead_end("decode")
            self._contain_poisoned_step(
                CAUSE_SLOT_HEALTH,
                named=[self._slots[i] for i in tripped])
            return
        for i, slot in enumerate(self._slots):
            if slot is None or slot.req is not snapshot[i]:
                if snapshot[i] is not None and not self.device_termination:
                    self._bill_waste(self.chunk_len, snapshot[i])
                continue
            slot.decode_chunks_inflight -= 1
            if slot.stale_chunks > 0:
                # Superseded by a forced-run fast-forward (its rows
                # index the pre-splice stream; FIFO consume keeps the
                # countdown exact — mirror of the batcher).
                slot.stale_chunks -= 1
                continue
            if self.device_termination:
                new_ids, finish = consume_chunk_row(
                    res.tokens[i], bool(res.done[i]), int(res.lengths[i]),
                    len(slot.emitted), ct, self.eos_ids)
            else:
                new_ids, finish, wasted = scan_chunk_row(
                    res.tokens[i], len(slot.emitted), self.eos_ids,
                    slot.req.max_tokens)
                self._bill_waste(wasted, slot.req)
            if new_ids:
                if slot.t_first is None:
                    # Ragged admission: the first sampled
                    # token rode this chunk — TTFT lands here.
                    slot.t_first = time.monotonic()
                    if slot.req.t_first0 is None:
                        slot.req.t_first0 = slot.t_first
                piece = self._piece(new_ids, len(slot.emitted))
                slot.emitted.extend(new_ids)
                if slot.req.export is not None:
                    slot.req.export.ids = list(slot.emitted)
                slot.req.out_queue.put_nowait(("token", piece))
                if self._grammar is not None and slot.req.gpid >= 0:
                    self._grammar_consume(slot, new_ids)
                    if finish is None:
                        self._grammar_fast_forward(i, slot)
                        if self._slots[i] is not slot:
                            continue
            if finish is not None:
                self._finish(i, finish)
        # Early exoneration (mirror of the batcher): after
        # PROBATION_CLEAN_CHUNKS clean chunks that actually TESTED a
        # flagged suspect, suspicion narrows to the parked half, which
        # replays now instead of stalling admissions until the probe
        # drains; with nothing parked, the cleared flags close the case.
        if any(r is not None and r.suspect for r in snapshot):
            self._probation_clean += 1
            if self._probation_clean >= PROBATION_CLEAN_CHUNKS:
                self._probation_clean = 0
                for s in self._slots:
                    if s is not None:
                        s.req.suspect = False
                if self._parked:
                    self._unpark_parked()
        elif self._parked and not any(
                s is not None and s.req.suspect for s in self._slots
        ) and not any(
                r is not None and r.suspect
                for e in self._inflight if e[0] == "chunk" for r in e[2]):
            # Every probe suspect completed and none remains in the pipe:
            # the parked half inherits the suspicion now.
            self._unpark_parked()

    # ------------------------------------------- containment

    def _fail_all_active(self, error: BaseException) -> None:
        self._inflight.clear()
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._slots[i] = None
                self._pool_release_slot(slot, cache_chain=False)
                self._bill_delivered(slot.req, len(slot.emitted))
                slot.req.out_queue.put_nowait(("error", error))
        for slot in self._parked:
            # Parked slots' block lists were cleared at the reset that
            # parked them (stale-generation views) — release is a no-op
            # there by construction.
            self._pool_release_slot(slot, cache_chain=False)
            self._bill_delivered(slot.req, len(slot.emitted))
            slot.req.out_queue.put_nowait(("error", error))
        self._parked.clear()

    def _bill_delivered(self, req: _FakeReq, n_total: int) -> None:
        """Bill the emitted transcript as delivered, incrementally past
        what was already billed (a fleet import's prefix was billed by
        the donor — see _FakeReq.ledger_delivered). A cancelled
        hedge-loser branch (export.discard) emitted tokens the relay
        never forwarded — hedge_loser burn, not delivered (mirror of
        the batcher's _finish)."""
        n_new = n_total - req.ledger_delivered
        req.ledger_delivered = n_total
        cls = (CLASS_HEDGE_LOSER
               if (req.export is not None
                   and getattr(req.export, "discard", False))
               else CLASS_DELIVERED)
        self.ledger.record(cls, n_new, lane=req.lane, tenant=req.tenant)
        # Session budget: only tokens the client actually got
        # spend budget — hedge-loser burn never demotes a session.
        if cls == CLASS_DELIVERED:
            self._session_budgets.charge(req.session, n_new)

    def _contain_poisoned_step(self, cause: str, named=(),
                               error: Optional[BaseException] = None) -> None:
        """Quarantine + reset-and-replay — the same flow as
        BatchedTorchEngine._contain_poisoned_step over numpy state (the
        'reset' here is dropping the speculative pipeline; per-slot
        device state is re-derived from host truth by _replay_slot)."""
        survivors = [s for s in self._slots if s is not None]
        if not self.supervisor.allow_reset():
            self._fail_all_active(
                error if isinstance(error, Exception)
                else EngineUnavailable("engine reset budget exhausted"))
            return
        quarantined: List[_FakeSlot] = []
        reasons: dict = {}
        pool = list(survivors)
        if named:
            for slot in named:
                if self.supervisor.implicate(slot.req):
                    quarantined.append(slot)
                    reasons[id(slot)] = REASON_HEALTH
        else:
            # Mirror of the batcher: narrow to the standing suspect pool
            # so early exoneration can't widen the next bisection back
            # out to the whole batch.
            flagged = [s for s in survivors if s.req.suspect]
            if flagged:
                pool = flagged
            if len(pool) == 1:
                slot = pool[0]
                if self.supervisor.implicate(slot.req):
                    quarantined.append(slot)
                    reasons[id(slot)] = REASON_ISOLATED
        self._slots = [None] * self.batch_size
        self._inflight.clear()
        if self._pool is not None:
            # Mirror the batcher's reset: the pool world rebuilds empty
            # (cached KV would be device-invalid there), and survivors'
            # block lists are stale previous-generation views — cleared
            # so nothing ever decrefs stale ids into the fresh pool.
            self._pool_reset()
            for s in survivors:
                s.blocks = []
                s.pool_starved = False
        self.supervisor.note_reset(cause)
        qset = {id(s) for s in quarantined}
        for slot in quarantined:
            self.supervisor.note_quarantine(reasons[id(slot)])
            # Ledger: the quarantined transcript is discarded — burned,
            # never delivered (mirror of the batcher).
            burn = len(slot.emitted) - slot.req.ledger_delivered
            slot.req.ledger_delivered = len(slot.emitted)
            self.ledger.record(CLASS_QUARANTINE_BURN, burn,
                               lane=slot.req.lane, tenant=slot.req.tenant)
            slot.req.out_queue.put_nowait(("error", RequestQuarantined(
                f"request quarantined after poisoning {cause} "
                f"{slot.req.suspect_count}x (retry budget "
                f"{self.supervisor.retry_budget})")))
        rest = [s for s in survivors
                if id(s) not in qset and not s.req.cancel.is_set()]
        if named:
            probe, parked = rest, []
        else:
            # Bisect within the suspect pool only; non-suspects replay
            # immediately alongside the probe (mirror of the batcher).
            pool_rest = [s for s in pool
                         if id(s) not in qset and not s.req.cancel.is_set()]
            pool_ids = {id(s) for s in pool_rest}
            innocents = [s for s in rest if id(s) not in pool_ids]
            if len(pool_rest) <= 1:
                probe, parked = rest, []
            else:
                probe_sus, parked = EngineSupervisor.split(pool_rest)
                probe = probe_sus + innocents
            for s in innocents:
                s.req.suspect = False
            for s in pool_rest:
                s.req.suspect = True
        self._parked.extend(parked)
        self._probation_clean = 0   # each containment pass restarts probation
        for slot in probe:
            self._replay_slot(slot)

    def _unpark_parked(self) -> None:
        """End bisection probation: replay every parked slot and let
        admissions resume on the next tick."""
        parked, self._parked = self._parked, []
        self._probation_clean = 0
        for slot in parked:
            self._replay_slot(slot)

    def _replay_slot(self, slot: _FakeSlot) -> None:
        """Re-seat one surviving request: the device cursors re-derive
        from the host-side emitted prefix (the scripted stream is the
        'model', so replayed tokens are bit-identical by construction —
        exactly the property the batched engine gets from seeded sampling)."""
        req = slot.req
        if req.cancel.is_set():
            return
        g = len(slot.emitted)
        i = self._slots.index(None)
        if self._pool is not None:
            # Pool mirror of the batcher's replay: re-derive the chain
            # through the radix tree (a preempt-cached or shared prefix
            # re-maps; after a reset the empty tree means fresh blocks).
            chain = slot.pool_ids + (slot.emitted[:-1] if slot.emitted
                                     else [])
            try:
                slot.blocks, _ = self._pool_map_prefix(chain,
                                                       match_all=True)
            except PoolExhausted:
                req.out_queue.put_nowait(("error", EngineUnavailable(
                    "replay failed: kv pool exhausted")))
                return
            if req.export is not None and slot.blocks:
                req.export.blocks = list(slot.blocks)
        slot.dev_idx = g
        slot.dev_ngen = g
        slot.last_tok = slot.emitted[-1] if slot.emitted else 0
        slot.dev_active = (g < req.max_tokens
                           if self.device_termination else True)
        slot.decode_chunks_inflight = 0
        slot.stale_chunks = 0
        if self._grammar is not None and req.gpid >= 0:
            slot.gs = self._grammar.run(req.gpid, slot.emitted)
            slot.dev_gs = slot.gs
        self._slots[i] = slot
        self.supervisor.note_replay(g)
        # Ledger: the containment replay re-derives the emitted prefix
        # (the fake's cursors jump, but accounting mirrors the real
        # engine's re-splice prefill).
        self.ledger.record(CLASS_REPLAYED, g, lane=req.lane,
                           tenant=req.tenant)
        if req.trace is not None:
            req.trace.link("resumed", slot=i, tokens=g)

    def _finish(self, slot_idx: int, finish: str,
                error: Optional[BaseException] = None,
                wasted_inflight: bool = False) -> None:
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None
        if slot is None:  # pragma: no cover - defensive
            return
        # Pool mirror: release blocks; clean finishes cache the chain
        # first (completion feeds sharing — same rule as the batcher).
        self._pool_release_slot(
            slot, cache_chain=(error is None
                               and finish in ("stop", "length")))
        # Mirror the batcher's billing: capped by the remaining token
        # budget — the device freezes there, so a disconnect near natural
        # completion can't read as a full pipe of waste.
        if (wasted_inflight and self.device_termination
                and slot.decode_chunks_inflight > 0):
            remaining = max(0, slot.req.max_tokens - len(slot.emitted))
            self._bill_waste(min(
                slot.decode_chunks_inflight * self._chunk_waste_bound(),
                remaining), slot.req)
        # Ledger + TTFT SLO (mirror of the batcher's _finish).
        self._bill_delivered(slot.req, len(slot.emitted))
        if error is not None:
            slot.req.out_queue.put_nowait(("error", error))
            return
        now = time.monotonic()
        if (slot.req.t_submit and not slot.req.ttft_exempt
                and not (slot.req.export is not None
                         and getattr(slot.req.export, "discard", False))):
            # t_first0 survives preempt/resume (mirror of the batcher);
            # fleet imports are exempt — their first byte was the
            # donor's.
            ttft_ms = ((slot.req.t_first0 or slot.t_first or now)
                       - slot.req.t_submit) * 1000.0
            lane = (slot.req.lane if slot.req.lane in LANES
                    else LANE_INTERACTIVE)
            self._slo.note(SLO_TTFT, lane, ttft_ms, now=now)
            # Turn-N session TTFT: judged ONLY for radix-warm
            # re-admissions of a declared session — the sample set the
            # two-tier cache is accountable for.
            if slot.req.session and slot.req.radix_warm:
                self._slo.note(SLO_SESSION_TTFT, lane, ttft_ms, now=now)
        # Starvation truncation is a client-visible degradation: the transcript is short of what decode would have
        # produced, so the result says so instead of passing as a
        # natural stop.
        degraded = bool(slot.pool_starved)
        if degraded and slot.req.trace is not None:
            slot.req.trace.link("degraded", cause="kv_pool_starved",
                                tokens=len(slot.emitted))
        # Stamped AFTER construction: _result is a documented test
        # override hook, so its signature stays what subclasses expect.
        result = self._result(slot.req, slot.emitted, finish)
        result.degraded = result.degraded or degraded
        slot.req.out_queue.put_nowait(("done", result))

    # ------------------------------------------------------------ serving

    def _piece(self, ids: List[int], offset: int) -> str:
        """Token ids → text increment. Default rendering is "t<id>"
        words (the round-trip encoding the radix suites rely on); under
        GRAMMAR_DECODE the tokens ARE ByteTokenizer byte ids, so pieces
        render as the real UTF-8 text — the HTTP end-to-end grammar
        tests read actual kubectl commands off the wire."""
        if self._grammar is not None:
            return self._grammar.tokenizer.decode(ids)
        text = " ".join(f"t{t}" for t in ids)
        return text if offset == 0 else " " + text

    def _result(self, req: _FakeReq, ids: List[int],
                finish: str) -> EngineResult:
        return EngineResult(
            text=(self._grammar.tokenizer.decode(ids)
                  if self._grammar is not None
                  else " ".join(f"t{t}" for t in ids)),
            prompt_tokens=len(req.prompt.split()),
            completion_tokens=len(ids),
            finish_reason=finish,
            engine=self.name,
            weights_version=self.weights_version,
        )

    async def stream_events(self, prompt: str, *, max_tokens: int = 128,
                            temperature: float = 0.0,
                            timeout: Optional[float] = None,
                            seed: Optional[int] = None,
                            resume_ids: Optional[List[int]] = None,
                            export: Optional[RequestExport] = None):
        """Fleet-facing event stream — the same cross-replica contract
        the batcher speaks (seed pin, resume import, live export);
        ``temperature`` is accepted for signature parity and ignored
        (streams are scripted)."""
        del temperature
        async for ev in self._stream_events(
                prompt, max_tokens=max_tokens, timeout=timeout, seed=seed,
                resume_ids=resume_ids, export=export):
            yield ev

    async def _stream_events(self, prompt: str, *, max_tokens: int,
                             timeout: Optional[float],
                             seed: Optional[int] = None,
                             resume_ids: Optional[List[int]] = None,
                             export: Optional[RequestExport] = None):
        if not self._ready:
            raise EngineUnavailable("FakeChunkedEngine not started")
        if seed is None:
            seed = zlib.crc32(
                prompt.encode("utf-8", "surrogatepass")) & 0x7FFFFFFF
        # QoS classification + fair-share admission (mirror of the
        # batcher's submit path).
        qctx = current_qos()
        tenant = (qctx.tenant if qctx is not None else "") or ANON_TENANT
        lane = (qctx.lane if qctx is not None
                and qctx.lane in LANES else LANE_INTERACTIVE)
        session = qctx.session if qctx is not None else ""
        # Over-budget sessions classify into the background lane: the session keeps working — WDRR guarantees background a
        # share — but stops outranking fresh interactive traffic.
        lane = self._session_budgets.lane_for(session, lane)
        gpid = -1
        if self._grammar is not None:
            from ..constrain import current_grammar

            gctx = current_grammar()
            if gctx is not None and gctx.allowed_verbs:
                # Mirror the batcher: a novel verb set compiles a
                # variant FSM — keep that off the event loop.
                gpid = await asyncio.to_thread(
                    self._grammar.resolve, lane=lane, ctx=gctx)
            else:
                gpid = self._grammar.resolve(lane=lane, ctx=gctx)
        if self.faults is not None:
            burst = self.faults.tenant_flood()
            if burst:
                self._inject_flood(burst)
        now = time.monotonic()
        req = _FakeReq(
            prompt=prompt,
            prompt_ids=self._prompt_token_ids(prompt),
            max_tokens=max(1, max_tokens),
            deadline=(now + timeout) if timeout else None,
            out_queue=asyncio.Queue(),
            cancel=asyncio.Event(),
            stream=list(self.stream_fn(prompt)),
            seed=int(seed),
            resume_ids=list(resume_ids) if resume_ids else None,
            export=export,
            tenant=tenant,
            lane=lane,
            t_submit=now,
            trace=current_trace(),
            # Fleet import: the prefix was decoded and billed delivered
            # on the donor replica (see _FakeReq.ledger_delivered), and
            # the client's first byte happened there too.
            ledger_delivered=len(resume_ids) if resume_ids else 0,
            ttft_exempt=bool(resume_ids),
            gpid=gpid,
            session=session,
        )
        if export is not None:
            # Version the portable state at submit: the
            # fleet's version-pinned failover routes on this stamp.
            export.weights_version = self.weights_version
        # put() raises TenantOverloaded (429) at the per-tenant cap and
        # EngineOverloaded when this tenant floods a full queue; a quiet
        # arrival instead displaces the flooder's newest request.
        for victim in self._queue.put(req):
            victim.out_queue.put_nowait(("error", EngineOverloaded(
                f"displaced from a full admission queue (tenant "
                f"{victim.tenant!r} holds the largest queue share)")))
        try:
            while True:
                if req.deadline is not None:
                    remaining = req.deadline - time.monotonic()
                    try:
                        event, payload = await asyncio.wait_for(
                            req.out_queue.get(), remaining + 2.0)
                    except asyncio.TimeoutError:
                        raise GenerationTimeout(
                            "generation exceeded timeout")
                else:
                    event, payload = await req.out_queue.get()
                if event == "error":
                    raise payload
                yield (event, payload)
                if event == "done":
                    return
        finally:
            req.cancel.set()

    async def generate(
        self,
        prompt: str,
        *,
        max_tokens: int = 128,
        temperature: float = 0.0,
        timeout: Optional[float] = None,
        seed: Optional[int] = None,
    ) -> EngineResult:
        async for event, payload in self._stream_events(
                prompt, max_tokens=max_tokens, timeout=timeout, seed=seed):
            if event == "done":
                return payload
        raise EngineUnavailable("stream ended without a result")

    async def generate_stream(
        self,
        prompt: str,
        *,
        max_tokens: int = 128,
        temperature: float = 0.0,
        timeout: Optional[float] = None,
        seed: Optional[int] = None,
    ) -> AsyncIterator[str]:
        async for event, payload in self._stream_events(
                prompt, max_tokens=max_tokens, timeout=timeout, seed=seed):
            if event == "token":
                yield payload
