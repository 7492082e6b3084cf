"""Continuous-batching engine, in PyTorch.

The counterpart of the JAX package's ``engine/batcher.py`` at
``DECODE_BATCH_SIZE`` > 1, in its three attention regimes (resolved at
startup; ``kv_pool_health()["attention_regime"]`` reports which):

- ``ragged`` (``KV_POOL=true``, ``RAGGED_ATTENTION=auto|on``, the
  defaults): every forward over the pool — preload, admission, decode —
  reads through the ragged kernel (``ops/ragged_attention.py``), and
  admissions ride the next chunk's ragged prologue (below).
- ``paged`` or ``gather`` (``KV_POOL=true``, ``RAGGED_ATTENTION=off``):
  the legacy ladder. An admission prefills its unmatched suffix eagerly
  through ``(bucket, kv_limit)`` gather programs (flash where it tiles
  the shape), samples its first token and arms its slot; decode reads
  the pool through the paged decode kernel (``DECODE_ATTN`` resolved to
  ``paged``: one KV bucket) or the gather path (``dense``: a KV-bucket
  ladder per dispatch).
- ``paged`` or ``dense`` (``KV_POOL=false``, the dense KV ladder): one
  dense per-slot cache [L, N, S_alloc + 1, KV, hd]. An admission
  prefills into a scratch cache (the system-prompt prefix splice, one
  bucket, or chunked — ``TorchEngine._prefill_prompt``), samples its
  first token and splices the scratch rows into its slot; decode runs
  the paged decode kernel over the whole cache or the dense reference
  over a KV-bucket ladder. No pool, no radix tree. A burst of prefix
  hits that share one suffix shape is admitted as a group (below).

``DECODE_ATTN=auto`` picks ``paged`` for a GQA model (several query
heads over each of several KV heads) on the card, raising the page to
64, and ``dense`` otherwise (``resolve_decode_attn``). Under
``KV_QUANT=int8`` (an int8 pool or dense cache, ``ops/quant.py::
QuantKV``) no kernel reads the cache, as in the JAX engine: the pool
serves the ``gather`` regime (``RAGGED_ATTENTION`` and
``DECODE_ATTN=paged`` resolve to it, with the JAX warnings) and the
dense ladder ``dense``, both through ``dense_attention_quant``. Eager
admissions deliver their first token through a ``("first", ...)``
entry of the in-flight list (a group admission its first tokens through
one ``("firsts", ...)`` entry). In every regime:

- **One shared KV pool** ([L, n_blocks + 1, page, KV, hd], zeroed at
  start) and per-slot block tables, unless ``KV_POOL=false``. The host
  is truth for ownership — ``BlockPool`` refcounts, the radix tree and
  the numpy table rows; the device only ever sees table snapshots at
  dispatch.
- **Radix prefix sharing**: the system prompt is prefilled once at start
  and left cached; an admission maps its longest cached prefix (full
  pages shared, a partial tail copied on write) and prefills only the
  rest.
- **Ragged staged admission** (the ragged regime): the unmatched prompt
  suffix does not run a
  prefill of its own. It rides the NEXT decode chunk as a long-q_len row
  of one ragged window (the prologue), while every other live slot takes
  its normal decode step at q_len=1 in the same forward. Only the head of
  a prompt beyond the widest admission window prefills eagerly.
- **Device-side termination** (``DEVICE_TERMINATION``, on by default):
  each chunk runs ``chunk_len`` forward steps whose carry (tokens,
  positions, live mask, generated counts, budgets, health word) stays on
  the device; EOS, token budgets and non-finite logits freeze a slot
  inside the chunk. The host reads ONE packed int32 buffer per chunk
  (``protocol.pack_chunk``, v3) and nothing else — no ``.item()`` or
  boolean index runs inside the step loop. Off, the JAX engine's
  host-scan path: every dispatched slot decodes the whole chunk, the host
  scans each row for EOS and the budget (``protocol.scan_chunk_row``) and
  bills the steps past a finish as waste; the ragged regime, which arms
  staged admissions inside the chunk's carry, resolves to the legacy
  ladder, and the grammar and speculative decoding refuse it.
- **The chunk pipeline** (``CHUNK_PIPE_DEPTH``, 3 by default): the
  scheduler keeps up to that many chunks in flight, dispatching chunk
  N+1 before it reads chunk N. Each in-flight entry (a chunk's packed
  buffer, an eager admission's first token) starts its device->host copy
  into pinned memory at dispatch, with an event recorded behind it; the
  read waits on that event only, never on the chunks dispatched after
  it. Every host->device upload between dispatches (block tables,
  staged admissions, the live mask, prefill tokens, grammar masks)
  goes through pinned staging with a non-blocking copy
  (``TorchEngine._h2d``): a copy from pageable memory would wait for the
  whole stream and collapse the pipe. Admissions arm their slots on
  the latest device state, so a request admitted with two chunks in
  flight starts decoding two chunks later; a chunk dispatched for a
  slot that was freed or reassigned since is discarded at its read.
- **Seeded sampling**: every sampled token, an admission's first one
  included, draws from ``fold_in(PRNGKey(seed), g)`` at its generation
  index ``g`` (``sampling.sample_tokens_seeded``, jax's threefry bits),
  so a transcript depends only on the seed and the logits — the same
  tokens as the JAX engine's, and the same after a preemption.
- **QoS admission** (``engine/qos.py``): the admission queue is the JAX
  package's ``QoSQueue`` — weighted deficit round robin over per-tenant
  sub-queues by lane, the per-tenant cap (``TenantOverloaded``, a 429),
  a full queue displacing the dominant tenant's newest request for a
  quieter arrival, expired requests purged at scan time — with the
  brownout controller trimming lower lanes' slot shares. A request's
  tenant and lane ride the ``QoSContext`` of its caller; a direct call
  with none runs in one interactive ``anon`` bucket, as before.
- **Preempt and resume**: a higher-lane request queued past
  ``PREEMPT_WAIT_MS`` with every slot busy takes the slot of the
  cheapest lower-lane request, which is requeued at the head of its
  tenant's queue with its prompt, its generated ids and its seed. Its
  resume (``_replay_slot``) re-maps its cached chain in the pool (or
  prefills prompt + ids on the dense ladder), forces the carry token to
  its last id and re-arms the slot at ``ngen = g``: the transcript goes
  on as if it had never left.
- **The telemetry plane**, at the JAX engine's sites: the goodput
  ledger (``obs/ledger.py``: delivered at finish, preempted and replayed
  at a resume, wasted_masked for the steps in-flight chunks spend on a
  slot a host-only finish ended, quarantine_burn for a health-tripped
  request); the SLO engine (``obs/slo.py``: queue wait at admission,
  TTFT at finish), whose fast-window interactive queue-wait burn feeds
  the brownout controller; the step-time sentinel (``obs/steptime.py``:
  a prefill sample at an eager admission's first token, one sample per
  chunk cycle); the chunk-event ring ``_chunk_log`` behind
  ``/debug/chunks``; and ``profile``, which runs a ``torch.profiler``
  capture on the scheduler thread (``obs/profiler.py``).
- **Blast-radius containment** (``engine/containment.py``, the JAX
  engine's inner ring): a tripped health word names its slot, a
  scheduler exception poisons the step. Either way the decode state is
  reset (the old pool or cache dropped before the new one is
  allocated) and every survivor replays from prompt + generated ids
  through ``_replay_slot`` under its seed; a request implicated past
  ``QUARANTINE_RETRY_BUDGET`` ends with ``RequestQuarantined`` (410),
  and a fault naming no slot is bisected (half the suspects replay,
  half are parked) until the culprit runs alone. Resets are
  rate-limited (``ENGINE_RESET_MAX_PER_MIN``; past it every active
  request fails fast and the breaker opens). A supervisor thread
  restarts a scheduler thread that died, and a watchdog thread fails
  every waiting request when the scheduler stops making progress.
  ``testing/faults.py`` reaches the engine at the JAX engine's seams:
  ``admit``, ``chunk``, ``decode:nan`` (a fixed-shape ``[N]`` bool
  device input of ``_run_chunk`` that NaN-fills the target's logits, so
  the real health detection catches it), ``decode:poison_step`` at the
  chunk fetch, ``scheduler:die`` and ``tenant:flood``.
- **Grammar-constrained decoding** (``GRAMMAR_DECODE``, the JAX
  engine's; ``constrain/``): the chunk carries a per-slot FSM state
  word ``gs`` (``_fsm_d``, the global state ``pid * S_max + s``) and
  reads the stacked tables (``tok_class``, ``class_ok``,
  ``class_next``, refreshed by the runtime's version at dispatch). Each
  step, the ragged prologue included, masks illegal logits to -inf
  before the draw (and before the greedy argmax), freezes a slot with no
  legal token on ``HEALTH_GRAMMAR_DEAD`` (the containment lane replays
  or quarantines it) and advances ``gs`` by the sampled token's class.
  The host keeps each slot's state over the tokens it consumed. A forced
  run (a chain of states with one legal token each) of at least
  ``GRAMMAR_FORCED_RUN_MIN`` tokens is spliced as ONE prefill instead of
  decoded: at admission with the prompt (the pool regimes), and
  mid-stream after a consume (``_grammar_fast_forward``, the pool
  regimes only). Forced tokens take generation indices but no
  randomness, so transcripts equal masked step-by-step decode.
- **Speculative decoding** (``SPEC_DECODE``, the JAX engine's; the pool
  regimes only): a draft model (``SPEC_DRAFT_MODEL``, same vocabulary,
  never quantized) with its own dense per-slot cache proposes
  ``SPEC_DRAFT_K`` = k greedy tokens a verify iteration (k + 1 draft
  forwards: the last writes the k-th proposal's KV row), and ONE target
  forward over the (k + 1)-token window (the ragged kernel at q_len =
  k + 1, or the gather path) keeps every position's logits. Each
  position runs the plain step's fold (corrupt, grammar mask, seeded
  draw at its own generation index, health, EOS, budget); a window
  stays valid while each draft equals the token sampled against it, so
  the transcript never depends on the draft and equals spec-off's. A
  chunk runs ``max(1, CHUNK_LEN // (k + 1))`` iterations into a
  compacting token buffer (the packed buffer's drafted/accepted lanes
  ride along); every site that arms the target's KV (admission,
  replay, fast-forward) prefills the span into the draft's cache too.
  ``draft:die`` flips the engine to plain chunks at dispatch.
- **The two-tier host KV** (``HOST_KV_BLOCKS`` > 0, the pool with the
  radix tree; the JAX engine's): radix eviction under pool pressure
  *demotes* a cold cached page to a ``HostBlockStore`` in host RAM
  (``_pool_offload_block``: the block's bytes across every K/V leaf,
  CRC32-stamped) instead of dropping it, and a later match walking into
  it *onloads* it back into a fresh pool block (``_pool_onload_block``)
  once the checksum verifies. A corrupt or allocation-starved onload
  ends the match there and the suffix prefills: the tier can turn a hit
  into a prefill, never fail a request. A containment reset rebuilds
  both tiers empty with the counters carried.
- **Pool starvation** is counted (``starved_slots_total`` in
  ``kv_pool_health``): a slot whose table cannot grow even after radix
  eviction is truncated at its current length, its result marked
  ``degraded``, and the incident watcher's ``pool_exhausted`` reads the
  count.
- **The fleet's contract** (``stream_events``, the JAX engine's): a
  request carries a ``protocol.RequestExport`` whose ``ids`` the
  scheduler points at the generated ids after every consume (a fresh
  list each time) and whose ``blocks`` follow the table, stamped at
  submit with the engine's ``weights_version``; an imported
  ``resume_ids`` (a prefix generated on another replica) is seated
  through ``_admit_resume`` and replayed, billed on the donor
  (``ledger_delivered``) and exempt from the TTFT SLO; a cancelled hedge
  loser (``export.discard``) bills its tokens as ``hedge_loser``. A
  restart after ``swap_weights`` rebuilds every structure that holds
  KV computed under the old weights (the pool, the radix tree and its
  preloaded system prompt, the host tier, the dense prefix cache, the
  draft's cache) and keeps the grammar runtime and the draft's weights.
- **Group admission** (the dense KV ladder with the system-prompt
  prefix cache; the JAX engine's ``_admit_group``): the prefix hits of
  one admission pass that share a ``(suffix bucket, kv_limit)`` shape
  are spliced into ``kpad`` suffix-depth scratch rows (``kpad`` in
  ``ADMIT_KPADS``, capped by the batch and, per scratch depth, by
  ``ADMIT_SCRATCH_MB``), prefilled in ONE forward over ``[kpad,
  sbucket]`` (flash where it tiles the shape), each row's first token
  drawn at generation index 0 of its own seed, and the rows written into
  their slots (``kv_set_slots``; padding rows carry the out-of-range
  slot ``batch_size`` and are dropped). The first tokens travel as one
  ``("firsts", ...)`` in-flight entry. Transcripts equal single
  admission's. Resumes and grammar requests take the single path.
- **Serving on a mesh** (``MESH_SHAPE``, the JAX engine's mesh rules on
  the ``data``, ``expert`` and ``model`` axes): the weights split over
  the shards, the pool or dense cache split on KV heads (each shard's K
  and V tensors of its own, written through its own leaves), the dense
  cache's slots over ``data``, every forward over the shards. The
  pool's kernels run once per shard through the sharded wrappers; where
  KV or H does not divide tp the pool serves the gather path instead,
  with the JAX warning. A >1 data, pipe or seq axis turns a requested
  pool into the dense ladder, loudly (``kv_pool_mesh_fallback``); on a
  pipe axis paged decode falls back to dense too (the stages read
  dense), and long admissions on a seq axis prefill by the ring
  (``TorchEngine._prefill_prompt``). The
  dense ladder reads per (data, model) shard in the JAX layouts (heads
  split together, MQA's KV head replicated, or heads replicated). MoE
  layers run dense under tp or dispatched over ``expert``. Speculative
  decoding rides a tp/ep mesh: the draft's weights and cache split as
  the target's, its cache replicated when its KV heads do not divide tp
  (``draft_kv_fallback``). The block tables, the radix tree and every
  host structure are one, shared by the shards. ``sharding_health``,
  ``spec_health`` and ``stats()["sharding"]`` report the mesh and the
  flags.
- Each attention kernel is the Hopper kernel for CUDA tensors and its
  plain version for CPU tensors.

The scheduler runs on one worker thread (restarted by the supervisor
after a death); request coroutines talk to it through the QoS admission
queue and per-request asyncio queues. A sticky CUDA error (an illegal
address) cannot be contained: every later call fails, the resets spend
their budget, and fail-fast and the breaker take over.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import logging
import queue as _queue
import threading
import time
import traceback
import zlib
from typing import List, Optional

import numpy as np
import torch

from ..models.config import get_config, spec_draft_config
from ..models.transformer import KVCache, forward, init_params
from ..obs import (PHASE_DECODE, PHASE_PREFILL, PHASE_SPEC_VERIFY,
                   SLO_QUEUE_WAIT, SLO_TTFT, GoodputLedger, SloEngine,
                   StepTimeSentinel, Trace, current_trace, prefill_bucket)
from ..obs.ledger import (CLASS_DELIVERED, CLASS_DRAFT_REJECTED,
                          CLASS_HEDGE_LOSER, CLASS_PREEMPTED,
                          CLASS_QUARANTINE_BURN, CLASS_REPLAYED,
                          CLASS_WASTED_MASKED)
from ..obs.profiler import ProfilerSession, scope
from ..obs.slo import SLO_SESSION_TTFT
from ..ops.paged_attention import paged_supported
from ..ops.quant import (QuantKV, ShardedKV, kv_broadcast_rows, kv_map,
                         kv_set_slots, kv_update_slice)
from ..parallel.sharding import (ShardedParams, draft_kv_fallback,
                                  kernel_heads_divide, residual_fraction,
                                  shard_params)
from .containment import (CAUSE_SCHEDULER_DEATH, CAUSE_SCHEDULER_ERROR,
                          CAUSE_SLOT_HEALTH, PROBATION_CLEAN_CHUNKS,
                          REASON_HEALTH, REASON_ISOLATED, EngineSupervisor)
from .kv_pool import (BlockPool, HostBlockStore, alloc_with_evict,
                      check_host_tier, map_prefix, pages_for)
from .protocol import (HEALTH_GRAMMAR_DEAD, HEALTH_NONFINITE,
                       HEALTH_TOKEN_RANGE,
                       EngineOverloaded, EngineResult, EngineUnavailable,
                       GenerationTimeout, RequestExport, RequestQuarantined,
                       TenantOverloaded, consume_chunk_row, describe_health,
                       pack_chunk, scan_chunk_row, unpack_chunk)
from .qos import (ANON_TENANT, LANE_BACKGROUND, LANE_BATCH,
                  LANE_INTERACTIVE, LANES, BrownoutController, QoSQueue,
                  SessionBudgets, current_qos, lane_rank)
from .prefix_cache import round_kv_limit
from .radix_cache import RadixCache
from .sampling import (apply_mask, eos_mask, greedy_tokens,
                       sample_tokens_seeded)
from .tokenizer import StreamDecoder
from .torch_engine import TorchEngine, engine_kwargs, kv_bucket_ladder

logger = logging.getLogger(__name__)

#: smallest KV page ``DECODE_ATTN=auto`` serves paged decode at (the JAX
#: package's floor; 64 divides the 128-token kv-limit tile).
_AUTO_PAGED_MIN_PAGE = 64


def default_seed(prompt: str) -> int:
    """The seed a request's tokens are drawn under when the caller gives
    none: the prompt's CRC32 (the JAX batcher's rule)."""
    return zlib.crc32(prompt.encode("utf-8", "surrogatepass")) & 0x7FFFFFFF


def resolve_decode_attn(decode_attn: str, cfg, *, kv_quant: str = "",
                        page_size: int, device: torch.device,
                        dtype: torch.dtype = torch.bfloat16,
                        pipe: int = 1) -> tuple:
    """Resolve ``DECODE_ATTN`` to a concrete impl and page size (the JAX
    ``resolve_decode_attn``, whose accelerator test becomes "the engine
    serves on cuda").

    ``auto`` is ``paged`` for a GQA model — several query heads sharing
    each of several KV heads — with no KV quantization and a geometry
    ``paged_supported`` takes (page, head_dim and ``dtype``), with the
    page raised to ``_AUTO_PAGED_MIN_PAGE``; ``dense`` for MQA, MHA and
    always on the CPU (where the kernel's plain version would stand in for
    it).
    Never ``paged`` on a ``pipe`` axis > 1 (the stages read dense, as
    in JAX). Explicit ``dense``/``paged`` pass through. Returns ``(impl,
    page_size)``."""
    if decode_attn != "auto":
        return decode_attn, page_size
    page = max(page_size, _AUTO_PAGED_MIN_PAGE)
    if (device.type == "cuda"
            and cfg.q_per_kv > 1 and cfg.n_kv_heads > 1 and not kv_quant
            and pipe <= 1
            and paged_supported(page, cfg.head_dim, 1, dtype)):
        return "paged", page
    return "dense", page_size


def termination_fold(nxt, step_logits, prev_tok, live, ngen, budget,
                     health, eos_ids, vocab_size: int,
                     health_check: bool, grammar=None):
    """The per-step termination fold of the JAX chunk body, on [N]
    device tensors: health bits freeze a slot before its token counts,
    the FSM state word of every row that really sampled advances by its
    token's class (``grammar`` = ``(gs, tc, class_next)``: [N] states,
    the [N, V] token -> class rows, the stacked table), frozen rows
    repeat their previous token, EOS and the token budget end a slot.
    Returns ``(nxt, live, ngen, health, counted, gs)`` (``gs`` None
    without a grammar)."""
    if health_check:
        bad_logit = ~torch.isfinite(step_logits).all(dim=-1)
        health = health | (live & bad_logit).to(health.dtype) \
            * HEALTH_NONFINITE
        if vocab_size > 0:
            bad_tok = (nxt < 0) | (nxt >= vocab_size)
            health = health | (live & bad_tok).to(health.dtype) \
                * HEALTH_TOKEN_RANGE
        live = live & (health == 0)
    gs = None
    if grammar is not None:
        # The EOS class self-loops, so a terminating row parks in place;
        # frozen rows keep their state.
        gs, tc, class_next = grammar
        cls = torch.gather(
            tc, 1, nxt.clamp(0, tc.shape[1] - 1).long()[:, None])[:, 0]
        gs = torch.where(live, class_next[gs, cls], gs)
    nxt = torch.where(live, nxt, prev_tok)
    hit_eos = eos_mask(nxt, eos_ids) & live
    counted = live & ~hit_eos
    ngen = ngen + counted.to(torch.int32)
    done_now = hit_eos | (counted & (ngen >= budget))
    live = live & ~done_now
    return nxt, live, ngen, health, counted, gs


def step_fold(step_logits, prev_tok, live, ngen, budget, health, gram,
              sample, eos_ids, vocab_size: int, health_check: bool):
    """THE per-step fold, shared by the ragged prologue and the step loop,
    in the JAX chunk body's order: the grammar mask (a live row with no
    legal token freezes on HEALTH_GRAMMAR_DEAD before it samples), the
    draw ``sample(step_logits, ngen, live[, mask])`` (the mask passed
    only under a grammar), then ``termination_fold`` (health, the FSM
    advance, EOS and budget).
    ``gram`` is ``(gs, tc, ok, next)``: the [N] state words, the chunk's
    hoisted [N, V] token -> class rows and the two stacked tables; None
    without a grammar. Returns ``(nxt, live, ngen, health, counted,
    gs)``."""
    mask = grammar = None
    if gram is not None:
        gs, tc, ok_d, next_d = gram
        with scope("grammar_mask"):
            mask = torch.gather(ok_d[gs], 1, tc)
            dead = live & ~mask.any(dim=-1)
            health = health | dead.to(health.dtype) * HEALTH_GRAMMAR_DEAD
            live = live & ~dead
        grammar = (gs, tc, next_d)
    nxt = (sample(step_logits, ngen, live) if mask is None
           else sample(step_logits, ngen, live, mask))
    return termination_fold(nxt, step_logits, prev_tok, live, ngen, budget,
                            health, eos_ids, vocab_size, health_check,
                            grammar=grammar)


@dataclasses.dataclass
class _Request:
    prompt_ids: List[int]
    max_tokens: int
    temperature: float
    deadline: Optional[float]
    loop: asyncio.AbstractEventLoop
    out_queue: asyncio.Queue
    cancel: threading.Event
    t_submit: float
    # Per-request sampling seed: token g draws from
    # fold_in(PRNGKey(seed), g), so the transcript depends only on the
    # seed and the logits, never on the batch or a preemption.
    seed: int = 0
    trace: Optional[Trace] = None
    # QoS: the fair-share tenant and the priority lane, read off the
    # caller's QoSContext at submit (none: one interactive anon bucket),
    # the session a token budget charges, and the QoSQueue's stamp of
    # the latest (re-)enqueue, which starvation is judged against.
    tenant: str = ANON_TENANT
    lane: str = LANE_INTERACTIVE
    session: str = ""
    t_enqueue: float = 0.0
    # Preemption: how often this request left a slot (PREEMPT_BUDGET
    # bounds it), when the current preemption began (that wall time is
    # credited to the deadline at resume), the generated ids it resumes
    # from, how many chars of their text the client already holds, and
    # whether the resume has emitted the rest. resume_cause says why the
    # next _replay_slot runs ("preempt"); it is cleared there, so a later
    # replay of another cause is not taken for a preemption's.
    preempt_count: int = 0
    preempt_t0: Optional[float] = None
    resume_ids: Optional[List[int]] = None
    resume_skip: int = 0
    resume_emitted: bool = False
    resume_cause: str = ""
    # The ledger: transcript tokens already billed (delivered, or burned
    # by a quarantine). The SLO books: the first token this request ever
    # delivered (it survives a preemption, so a resumed request's TTFT
    # is its client's first byte), and whether its admission
    # radix-matched at least one full page (the session TTFT's gate).
    ledger_delivered: int = 0
    t_first0: Optional[float] = None
    radix_warm: bool = False
    # The fleet: ``export`` is the live outbound view (the scheduler
    # points its ``ids`` at the generated ids after every consume and
    # its ``blocks`` at the table, so the fleet can carry the request
    # to another replica); ``ttft_exempt`` marks an import whose first
    # byte happened on the donor replica. An import's resume_ids ride
    # _admit_resume, and the donor billed them (ledger_delivered).
    export: Optional[RequestExport] = None
    ttft_exempt: bool = False
    # Containment: the raw prompt text (decode-fault targeting matches
    # it), how often this request was solo-implicated in a poisoned step
    # (it survives resets and parking; past QUARANTINE_RETRY_BUDGET it
    # is quarantined), and whether it stands in the suspect pool a
    # step-wide fault is being bisected over.
    prompt: str = ""
    suspect_count: int = 0
    suspect: bool = False
    # Grammar-constrained decoding: the profile id resolved at submit
    # (the base profile, clamped readonly for the background lane or on
    # request, narrowed by allowed verbs); -1 with no grammar.
    gpid: int = -1


@dataclasses.dataclass
class _Slot:
    req: _Request
    detok: StreamDecoder
    n_prompt: int
    pos: int                      # scheduled device position (upper bound)
    queue_ms: float
    t_admit: float
    prefill_ms: float = 0.0       # admission latency: admit -> first token
    t_first: Optional[float] = None
    chunks_inflight: int = 0      # dispatched-but-unconsumed chunks
    decode_chunks_inflight: int = 0  # the "chunk" subset of chunks_inflight
    exhausted: bool = False       # KV capacity reached; finish at length
    prefix_hit: bool = False      # admission radix-matched a prefix
    # The pool blocks this slot's table maps, in page order, and the
    # admitted (possibly left-truncated) prompt ids — the basis of the
    # radix chain inserted at finish.
    blocks: Optional[List[int]] = None
    pool_ids: Optional[List[int]] = None
    # Grammar: the FSM state over the tokens consumed so far (host
    # truth; the device carries its own copy in _fsm_d), and the
    # in-flight chunks a fast-forward spliced over, whose rows the
    # consume skips.
    gs: int = 0
    stale_chunks: int = 0
    # Speculative decoding: host truth of the device carry at the last
    # arm — the carry token sat at ``anchor_pos`` when ``anchor_g``
    # tokens were generated. A spec chunk advances by what it accepted,
    # not by its width, so the consume re-syncs ``pos`` from these.
    anchor_pos: int = 0
    anchor_g: int = 0


class BatchedTorchEngine(TorchEngine):
    """Engine-protocol implementation with continuous batching."""

    name = "torch-batched"

    #: burst ramp: while admissions keep landing within this window and
    #: slots are free, hold the first chunk so the burst boards it
    #: together (capped at ADMIT_RAMP_MAX_SECS from the first hold).
    ADMIT_RAMP_SECS = 0.03
    ADMIT_RAMP_MAX_SECS = 0.12

    #: group admission's sizes (a group pads to the smallest that holds
    #: it); ``admit_kpads`` caps them by the batch, ``admit_kpads_for``
    #: by the scratch budget at a depth.
    ADMIT_KPADS = (2, 4, 8, 16)

    def __init__(self, *args, batch_size: int = 8, chunk_len: int = 16,
                 chunk_pipe_depth: int = 3,
                 admit_scratch_mb: int = 512,
                 device_termination: bool = True,
                 ragged_attention: str = "auto",
                 decode_attn: str = "auto",
                 kv_page_size: int = 16,
                 kv_pool: bool = True,
                 kv_pool_page: int = 16,
                 kv_pool_blocks: int = 0,
                 radix_cache: bool = True,
                 radix_lru_blocks: int = 0,
                 host_kv_blocks: int = 0,
                 max_queue_depth: int = 64,
                 slot_health_check: bool = True,
                 lane_weights: Optional[dict] = None,
                 tenant_max_queue: int = 0,
                 preempt_wait_ms: float = 500.0,
                 preempt_budget: int = 2,
                 slo_interactive_ms: float = 2000.0,
                 session_token_budget: int = 0,
                 ledger_enable: bool = True,
                 slo_ttft_ms: float = 5000.0,
                 slo_session_ttft_ms: float = 0.0,
                 slo_objective: float = 0.99,
                 slo_windows: tuple = (300, 3600),
                 sentinel_enable: bool = True,
                 sentinel_window: int = 256,
                 sentinel_factor: float = 2.0,
                 sentinel_min_samples: int = 16,
                 perf_baselines=None,
                 quarantine_retry_budget: int = 1,
                 reset_max_per_min: int = 12,
                 watchdog_secs: float = 120.0,
                 startup_grace_secs: float = 900.0,
                 grammar_decode: bool = False,
                 grammar_profile: str = "default",
                 grammar_forced_run_min: int = 4,
                 spec_decode: bool = False,
                 spec_draft_k: int = 4,
                 spec_draft_model: str = "gemma-2b-it",
                 spec_draft_path: Optional[str] = None,
                 spec_draft_seed: Optional[int] = None,
                 spec_draft_params=None,
                 faults=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if chunk_len < 1:
            raise ValueError("chunk_len must be >= 1")
        if chunk_pipe_depth < 1:
            raise ValueError("chunk_pipe_depth must be >= 1")
        # The grammar's FSM word and the speculative accept/reject fold
        # ride the chunk's carry: both need device-side termination.
        if grammar_decode and not device_termination:
            raise ValueError("GRAMMAR_DECODE requires DEVICE_TERMINATION")
        if spec_decode and not device_termination:
            raise ValueError("SPEC_DECODE requires DEVICE_TERMINATION")
        if ragged_attention not in ("auto", "on", "off"):
            raise ValueError(f"RAGGED_ATTENTION must be auto|on|off, got "
                             f"{ragged_attention!r}")
        if decode_attn not in ("auto", "dense", "paged"):
            raise ValueError(f"DECODE_ATTN must be auto|dense|paged, got "
                             f"{decode_attn!r}")
        self.batch_size = batch_size
        self.chunk_len = chunk_len
        self.chunk_pipe_depth = chunk_pipe_depth
        self.device_termination = bool(device_termination)
        # Group admission: the scratch budget, its per-depth kpad caps
        # (filled at start), and the groups served.
        self.admit_scratch_mb = max(0, admit_scratch_mb)
        self._admit_kpad_caps: dict = {}
        self._group_admitted = 0
        self.ragged_attention = ragged_attention
        self.decode_attn = decode_attn
        self.kv_page_size = max(1, kv_page_size)
        self.kv_pool = bool(kv_pool)
        # KV_POOL as asked; ``kv_pool`` is whether the pool serves, which
        # a mesh with a >1 data, pipe or seq axis turns off at start
        # (``kv_pool_mesh_fallback``, the JAX ``_use_pool``).
        self._kv_pool_asked = self.kv_pool
        self._kv_pool_mesh_fallback = False
        if ragged_attention == "on" and not self.kv_pool:
            raise ValueError("RAGGED_ATTENTION=on needs the KV pool "
                             "(KV_POOL=true)")
        self.kv_pool_page = max(1, kv_pool_page)
        if 128 % self.kv_pool_page:
            raise ValueError(
                f"KV_POOL_PAGE must divide the 128-token tile, got "
                f"{self.kv_pool_page}")
        self.kv_pool_blocks = max(0, kv_pool_blocks)
        self.radix_cache = bool(radix_cache)
        self.radix_lru_blocks = max(0, radix_lru_blocks)
        # The two-tier KV: host-RAM capacity (blocks) behind the radix
        # tree; 0 keeps the single-tier world.
        check_host_tier(host_kv_blocks, self.kv_pool, self.radix_cache)
        self.host_kv_blocks = host_kv_blocks
        self.max_queue_depth = max(0, max_queue_depth)
        self.slot_health_check = slot_health_check
        self._pool: Optional[BlockPool] = None
        self._radix: Optional[RadixCache] = None
        self._host_store: Optional[HostBlockStore] = None
        # Slots truncated by pool exhaustion (starved even after radix
        # eviction): an engine counter, so a containment reset keeps it.
        self._pool_starved = 0
        self._slots: List[Optional[_Slot]] = [None] * batch_size
        self._pending_adm: dict = {}    # slot_idx -> staged admission
        self._inflight: list = []
        # The QoS ring: the fair-share admission queue (WDRR over
        # per-tenant sub-queues, tenant caps, displacement, scan-time
        # expiry), the preemption policy, the brownout controller fed
        # the interactive queue wait, and the session token budgets.
        self._admissions = QoSQueue(
            max_depth=self.max_queue_depth,
            tenant_cap=max(0, tenant_max_queue),
            weights=lane_weights, on_expire=self._expire_queued)
        self.preempt_wait_ms = max(0.0, preempt_wait_ms)
        self.preempt_budget = max(0, preempt_budget)
        self._brownout = BrownoutController(slo_interactive_ms)
        self._session_budgets = SessionBudgets(session_token_budget)
        # The telemetry plane, as the JAX engine builds it: the goodput
        # ledger; the SLO engine judging TTFT, queue wait (at the
        # brownout's SLO_INTERACTIVE_MS) and the session TTFT per lane,
        # whose fast-window interactive queue-wait burn the brownout
        # controller reads; the step-time sentinel.
        self.ledger = GoodputLedger(enabled=ledger_enable)
        self._slo = SloEngine(
            {SLO_TTFT: slo_ttft_ms, SLO_QUEUE_WAIT: slo_interactive_ms,
             SLO_SESSION_TTFT: slo_session_ttft_ms},
            objective=slo_objective, windows=tuple(slo_windows))
        self._steptime = StepTimeSentinel(
            enabled=sentinel_enable, window=sentinel_window,
            factor=sentinel_factor, min_samples=sentinel_min_samples,
            baselines=perf_baselines)
        # (t, phase, bucket, (steps, tokens)) of the previous dispatch
        # and whether a chunk was consumed since: the pair that gates a
        # dispatch-to-dispatch interval into a step-time sample, taken
        # only while the pipe never empties (a chunk still in flight at
        # the next dispatch), so an idle gap between requests never
        # reads as a step. A one-deep pipe never satisfies it and
        # records no decode samples, as in the JAX engine.
        self._steptime_pending = None
        self._steptime_consumed = False
        # Pipeline observability: decode steps billed as waste, chunk
        # dispatch/consume/prune counts, fetch-latency samples (drained by
        # the /metrics scrape), the last consumed chunk's device-reported
        # live-slot count, and the ring of chunk events behind
        # /debug/chunks. Scheduler-thread writes, racy scrape reads.
        self._wasted_steps = 0
        self._chunks_dispatched = 0
        self._chunks_consumed = 0
        self._chunks_pruned = 0
        self._fetch_samples: collections.deque = collections.deque(
            maxlen=4096)
        self._last_n_alive = 0
        self._chunk_log: collections.deque = collections.deque(maxlen=512)
        # A torch.profiler capture the scheduler thread runs (profile()):
        # [session, trace_dir, seconds, t_end, future] or None.
        self._profile_req: Optional[list] = None
        self._preemptions = 0          # slots taken from a running request
        self._preempted_tokens = 0     # generated tokens carried across
        self._preempt_times: collections.deque = collections.deque(
            maxlen=512)
        self._preempt_for_lane: Optional[str] = None
        self._rejections = 0           # requests shed at submit/displaced
        # Finish times, engine-wide and per lane: the drain rate that
        # prices a shed's Retry-After (retry_after_hint).
        self._finish_times: collections.deque = collections.deque(maxlen=64)
        self._lane_finish: dict = {}
        # Containment: the fault injector (None in normal serving), the
        # supervisor (policy and counters; the mechanism is
        # _contain_poisoned_step, _reset_decode_state and _replay_slot),
        # the slots parked out of the batch while a bisection probe
        # replays, and the clean chunks the probe consumed so far.
        self.faults = faults
        self.supervisor = EngineSupervisor(
            retry_budget=quarantine_retry_budget,
            max_resets_per_min=reset_max_per_min)
        self._parked: List[_Slot] = []
        self._probation_clean = 0
        # The watchdog: no scheduler progress for watchdog_secs with work
        # in flight fails every waiting request (0 disables it); until
        # the first pipeline entry is consumed, and while an admission
        # runs, the limit widens to startup_grace_secs (the kernels build
        # and load on first use).
        self.watchdog_secs = max(0.0, watchdog_secs)
        self.startup_grace_secs = max(0.0, startup_grace_secs)
        self._last_progress = time.monotonic()
        self._first_consumed = False
        self._stopping = False      # stop() draining: never re-mark ready
        self._warming = False       # start()'s warm-up generate runs
        # Each start() is an epoch: the supervisor and watchdog threads
        # of an earlier one end even when a restart follows the stop
        # within their poll period.
        self._epoch = 0
        self._worker: Optional[threading.Thread] = None
        self._guards: List[threading.Thread] = []   # supervisor, watchdog
        self._running = False
        self._admitting = 0
        # Requests popped off the queue but not yet slotted or errored:
        # if the scheduler thread dies mid-admission, only this list lets
        # the supervisor requeue them.
        self._admitting_reqs: List[_Request] = []
        self._last_admit_t = 0.0
        self._ramp_hold_t0 = None
        #: forward passes run through ``_forward`` (pool prefill chunks,
        #: prologues, decode steps): each launches its attention kernel
        #: once per layer.
        self.forward_steps = 0
        #: decode steps (one query per slot) run by the decode chunks.
        self.decode_steps = 0
        # Grammar-constrained decoding: the runtime is compiled against
        # the tokenizer at start (and kept across restarts); its stacked
        # tables reach the device at dispatch, refreshed by version.
        # Cumulative counters (scheduler-thread writes, racy scrape
        # reads): tokens delivered by forced-run splices, tokens sampled
        # under the mask, dead ends by cause, and splice events.
        self.grammar_decode = bool(grammar_decode)
        self.grammar_profile = grammar_profile
        self.grammar_forced_run_min = max(1, grammar_forced_run_min)
        self._grammar = None
        self._grammar_version = -1
        self._grammar_forced = 0
        self._grammar_masked = 0
        self._grammar_dead_ends: dict = {}
        self._grammar_ff_splices = 0
        # Speculative decoding: the draft model (loaded at start, random
        # from seed + 1 unless spec_draft_seed says otherwise, kept
        # across restarts), its dense per-slot cache (_init_decode_state),
        # whether it still drafts (a draft:die drill ends that), the
        # verify iterations a chunk runs and the tokens its row holds.
        # Cumulative counters (scheduler-thread writes, racy reads):
        # proposals, accepted proposals, degradations, and the draft's
        # and the verifier's forwards.
        self.spec_decode = bool(spec_decode)
        self.spec_draft_k = int(spec_draft_k)
        self.spec_draft_model = spec_draft_model
        self.spec_draft_path = spec_draft_path
        self.spec_draft_seed = spec_draft_seed
        self._draft_params = spec_draft_params
        self._draft_cfg = (spec_draft_config(self.spec_draft_k,
                                             spec_draft_model,
                                             self.model_cfg, self.kv_pool)
                           if self.spec_decode else None)
        self._draft_cache: Optional[KVCache] = None
        # Whether the draft world rides the mesh, and whether its KV
        # serves replicated (its KV heads do not divide the model axis).
        self._draft_sharded = False
        self._draft_kv_fallback = False
        self._spec_live = False
        self._spec_steps = 0
        self._chunk_tokens = self.chunk_len
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_degraded = 0
        self.draft_forward_steps = 0
        self.verify_steps = 0
        # Resolved at startup (_resolve_regime).
        self._decode_impl = ""
        self._attention_regime = ""

    @classmethod
    def from_config(cls, cfg, faults=None, devices: Optional[list] = None
                    ) -> "BatchedTorchEngine":
        """``faults``: the factory's one shared injector (None: no
        drill); ``devices``: the mesh's devices when they are not the
        distinct cards (``TorchEngine.from_config``)."""
        return cls(
            get_config(cfg.model_name),
            batch_size=cfg.decode_batch_size,
            chunk_len=cfg.chunk_len,
            chunk_pipe_depth=cfg.chunk_pipe_depth,
            admit_scratch_mb=cfg.admit_scratch_mb,
            device_termination=cfg.device_termination,
            ragged_attention=cfg.ragged_attention,
            decode_attn=cfg.decode_attn,
            kv_page_size=cfg.kv_page_size,
            kv_pool=cfg.kv_pool,
            kv_pool_page=cfg.kv_pool_page,
            kv_pool_blocks=cfg.kv_pool_blocks,
            radix_cache=cfg.radix_cache,
            radix_lru_blocks=cfg.radix_lru_blocks,
            host_kv_blocks=cfg.host_kv_blocks,
            max_queue_depth=cfg.max_queue_depth,
            slot_health_check=cfg.slot_health_check,
            lane_weights=cfg.lane_weight_map,
            tenant_max_queue=cfg.tenant_max_queue,
            preempt_wait_ms=cfg.preempt_wait_ms,
            preempt_budget=cfg.preempt_budget,
            slo_interactive_ms=cfg.slo_interactive_ms,
            session_token_budget=cfg.qos_session_token_budget,
            ledger_enable=cfg.ledger_enable,
            slo_ttft_ms=cfg.slo_ttft_ms,
            slo_session_ttft_ms=cfg.slo_session_ttft_ms,
            slo_objective=cfg.slo_objective,
            slo_windows=cfg.slo_window_list,
            sentinel_enable=cfg.sentinel_enable,
            sentinel_window=cfg.sentinel_window,
            sentinel_factor=cfg.sentinel_factor,
            sentinel_min_samples=cfg.sentinel_min_samples,
            perf_baselines=cfg.perf_baselines or None,
            quarantine_retry_budget=cfg.quarantine_retry_budget,
            reset_max_per_min=cfg.engine_reset_max_per_min,
            watchdog_secs=cfg.engine_watchdog_secs,
            startup_grace_secs=cfg.engine_startup_grace_secs,
            grammar_decode=cfg.grammar_decode,
            grammar_profile=cfg.grammar_profile,
            grammar_forced_run_min=cfg.grammar_forced_run_min,
            spec_decode=cfg.spec_decode,
            spec_draft_k=cfg.spec_draft_k,
            spec_draft_model=cfg.spec_draft_model,
            spec_draft_path=cfg.spec_draft_path,
            faults=faults,
            devices=devices,
            **engine_kwargs(cfg),
        )

    # ------------------------------------------------------------ startup

    async def start(self) -> None:
        self._warming = True
        try:
            await super().start()
        finally:
            self._warming = False

    def _start_blocking(self) -> None:
        t0 = time.monotonic()
        self._stopping = False
        self._first_consumed = False    # re-arm the cold-start grace
        self._setup_mesh()
        if (self.spec_decode and self.mesh is not None and any(
                self.mesh.shape[a] > 1 for a in ("data", "pipe", "seq"))):
            raise ValueError(
                "SPEC_DECODE does not compose with a mesh that has a "
                ">1 data/pipe/seq axis (MESH_SHAPE); use a tensor/"
                "expert-parallel mesh or disable one of them")
        self._load()
        # The pool's blocks are shared by every slot, so they never split
        # over data: a mesh with a >1 data/pipe/seq axis serves the dense
        # ladder, loudly (the JAX engine's rule).
        mesh_pool_ok = self.mesh is None or all(
            self.mesh.shape[a] == 1 for a in ("data", "pipe", "seq"))
        self.kv_pool = self._kv_pool_asked and mesh_pool_ok
        self._kv_pool_mesh_fallback = self._kv_pool_asked and not \
            mesh_pool_ok
        if self._kv_pool_mesh_fallback:
            logger.warning(
                "KV_POOL does not compose with data/pipe/seq mesh axes "
                "(mesh %s); falling back to the dense KV ladder",
                dict(self.mesh.shape))
        cfg = self.model_cfg
        if self.grammar_decode and self._grammar is None:
            self._grammar_start()
        if self.spec_decode:
            self._spec_load()
        self._resolve_regime()
        if not self.kv_pool:
            self._init_prefix_cache()
            if self._prefix is not None:
                # The group admission's kpad caps at every suffix
                # scratch depth a prefix hit can take.
                P = self._prefix.n
                self._cap_admit_kpads(sorted({
                    d for d in (round_kv_limit(P + b, self.max_seq_len)
                                for b in self.prefill_buckets)
                    if d is not None}))
        self._eos_d = torch.tensor(sorted(set(cfg.eos_ids)),
                                   dtype=torch.int32, device=self.device)
        self._init_decode_state()
        self._pool_preload_system_prompt()
        self._running = True
        self._worker = threading.Thread(target=self._worker_main,
                                        name="torch-batcher", daemon=True)
        self._worker.start()
        # The scheduler-death supervisor, and the hang watchdog.
        self._epoch += 1
        self._guards = [threading.Thread(
            target=self._supervise_scheduler, args=(self._epoch,),
            name="torch-batcher-supervisor", daemon=True)]
        if self.watchdog_secs > 0:
            self._guards.append(threading.Thread(
                target=self._watchdog_loop, args=(self._epoch,),
                name="torch-batcher-watchdog", daemon=True))
        for t in self._guards:
            t.start()
        logger.info("BatchedTorchEngine ready on %s in %.1fs: %d slots, "
                    "%s regime (decode %s), %s, chunk %d, pipe %d deep, "
                    "%s termination", self.device,
                    time.monotonic() - t0, self.batch_size,
                    self._attention_regime, self._decode_impl,
                    (f"pool {self._pool_n_blocks} blocks x "
                     f"{self.kv_pool_page} tokens" if self.kv_pool
                     else f"dense cache of {self._S_alloc} positions"),
                    self.chunk_len, self.chunk_pipe_depth,
                    "device" if self.device_termination else "host-scan")

    def _grammar_start(self) -> None:
        """Compile the kubectl grammar against this tokenizer (host numpy
        truth), after the boot-time cross-check with the safety ring."""
        from ..constrain import GrammarRuntime, assert_safety_consistent

        assert_safety_consistent()
        self._grammar = GrammarRuntime(
            self.tokenizer, self.model_cfg.vocab_size,
            self.model_cfg.eos_ids, profile=self.grammar_profile,
            forced_run_min=self.grammar_forced_run_min)
        h = self._grammar.health()
        logger.info("grammar-constrained decode on: profile=%s hash=%s "
                    "states=%d classes=%d", self.grammar_profile,
                    h["grammar_hash"], h["states"], h["classes"])

    def _spec_load(self) -> None:
        """The draft model, as the JAX engine loads it: the caller's
        parameters (kept across restarts), else the checkpoint at
        ``spec_draft_path``, else a random init from ``spec_draft_seed``
        (default ``seed + 1``), always at the engine dtype and never
        quantized (its config was checked at construction). On a mesh the
        draft world rides it (JAX ``engine/batcher.py:1480-1525``): its
        weights split through ``shard_params`` as the target's, its cache
        per ``draft_cache_specs`` (``_init_decode_state``), replicated
        when its KV heads do not divide the model axis
        (``draft_kv_fallback``, loud)."""
        dcfg = self._draft_cfg
        if self._draft_params is None and self.spec_draft_path:
            from ..models.convert import convert_hf_checkpoint

            logger.info("Loading draft checkpoint from %s",
                        self.spec_draft_path)
            self._draft_params = convert_hf_checkpoint(
                dcfg, self.spec_draft_path, dtype=self.dtype,
                device=self.device)
        elif self._draft_params is None:
            dseed = (self.spec_draft_seed
                     if self.spec_draft_seed is not None
                     else self.seed + 1)
            logger.warning("No SPEC_DRAFT_PATH; random-initializing draft "
                           "%s (toy/dev mode, seed %d)", dcfg.name, dseed)
            gen = torch.Generator(device=self.device).manual_seed(dseed)
            self._draft_params = init_params(gen, dcfg, dtype=self.dtype,
                                             device=self.device)
        self._draft_sharded = self.mesh is not None and self.mesh.size > 1
        self._draft_kv_fallback = draft_kv_fallback(self.mesh, dcfg)
        if self._draft_sharded and not isinstance(self._draft_params,
                                                  ShardedParams):
            self._draft_params = shard_params(self._draft_params, self.mesh,
                                              dcfg)
        if self._draft_kv_fallback:
            logger.warning(
                "draft %s KV heads (%d) do not divide the mesh's model "
                "axis (%d); draft KV serves replicated (gather fallback)",
                dcfg.name, dcfg.n_kv_heads, self.mesh.shape["model"])

    def _resolve_regime(self) -> None:
        """The JAX engine's startup resolution (its mesh branches on the
        ``model`` axis included): the decode attention (``_decode_impl``:
        ragged, paged or dense), the regime ``kv_pool_health`` reports,
        the page, the speculative chunk's geometry, the KV span
        ``_S_alloc`` and the decode KV buckets."""
        cfg = self.model_cfg
        on_card = self.device.type == "cuda"
        pipe = self.mesh.pp if self.mesh is not None else 1
        impl, page = resolve_decode_attn(
            self.decode_attn, cfg, kv_quant=self.kv_quant,
            page_size=(self.kv_pool_page if self.kv_pool
                       else self.kv_page_size),
            device=self.device, dtype=self.dtype, pipe=pipe)
        if impl == "paged" and self.kv_quant:
            # No kernel reads int8 KV (nor does the JAX package's).
            if self.kv_pool:
                logger.warning(
                    "DECODE_ATTN=paged does not read int8 KV; pool "
                    "decode uses the gather path (dense attention)")
            else:
                logger.warning("DECODE_ATTN=paged does not read int8 KV; "
                               "falling back to the dense KV ladder")
            impl = "dense"
        if impl == "paged" and pipe > 1 and not self.kv_pool:
            # The pipeline stages read dense (JAX engine/batcher.py:1698).
            logger.warning("paged decode attention does not compose "
                           "with a pipe mesh axis; falling back to dense")
            impl = "dense"
        if (impl == "paged" and on_card
                and not paged_supported(page, cfg.head_dim, 1, self.dtype)):
            raise ValueError(
                f"DECODE_ATTN=paged: the paged kernel cannot serve page "
                f"{page}, head_dim {cfg.head_dim}, dtype {self.dtype}")
        if self.kv_pool:
            if page != self.kv_pool_page:
                logger.info("DECODE_ATTN=auto raises KV_POOL_PAGE %d -> %d",
                            self.kv_pool_page, page)
                self.kv_pool_page = page
            use_ragged = self.ragged_attention != "off"
            if use_ragged and not self.device_termination:
                logger.warning(
                    "RAGGED_ATTENTION needs DEVICE_TERMINATION (staged "
                    "admissions arm inside the chunk carry); serving "
                    "the legacy ladder")
                use_ragged = False
            if use_ragged and self.kv_quant:
                logger.warning(
                    "RAGGED_ATTENTION: the ragged pool kernel reads "
                    "bf16 KV; int8 KV serves the gather path")
                use_ragged = False
            tp = self.mesh.tp if self.mesh is not None else 1
            if impl == "paged" and not kernel_heads_divide(cfg, tp):
                # The sharded pool kernels split Q and KV heads together
                # (whole KV groups per shard); geometries that don't
                # divide serve the gather path.
                logger.warning(
                    "paged pool decode needs KV (%d) and H (%d) "
                    "divisible by the model axis (%d); using the "
                    "gather path", cfg.n_kv_heads, cfg.n_heads, tp)
                impl = "dense"
            if use_ragged and not kernel_heads_divide(cfg, tp):
                logger.warning(
                    "ragged pool attention needs KV (%d) and H (%d) "
                    "divisible by the model axis (%d); using the "
                    "gather path", cfg.n_kv_heads, cfg.n_heads, tp)
                use_ragged = False
            if use_ragged:
                impl = "ragged"
            if impl == "paged" and self.spec_decode:
                # The paged decode kernel is single-query; a verify
                # window spans k + 1 tokens.
                logger.info("SPEC_DECODE: verify windows are multi-token; "
                            "decode attention uses the gather path")
                impl = "dense"
            self._attention_regime = {"ragged": "ragged",
                                      "paged": "paged"}.get(impl, "gather")
            # Every per-slot table covers max_seq_len in whole pages; 0
            # blocks = auto, the dense envelope (every slot at full
            # length), which prefix sharing then oversubscribes. A
            # speculative chunk's verify window reads and writes up to
            # k positions past the last one a plain chunk reaches, so
            # the span takes the JAX engine's slack of one chunk's
            # tokens: a near-capacity slot's last window stays inside
            # its table.
            span = self.max_seq_len
            if self.spec_decode:
                self._spec_steps = max(1, self.chunk_len
                                       // (self.spec_draft_k + 1))
                self._chunk_tokens = self._spec_steps * (
                    self.spec_draft_k + 1)
                span += max(self.chunk_len, self._chunk_tokens)
            S_alloc = -(-span // page) * page
            self._pool_max_pages = S_alloc // page
            self._pool_n_blocks = (self.kv_pool_blocks
                                   or self.batch_size * self._pool_max_pages)
            if self._pool_n_blocks < self._pool_max_pages:
                raise ValueError(
                    f"KV_POOL_BLOCKS={self._pool_n_blocks} cannot hold even "
                    f"one full-length sequence ({self._pool_max_pages} "
                    f"pages)")
            # The pool prefill of the legacy ladder gathers a kv_limit of
            # its own ladder, so a short prompt never attends the span.
            self._pool_prefill_kv_buckets = kv_bucket_ladder(S_alloc)
        else:
            if page != self.kv_page_size:
                logger.info("DECODE_ATTN=auto: GQA model (%d q heads per KV "
                            "head) serves paged decode; KV_PAGE_SIZE %d -> "
                            "%d", cfg.q_per_kv, self.kv_page_size, page)
                self.kv_page_size = page
            self._attention_regime = impl
            # One chunk of slack past max_seq: a near-capacity slot's last
            # chunk runs at full length without writing past the cache.
            S_alloc = self.max_seq_len + self.chunk_len
            if impl == "paged":
                S_alloc = -(-S_alloc // page) * page
        self._decode_impl = impl
        self._S_alloc = S_alloc
        self._spec_live = self.spec_decode
        if self.spec_decode:
            logger.info("speculative decode on: draft=%s k=%d (%d verify "
                        "iterations x %d tokens per chunk)",
                        self._draft_cfg.name, self.spec_draft_k,
                        self._spec_steps, self.spec_draft_k + 1)
        # Paged and ragged decode cost tracks each slot's live pages in one
        # call; the dense read attends over the smallest bucket covering
        # every live position.
        self._kv_buckets = ((S_alloc,) if impl in ("paged", "ragged")
                            else kv_bucket_ladder(S_alloc))

    def _init_decode_state(self) -> None:
        """(Re-)initialize the device-resident scheduler state: the zeroed
        KV pool, the host allocator, radix tree and tables (or the zeroed
        dense cache), the draft's zeroed cache under speculative decode,
        the per-slot carry vectors and the all-False ``decode:nan`` mask.
        Called at start and by the containment reset (which condemns
        every cached block): the old device buffers are dropped before
        the new ones are allocated, so a reset's peak is steady state,
        not steady state plus a second pool."""
        N = self.batch_size
        dev = self.device
        self._cache = self._draft_cache = None
        self._tok_d = self._pos_d = self._active_d = None
        self._ngen_d = self._budget_d = self._seeds_d = self._temps_d = None
        if self.kv_pool:
            self._cache = KVCache.pool(self.model_cfg, self._pool_n_blocks,
                                       self.kv_pool_page, dtype=self.dtype,
                                       device=dev, kv_quant=self.kv_quant,
                                       mesh=self.mesh)
            prev_pool, prev_radix = self._pool, self._radix
            prev_store = self._host_store
            self._pool = BlockPool(self._pool_n_blocks, self.kv_pool_page)
            # A reset condemns the host tier too: its payloads were
            # gathered from the poisoned device world, so BOTH tiers
            # restart empty.
            self._host_store = (HostBlockStore(self.host_kv_blocks)
                                if self.host_kv_blocks > 0 else None)
            self._radix = (RadixCache(self._pool,
                                      max_blocks=self.radix_lru_blocks,
                                      host_store=self._host_store,
                                      offload_fn=self._pool_offload_block,
                                      onload_fn=self._pool_onload_block,
                                      faults=self.faults)
                           if self.radix_cache else None)
            # Cumulative counters survive the rebuild: the /metrics
            # delta-mirror must never see totals go backwards.
            if prev_pool is not None:
                self._pool.carry_counters(prev_pool)
            if prev_radix is not None and self._radix is not None:
                self._radix.carry_counters(prev_radix)
            if prev_store is not None and self._host_store is not None:
                self._host_store.carry_counters(prev_store)
            self._tables = np.full((N, self._pool_max_pages),
                                   self._pool_n_blocks, np.int32)
        else:
            self._cache = KVCache.zeros(self.model_cfg, N, self._S_alloc,
                                        dtype=self.dtype, device=dev,
                                        kv_quant=self.kv_quant,
                                        mesh=self.mesh, split_rows=True)
        self._tok_d = torch.zeros((N, 1), dtype=torch.int32, device=dev)
        self._pos_d = torch.zeros((N, 1), dtype=torch.int32, device=dev)
        self._active_d = torch.zeros((N,), dtype=torch.bool, device=dev)
        self._ngen_d = torch.zeros((N,), dtype=torch.int32, device=dev)
        self._budget_d = torch.ones((N,), dtype=torch.int32, device=dev)
        # Sampling config: each slot's seed and temperature on the device
        # (the seeded sampler's inputs), and the temperatures on the host
        # too, so an all-greedy batch never touches the sampled path.
        self._seeds_d = torch.zeros((N,), dtype=torch.int64, device=dev)
        self._temps_d = torch.zeros((N,), dtype=torch.float32, device=dev)
        self._temps = [0.0] * N
        # The decode:nan seam's input when no drill is armed: a fixed
        # [N] bool tensor, so the chunk keeps one input set.
        self._no_corrupt_d = torch.zeros((N,), dtype=torch.bool, device=dev)
        # Each slot's FSM state word (global state), re-armed from host
        # truth by every admission and replay.
        self._fsm_d = (torch.zeros((N,), dtype=torch.int64, device=dev)
                       if self._grammar is not None else None)
        # The draft's dense per-slot cache, rebuilt with the rest (a
        # replay re-prefills it from host truth, as the pool's blocks).
        if self.spec_decode:
            self._draft_cache = KVCache.zeros(self._draft_cfg, N,
                                              self._S_alloc,
                                              dtype=self.dtype, device=dev,
                                              mesh=self.mesh)

    # ------------------------------------------------ block-paged KV pool

    def _tables_d(self, tables: np.ndarray) -> torch.Tensor:
        """Device copy of a block-table snapshot (through pinned staging:
        the host rewrites its table rows while the copy may still be
        queued)."""
        return self._h2d(tables)

    def _forward(self, tokens, positions, tables, *, attn_impl: str,
                 kv_limit=None, q_lens=None, write_mask=None,
                 logits_at=None):
        """One forward over the serving cache (``tables`` None for the
        dense cache). The tokens that write KV are the live ones: the
        write mask, as [B, S], is also the forward's ``token_mask`` (the
        JAX engine's ``live[:, None]``, ``wmask`` and prefill ``mask``),
        and the MoE MLP runs under the engine's ``moe_impl``."""
        self.forward_steps += 1
        token_mask = None
        if write_mask is not None:
            token_mask = (write_mask if write_mask.dim() == 2
                          else write_mask[:, None])
        logits, self._cache = forward(
            self.params, self.model_cfg, tokens, positions, self._cache,
            kv_limit=kv_limit, attn_impl=attn_impl,
            page_size=self.kv_page_size, logits_at=logits_at,
            write_mask=write_mask, block_tables=tables, q_lens=q_lens,
            token_mask=token_mask, moe_impl=self.moe_impl, mesh=self.mesh)
        return logits

    def _run_arm(self, slot_idx: int, n_prompt: int, first_tok,
                 temperature: float, max_toks: int, seed: int,
                 ngen0: int) -> None:
        """Write one slot's carry and config into the device vectors (the
        JAX arm program): carry token (an int, or a 0-d device tensor that
        never visits the host), position, live flag, generated count,
        token budget, sampling seed and temperature. Each is an in-place
        fill queued behind the chunks in flight (a host value is a
        kernel argument, never an upload), so the slot arms on the
        latest carry."""
        self._tok_d[slot_idx, 0].fill_(first_tok)
        self._pos_d[slot_idx, 0].fill_(n_prompt)
        self._active_d[slot_idx].fill_(max_toks > ngen0)
        self._ngen_d[slot_idx].fill_(ngen0)
        self._budget_d[slot_idx].fill_(max_toks)
        self._seeds_d[slot_idx].fill_(int(seed))
        self._temps_d[slot_idx].fill_(float(temperature))
        self._temps[slot_idx] = float(temperature)

    def _run_cow(self, src: int, dst: int, rows: int) -> None:
        """Copy-on-write: the first ``rows`` KV rows of pool block ``src``
        into block ``dst``, every layer, in place (payload and scales of
        an int8 pool)."""
        with scope("kv_splice"):
            for kv in (self._cache.k, self._cache.v):
                kv_map(lambda a: a[:, dst, :rows].copy_(a[:, src, :rows]),
                       kv)

    # ------------------------------------------ host-tier block transfer
    #
    # Both copies run on torch's current stream, where every kernel of
    # the engine is queued. A demote's D2H read (alloc_with_evict at
    # admission or at coverage growth) is synchronous: it waits for every
    # chunk in flight, stalling the pipe for that one read, and so never
    # reads a block a queued kernel still writes (a demoted block is a
    # cached one, which no slot's chunk writes anyway). An onload's H2D
    # copy goes through pinned staging without waiting (_h2d); it and
    # its copy_ are queued after every chunk already in flight, which
    # could only touch the block's previous (freed) contents, and before
    # any kernel that reads it (the table that maps it is uploaded after
    # the match returns).

    def _kv_leaves(self) -> list:
        """The pool's K/V leaves in the JAX cache pytree's order: ``k``
        then ``v``, and under ``KV_QUANT=int8`` each ``QuantKV``'s ``q``
        then ``s`` (so the checksum covers the scales too). On a mesh
        each of ``k`` and ``v`` walks its shards in order: a payload
        holds every shard's rows (a replicated KV head once per shard),
        and an onload writes every shard's own leaves."""
        out = []
        for kv in (self._cache.k, self._cache.v):
            parts = kv.shards if isinstance(kv, ShardedKV) else (kv,)
            for part in parts:
                out.extend((part.q, part.s) if isinstance(part, QuantKV)
                           else (part,))
        return out

    def _pool_offload_block(self, block: int) -> np.ndarray:
        """Demote path: pool block ``block`` across every K/V leaf as one
        flat ``uint8`` payload (each leaf's ``[L, page, ...]`` slice,
        row-major, in leaf order — the JAX engine's bytes for the same
        geometry). The slice is a strided view: copied contiguous and
        viewed as bytes on the device (numpy has no bfloat16), then
        read back synchronously."""
        parts = [leaf[:, block].contiguous().view(torch.uint8).reshape(-1)
                 for leaf in self._kv_leaves()]
        return torch.cat(parts).cpu().numpy()

    def _pool_onload_block(self, block: int, data: np.ndarray) -> None:
        """Promote path: a verified payload's bytes back into pool block
        ``block``, split by ``_pool_offload_block``'s leaf walk, each part
        written in place through ``copy_`` (the JAX engine's
        ``.at[:, block].set``)."""
        dsts = [leaf[:, block] for leaf in self._kv_leaves()]
        want = sum(d.numel() * d.element_size() for d in dsts)
        raw = np.asarray(data, dtype=np.uint8).reshape(-1)
        if raw.size != want:
            raise ValueError(f"host KV payload of {raw.size} bytes for a "
                             f"{want}-byte block")
        flat = self._h2d(raw)
        off = 0
        for dst in dsts:
            n = dst.numel() * dst.element_size()
            dst.copy_(flat[off:off + n].view(dst.dtype).reshape(dst.shape))
            off += n

    def _pool_alloc(self, n: int) -> Optional[List[int]]:
        """Allocate with radix-eviction backpressure."""
        return alloc_with_evict(self._pool, self._radix, n)

    def _pool_map_prefix(self, ids: List[int],
                         match_all: bool = False) -> tuple:
        """A slot's block chain: shared full blocks + tail COW + fresh
        blocks (``kv_pool.map_prefix``). ``match_all`` (a resume) lets
        the match cover every id: its carry token is forced, so no
        last position must run for logits. Returns (blocks, m)."""
        return map_prefix(self._pool, self._radix, ids, match_all=match_all,
                          cow=self._run_cow)

    def _pool_kv_limit(self, needed: int) -> int:
        """Smallest prefill KV bucket covering ``needed`` positions (every
        bucket is a whole page count: a 128-tiled ladder, and the page
        divides 128)."""
        needed = min(needed, self._S_alloc)
        return next(b for b in self._pool_prefill_kv_buckets
                    if b >= needed)

    def _pool_prefill_shape(self, n: int) -> tuple:
        """The gather path's one prefill shape for a prompt of ``n``
        tokens: ``kv_limit`` the KV rung covering the prompt, and every
        window padded to the largest prefill bucket within it. The shape
        depends on the prompt alone, never on where the radix match split
        it, so a token's K/V row and the last logits come out of the same
        GEMM shapes whichever admission computes them (on the card the
        GEMM library picks its kernel, and so its rounding, by shape).
        Returns ``(bucket, kv_limit)``."""
        kv_limit = self._pool_kv_limit(n)
        bucket = max((b for b in self.prefill_buckets if b <= kv_limit),
                     default=self.prefill_buckets[0])
        return bucket, kv_limit

    def _pool_prefill_span(self, table_row: np.ndarray, ids: List[int],
                           start: int) -> torch.Tensor:
        """Prefill ``ids[start:]`` at absolute offsets through one table
        row: in the ragged regime through the ragged kernel (q_len = the
        window's valid length) in windows of the largest prefill bucket,
        else through the gather program at the prompt's one
        ``_pool_prefill_shape``, flash where it tiles the shape. Returns
        the last valid position's logits [1, vocab]."""
        n = len(ids)
        tables_d = self._tables_d(table_row[None])
        ragged = self._decode_impl == "ragged"
        if ragged:
            width, kv_limit = self.prefill_buckets[-1], None
        else:
            width, kv_limit = self._pool_prefill_shape(n)
        offset, logits = start, None
        while offset < n:
            L = min(width, n - offset)
            bucket = (next(b for b in self.prefill_buckets if b >= L)
                      if ragged else width)
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :L] = ids[offset:offset + L]
            cols = torch.arange(bucket, device=self.device)
            logits = self._forward(
                self._h2d(tokens), (offset + cols)[None].to(torch.int32),
                tables_d,
                attn_impl=("ragged" if ragged
                           else self._prefill_impl_for(bucket, kv_limit)),
                kv_limit=kv_limit,
                q_lens=torch.full((1,), L, dtype=torch.int32,
                                  device=self.device),
                write_mask=(cols < L)[None],
                logits_at=torch.full((1,), L - 1, dtype=torch.int64,
                                     device=self.device))
            offset += L
        return logits[:, 0]

    def _pool_ensure_coverage(self, idx: int, slot: _Slot,
                              chunk_tokens: Optional[int] = None) -> bool:
        """Grow the slot's table to cover the next chunk's writes
        (``chunk_tokens`` of them: a speculative chunk's row is wider
        than ``chunk_len``). False = pool exhausted even after radix
        eviction: the slot is marked exhausted, counted as starved, and
        finishes at its current length (truncation, never corruption)."""
        target = min(slot.pos + (chunk_tokens or self.chunk_len),
                     self._S_alloc)
        need = pages_for(target, self.kv_pool_page)
        while len(slot.blocks) < need:
            b = self._pool_alloc(1)
            if b is None:
                slot.exhausted = True
                self._pool_starved += 1
                if slot.req.trace is not None:
                    slot.req.trace.event(
                        f"engine: kv pool exhausted at position "
                        f"{slot.pos} — finishing at current length")
                logger.warning(
                    "kv pool exhausted: slot truncated at position %d "
                    "(%d blocks live, %d cached)", slot.pos,
                    self._pool.n_blocks - self._pool.free_count,
                    self._radix.cached_block_count()
                    if self._radix else 0)
                return False
            self._tables[idx, len(slot.blocks)] = b[0]
            slot.blocks.extend(b)
            if slot.req.export is not None:
                slot.req.export.blocks = list(slot.blocks)
        return True

    def _pool_release_slot(self, idx: int, slot: _Slot,
                           cache_chain: bool = True) -> None:
        """Release a leaving slot's block refs. ``cache_chain`` first
        inserts the request's verified KV chain (admitted prompt +
        emitted[:-1], rows the device has certainly written) into the
        radix tree, so the next turn re-maps those blocks."""
        self._tables[idx, :] = self._pool_n_blocks
        if not slot.blocks:
            slot.blocks = []
            return
        if cache_chain and self._radix is not None and slot.pool_ids:
            gen = list(slot.detok.ids)
            chain = slot.pool_ids + (gen[:-1] if gen else [])
            chain = chain[:len(slot.blocks) * self.kv_pool_page]
            self._radix.insert(chain, slot.blocks)
        self._pool.decref(slot.blocks)
        slot.blocks = []

    def _admit_one_pool(self, req: _Request) -> None:
        """Radix-match the prompt and map shared blocks copy-on-write.
        The ragged regime STAGES the unmatched suffix for the next
        chunk's ragged prologue (which prefills it, samples the first
        token and arms the slot in the same forward as everyone else's
        decode step); only a head beyond the widest admission window
        prefills here. The legacy ladder prefills the whole suffix here,
        samples the first token and arms the slot (``_arm_first``).

        Under the grammar, the forced run from the START state (``kubectl
        `` and on, when it reaches GRAMMAR_FORCED_RUN_MIN or ends the
        command) rides the same prefill as the prompt: the slot starts at
        generation index ``len(run)``. A run that ends the request
        (budget or EOS next) finishes it here; under pool pressure the
        run is decoded instead."""
        slot_idx = self._slots.index(None)
        t_adm = time.monotonic()
        wait_ms = (t_adm - req.t_submit) * 1000.0
        self._brownout.note_queue_wait(req.lane, wait_ms, now=t_adm)
        self._slo.note(SLO_QUEUE_WAIT, req.lane, wait_ms, now=t_adm)
        ids = list(req.prompt_ids)
        max_prompt = self.max_seq_len - max(1, req.max_tokens)
        if len(ids) > max_prompt:
            ids = ids[-max_prompt:]
        n_prompt = len(ids)
        run: List[int] = []
        ends_eos = False
        gs1 = -1
        if self._grammar is not None and req.gpid >= 0:
            gs1 = self._grammar.start_state(req.gpid)
            run, ends_eos, gs_end = self._grammar.forced_run(
                gs1, req.max_tokens)
            if len(run) >= self.grammar_forced_run_min or (
                    ends_eos and run):
                gs1 = gs_end
            else:
                run, ends_eos = [], False
        full = ids + run
        blocks, m = self._pool_map_prefix(ids)
        # A seating that radix-matched at least one full page is a warm
        # re-admission: the only kind the session TTFT SLO judges.
        req.radix_warm = m >= self.kv_pool_page
        first_d = staged = None
        try:
            grow = pages_for(len(full), self.kv_pool_page) - len(blocks)
            if grow > 0:
                extra = self._pool_alloc(grow)
                if extra is None:       # pool pressure: decode the run
                    run, ends_eos, full = [], False, ids
                    gs1 = self._grammar.start_state(req.gpid)
                else:
                    blocks = blocks + extra
            self._tables[slot_idx, :] = self._pool_n_blocks
            self._tables[slot_idx, :len(blocks)] = blocks
            done_at_admit = bool(run) and (len(run) >= req.max_tokens
                                           or ends_eos)
            span = full[:-1] if done_at_admit else full
            if done_at_admit:
                # The run's rows still back the radix chain at finish.
                self._pool_prefill_span(self._tables[slot_idx], span, m)
            elif self._decode_impl == "ragged":
                stage_start = max(m, len(span) - self.prefill_buckets[-1])
                if stage_start > m:
                    self._pool_prefill_span(self._tables[slot_idx],
                                            span[:stage_start], m)
                staged = dict(ids=span[stage_start:], start=stage_start)
                # The slot's budget, count, live flag and FSM state go to
                # the device now; its token, position and first sample
                # come from the prologue.
                self._run_arm(slot_idx, stage_start, 0, req.temperature,
                              req.max_tokens, req.seed, len(run))
                if gs1 >= 0:
                    self._grammar_arm(slot_idx, gs1)
                # The draft mirrors the whole span now: the prologue's
                # draft forward reads rows below the window's start.
                self._draft_prefill_slot(slot_idx, span)
            else:
                last_logits = self._pool_prefill_span(
                    self._tables[slot_idx], span, m)
                first_d = self._arm_first(slot_idx, last_logits, req,
                                          n_prompt + len(run), gs=gs1,
                                          ngen0=len(run))
                # The draft conditions on the same prompt (and run)
                # before it drafts; it has no radix tree, so it prefills
                # the whole span (pages the match promoted from the host
                # tier included).
                self._draft_prefill_slot(slot_idx, span)
        except Exception:
            self._tables[slot_idx, :] = self._pool_n_blocks
            self._pool.decref(blocks)
            raise
        slot = _Slot(
            req=req, detok=StreamDecoder(self.tokenizer), n_prompt=n_prompt,
            pos=n_prompt + len(run), queue_ms=wait_ms, t_admit=t_adm,
            chunks_inflight=(0 if done_at_admit or staged is not None
                             else 1),
            prefix_hit=m > 0, blocks=blocks, pool_ids=ids, gs=gs1,
            anchor_pos=n_prompt + len(run), anchor_g=1 + len(run))
        if req.export is not None:
            req.export.blocks = list(blocks)
        self._slots[slot_idx] = slot
        if run:
            piece = slot.detok.push(*run)
            if req.export is not None:
                req.export.ids = list(slot.detok.ids)
            if req.t_first0 is None:
                req.t_first0 = time.monotonic()
            if piece is not None:
                self._emit(req, "token", piece)
            self._grammar_forced += len(run)
            self._grammar_ff_splices += 1
            if req.trace is not None:
                req.trace.event(
                    f"grammar: admission forced run of {len(run)} tokens "
                    f"spliced with the prompt prefill")
        if done_at_admit:
            slot.t_first = time.monotonic()
            self._finish(slot_idx, "stop" if ends_eos
                         and len(run) < req.max_tokens else "length")
        elif staged is not None:
            self._pending_adm[slot_idx] = staged
        else:
            self._inflight.append(("first", self._to_host_async(first_d),
                                   slot, slot_idx))
        self._last_admit_t = time.monotonic()

    def _admit_one_dense(self, req: _Request) -> None:
        """The dense KV ladder's admission (the JAX ``_admit_one``):
        prefill into a scratch cache (the system-prompt prefix splice, one
        bucket, or chunked), sample the first token, splice the scratch
        rows into the slot and arm it. The first token reaches the client
        through a ``("first", ...)`` entry of the in-flight list."""
        slot_idx = self._slots.index(None)
        t_adm = time.monotonic()
        wait_ms = (t_adm - req.t_submit) * 1000.0
        self._brownout.note_queue_wait(req.lane, wait_ms, now=t_adm)
        self._slo.note(SLO_QUEUE_WAIT, req.lane, wait_ms, now=t_adm)
        last_logits, scratch, n_prompt, prefix_hit = self._prefill_prompt(
            req.prompt_ids, req.max_tokens)
        self._splice_scratch(slot_idx, scratch, n_prompt)
        # Under the grammar the first sample is masked to the START
        # state's legal set (masking only: a splice needs the pool).
        gs0 = (self._grammar.start_state(req.gpid)
               if self._grammar is not None and req.gpid >= 0 else -1)
        first_d = self._arm_first(slot_idx, last_logits, req, n_prompt,
                                  gs=gs0)
        slot = self._slots[slot_idx] = _Slot(
            req=req, detok=StreamDecoder(self.tokenizer), n_prompt=n_prompt,
            pos=n_prompt, queue_ms=wait_ms,
            t_admit=t_adm, chunks_inflight=1, prefix_hit=prefix_hit, gs=gs0)
        self._inflight.append(("first", self._to_host_async(first_d), slot,
                               slot_idx))
        self._last_admit_t = time.monotonic()

    def _splice_scratch(self, slot_idx: int, scratch: KVCache,
                        n: int) -> None:
        """Copy a scratch prefill's first ``n`` KV rows into a dense slot;
        the slot's rows past them are rewritten by decode before any
        query can read them."""
        with scope("kv_splice"):
            for dst, src in ((self._cache.k, scratch.k),
                             (self._cache.v, scratch.v)):
                kv_set_slots(dst, kv_map(lambda a: a[:, :, :n], src),
                             [slot_idx])

    def _arm_first(self, slot_idx: int, last_logits: torch.Tensor,
                   req: _Request, n_prompt: int, gs: int = -1,
                   ngen0: int = 0) -> torch.Tensor:
        """An eager admission's first token, sampled on the device from
        the prompt's last logits (argmax when greedy, else the draw at
        generation index ``ngen0`` of the request's seed stream: 0, or
        the index after an admission's forced run), and the slot armed
        behind it at ``n_prompt`` with ``ngen0 + 1`` tokens generated.
        A grammar state ``gs`` >= 0 masks the sample to its legal set
        and arms the slot's FSM word past the sampled token. Returns the
        [1] device tensor; nothing is read back."""
        dev = self.device
        mask = None
        if gs >= 0:
            mask = self._h2d(self._grammar.allowed_np(gs))[None]
        if req.temperature > 0.0:
            first_d = sample_tokens_seeded(
                last_logits,
                torch.full((1,), req.seed, dtype=torch.int64, device=dev),
                torch.full((1,), ngen0, dtype=torch.int32, device=dev),
                torch.full((1,), req.temperature, dtype=torch.float32,
                           device=dev),
                top_k=self.top_k, top_p=self.top_p, mask=mask)
        else:
            first_d = greedy_tokens(apply_mask(last_logits, mask))
        self._run_arm(slot_idx, n_prompt, first_d[0], req.temperature,
                      req.max_tokens, req.seed, ngen0 + 1)
        if gs >= 0:
            self._grammar_arm_after_sample(slot_idx, gs, first_d)
        return first_d

    def _pool_preload_system_prompt(self) -> None:
        """Prefill the shared system prompt once and leave its chain
        cached in the radix tree, so every request's admission maps it
        instead of prefilling it (HBM_PREFIX_CACHE)."""
        if self._radix is None or not self.use_prefix_cache:
            return
        from .prompts import SYSTEM_PROMPT

        ids = self.tokenizer.encode(SYSTEM_PROMPT)
        P = len(ids)
        if P + self.prefill_buckets[0] > self.max_seq_len:
            logger.warning("Radix preload skipped: system prompt is %d "
                           "tokens; no room for a suffix within max_seq "
                           "%d", P, self.max_seq_len)
            return
        need = pages_for(P, self.kv_pool_page)
        if need > self._radix.max_blocks:
            logger.warning("Radix preload skipped: system prompt needs %d "
                           "blocks, RADIX_LRU_BLOCKS budget is %d", need,
                           self._radix.max_blocks)
            return
        blocks = self._pool_alloc(need)
        if blocks is None:  # pragma: no cover - tiny pools only
            logger.warning("Radix preload skipped: pool too small")
            return
        row = np.full((self._pool_max_pages,), self._pool_n_blocks,
                      np.int32)
        row[:need] = blocks
        try:
            self._pool_prefill_span(row, list(ids), 0)
            self._radix.insert(list(ids), blocks)
        finally:
            self._pool.decref(blocks)
        logger.info("Radix cache preloaded: %d-token system prompt "
                    "resident in %d pool blocks", P, need)

    def kv_pool_health(self) -> Optional[dict]:
        """Block-state counts, starved slots, the attention regime, radix
        hit counters and the host tier's stats for /health (host counters
        only); None without a pool."""
        if self._pool is None:
            return None
        body = self._pool.stats(
            self._radix.cached_blocks() if self._radix else ()).as_dict()
        body["starved_slots_total"] = self._pool_starved
        body["attention_regime"] = self._attention_regime
        if self._radix is not None:
            body["radix"] = self._radix.stats()
        if self._host_store is not None:
            body["host_tier"] = self._host_store.stats()
        return body

    # ----------------------------------------- grammar-constrained decode
    #
    # Host truth: the GrammarRuntime's numpy tables and each slot's ``gs``
    # (the state over CONSUMED tokens). The device carries its own state
    # vector (_fsm_d) like ngen and the live flags; every admission and
    # replay re-arms it from host truth.

    def _grammar_tables_d(self) -> tuple:
        """Device copies of the stacked tables (``tok_class`` [P, V] and
        ``class_next`` [P*S, C] as int64, the gather index type, and
        ``class_ok`` [P*S, C] bool), refreshed when a variant install
        moved the runtime's version: a consistent snapshot taken under
        its lock, stamped with ITS version, so a racing install can
        neither tear the rows nor leave a newer version on older
        contents."""
        g = self._grammar
        if g.version != self._grammar_version:
            version, tc, ok, nxt = g.snapshot_tables()
            self._gram_tc_d = self._h2d(tc.astype(np.int64))
            self._gram_ok_d = self._h2d(ok)
            self._gram_next_d = self._h2d(nxt.astype(np.int64))
            self._grammar_version = version
        return self._gram_tc_d, self._gram_ok_d, self._gram_next_d

    def _grammar_arm(self, slot_idx: int, gs: int) -> None:
        self._fsm_d[slot_idx].fill_(gs)

    def _grammar_arm_after_sample(self, slot_idx: int, gs_base: int,
                                  first_d: torch.Tensor) -> None:
        """Arm a slot whose first token is still a device value (no host
        read): its word becomes advance(gs_base, first token), through
        the device tables."""
        tc, _, nxt = self._grammar_tables_d()
        cls = tc[gs_base // self._grammar.S_max].index_select(
            0, first_d.long())
        self._fsm_d[slot_idx:slot_idx + 1] = nxt[gs_base].index_select(
            0, cls)

    def _grammar_note_dead_end(self, cause: str) -> None:
        self._grammar_dead_ends[cause] = \
            self._grammar_dead_ends.get(cause, 0) + 1

    def _grammar_consume(self, slot: _Slot, new_ids) -> None:
        """Advance a slot's host state by consumed tokens and count them
        as masked decode steps."""
        for t in new_ids:
            slot.gs = self._grammar.advance(slot.gs, int(t))
        self._grammar_masked += len(new_ids)

    def _grammar_fast_forward(self, idx: int, slot: _Slot) -> None:
        """Forced-run fast-forward (the JAX engine's): when the slot's
        state starts a chain of single-successor states, splice the whole
        run as ONE prefill into its pool blocks instead of decoding it.

        The chunks in flight decode the run's head anyway (their compute
        is sunk and, under the mask, their tokens are the forced ones),
        so the splice fires only when the run exceeds what they cover by
        GRAMMAR_FORCED_RUN_MIN (or ends the command); the chunks it
        splices over are marked stale (the consume skips their rows,
        which index the stream before the splice; the FIFO read makes
        the countdown exact) and billed as waste.

        The prefill covers positions base-1 .. base+len(run)-2 (the last
        emitted token, whose row decode had not written, and run[:-1]);
        the run's last token becomes the carry, its row unwritten, so
        the "last generated row unwritten" rule of every replay and radix
        path holds. Forced tokens take generation indices but no
        randomness: ngen re-arms at the post-run count, and the next
        sampled token draws what masked step-by-step decode would."""
        if (self._grammar is None or not self.kv_pool
                or slot.req.gpid < 0 or slot.exhausted):
            return
        req = slot.req
        g = len(slot.detok.ids)
        cap = req.max_tokens - g
        if cap <= 0:
            return
        run, ends_eos, end_gs = self._grammar.forced_run(slot.gs, cap)
        covered = slot.decode_chunks_inflight * (
            self._chunk_tokens if self._spec_live else self.chunk_len)
        net = len(run) - covered
        if net < self.grammar_forced_run_min and not (
                ends_eos and run and net > 0):
            return
        base = len(slot.pool_ids or []) + g   # the position after the ids
        if base + len(run) > self._S_alloc:
            return                            # the capacity sweep's job
        need = pages_for(base + len(run), self.kv_pool_page)
        while len(slot.blocks) < need:
            b = self._pool_alloc(1)
            if b is None:
                return                        # pool pressure: decode it
            self._tables[idx, len(slot.blocks)] = b[0]
            slot.blocks.extend(b)
        ids_full = list(slot.pool_ids or []) + list(slot.detok.ids) + run
        self._pool_prefill_span(self._tables[idx],
                                ids_full[:base + len(run) - 1],
                                max(0, base - 1))
        # The draft holds the run's rows too (from base - 1, over the
        # slot's rows it already decoded): it drafts what comes after.
        self._draft_prefill_slot(idx, ids_full[:base + len(run) - 1],
                                 start=max(0, base - 1))
        piece = slot.detok.push(*run)
        slot.gs = end_gs
        if req.export is not None:
            req.export.ids = list(slot.detok.ids)
            req.export.blocks = list(slot.blocks)
        if piece is not None:
            self._emit(req, "token", piece)
        self._grammar_forced += len(run)
        self._grammar_ff_splices += 1
        if slot.decode_chunks_inflight > 0:
            self._bill_waste(min(covered, cap), req)
            slot.stale_chunks += slot.decode_chunks_inflight
        if req.trace is not None:
            req.trace.event(
                f"grammar: forced run of {len(run)} tokens spliced as one "
                f"prefill (state {slot.gs}, "
                f"{'EOS next' if ends_eos else 'decode resumes'})")
        new_g = len(slot.detok.ids)
        slot.pos = max(slot.pos, base + len(run))
        if new_g >= req.max_tokens:
            self._finish(idx, "length")
            return
        if ends_eos:
            self._finish(idx, "stop")
            return
        # The carry: the run's last token at its own position, ngen at
        # the post-run count.
        self._run_arm(idx, base + len(run) - 1, run[-1], req.temperature,
                      req.max_tokens, req.seed, new_g)
        self._grammar_arm(idx, end_gs)
        slot.anchor_pos = base + len(run) - 1
        slot.anchor_g = new_g

    def grammar_health(self) -> Optional[dict]:
        """The grammar view for /health (host counters only); None with
        the grammar off."""
        if self._grammar is None:
            return None
        body = dict(self._grammar.health())
        body["forced_tokens_total"] = self._grammar_forced
        body["masked_steps_total"] = self._grammar_masked
        body["fast_forward_splices_total"] = self._grammar_ff_splices
        body["dead_ends_total"] = dict(self._grammar_dead_ends)
        return body

    # ------------------------------------------------ speculative decode
    #
    # The draft lives inside this engine: its parameters and its dense
    # per-slot cache sit beside the target's, and every site that arms
    # the target's KV (admission, replay, fast-forward) prefills the same
    # span into the draft's cache, so both condition on one transcript.
    # Verification is exact match against the target's own seeded draw:
    # no transcript depends on a draft, which is why losing the draft
    # (draft:die) degrades to plain decode and fails nothing.

    def _draft_forward(self, tokens, positions, live, kv_limit: int):
        """One draft forward over its dense cache (the JAX engine's
        ``draft_forward_step``): dense attention over ``kv_limit``
        positions, KV written for the ``live`` rows only. Returns the
        logits [N, S, vocab]."""
        self.draft_forward_steps += 1
        logits, self._draft_cache = forward(
            self._draft_params, self._draft_cfg, tokens, positions,
            self._draft_cache, kv_limit=kv_limit, attn_impl="dense",
            write_mask=live, token_mask=live[:, None], moe_impl="dense",
            mesh=self.mesh)
        return logits

    def _draft_prefill_slot(self, slot_idx: int, ids: List[int],
                            start: int = 0) -> None:
        """Mirror a target KV span into the draft's cache: prefill
        ``ids[start:]`` at absolute offsets into the slot's rows, in
        windows of the largest prefill bucket, each padded to the
        smallest bucket that holds it and attending over the prefill KV
        rung that covers it (the JAX ``_draft_prefill_slot``, whose
        scratch the slot's own rows stand in for: at ``start`` 0 they
        are zeroed first, as its scratch starts zeroed)."""
        if not self._spec_live:
            return
        n = len(ids)
        if n <= start:
            return
        cache = self._draft_cache
        with scope("kv_splice"):
            view = KVCache(*(kv_map(lambda a: a[:, slot_idx:slot_idx + 1],
                                    leaf) for leaf in (cache.k, cache.v)))
            if start == 0:
                for leaf in (view.k, view.v):
                    kv_map(torch.Tensor.zero_, leaf)
        big = self.prefill_buckets[-1]
        offset = start
        while offset < n:
            L = min(big, n - offset)
            bucket = next(b for b in self.prefill_buckets if b >= L)
            kv_limit = self._pool_kv_limit(offset + bucket)
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :L] = ids[offset:offset + L]
            positions = offset + torch.arange(bucket, device=self.device)
            forward(self._draft_params, self._draft_cfg, self._h2d(tokens),
                    positions[None].to(torch.int32), view,
                    kv_limit=kv_limit, attn_impl="dense", moe_impl="dense",
                    logits_at=torch.full((1,), L - 1, dtype=torch.int64,
                                         device=self.device),
                    mesh=self.mesh)
            offset += L

    def _chunk_waste_bound(self) -> int:
        """Counted device steps one in-flight chunk can hold for a slot
        (the waste cap at a host-only finish): a speculative chunk's row
        is ``_chunk_tokens`` wide, and a draft:die flip can leave chunks
        of both widths in flight."""
        if self.spec_decode:
            return max(self.chunk_len, self._chunk_tokens)
        return self.chunk_len

    def spec_health(self) -> Optional[dict]:
        """The speculative-decode view for /health (host counters only);
        None with it off. Its draft flags mirror ``sharding_health``'s."""
        if not self.spec_decode:
            return None
        drafted = self._spec_drafted
        return {
            "enabled": self.spec_decode,
            "active": self._spec_live,
            "draft_model": (self._draft_cfg.name if self._draft_cfg
                            is not None else self.spec_draft_model),
            "k": self.spec_draft_k,
            "verify_steps_per_chunk": self._spec_steps,
            "drafted_tokens_total": drafted,
            "accepted_tokens_total": self._spec_accepted,
            "acceptance_ratio": (round(self._spec_accepted / drafted, 4)
                                 if drafted else None),
            "degraded_total": self._spec_degraded,
            "draft_sharded": bool(self._draft_sharded),
            "draft_kv_fallback": bool(self._draft_kv_fallback),
        }

    # -------------------------------------------------------------- chunk

    def _sample(self, step_logits: torch.Tensor, ngen: torch.Tensor,
                live: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step's tokens: argmax for an all-greedy batch (host
        knowledge), else each live sampled row's draw at its generation
        index ``ngen``; under the grammar's ``mask`` either way."""
        if not any(t > 0.0 for t in self._temps):
            return greedy_tokens(apply_mask(step_logits, mask))
        return sample_tokens_seeded(step_logits, self._seeds_d, ngen,
                                    self._temps_d, top_k=self.top_k,
                                    top_p=self.top_p, active=live,
                                    mask=mask)

    def _step_fold(self, step_logits, prev_tok, live, ngen, budget,
                   health, gram):
        """``step_fold`` with this engine's sampler, EOS ids and health
        check."""
        return step_fold(step_logits, prev_tok, live, ngen, budget, health,
                         gram, self._sample, self._eos_d,
                         self.model_cfg.vocab_size, self.slot_health_check)

    def _run_chunk(self, force: torch.Tensor,
                   tables: Optional[torch.Tensor],
                   adm: Optional[tuple] = None,
                   kv_limit: Optional[int] = None,
                   corrupt: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode chunk: ``chunk_len`` forward steps over every slot
        with the termination fold in the carry, attending through the
        resolved decode impl (over ``kv_limit`` positions where it reads
        a bucket), the first step replaced by the ragged prologue when
        admissions are staged (``adm`` = (tok [N, W], len, start) device
        tensors; ``_run_arm`` already armed the staged slots' budget,
        count and live flag). ``tables`` is None on the dense cache.
        ``corrupt`` ([N] bool, the ``decode:nan`` seam; None: the cached
        all-False mask) NaN-fills its rows' logits on every step before
        the fold, as the JAX chunk body does, so the device's own health
        check is what catches them. Under the grammar the FSM state words
        ride the carry (``_fsm_d``) and each slot's token -> class row is
        gathered once per chunk: the profile id is chunk-invariant.
        Updates the device carry and returns the packed buffer."""
        if corrupt is None:
            corrupt = self._no_corrupt_d
        if not self.device_termination:
            return self._run_chunk_host_scan(force, tables, kv_limit, corrupt)
        bad_rows = corrupt[:, None]
        tok, pos, ngen, budget = (self._tok_d, self._pos_d, self._ngen_d,
                                  self._budget_d)
        live = self._active_d & force
        health = torch.zeros_like(ngen)
        gs = tables_g = None
        if self._grammar is not None:
            gs = self._fsm_d
            tc_all, ok_d, next_d = self._grammar_tables_d()
            tables_g = (tc_all[torch.div(gs, self._grammar.S_max,
                                         rounding_mode="floor")],
                        ok_d, next_d)
        steps = self.chunk_len
        toks = []
        if adm is not None:
            nxt, pos, live, ngen, health, _, gs = self._prologue(
                adm, tok, pos, live, ngen, budget, health, gs, tables_g,
                tables, bad_rows)
            tok = nxt[:, None]
            toks.append(nxt)
            steps -= 1
        for _ in range(steps):
            logits = self._forward(tok, pos, tables,
                                   attn_impl=self._decode_impl,
                                   kv_limit=kv_limit, write_mask=live)
            self.decode_steps += 1
            step_logits = logits[:, 0].masked_fill(bad_rows, float("nan"))
            nxt, live, ngen, health, counted, gs = self._step_fold(
                step_logits, tok[:, 0], live, ngen, budget, health,
                None if gs is None else (gs, *tables_g))
            pos = pos + counted.to(torch.int32)[:, None]
            tok = nxt[:, None]
            toks.append(nxt)
        done = force & ~live
        packed = pack_chunk(torch.stack(toks, dim=1), done, ngen,
                            live.sum(), health=health, xp=torch)
        (self._tok_d, self._pos_d, self._active_d, self._ngen_d,
         self._budget_d) = tok, pos, live, ngen, budget
        if gs is not None:
            self._fsm_d = gs
        return packed

    def _run_chunk_host_scan(self, force: torch.Tensor,
                             tables: Optional[torch.Tensor],
                             kv_limit: Optional[int],
                             corrupt: torch.Tensor) -> torch.Tensor:
        """The ``DEVICE_TERMINATION=false`` chunk (the JAX engine's
        ``batched_chunk_legacy``): every slot of ``force`` decodes the
        whole chunk — no EOS or budget freeze, the host scans each row
        (``protocol.scan_chunk_row``). Health still accumulates over the
        chunk, but nothing freezes: the containment pass discards a
        tripped chunk. The done mask is all-False and the generated
        counts advance by the chunk. Updates the carry and returns the
        packed buffer."""
        bad_rows = corrupt[:, None]
        tok, pos, ngen = self._tok_d, self._pos_d, self._ngen_d
        health = torch.zeros_like(ngen)
        step = force.to(torch.int32)
        vocab = self.model_cfg.vocab_size
        toks = []
        for _ in range(self.chunk_len):
            logits = self._forward(tok, pos, tables,
                                   attn_impl=self._decode_impl,
                                   kv_limit=kv_limit, write_mask=force)
            self.decode_steps += 1
            step_logits = logits[:, 0].masked_fill(bad_rows, float("nan"))
            nxt = self._sample(step_logits, ngen, force)
            if self.slot_health_check:
                bad = ~torch.isfinite(step_logits).all(dim=-1)
                health = health | (force & bad).to(health.dtype) \
                    * HEALTH_NONFINITE
                bad_tok = (nxt < 0) | (nxt >= vocab)
                health = health | (force & bad_tok).to(health.dtype) \
                    * HEALTH_TOKEN_RANGE
            nxt = torch.where(force, nxt, tok[:, 0])
            pos = pos + step[:, None]
            ngen = ngen + step
            tok = nxt[:, None]
            toks.append(nxt)
        packed = pack_chunk(torch.stack(toks, dim=1), torch.zeros_like(force),
                            ngen, force.sum(), health=health, xp=torch)
        self._tok_d, self._pos_d, self._ngen_d = tok, pos, ngen
        return packed

    def _prologue(self, adm, tok, pos, live, ngen, budget, health, gs,
                  tables_g, tables, bad_rows) -> tuple:
        """The ragged prologue: staged slots prefill their suffix (q_len
        = its length) and sample their first token off its last
        position, while every other live slot takes its decode step at
        q_len=1 in the same forward (``adm`` = (tok [N, W], len, start);
        ``_run_arm`` already armed the staged slots' budget, count and
        live flag). Returns ``(nxt, pos, live, ngen, health, counted,
        gs)`` after the step's fold."""
        a_tok, a_len, a_start = adm
        is_adm = a_len > 0
        W = a_tok.shape[1]
        cols = torch.arange(W, dtype=torch.int32, device=self.device)
        q_len = torch.where(is_adm, a_len, 1)
        start = torch.where(is_adm, a_start, pos[:, 0])
        win_tok = a_tok.clone()
        win_tok[:, 0] = torch.where(is_adm, a_tok[:, 0], tok[:, 0])
        q_lens = torch.where(live, q_len, 0)
        logits = self._forward(
            win_tok, start[:, None] + cols[None, :], tables,
            attn_impl="ragged", q_lens=q_lens,
            write_mask=(cols[None, :] < q_len[:, None]) & live[:, None],
            logits_at=(q_lens.clamp(min=1) - 1).long())
        step_logits = logits[:, 0].masked_fill(bad_rows, float("nan"))
        nxt, live, ngen, health, counted, gs = self._step_fold(
            step_logits, win_tok[:, 0], live, ngen, budget, health,
            None if gs is None else (gs, *tables_g))
        pos = (start + q_len * counted.to(torch.int32))[:, None]
        return nxt, pos, live, ngen, health, counted, gs

    def _run_spec_chunk(self, force: torch.Tensor, tables: torch.Tensor,
                        adm: Optional[tuple] = None,
                        kv_limit: Optional[int] = None,
                        corrupt: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """One speculative chunk (the JAX ``spec_chunk_impl``):
        ``_spec_steps`` verify iterations, each k + 1 greedy draft
        forwards (masked by the grammar, whose speculative state ``dgs``
        the draft walks; the last forward only writes the k-th
        proposal's KV row), then ONE target forward over the carry token
        and the k proposals, every position's logits kept, then the
        plain step's fold at each position j (``_step_fold`` over the
        rows still valid in the window, ``seg``): a row stays valid
        while each proposal equals the token sampled against it, dies
        with its row at EOS, budget or a health trip, and re-drafts
        from the corrected carry next iteration. Tokens land in a
        buffer ``CT`` wide through a per-slot cursor (the EOS that ends
        a row too); a lane that writes nothing lands in one spare
        column, sliced off. With staged admissions the ragged prologue
        runs first (after one draft forward over the window's first
        token, which keeps the draft's rows gapless) and its token takes
        column 0. ``drafted`` grows by k for each live iteration;
        ``accepted`` counts positions j >= 1 that counted. Updates the
        device carry and returns the packed buffer with both lanes."""
        if corrupt is None:
            corrupt = self._no_corrupt_d
        bad_rows = corrupt[:, None]
        k = self.spec_draft_k
        N = self.batch_size
        dev = self.device
        ragged = self._decode_impl == "ragged"
        # The draft attends over the chunk's KV bucket in the gather
        # regime and over the whole span in the ragged one (where the
        # target needs no bucket), as in the JAX engine.
        draft_kvl = self._S_alloc if ragged else kv_limit
        CT = self._spec_steps * (k + 1) + (1 if adm is not None else 0)
        tok, pos, ngen, budget = (self._tok_d, self._pos_d, self._ngen_d,
                                  self._budget_d)
        live = self._active_d & force
        health = torch.zeros_like(ngen)
        zeros = torch.zeros_like(ngen)
        drafted, accepted = zeros, zeros
        rows = torch.arange(N, device=dev)
        gs = tables_g = None
        if self._grammar is not None:
            gs = self._fsm_d
            tc_all, ok_d, next_d = self._grammar_tables_d()
            tables_g = (tc_all[torch.div(gs, self._grammar.S_max,
                                         rounding_mode="floor")],
                        ok_d, next_d)
        if adm is not None:
            a_tok, a_len, a_start = adm
            is_adm = a_len > 0
            wt0 = torch.where(is_adm, a_tok[:, 0],
                              tok[:, 0]).to(tok.dtype)
            st0 = torch.where(is_adm, a_start, pos[:, 0])
            self._draft_forward(wt0[:, None], st0[:, None], live, draft_kvl)
            live0 = live
            nxt0, pos, live, ngen, health, c0, gs = self._prologue(
                adm, tok, pos, live, ngen, budget, health, gs, tables_g,
                tables, bad_rows)
            # An uncounted prologue (EOS, a freeze) keeps the window's
            # first token as the carry: EOS never becomes a spec carry.
            tok = torch.where(c0, nxt0.to(tok.dtype), wt0)[:, None]
            buf = tok.repeat(1, CT + 1)
            wrote = live0 & (health == 0)
            buf[rows, torch.where(wrote, 0, CT)] = nxt0.to(buf.dtype)
            cur_i = c0.to(torch.int32)
        else:
            # Entries no token reaches repeat the carry (the packed
            # contract): never an accidental EOS at a row's end.
            buf = tok.repeat(1, CT + 1)
            cur_i = zeros
        positions_k = torch.arange(k + 1, dtype=torch.int32, device=dev)
        for _ in range(self._spec_steps):
            it_live = live
            step_live = it_live.to(torch.int32)[:, None]
            drafts = []
            dtok, dpos, dgs = tok, pos, gs
            for j in range(k + 1):
                dl = self._draft_forward(dtok, dpos, it_live, draft_kvl)
                if j == k:
                    break
                dmask = None
                if gs is not None:
                    tc, ok_d, next_d = tables_g
                    dmask = torch.gather(ok_d[dgs], 1, tc)
                d = greedy_tokens(apply_mask(dl[:, 0], dmask))
                d = torch.where(it_live, d, dtok[:, 0].to(d.dtype))
                drafts.append(d)
                if gs is not None:
                    dcls = torch.gather(
                        tc, 1, d.clamp(0, tc.shape[1] - 1).long()[:, None]
                    )[:, 0]
                    dgs = torch.where(it_live, next_d[dgs, dcls], dgs)
                dtok = d[:, None].to(tok.dtype)
                dpos = dpos + step_live
            drafted = drafted + torch.where(it_live, k, 0).to(torch.int32)
            toks_in = torch.cat([tok] + [d[:, None].to(tok.dtype)
                                         for d in drafts], dim=1)
            logits = self._forward(
                toks_in, pos + positions_k[None, :], tables,
                attn_impl=self._decode_impl, kv_limit=kv_limit,
                q_lens=(torch.where(it_live, k + 1, 0).to(torch.int32)
                        if ragged else None),
                write_mask=it_live)
            self.verify_steps += 1
            seg = it_live
            cur = tok[:, 0]
            for j in range(k + 1):
                sl = logits[:, j].masked_fill(bad_rows, float("nan"))
                s, seg_out, ngen, health, counted, gs = self._step_fold(
                    sl, cur, seg, ngen, budget, health,
                    None if gs is None else (gs, *tables_g))
                # The row's EOS (a lane that froze writes nothing) lands
                # at the cursor: the finish reason's entry.
                wrote = seg & (health == 0)
                buf[rows, torch.where(wrote, cur_i, CT)] = s.to(buf.dtype)
                cnt = counted.to(torch.int32)
                cur_i = cur_i + cnt
                pos = pos + cnt[:, None]
                cur = torch.where(counted, s.to(cur.dtype), cur)
                # A row that left the window by a freeze or a finish
                # leaves the chunk; a mismatch only ends the window.
                live = live & ~(seg & ~seg_out)
                seg = seg_out
                if j >= 1:
                    accepted = accepted + cnt
                if j < k:
                    seg = seg & (s == drafts[j].to(s.dtype))
            tok = cur[:, None]
        done = force & ~live
        packed = pack_chunk(buf[:, :CT], done, ngen, live.sum(),
                            health=health, drafted=drafted,
                            accepted=accepted, xp=torch)
        (self._tok_d, self._pos_d, self._active_d, self._ngen_d,
         self._budget_d) = tok, pos, live, ngen, budget
        if gs is not None:
            self._fsm_d = gs
        return packed

    def _dispatch_chunk(self) -> None:
        """Dispatch one chunk for every live slot, carrying every staged
        admission in its ragged prologue. The admission width is the
        smallest prefill bucket covering the longest staged suffix. A
        speculative chunk's row is ``_chunk_tokens`` wide (one more with
        staged admissions, the prologue's token)."""
        if self.faults is not None:
            # A chunk:hang blocks this (scheduler) thread exactly like a
            # hung device dispatch: the watchdog's target.
            self.faults.check("chunk")
            # draft:die: the draft is gone. The engine flips to plain
            # chunks; requests in flight decode on with the same
            # transcripts (none depended on a draft). The one
            # degradation: nothing else falls back from the draft.
            if self._spec_live and self.faults.draft_die():
                self._spec_live = False
                self._spec_degraded += 1
                logger.warning("draft engine died (draft:die); degrading "
                               "to plain non-speculative decode")
        spec = self._spec_live
        ct = self._chunk_tokens if spec else self.chunk_len
        staged = {i: e for i, e in self._pending_adm.items()
                  if self._slots[i] is not None
                  and not self._slots[i].exhausted}
        self._pending_adm.clear()
        if staged and spec:
            ct += 1
        active_slots = [s for s in self._slots
                        if s is not None and not s.exhausted]
        if not active_slots:
            return
        if self.kv_pool:
            # Grow block tables to cover this chunk's writes BEFORE the
            # dispatch snapshot; a slot the pool cannot serve is excluded.
            for i, s in enumerate(self._slots):
                if s is not None and not s.exhausted:
                    self._pool_ensure_coverage(i, s, ct)
            active_slots = [s for s in self._slots
                            if s is not None and not s.exhausted]
            if not active_slots:
                return
        adm = adm_w = None
        if staged:
            N = self.batch_size
            longest = max(len(e["ids"]) for e in staged.values())
            adm_w = next(b for b in self.prefill_buckets if b >= longest)
            a_tok = np.zeros((N, adm_w), np.int64)
            a_vec = np.zeros((2, N), np.int32)   # len, start
            for i, e in staged.items():
                a_tok[i, :len(e["ids"])] = e["ids"]
                a_vec[:, i] = (len(e["ids"]), e["start"])
            vec = self._h2d(a_vec)
            adm = (self._h2d(a_tok), vec[0], vec[1])
        # The smallest KV bucket covering every position this chunk can
        # reach (``pos`` counts scheduled chunks: an upper bound).
        needed = max(s.pos for s in active_slots) + ct
        kv_limit = next((b for b in self._kv_buckets if b >= needed),
                        self._kv_buckets[-1])
        # Step-time sentinel: the interval since the previous dispatch is
        # one chunk cycle when a consume happened in between and the pipe
        # never emptied (a chunk still in flight now), so the stored unit
        # is ms per device step. A mixed admission chunk samples into the
        # prefill phase keyed by its ragged admission width, as in the
        # JAX engine.
        now = time.monotonic()
        pend = self._steptime_pending
        if (pend is not None and self._steptime_consumed
                and any(e[0] == "chunk" for e in self._inflight)):
            t0, phase0, bucket0, (steps0, toks0) = pend
            self._steptime.note(phase0, bucket0, now - t0, steps=steps0,
                                tokens=toks0, now=now)
        self._steptime_pending = (
            now, PHASE_PREFILL if adm_w is not None
            else PHASE_SPEC_VERIFY if spec else PHASE_DECODE,
            adm_w if adm_w is not None else kv_limit,
            (ct, ct * len(active_slots)))
        self._steptime_consumed = False
        force = self._h2d(np.array(
            [s is not None and not s.exhausted for s in self._slots], bool))
        tables = self._tables_d(self._tables) if self.kv_pool else None
        # The decode:nan seam: the cached all-False mask, or a drill's
        # mask naming the target slots.
        corrupt = self._no_corrupt_d
        if self.faults is not None:
            hits = self.faults.decode_nan_slots([
                s.req.prompt if s is not None and not s.exhausted else None
                for s in self._slots])
            if hits:
                mask = np.zeros((self.batch_size,), bool)
                mask[hits] = True
                corrupt = self._h2d(mask)
        run = self._run_spec_chunk if spec else self._run_chunk
        packed = run(force, tables, adm, kv_limit=kv_limit, corrupt=corrupt)
        # The seats the chunk decodes for, and their requests. A row is
        # delivered only to the seat it was dispatched for: a request
        # preempted with chunks in flight and resumed into the same slot
        # sits in a new seat, and those chunks' rows are stale for it.
        seats = [s if s is not None and not s.exhausted else None
                 for s in self._slots]
        snapshot = [s.req if s is not None else None for s in seats]
        for s in active_slots:
            s.pos += ct
            s.chunks_inflight += 1
            s.decode_chunks_inflight += 1
        # The device->host copy starts now, behind the chunk: its read
        # waits for this chunk alone, not for those dispatched after it.
        self._inflight.append(("chunk", self._to_host_async(packed),
                               snapshot, ct, spec, seats))
        self._chunks_dispatched += 1
        self._chunk_log.append({
            "t": time.time(), "event": "dispatch", "kv_bucket": kv_limit,
            "slots": len(active_slots), "admissions": len(staged),
            "pipe": sum(1 for e in self._inflight if e[0] == "chunk"),
        })

    def _consume_oldest(self) -> None:
        """Read the oldest in-flight entry: an eager admission's first
        token, a group admission's first tokens, or a chunk's packed
        buffer (THE one host read per entry,
        ``_fetch``: it waits on the entry's own event, whose copy started
        at dispatch), and deliver each slot's tokens and finish. A
        tripped health bit runs the containment pass instead, and
        nothing of the chunk reaches a client. Under the host scan
        (``DEVICE_TERMINATION=false``) each row is scanned for EOS and
        the budget, and the steps past a finish, or spent on a slot
        freed since the dispatch, are billed as waste here."""
        self._last_progress = time.monotonic()
        self._first_consumed = True     # the cold-start grace ends
        entry = self._inflight.pop(0)
        if entry[0] == "first":
            _, handle, seat, slot_idx = entry
            self._consume_first(int(self._fetch(handle)[0]), seat, slot_idx)
            return
        if entry[0] == "firsts":
            # A group admission's first tokens: one read for the group.
            _, handle, pairs = entry
            vals = self._fetch(handle)
            for (seat, slot_idx), v in zip(pairs, vals):
                self._consume_first(int(v), seat, slot_idx)
            return
        _, handle, snapshot, ct, is_spec, seats = entry
        if self.faults is not None:
            # decode:poison_step: a step-wide fault raised at the fetch,
            # naming no slot; the scheduler's except bisects for it.
            self.faults.poison_fetch(
                [r.prompt if r is not None else None for r in snapshot])
        t_fetch = time.monotonic()
        res = unpack_chunk(self._fetch(handle), self.batch_size, ct,
                           spec=is_spec)
        fetch_s = time.monotonic() - t_fetch
        self._fetch_samples.append(fetch_s)
        self._chunks_consumed += 1
        self._steptime_consumed = True   # arms the next dispatch's sample
        self._last_n_alive = res.n_alive
        self._chunk_log.append({
            "t": time.time(), "event": "consume", "n_alive": res.n_alive,
            "fetch_ms": round(fetch_s * 1000.0, 3),
            "pipe": sum(1 for e in self._inflight if e[0] == "chunk"),
        })
        # Speculative books, billed per snapshot request BEFORE the
        # health-trip return: the drafting happened whether or not the
        # chunk survives. Rejected proposals are the draft_rejected
        # waste; accepted ones bill delivered at finish like any token.
        if is_spec:
            for i, req_i in enumerate(snapshot):
                d, a = int(res.drafted[i]), int(res.accepted[i])
                if req_i is None or d <= 0:
                    continue
                self._spec_drafted += d
                self._spec_accepted += a
                if d > a:
                    self.ledger.record(CLASS_DRAFT_REJECTED, d - a,
                                       lane=req_i.lane, tenant=req_i.tenant)
        # A tripped health bit names its culprit. Nothing of a poisoned
        # chunk is emitted, the clean rows included: the replay
        # regenerates them exactly (seeded sampling), and no corrupt
        # token ever reaches a client.
        tripped = [i for i in range(self.batch_size)
                   if int(res.health[i]) and seats[i] is not None
                   and self._slots[i] is seats[i]]
        if tripped:
            self.supervisor.note_health_trips(len(tripped))
            for i in tripped:
                why = describe_health(int(res.health[i]))
                self._chunk_log.append({"t": time.time(),
                                        "event": "health_trip", "slot": i,
                                        "health": why})
                if int(res.health[i]) & HEALTH_GRAMMAR_DEAD:
                    # A grammar dead end: the slot froze before emitting
                    # anything and rides the containment lane.
                    self._grammar_note_dead_end("decode")
                if self._slots[i].req.trace is not None:
                    self._slots[i].req.trace.event(
                        f"engine: slot {i} health tripped ({why})")
            self._contain_poisoned_step(
                CAUSE_SLOT_HEALTH, named=[self._slots[i] for i in tripped])
            return
        eos_ids = self.model_cfg.eos_ids
        for i, slot in enumerate(self._slots):
            if slot is None or slot is not seats[i]:
                # Freed or reseated since the dispatch. Under the host
                # scan the device decoded the whole chunk for it: the
                # waste the done mask removes (with the mask the carry
                # froze it, and a host-only finish billed at _finish).
                if snapshot[i] is not None and not self.device_termination:
                    self._bill_waste(self.chunk_len, snapshot[i])
                continue
            slot.chunks_inflight -= 1
            slot.decode_chunks_inflight -= 1
            if slot.stale_chunks > 0:
                # A fast-forward spliced over this chunk: its rows index
                # the stream before the splice, which already delivered
                # these tokens.
                slot.stale_chunks -= 1
                continue
            if self.device_termination:
                new_ids, finish = consume_chunk_row(
                    res.tokens[i], bool(res.done[i]), int(res.lengths[i]),
                    len(slot.detok.ids), ct, eos_ids)
            else:
                new_ids, finish, wasted = scan_chunk_row(
                    res.tokens[i], len(slot.detok.ids), eos_ids,
                    slot.req.max_tokens)
                self._bill_waste(wasted, slot.req)
            if new_ids:
                if slot.t_first is None:
                    slot.t_first = time.monotonic()
                    slot.prefill_ms = (slot.t_first - slot.t_admit) * 1e3
                    if slot.req.t_first0 is None:
                        slot.req.t_first0 = slot.t_first
                piece = slot.detok.push(*new_ids)
                # The portable export: a fresh list per update, so the
                # fleet's read from another thread sees a settled
                # snapshot of the generated prefix.
                if slot.req.export is not None:
                    slot.req.export.ids = list(slot.detok.ids)
                if piece is not None:
                    self._emit(slot.req, "token", piece)
                if self._grammar is not None and slot.req.gpid >= 0:
                    self._grammar_consume(slot, new_ids)
                    if finish is None:
                        self._grammar_fast_forward(i, slot)
                        if self._slots[i] is not slot:
                            continue   # the fast-forward finished it
            if is_spec:
                # Re-sync the conservative position: a spec chunk
                # advances by what it accepted, not by its width, so
                # ``pos`` would drift high and the capacity sweep would
                # cut a long generation short. The carry sits at
                # anchor_pos plus the tokens emitted since the anchor,
                # plus one widest row for each chunk still in flight.
                slot.pos = (slot.anchor_pos
                            + (len(slot.detok.ids) - slot.anchor_g)
                            + slot.decode_chunks_inflight
                            * (self._chunk_tokens
                               + (1 if self._decode_impl == "ragged"
                                  else 0)))
            if finish is not None:
                self._finish(i, finish)
        self._probation_tick(snapshot)

    def _probation_tick(self, snapshot: list) -> None:
        """Bisection probation after a clean chunk (the JAX consume
        path's tail). A chunk whose snapshot held a flagged suspect is
        evidence: after PROBATION_CLEAN_CHUNKS of them suspicion is
        cleared and the parked half replays now, instead of stalling
        admissions until the probe drains. A chunk dispatched before an
        unpark holds only cleared slots and proves nothing. When every
        probe suspect finished and none rides the pipe, the parked half
        inherits the suspicion and replays."""
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
            self._unpark_parked()

    def _consume_first(self, first_tok: int, seat: _Slot,
                       slot_idx: int) -> None:
        """Deliver an eager admission's first token (the JAX
        ``_consume_first``) to the seat it was sampled for. A first-token
        EOS or a one-token budget finishes the slot here; a chunk already
        dispatched for it is then discarded by its seat check."""
        slot = self._slots[slot_idx]
        if slot is None or slot is not seat:
            return      # finished or reseated before its first token
        req = slot.req
        slot.chunks_inflight -= 1
        now = time.monotonic()
        slot.t_first = now
        if req.t_first0 is None:
            req.t_first0 = now
        slot.prefill_ms = (now - slot.t_admit) * 1000.0
        # Sentinel prefill sample: admission -> first-token consume, keyed
        # by the prefill bucket covering the prompt.
        self._steptime.note(
            PHASE_PREFILL,
            prefill_bucket(slot.n_prompt, self.prefill_buckets),
            now - slot.t_admit, tokens=slot.n_prompt, now=now)
        if first_tok in self.model_cfg.eos_ids:
            # The device never saw this EOS: chunks already dispatched
            # for the slot decode it for nothing (wasted_masked).
            self._finish(slot_idx, "stop", wasted_inflight=True)
            return
        piece = slot.detok.push(first_tok)
        if req.export is not None:
            req.export.ids = list(slot.detok.ids)
        if piece is not None:
            self._emit(req, "token", piece)
        grammar = self._grammar is not None and req.gpid >= 0
        if grammar:
            self._grammar_consume(slot, [first_tok])
        if req.max_tokens <= 1:
            self._finish(slot_idx, "length")
        elif grammar:
            self._grammar_fast_forward(slot_idx, slot)

    def _finish(self, slot_idx: int, finish: str,
                error: Optional[BaseException] = None,
                wasted_inflight: bool = False) -> None:
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None
        self._pending_adm.pop(slot_idx, None)
        self._temps[slot_idx] = 0.0
        if slot is None:  # pragma: no cover - defensive
            return
        if self.kv_pool:
            # Clean finishes cache their verified chain for the next turn.
            self._pool_release_slot(
                slot_idx, slot,
                cache_chain=error is None and finish in ("stop", "length"))
        # A host-only finish (cancel, deadline, first-token EOS) ends a
        # slot the device still decodes in every chunk already dispatched
        # for it: those steps are waste, capped by the slot's remaining
        # budget (the device freezes a slot at its budget). The host scan
        # bills them at the read instead (seat mismatch, prune):
        # counting both would bill twice.
        if (wasted_inflight and self.device_termination
                and slot.decode_chunks_inflight > 0):
            remaining = max(0, slot.req.max_tokens - len(slot.detok.ids))
            self._bill_waste(min(slot.decode_chunks_inflight
                                 * self._chunk_waste_bound(), remaining),
                             slot.req)
        # Every finish frees a slot: it feeds the drain rate behind
        # retry_after_hint, engine-wide and for its lane.
        t_fin = time.monotonic()
        lane = slot.req.lane
        self._finish_times.append(t_fin)
        self._lane_finish.setdefault(
            lane, collections.deque(maxlen=64)).append(t_fin)
        # The ledger: the transcript is what the client received —
        # goodput, errors included (a quarantine already billed its
        # tokens as burned) — and the session's budget is charged with
        # the same tokens. Billed past ledger_delivered: a migrated
        # import's prefix was decoded and billed on the donor replica. A
        # cancelled hedge loser (export.discard, set by the fleet before
        # the cancel) emitted tokens the client never received:
        # hedge_loser, and no session charge.
        n_new = len(slot.detok.ids) - slot.req.ledger_delivered
        slot.req.ledger_delivered = len(slot.detok.ids)
        discarded = (slot.req.export is not None
                     and slot.req.export.discard)
        self.ledger.record(CLASS_HEDGE_LOSER if discarded
                           else CLASS_DELIVERED, n_new, lane=lane,
                           tenant=slot.req.tenant)
        if not discarded:
            self._session_budgets.charge(slot.req.session, n_new)
        if error is not None:
            self._emit(slot.req, "error", error)
            return
        piece = slot.detok.flush()
        if piece is not None:
            self._emit(slot.req, "token", piece)
        t_end = time.monotonic()
        # TTFT from the first token the request ever delivered (it
        # survives a preemption); the session TTFT only for a radix-warm
        # re-admission of a declared session. A migrated import (its
        # first byte was the donor's) and a hedge loser (the winner
        # measures the request) take no sample.
        if not slot.req.ttft_exempt and not discarded:
            ttft_sample_ms = ((slot.req.t_first0 or slot.t_first or t_end)
                              - slot.req.t_submit) * 1000.0
            self._slo.note(SLO_TTFT, lane, ttft_sample_ms, now=t_end)
            if slot.req.session and slot.req.radix_warm:
                self._slo.note(SLO_SESSION_TTFT, lane, ttft_sample_ms,
                               now=t_end)
        self._emit(slot.req, "done", EngineResult(
            text=slot.detok.text,
            prompt_tokens=slot.n_prompt,
            completion_tokens=len(slot.detok.ids),
            queue_ms=slot.queue_ms,
            prefill_ms=slot.prefill_ms,
            decode_ms=(t_end - slot.t_admit) * 1000.0,
            ttft_ms=((slot.t_first or t_end) - slot.req.t_submit) * 1000.0,
            prefix_cache_hit=slot.prefix_hit,
            finish_reason=finish,
            engine=self.name,
            weights_version=self.weights_version,
            degraded=slot.exhausted,
            token_ids=tuple(slot.detok.ids),
        ))

    def _emit(self, req: _Request, event: str, payload) -> None:
        try:
            req.loop.call_soon_threadsafe(req.out_queue.put_nowait,
                                          (event, payload))
        except RuntimeError:
            # The request's event loop already closed; nothing listens.
            logger.warning("dropping %r event for a dead event loop", event)

    # ---------------------------------------------------------- scheduler

    def _admit_pending(self) -> None:
        """Admit queued requests into the free slots, in the QoS queue's
        order. Lanes at their brownout-trimmed slot cap stay queued;
        right after a preemption the first pop is pinned to the starved
        lane, so the freed slot goes to the waiter it was freed for.
        While a bisection has slots parked nothing is admitted: a new
        request joining a suspect batch would muddy the culprit's
        attribution (queued requests wait, never dropped)."""
        if self._parked:
            return
        free = sum(s is None for s in self._slots)
        counts = self.lane_occupancy()
        prefer, self._preempt_for_lane = self._preempt_for_lane, None
        pending = []
        while len(pending) < free:
            try:
                req = self._admissions.get_nowait(
                    exclude_lanes=self._capped_lanes(counts),
                    min_lane=prefer)
            except _queue.Empty:
                if prefer is None:
                    break
                prefer = None   # the starved waiter left (cancel, expiry)
                continue
            prefer = None
            counts[req.lane if req.lane in LANES else LANE_INTERACTIVE] += 1
            pending.append(req)
        self._admit_popped(pending)

    def _admit_popped(self, pending: List[_Request]) -> None:
        """Admit popped requests. A preempted request gets its paused
        wall time back on its deadline before anything judges it; a
        failing admission errors its own requests, never the scheduler.
        Each stays in ``_admitting_reqs`` until it is slotted or errored,
        so a scheduler death mid-admission cannot lose it. Prefix hits
        sharing a suffix shape are admitted as groups first (the JAX
        ``_admit_pending``'s order), at most the largest kpad the scratch
        budget allows at their depth, then every other request singly."""
        self._admitting_reqs.extend(pending)
        for req in pending:
            self._credit_preempt_wait(req)
        groups: dict = {}
        singles: List[_Request] = []
        for req in pending:
            key = self._suffix_group_key(req) if self.admit_kpads else None
            if key is None:
                singles.append(req)
            else:
                groups.setdefault(key, []).append(req)
        for (sbucket, kv_limit), reqs in groups.items():
            kpads = self.admit_kpads_for(kv_limit)
            while reqs:
                take = reqs[:(kpads[-1] if kpads else 1)]
                del reqs[:len(take)]
                if len(take) == 1:
                    self._admit_guarded(take[0])
                else:
                    self._admit_group_guarded(take, sbucket, kv_limit)
        for req in singles:
            self._admit_guarded(req)

    def _admit_guarded(self, req: _Request) -> None:
        self._admitting += 1
        # An admission ticks the watchdog: a cold one can block this
        # thread for a while and must not read as a hung device.
        self._last_progress = time.monotonic()
        try:
            if self.faults is not None:
                self.faults.check("admit")
            if req.cancel.is_set():
                return
            if (req.deadline is not None
                    and time.monotonic() > req.deadline):
                self._emit(req, "error",
                           GenerationTimeout("timed out waiting for a slot"))
                return
            if req.resume_ids:
                self._admit_resume(req)
            else:
                self._admit_fresh(req)
        except Exception:
            logger.exception("admission failed")
            self._emit(req, "error", EngineUnavailable("admission failed"))
        finally:
            self._admitting -= 1
        # Settled (slotted or errored). A BaseException skips this on
        # purpose: the record is what lets the supervisor requeue it.
        try:
            self._admitting_reqs.remove(req)
        except ValueError:  # pragma: no cover - defensive
            pass

    def _admit_fresh(self, req: _Request) -> None:
        if self.kv_pool:
            self._admit_one_pool(req)
        else:
            self._admit_one_dense(req)

    # ----------------------------------------------------- group admission
    #
    # The JAX engine runs a group only once a background warm has
    # compiled its shape (_batch_ready, _warm_batch_admit_shapes) and
    # serializes that warm's scratch with the scheduler's
    # (_admit_scratch_lock). Both exist for XLA's compiles: every shape
    # is ready at once in eager PyTorch, so neither is copied.

    @property
    def admit_kpads(self) -> tuple:
        """Group sizes usable at all: none under the pool (its suffixes
        prefill straight into fresh blocks, with no scratch to stage) and
        none past the batch size."""
        if self.kv_pool:
            return ()
        return tuple(k for k in self.ADMIT_KPADS if k <= self.batch_size)

    def admit_kpads_for(self, depth: int) -> tuple:
        """``admit_kpads`` capped so kpad suffix-scratch rows of ``depth``
        positions fit ``ADMIT_SCRATCH_MB`` (``_cap_admit_kpads``); a depth
        with no cap (budget 0, or no prefix cache) passes uncapped."""
        kpads = self.admit_kpads
        cap = self._admit_kpad_caps.get(depth)
        if cap is not None:
            kpads = tuple(k for k in kpads if k <= cap)
        return kpads

    def _scratch_row_bytes(self, depth: int) -> int:
        """Bytes of one kpad row of scratch at ``depth`` positions (K and
        V: the int8 payload and an f32 scale per (position, head) under
        ``KV_QUANT=int8``, else the model dtype), as the JAX engine
        counts them."""
        cfg = self.model_cfg
        per_pos_head = (cfg.head_dim + 4 if self.kv_quant == "int8"
                        else cfg.head_dim * self.dtype.itemsize)
        return 2 * cfg.n_layers * depth * cfg.n_kv_heads * per_pos_head

    def _cap_admit_kpads(self, depths) -> None:
        """The per-depth kpad caps of the ``ADMIT_SCRATCH_MB`` budget (0
        leaves every depth uncapped); a cap of 0 admits singly."""
        self._admit_kpad_caps = {}
        budget = self.admit_scratch_mb * 1_000_000
        if budget <= 0:
            return
        for depth in depths:
            row = self._scratch_row_bytes(depth)
            fits = tuple(k for k in self.ADMIT_KPADS if k * row <= budget)
            self._admit_kpad_caps[depth] = fits[-1] if fits else 0
            structural = self.admit_kpads
            if structural and (not fits or fits[-1] < structural[-1]):
                logger.info(
                    "ADMIT_SCRATCH_MB=%d caps group admissions at depth %d "
                    "to kpad<=%d (%.0f MB/row)", self.admit_scratch_mb,
                    depth, self._admit_kpad_caps[depth], row / 1e6)

    def _suffix_group_key(self, req: _Request):
        """``(sbucket, kv_limit)`` when the request takes the prefix-hit
        suffix prefill, else None (single admission): resumes re-splice
        their generated ids and grammar requests sample their first
        token masked, so both take the single path."""
        if self._prefix is None or req.resume_ids:
            return None
        if self._grammar is not None and req.gpid >= 0:
            return None
        ids = req.prompt_ids
        max_prompt = self.max_seq_len - max(1, req.max_tokens)
        if len(ids) > max_prompt or not self._prefix.matches(ids):
            return None
        plan = self._suffix_plan(ids)
        if plan is None:
            return None
        sbucket, kv_limit, _ = plan
        return (sbucket, kv_limit)

    def _admit_group_guarded(self, reqs: List[_Request], sbucket: int,
                             kv_limit: int) -> None:
        """``_admit_guarded`` for a group: a failing group errors its own
        requests (the JAX ``guarded``), and each leaves
        ``_admitting_reqs`` once settled."""
        self._admitting += len(reqs)
        self._last_progress = time.monotonic()
        try:
            self._admit_group(reqs, sbucket, kv_limit)
        except Exception:
            logger.exception("group admission failed; failing %d "
                             "request(s)", len(reqs))
            for req in reqs:
                self._emit(req, "error", EngineUnavailable("admission failed"))
        finally:
            self._admitting -= len(reqs)
        for req in reqs:
            try:
                self._admitting_reqs.remove(req)
            except ValueError:  # pragma: no cover - defensive
                pass

    def _admit_group(self, reqs: List[_Request], sbucket: int,
                     kv_limit: int) -> None:
        """The JAX ``_admit_group``: the ``admit`` fault point once for
        the group, cancelled requests dropped and expired ones answered,
        and a group of one or none admitted singly."""
        if self.faults is not None:
            self.faults.check("admit")
        live = []
        for req in reqs:
            if req.cancel.is_set():
                continue
            if req.deadline is not None and time.monotonic() > req.deadline:
                self._emit(req, "error",
                           GenerationTimeout("timed out waiting for a slot"))
                continue
            live.append(req)
        kpad = next((k for k in self.admit_kpads_for(kv_limit)
                     if k >= len(live)), None)
        if len(live) <= 1 or kpad is None:
            for req in live:
                if self.faults is not None:
                    self.faults.check("admit")
                self._admit_fresh(req)
            return
        self._admit_group_rows(live, kpad, sbucket, kv_limit)

    def _admit_group_rows(self, live: List[_Request], kpad: int,
                          sbucket: int, kv_limit: int) -> None:
        """The JAX ``_admit_group_locked``: the resident prefix spliced
        into ``kpad`` scratch rows of suffix depth, every suffix
        prefilled in one forward over ``[kpad, sbucket]`` with each
        row's logits taken at its last valid column, the first tokens
        drawn at generation index 0 of each row's seed, the rows written
        into their slots and the slots armed. Nothing is read back: the
        first tokens reach the host as one ``("firsts", ...)`` entry."""
        prefix = self._prefix
        cfg = self.model_cfg
        dev = self.device
        t_adm = time.monotonic()
        for req in live:
            wait_ms = (t_adm - req.t_submit) * 1000.0
            self._brownout.note_queue_wait(req.lane, wait_ms, now=t_adm)
            self._slo.note(SLO_QUEUE_WAIT, req.lane, wait_ms, now=t_adm)
        scratch = KVCache.zeros(cfg, kpad, kv_limit, dtype=self.dtype,
                                device=dev, kv_quant=self.kv_quant,
                                mesh=self.mesh)
        with scope("kv_splice"):
            kv_update_slice(scratch.k, kv_broadcast_rows(prefix.k, kpad))
            kv_update_slice(scratch.v, kv_broadcast_rows(prefix.v, kpad))
        tokens = np.zeros((kpad, sbucket), np.int32)
        suf_lens = np.ones((kpad,), np.int64)   # padding rows: column 0
        temps = np.zeros((kpad,), np.float32)
        seeds = np.zeros((kpad,), np.int64)
        for i, req in enumerate(live):
            suf = req.prompt_ids[prefix.n:]
            tokens[i, :len(suf)] = suf
            suf_lens[i] = len(suf)
            temps[i] = req.temperature
            seeds[i] = req.seed
        lens_d = self._h2d(suf_lens)
        cols = torch.arange(sbucket, dtype=torch.int32, device=dev)
        logits, _ = forward(
            self.params, cfg, self._h2d(tokens),
            (prefix.n + cols)[None].expand(kpad, sbucket), scratch,
            kv_limit=kv_limit,
            attn_impl=self._prefill_impl_for(sbucket, kv_limit),
            token_mask=cols[None] < lens_d[:, None], moe_impl=self.moe_impl,
            logits_at=lens_d - 1, mesh=self.mesh)
        first_d = sample_tokens_seeded(
            logits[:, 0], self._h2d(seeds),
            torch.zeros((kpad,), dtype=torch.int32, device=dev),
            self._h2d(temps), top_k=self.top_k, top_p=self.top_p)
        slots = np.full((kpad,), self.batch_size, np.int64)   # pad: drop
        pairs = []
        for i, req in enumerate(live):
            slot_idx = self._slots.index(None)
            n_prompt = prefix.n + int(suf_lens[i])
            slots[i] = slot_idx
            self._run_arm(slot_idx, n_prompt, first_d[i], req.temperature,
                          req.max_tokens, req.seed, 1)
            seat = self._slots[slot_idx] = _Slot(
                req=req, detok=StreamDecoder(self.tokenizer),
                n_prompt=n_prompt, pos=n_prompt,
                queue_ms=(t_adm - req.t_submit) * 1000.0, t_admit=t_adm,
                chunks_inflight=1, prefix_hit=True, gs=-1)
            if req.trace is not None:
                req.trace.event(
                    f"engine: group-admitted to slot {slot_idx} (burst of "
                    f"{len(live)}, suffix bucket {sbucket})")
            pairs.append((seat, slot_idx))
        # The scratch's trash row (past kv_limit) stays behind: the slots
        # take exactly the kv_limit positions the forward wrote.
        with scope("kv_splice"):
            for dst, src in ((self._cache.k, scratch.k),
                             (self._cache.v, scratch.v)):
                kv_set_slots(dst, kv_map(lambda a: a[:, :, :kv_limit], src),
                             slots)
        self._inflight.append(("firsts", self._to_host_async(first_d),
                               pairs))
        self._group_admitted += 1
        self._last_admit_t = time.monotonic()

    # ------------------------------------------------------------ QoS ring

    def lane_occupancy(self) -> dict:
        """Slots held per lane (a racy read: a hint for admission and
        brownout, not an invariant)."""
        counts = {lane: 0 for lane in LANES}
        for s in list(self._slots):
            if s is not None:
                lane = s.req.lane
                counts[lane if lane in LANES else LANE_INTERACTIVE] += 1
        return counts

    def _capped_lanes(self, counts: dict) -> tuple:
        """Lanes at their brownout-trimmed slot cap: admission skips them
        (they stay queued) until the interactive queue wait recovers.
        Caps floor at one slot, so brownout never starves a lane."""
        capped = []
        for lane in (LANE_BACKGROUND, LANE_BATCH):
            cap = self._brownout.lane_cap(lane, self.batch_size)
            if cap < self.batch_size and counts.get(lane, 0) >= cap:
                capped.append(lane)
        return tuple(capped)

    def _expire_queued(self, req: _Request) -> None:
        """The QoS queue's scan-time expiry: a queued request whose
        deadline passed fails now and stops occupying MAX_QUEUE_DEPTH."""
        if req.trace is not None:
            req.trace.event("qos: deadline expired while queued — purged "
                            "at queue scan")
        self._emit(req, "error",
                   GenerationTimeout("deadline expired while queued"))

    def _credit_preempt_wait(self, req: _Request) -> None:
        """Exclude preempted-out wall time from the victim's deadline:
        its clock stopped at preemption and restarts at re-admission."""
        t0 = req.preempt_t0
        if t0 is None:
            return
        req.preempt_t0 = None
        paused = time.monotonic() - t0
        if req.deadline is not None:
            req.deadline += paused
        if req.trace is not None:
            req.trace.event(f"qos: resuming after {paused * 1000.0:.0f}ms "
                            f"preempted (deadline credited)")

    def _maybe_preempt(self) -> bool:
        """Preemptive decode: when a higher-lane request has waited past
        PREEMPT_WAIT_MS and every slot is busy, take the slot of the
        cheapest strictly-lower-lane request (lowest lane, then fewest
        generated tokens) and requeue it at the head of its tenant's
        queue; _admit_pending hands the freed slot to the starved lane.
        A request past PREEMPT_BUDGET preemptions is never picked again.
        Runs every scheduler turn, chunks in flight or not (never while
        a bisection has slots parked): the victim's in-flight chunks are
        discarded at their read by the seat check, as after a
        cancel, and billed as waste."""
        if self.preempt_wait_ms <= 0 or self._parked:
            return False
        if any(s is None for s in self._slots):
            return False
        now = time.monotonic()
        # A brownout-capped lane could not use a freed slot: preempting
        # for it would only churn the victim.
        lane = self._admissions.starved_lane(
            now, self.preempt_wait_ms / 1000.0,
            exclude=self._capped_lanes(self.lane_occupancy()))
        if lane is None:
            return False
        rank = lane_rank(lane)
        victims = [
            (i, s) for i, s in enumerate(self._slots)
            if s is not None and not s.exhausted
            and lane_rank(s.req.lane) < rank
            and s.req.preempt_count < self.preempt_budget
        ]
        if not victims:
            return False
        idx, _ = min(victims, key=lambda t: (lane_rank(t[1].req.lane),
                                             len(t[1].detok.ids)))
        self._preempt_slot(idx, lane)
        self._preempt_for_lane = lane
        return True

    def _preempt_slot(self, idx: int, for_lane: str) -> None:
        """Take slot ``idx`` from its request and requeue the request at
        the head of its tenant's queue with (prompt, generated ids,
        seed): the resume (``_admit_resume``) continues the transcript
        exactly. In the pool the victim's verified chain is cached in
        the radix tree BEFORE it is requeued, so its resume re-maps those
        blocks instead of prefilling; a staged admission (its prologue
        not dispatched, its suffix rows never written) caches nothing.
        The steps the chunks in flight still decode for the victim are
        waste, capped by its remaining budget (device termination; the
        host scan bills them at the read)."""
        slot = self._slots[idx]
        self._slots[idx] = None
        staged = self._pending_adm.pop(idx, None)
        self._temps[idx] = 0.0
        req = slot.req
        req.preempt_count += 1
        req.preempt_t0 = time.monotonic()
        ids = list(slot.detok.ids)
        req.resume_ids = ids or None
        # The client holds detok.text already: the resume emits only the
        # text past it (UTF-8 hold-back can leave text behind the ids).
        req.resume_skip = len(slot.detok.text)
        req.resume_emitted = False
        if req.export is not None:
            req.export.ids = list(ids)
        if self.device_termination and slot.decode_chunks_inflight > 0:
            remaining = max(0, req.max_tokens - len(ids))
            self._bill_waste(min(slot.decode_chunks_inflight
                                 * self._chunk_waste_bound(), remaining),
                             req)
        self._preemptions += 1
        self._preempted_tokens += len(ids)
        # The ledger bills the preempted class at the resume: the
        # re-derivation is the device work, and a victim cancelled while
        # queued never pays it.
        req.resume_cause = "preempt" if ids else ""
        self._preempt_times.append(req.preempt_t0)
        if req.trace is not None:
            req.trace.event(
                f"qos: preempted out of slot {idx} after {len(ids)} tokens "
                f"(lane {req.lane} yields to starved lane {for_lane}; "
                f"preemption {req.preempt_count}/{self.preempt_budget}) — "
                f"exported for seeded replay")
        if self.kv_pool:
            self._pool_release_slot(idx, slot, cache_chain=staged is None)
        self._admissions.requeue_head(req)

    def _admit_resume(self, req: _Request) -> None:
        """Seat a preempted request again: emit the text of its generated
        ids the client does not hold yet, then re-splice (prompt, ids,
        seed) through ``_replay_slot``."""
        t_adm = time.monotonic()
        detok = StreamDecoder(self.tokenizer)
        piece = detok.push(*req.resume_ids)
        if req.resume_emitted:
            piece = None
        elif req.resume_skip and piece is not None:
            piece = piece[req.resume_skip:] or None
        req.resume_emitted = True
        req.resume_skip = 0
        slot = _Slot(req=req, detok=detok, n_prompt=len(req.prompt_ids),
                     pos=0,             # set by _replay_slot
                     queue_ms=(t_adm - req.t_submit) * 1000.0,
                     t_admit=t_adm)
        if piece is not None:
            self._emit(req, "token", piece)
        if req.export is not None:
            req.export.ids = list(detok.ids)
        if len(detok.ids) >= req.max_tokens:
            slot_idx = self._slots.index(None)
            slot.t_first = t_adm
            self._slots[slot_idx] = slot
            self._finish(slot_idx, "length")
            return
        self._replay_slot(slot)

    def _replay_slot(self, slot: _Slot) -> None:
        """Re-splice one request from prompt + generated-so-far ids:
        the KV of prompt ++ ids[:-1], the carry token forced to the last
        id, the slot re-armed with ngen = len(ids), so the seed stream
        continues at the generation index an uninterrupted run would be
        at. The slot object (detok state, timings) is reused: nothing
        the client has is emitted again.

        In the pool the KV is a radix match first (``match_all``): a
        preempted victim's chain was cached at preemption, so its resume
        maps those blocks (plus a tail copy-on-write) and prefills at
        most the rows the tree did not keep. On the dense ladder it is
        one prefill of prompt ++ ids[:-1] spliced into the slot.

        Numerics: the replay builds the emitted tokens' KV by prefill
        where the original run built it in decode. The two agree exactly
        in float32 on the CPU; in bf16 on the card a last-ulp difference
        can flip a near-tie pick."""
        req = slot.req
        resume_cause, req.resume_cause = req.resume_cause, ""
        if req.cancel.is_set():
            return
        if req.deadline is not None and time.monotonic() > req.deadline:
            self._emit(req, "error", GenerationTimeout("generation timeout"))
            return
        ids = list(slot.detok.ids)
        if not ids:
            self._admit_fresh(req)
            return
        g = len(ids)
        slot_idx = self._slots.index(None)
        replay_ids = list(req.prompt_ids) + ids[:-1]
        if self.kv_pool:
            max_prompt = self.max_seq_len - max(1, req.max_tokens - g)
            if len(replay_ids) > max_prompt:
                replay_ids = replay_ids[-max_prompt:]
            n_total = len(replay_ids)
            blocks, m = self._pool_map_prefix(replay_ids, match_all=True)
            try:
                self._tables[slot_idx, :] = self._pool_n_blocks
                self._tables[slot_idx, :len(blocks)] = blocks
                if m < n_total:
                    self._pool_prefill_span(self._tables[slot_idx],
                                            replay_ids, m)
                self._run_arm(slot_idx, n_total, ids[-1], req.temperature,
                              req.max_tokens, req.seed, g)
                # The draft's rows were reset or belong to another
                # request: re-derive its view of prompt + ids[:-1].
                self._draft_prefill_slot(slot_idx, replay_ids)
            except Exception:
                self._tables[slot_idx, :] = self._pool_n_blocks
                self._pool.decref(blocks)
                raise
            slot.blocks = blocks
            if req.export is not None:
                req.export.blocks = list(blocks)
            # The chain basis for the radix insert at finish: replay_ids
            # minus the g - 1 generated ids.
            slot.pool_ids = (replay_ids[:n_total - (g - 1)] if g > 1
                             else replay_ids)
            if req.trace is not None and m > 0:
                req.trace.event(
                    f"engine: replay re-mapped {m}/{n_total} tokens from "
                    f"shared pool blocks (prefilled {n_total - m})")
        else:
            _, scratch, n_total, _ = self._prefill_prompt(
                replay_ids, max(1, req.max_tokens - g))
            self._splice_scratch(slot_idx, scratch, n_total)
            self._run_arm(slot_idx, n_total, ids[-1], req.temperature,
                          req.max_tokens, req.seed, g)
        slot.pos = slot.anchor_pos = n_total
        slot.anchor_g = g
        slot.chunks_inflight = 0
        slot.decode_chunks_inflight = 0
        slot.stale_chunks = 0
        if self._grammar is not None and req.gpid >= 0:
            # Host truth and the device word both re-derive from the
            # emitted ids: the next masked step samples at the state the
            # fault-free run is in (an off-grammar prefix lands in DEAD
            # and trips again).
            slot.gs = self._grammar.run(req.gpid, ids)
            self._grammar_arm(slot_idx, slot.gs)
        slot.exhausted = n_total >= self.max_seq_len
        self._slots[slot_idx] = slot
        self.supervisor.note_replay(g)
        # The ledger: the g generated tokens are re-derived by the replay,
        # device work that produces no new client byte — preempted for a
        # QoS resume, replayed for any other cause.
        self.ledger.record(
            CLASS_PREEMPTED if resume_cause == "preempt" else CLASS_REPLAYED,
            g, lane=req.lane, tenant=req.tenant)
        if req.trace is not None:
            req.trace.event(
                f"engine: replayed into slot {slot_idx} from {g} "
                f"generated tokens (seed {req.seed})")
        self._last_admit_t = time.monotonic()

    def qos_health(self) -> dict:
        """The QoS view for /health: queue depth per lane, the brownout
        level and lane shares, preemptions in total and in the last
        minute, expiry and displacement totals, session budgets."""
        now = time.monotonic()
        return {
            "lanes": self._admissions.lane_depths(),
            "brownout_level": self._brownout.level,
            "lane_shares": {k: round(v, 4)
                            for k, v in self._brownout.shares.items()},
            "preemptions_total": self._preemptions,
            "preemptions_last_60s": sum(
                1 for t in list(self._preempt_times) if t >= now - 60.0),
            "queue_expired_total": self._admissions.expired_total,
            "queue_displaced_total": self._admissions.displaced_total,
            "session_budgets": self._session_budgets.snapshot(),
        }

    def _bill_waste(self, n: int, req: Optional[_Request]) -> None:
        """Bill ``n`` wasted device steps to both the
        wasted_decode_steps counter and the ledger's wasted_masked class,
        at one call site per waste event, so the two books never drift."""
        if n <= 0:
            return
        self._wasted_steps += n
        lane = req.lane if req is not None else LANE_INTERACTIVE
        tenant = req.tenant if req is not None else None
        self.ledger.record(CLASS_WASTED_MASKED, n, lane=lane, tenant=tenant)

    def slo_health(self) -> dict:
        """The SLO burn-rate view for /health (pure reads)."""
        return self._slo.snapshot()

    def steptime_health(self) -> dict:
        """The step-time sentinel's view for /health and the incident
        watcher (a bounded-ring sort per digest, never stats())."""
        return self._steptime.snapshot()

    def ledger_snapshot(self) -> dict:
        """The goodput ledger for /debug/ledger: the lane table, the
        hashed-tenant table and the conservation check."""
        snap = self.ledger.snapshot()
        snap["tenants"] = self.ledger.tenant_snapshot()
        snap["conservation"] = self.ledger.conservation()
        return snap

    def stats(self) -> dict:
        """The scrape-time engine view /metrics mirrors, under the JAX
        engine's keys: occupancy, queue depth and KV pages; the decode
        pipeline (its depth, the chunks in flight, the termination mode
        served), the wasted steps and chunk counts,
        and the fetch-latency samples since the last call (drained);
        the QoS section, the ledger's lane table, the SLO burn rates, the
        step-time digests, the containment totals, the grammar totals
        and the speculative-decode totals."""
        slots = list(self._slots)
        if self._pool is not None:
            used = self._pool.n_blocks - self._pool.free_count
            pages_total = self._pool.n_blocks
        else:
            page = self.kv_page_size
            used = sum(-(-min(s.pos, self.max_seq_len) // page)
                       for s in slots if s is not None)
            pages_total = self.batch_size * -(-self.max_seq_len // page)
        fetch_samples = []
        while True:
            try:
                fetch_samples.append(self._fetch_samples.popleft())
            except IndexError:
                break
        return {
            "batch_occupancy": sum(s is not None for s in slots),
            "queue_depth": self._admissions.qsize(),
            "kv_pages_used": used,
            "kv_pages_total": pages_total,
            "pipe_depth": self.chunk_pipe_depth,
            "pipe_inflight": sum(1 for e in list(self._inflight)
                                 if e[0] == "chunk"),
            "device_active_slots": self._last_n_alive,
            "device_termination": self.device_termination,
            "wasted_decode_steps": self._wasted_steps,
            "chunks_dispatched": self._chunks_dispatched,
            "chunks_consumed": self._chunks_consumed,
            "chunks_pruned": self._chunks_pruned,
            "chunk_fetch_secs": fetch_samples,
            "queue_rejections": self._rejections,
            "qos": dict(self._admissions.stats(),
                        lane_occupancy=self.lane_occupancy(),
                        preemptions=self._preemptions,
                        preempted_tokens=self._preempted_tokens,
                        brownout_level=self._brownout.level,
                        brownout_transitions=self._brownout.transitions,
                        lane_shares={
                            k: round(v, 4)
                            for k, v in self._brownout.shares.items()}),
            "ledger": self.ledger.snapshot(),
            "slo": self._slo.snapshot(),
            "steptime": self._steptime.snapshot(),
            # Containment totals (resets by cause, quarantines by reason,
            # health trips, replayed tokens), mirrored into /metrics.
            "containment": dict(self.supervisor.stats(),
                                parked=len(self._parked),
                                slot_health_check=self.slot_health_check),
            # Grammar totals (None with the grammar off), mirrored into
            # /metrics and summarized in /health's grammar section.
            "grammar": self.grammar_health(),
            # Speculative totals (None with it off), likewise.
            "spec": self.spec_health(),
            # The mesh (None without one), mirrored into /metrics.
            "sharding": self.sharding_health(),
        }

    def sharding_health(self) -> Optional[dict]:
        """The sharding view for /health and /metrics, under the JAX
        batcher's keys (host attributes only): the mesh, its device
        count, the residual fraction the policy splits at the decode
        shape, whether the pool actually serves (the JAX ``_use_pool``),
        the mesh-fallback flag (a data axis turned a requested pool into
        the dense ladder), the draft flags (the draft world on the mesh,
        its KV replicated) and the attention regime actually serving."""
        if self.mesh is None:
            return None
        return {
            "mesh": dict(self.mesh.shape),
            "devices": int(self.mesh.size),
            "residual_tp_fraction": residual_fraction(
                self.mesh, self.batch_size, self.model_cfg.dim),
            "pool_sharded": bool(self.kv_pool),
            "kv_pool_mesh_fallback": bool(self._kv_pool_mesh_fallback),
            "draft_sharded": bool(self._draft_sharded),
            "draft_kv_fallback": bool(self._draft_kv_fallback),
            "attention_regime": self._attention_regime,
        }

    #: finish times older than this do not feed the drain rate: after an
    #: idle hour the first shed must not price Retry-After off a rate
    #: diluted by the gap.
    DRAIN_RATE_HORIZON_SECS = 60.0

    def retry_after_hint(self, lane: Optional[str] = None) -> float:
        """Seconds until the queued work plausibly drains, from the
        completion rate of recent finishes (the last 64, within the
        horizon): the Retry-After a shed carries. With ``lane`` the
        estimate is that lane's own depth over its own drain rate,
        falling back to the engine-wide one without lane history; 5 s
        with no history at all; clamped to [1, 60]."""
        horizon = time.monotonic() - self.DRAIN_RATE_HORIZON_SECS
        if lane is not None:
            depth = self._admissions.lane_depths().get(lane, 0)
            ts = [t for t in list(self._lane_finish.get(lane, ()))
                  if t >= horizon]
            if len(ts) >= 2 and ts[-1] > ts[0]:
                rate = (len(ts) - 1) / (ts[-1] - ts[0])
                if rate > 0:
                    return min(max(depth / rate, 1.0), 60.0)
            return self.retry_after_hint()
        depth = self._admissions.qsize()
        ts = [t for t in list(self._finish_times) if t >= horizon]
        if len(ts) >= 2 and ts[-1] > ts[0]:
            rate = (len(ts) - 1) / (ts[-1] - ts[0])
            if rate > 0:
                return min(max(depth / rate, 1.0), 60.0)
        return 5.0

    # ---------------------------------------------------------- scheduler

    def _sweep_finishes(self) -> None:
        """Host-only finishes before a dispatch: cancellation, deadline,
        and KV capacity (``pos`` counts scheduled chunks, so a slot at
        capacity finishes once its in-flight chunk is consumed)."""
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
            elif slot.exhausted or slot.pos >= self.max_seq_len:
                slot.exhausted = True
                if slot.chunks_inflight == 0:
                    self._finish(i, "length")

    def _prune_dead_chunks(self) -> None:
        """Drop leading chunk entries that carry tokens for no live slot
        (every slot they were dispatched for finished since, e.g. the
        chunks still in flight when the last request ends): their read
        would only block the scheduler. Under the host scan a pruned
        chunk still decoded a whole chunk for each slot it was
        dispatched with, billed as waste here."""
        while self._inflight and self._inflight[0][0] == "chunk":
            snapshot, seats = self._inflight[0][2], self._inflight[0][5]
            if any(seat is not None and self._slots[i] is seat
                   for i, seat in enumerate(seats)):
                return
            self._inflight.pop(0)
            if not self.device_termination:
                for snap in snapshot:
                    if snap is not None:
                        self._bill_waste(self.chunk_len, snap)
            self._chunks_pruned += 1
            self._chunk_log.append({"t": time.time(), "event": "prune"})

    def _worker_loop(self) -> None:
        # The chunk pipeline, CHUNK_PIPE_DEPTH deep (the JAX engine's
        # loop): dispatch chunk N+1 on the device carry before reading
        # chunk N, so the host's reads, detokenizing and admissions
        # overlap the device's work. The in-flight list holds two kinds
        # of entry, read strictly first in, first out:
        #
        # - ("chunk", handle, snapshot, ct, spec, seats): a decode chunk
        #   for every slot, with the slot -> seat (and request) snapshot
        #   at dispatch; a row whose slot was freed or reseated since is
        #   discarded at the read.
        # - ("first", handle, seat, slot_idx): an eager admission's first
        #   token, still on its way to the host: an admission never
        #   waits on a host read.
        # - ("firsts", handle, [(seat, slot_idx), ...]): a group
        #   admission's first tokens, one vector read once.
        #
        # Only chunks count against the depth; first-token entries are
        # transfers, not compute. (The list is not reset here: a
        # supervisor restart may already have queued replays.)
        while self._running:
            try:
                if self.faults is not None:
                    # scheduler:die raises a BaseException the except
                    # below cannot catch: this thread really dies, and
                    # the supervisor's restart is what recovers.
                    self.faults.check_scheduler_die()
                self._last_progress = time.monotonic()
                # Bisection probation ends when the probe group drains
                # (no slot, nothing in flight), or earlier after
                # PROBATION_CLEAN_CHUNKS clean chunks (_probation_tick).
                if (self._parked and not self._inflight
                        and all(s is None for s in self._slots)):
                    self._unpark_parked()
                    continue
                self._profile_tick()
                # The QoS ring: the brownout controller's evaluation
                # (time-gated, cheap; the SLO engine's fast-window burn
                # of interactive queue wait is its early-trim input),
                # then preemption for the starved lane, whose freed slot
                # _admit_pending hands to it.
                self._brownout.maybe_eval(
                    burn_fn=lambda: self._slo.fast_burn(
                        SLO_QUEUE_WAIT, LANE_INTERACTIVE))
                self._maybe_preempt()
                self._admit_pending()
                self._sweep_finishes()
                n_active = sum(s is not None and not s.exhausted
                               for s in self._slots)
                chunks_in_pipe = sum(1 for e in self._inflight
                                     if e[0] == "chunk")
                # Latency at low occupancy: with at most two slots live
                # and no chunk in flight, deliver a fresh admission's
                # first token before dispatching behind it; with more
                # streams, keep the pipe full and let the read overlap.
                if (chunks_in_pipe == 0 and n_active <= 2 and self._inflight
                        and self._inflight[0][0] in ("first", "firsts")):
                    self._consume_oldest()
                    continue
                if n_active > 0 and chunks_in_pipe < self.chunk_pipe_depth:
                    now = time.monotonic()
                    if (chunks_in_pipe == 0
                            and any(s is None for s in self._slots)
                            and now - self._last_admit_t
                            < self.ADMIT_RAMP_SECS):
                        # Burst ramp: while admissions keep landing and
                        # slots are free, hold the first chunk so the
                        # rest of a burst boards it (capped from the
                        # hold's start: a steady trickle cannot defer it).
                        if self._ramp_hold_t0 is None:
                            self._ramp_hold_t0 = now
                        if now - self._ramp_hold_t0 < self.ADMIT_RAMP_MAX_SECS:
                            if self._admissions.empty():
                                time.sleep(0.002)
                            continue
                    self._ramp_hold_t0 = None
                    self._dispatch_chunk()
                    continue
                self._prune_dead_chunks()
                if self._inflight:
                    self._consume_oldest()
                    continue
                # Idle: wait for an admission.
                try:
                    req = self._admissions.get(timeout=0.05)
                except _queue.Empty:
                    continue
                self._admit_popped([req])
            except Exception as e:
                # The step is poisoned, not the engine: the containment
                # pass quarantines the culprit (bisecting when the fault
                # names no slot) and replays the survivors; only a spent
                # reset budget fails every active request. The frames of
                # the traceback drop their locals first, so no tensor of
                # the failed step outlives the reset.
                logger.exception("batch scheduler step poisoned; running "
                                 "containment")
                traceback.clear_frames(e.__traceback__)
                try:
                    self._contain_poisoned_step(CAUSE_SCHEDULER_ERROR,
                                                error=e)
                except Exception:  # pragma: no cover - containment itself
                    logger.exception("containment failed; failing active "
                                     "slots")
                    self._fail_all_active(
                        EngineUnavailable("scheduler error"))
        # Shutdown: active, parked and queued requests all fail, so no
        # generate() call blocks forever.
        self._fail_all_active(EngineUnavailable("engine stopped"))
        for req in self._admissions.drain():
            self._emit(req, "error", EngineUnavailable("engine stopped"))
        self._profile_tick(stopping=True)

    # ------------------------------------------------------------ profiler

    async def profile(self, seconds: float, trace_dir: str) -> None:
        """One ``torch.profiler`` capture of ``seconds`` into
        ``trace_dir``, run by the scheduler thread (the profiler records
        the ranges of the thread that starts it, and the forwards run
        there): started at its next loop pass, stopped and exported at
        the first pass after ``seconds``. One at a time; raises when the
        engine's device cannot be traced."""
        if not self._running:
            raise EngineUnavailable("engine not started")
        if self._profile_req is not None:
            raise RuntimeError("a capture is already running")
        session = ProfilerSession(self.device)
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._profile_req = [session, trace_dir, seconds, None, fut]
        await asyncio.wrap_future(fut)

    def _profile_tick(self, stopping: bool = False) -> None:
        """The scheduler's side of ``profile``: start a requested
        capture, or stop and export a running one that is due (or the
        engine is stopping)."""
        req = self._profile_req
        if req is None:
            return
        session, trace_dir, seconds, t_end, fut = req
        try:
            if t_end is None and not stopping:
                session.start()
                req[3] = time.monotonic() + seconds
                return
            if t_end is None:
                raise EngineUnavailable("engine stopped")
            if stopping or time.monotonic() >= t_end:
                self._profile_req = None
                session.stop(trace_dir)
                fut.set_result(trace_dir)
        except Exception as e:
            self._profile_req = None
            fut.set_exception(e)

    def _worker_main(self) -> None:
        """The scheduler thread's entry: runs the loop and, when the loop
        dies of an uncatchable fault (a BaseException: the poisoned-step
        containment inside the loop handles every Exception), lets the
        thread end so ``_supervise_scheduler`` notices and restarts it.
        Never re-raises: a dead scheduler is a recoverable engine event,
        not a process event."""
        try:
            self._worker_loop()
        except BaseException:
            logger.critical("batch scheduler thread died; the supervisor "
                            "will restart it", exc_info=True)

    # --------------------------------------------------------- containment

    def set_reset_listener(self, fn) -> None:
        """Wire engine resets to the service (the circuit breaker):
        ``fn(cause)`` runs after every recorded reset, so a flapping
        engine opens the breaker even while requests keep recovering."""
        self.supervisor.on_reset = fn

    def _fail_all_active(self, error: BaseException) -> None:
        """Every active and parked request fails (queued ones stay): the
        path when containment is out of budget, and at shutdown."""
        self._inflight.clear()
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._finish(i, "error", error=error)
        for slot in self._parked:
            self._emit(slot.req, "error", error)
        self._parked.clear()

    def _contain_poisoned_step(self, cause: str, named=(),
                               error: Optional[BaseException] = None
                               ) -> None:
        """The quarantine and reset-and-replay pass (the JAX engine's).

        ``named`` lists the slots the device health word implicated (the
        culprit is known); empty means a step-wide fault (an exception in
        a scheduler step, a poisoned fetch) and bisection isolates it:
        half the suspects replay, the rest are parked, and whichever half
        poisons again is halved in turn. A slot solo-implicated past its
        retry budget ends with ``RequestQuarantined`` (410: the engine is
        fine, that request is not); every other survivor is re-spliced
        from prompt + generated ids and replays under its seed. Queued
        requests are untouched: a reset drops none."""
        survivors = [s for s in self._slots if s is not None]
        if not self.supervisor.allow_reset():
            # The reset budget (ENGINE_RESET_MAX_PER_MIN) is spent: a
            # flapping engine must degrade, not thrash. The failures feed
            # the breaker, the next ring out.
            logger.critical(
                "engine reset budget exhausted (%d/min); failing %d "
                "slot(s) instead of resetting again",
                self.supervisor.max_resets_per_min, len(survivors))
            self._fail_all_active(
                error if isinstance(error, Exception) else
                EngineUnavailable("engine reset budget exhausted"))
            return
        # Culprit isolation: a health-named slot is implicated directly;
        # an unnamed fault whose suspect pool is down to one request has
        # bisected to its culprit. Either way the retry budget decides
        # between quarantine now and one more replay.
        quarantined: List[_Slot] = []
        reasons: dict = {}
        pool = list(survivors)
        if named:
            for slot in named:
                if self.supervisor.implicate(slot.req):
                    quarantined.append(slot)
                    reasons[id(slot)] = REASON_HEALTH
        else:
            # Narrow to the standing suspect pool: after an early
            # exoneration the batch mixes cleared cohabitants (and new
            # admissions) with the still-suspect half, and only the
            # latter keeps bisecting. No flag standing: everyone.
            flagged = [s for s in survivors if s.req.suspect]
            if flagged:
                pool = flagged
            if len(pool) == 1:
                slot = pool[0]
                if self.supervisor.implicate(slot.req):
                    quarantined.append(slot)
                    reasons[id(slot)] = REASON_ISOLATED
        self._reset_decode_state(survivors, cause)

        qset = {id(s) for s in quarantined}
        for slot in quarantined:
            reason = reasons[id(slot)]
            self.supervisor.note_quarantine(reason)
            # The ledger: everything this request generated is discarded
            # — burned, never delivered (a quarantine never reaches
            # _finish, so nothing bills twice).
            burn = len(slot.detok.ids) - slot.req.ledger_delivered
            slot.req.ledger_delivered = len(slot.detok.ids)
            self.ledger.record(CLASS_QUARANTINE_BURN, burn,
                               lane=slot.req.lane, tenant=slot.req.tenant)
            if slot.req.trace is not None:
                slot.req.trace.event(
                    f"engine: quarantined ({reason}, suspected "
                    f"{slot.req.suspect_count}x, {len(slot.detok.ids)} "
                    f"tokens generated)")
            self._finish_times.append(time.monotonic())
            self._emit(slot.req, "error", RequestQuarantined(
                f"request quarantined after poisoning {cause} "
                f"{slot.req.suspect_count}x (retry budget "
                f"{self.supervisor.retry_budget})"))

        rest = [s for s in survivors
                if id(s) not in qset and not s.req.cancel.is_set()]
        if named:
            probe, parked = rest, []
        else:
            # A step-wide fault: bisect within the suspect pool only —
            # replay one half, park the other, and replay every
            # non-suspect alongside the probe. If the probe poisons
            # again this pass recurses on the halved pool; after
            # PROBATION_CLEAN_CHUNKS clean chunks (or a drain) suspicion
            # moves to the parked half, which unparks.
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
        logger.warning(
            "engine reset (%s): %d survivor(s) — %d quarantined, "
            "%d replaying, %d parked for bisection", cause, len(survivors),
            len(quarantined), len(probe), len(parked))
        self._parked.extend(parked)
        self._probation_clean = 0   # each pass restarts probation
        for slot in parked:
            if slot.req.trace is not None:
                slot.req.trace.event("engine: parked for culprit bisection")
        for slot in probe:
            self._guarded_replay(slot)

    def _unpark_parked(self) -> None:
        """End bisection probation: replay every parked slot (each
        resumes from its generated ids); admissions resume on the next
        loop pass."""
        parked, self._parked = self._parked, []
        self._probation_clean = 0
        for slot in parked:
            self._guarded_replay(slot)

    def _reset_decode_state(self, survivors: List[_Slot],
                            cause: str) -> None:
        """Tear down and record one reset: the slots detach, the entries
        in flight drop (their events and pinned host buffers with them:
        the kernels still queued run out on the old buffers, which the
        stream-ordered allocators hand out again only behind them) and
        every device buffer is rebuilt as startup built it. The old
        ones may hold poisoned (NaN) KV rows: nothing
        is salvaged; a replay re-derives each slot from host truth
        (prompt, generated ids, seed). In the pool the rebuilt allocator
        and radix tree start empty, so every survivor's block list is
        stale: cleared here (a replay must never decref an old id into
        the new pool)."""
        self._slots = [None] * self.batch_size
        self._inflight.clear()
        self._init_decode_state()
        if self.kv_pool:
            for s in survivors:
                s.blocks = []
        # Staged ragged admissions die with the state they were staged
        # against; their replay re-stages them.
        self._pending_adm.clear()
        self._last_progress = time.monotonic()
        self.supervisor.note_reset(cause)

    def _guarded_replay(self, slot: _Slot) -> None:
        """Replay one survivor; a failing replay (an allocation, a drill
        hitting the admission path) errors that request only."""
        try:
            self._replay_slot(slot)
        except Exception:
            logger.exception("replay failed; failing the request")
            self._emit(slot.req, "error",
                       EngineUnavailable("replay after engine reset failed"))

    def _supervise_scheduler(self, epoch: int) -> None:
        """Watch for scheduler-thread death (the watchdog watches for a
        hang). A dead scheduler (scheduler:die in a drill, an uncatchable
        error in the wild) recovers like a poisoned step: reset, replay
        the survivors, and a new loop thread, started as ``start`` starts
        it (the default stream and device, no per-thread state of its
        own). Queued requests sit in a thread-safe queue the dead thread
        never drained, and requests it popped but had not settled are
        requeued at the head: zero queued requests are dropped."""
        while self._running and self._epoch == epoch:
            time.sleep(0.2)
            worker = self._worker
            if (not self._running or self._stopping or worker is None
                    or worker.is_alive() or self._epoch != epoch):
                continue
            survivors = [s for s in self._slots if s is not None]
            if not self.supervisor.allow_reset():
                logger.critical("scheduler dead and reset budget "
                                "exhausted; marking the engine degraded")
                self._ready = False
                err = EngineUnavailable(
                    "scheduler dead; engine reset budget exhausted")
                self._fail_all_active(err)
                for req in self._admitting_reqs:
                    self._emit(req, "error", err)
                self._admitting_reqs.clear()
                for req in self._admissions.drain():
                    self._emit(req, "error", err)
                self._abandon_profile()
                return
            logger.critical("batch scheduler thread dead; resetting the "
                            "decode state and restarting it (%d "
                            "survivor(s))", len(survivors))
            # Requests popped but not settled hold no slot and no
            # generated token: a fresh admission replays them exactly.
            # Head re-entry, never put(): no cap may shed them.
            slotted = {id(s.req) for s in survivors}
            for req in reversed(self._admitting_reqs):
                if id(req) not in slotted:
                    self._admissions.requeue_head(req)
            self._admitting_reqs.clear()
            self._reset_decode_state(survivors, CAUSE_SCHEDULER_DEATH)
            self._abandon_profile()
            for slot in survivors:
                self._guarded_replay(slot)
            self._worker = threading.Thread(
                target=self._worker_main, name="torch-batcher", daemon=True)
            self._worker.start()

    def _abandon_profile(self) -> None:
        """A capture the dead thread started cannot be stopped by the
        thread that started it: stop it here (the new thread must not
        start a second one while the first runs) and settle its caller.
        A capture not yet started is left to the new thread."""
        req = self._profile_req
        if req is None or req[3] is None:
            return
        self._profile_req = None
        session, trace_dir, _, _, fut = req
        try:
            session.stop(trace_dir)
            fut.set_result(trace_dir)
        except Exception as e:
            fut.set_exception(e)

    # ------------------------------------------------------------ watchdog

    def _watchdog_loop(self, epoch: int) -> None:
        """Detect a hung device dispatch: the scheduler thread blocks in a
        call that never returns, so every request — those without a
        client timeout too — would wait forever while /health stayed
        green. Checked from a thread of its own every quarter of the
        limit (at least a second); fires once, and re-marks the engine
        ready when progress resumes. The limit is read at every pass, so
        it can be tightened on a live engine (0 pauses the watchdog)."""
        fired = False
        last = time.monotonic()
        while self._running and self._epoch == epoch:
            time.sleep(0.25)
            interval = max(1.0, self.watchdog_secs / 4.0)
            if (self.watchdog_secs <= 0
                    or time.monotonic() - last < interval):
                continue
            last = time.monotonic()
            if not fired:
                fired = self._watchdog_check()
            elif time.monotonic() - self._last_progress <= 2 * interval:
                # The stall was transient: the scheduler ticks again.
                # Failed requests stay failed; new traffic is served
                # (never while stop() drains).
                logger.warning("engine watchdog: scheduler progress "
                               "resumed; re-marking the engine ready")
                if not self._stopping:
                    self._ready = True
                fired = False

    def _watchdog_check(self) -> bool:
        """One watchdog evaluation; True when it fired."""
        busy = bool(self._inflight) or any(
            s is not None for s in self._slots)
        if not busy:
            self._last_progress = time.monotonic()
            return False
        # The cold-start grace: until the first pipeline entry is
        # consumed, and while an admission runs on the scheduler thread,
        # no progress is judged against ENGINE_STARTUP_GRACE_SECS.
        limit = self.watchdog_secs
        if not self._first_consumed or self._admitting > 0:
            limit = max(limit, self.startup_grace_secs)
        if time.monotonic() - self._last_progress <= limit:
            return False
        logger.critical(
            "engine watchdog: no scheduler progress for %.0fs with work in "
            "flight — marking the engine degraded and failing %d slot(s)",
            limit, sum(s is not None for s in self._slots))
        self._ready = False
        err = EngineUnavailable("engine watchdog: device dispatch hung")
        for slot in list(self._slots):
            if slot is not None:
                # Unblock the waiting coroutine but leave _slots to the
                # scheduler thread: a merely slow scheduler drops the
                # cancelled request at its next sweep.
                slot.req.cancel.set()
                self._emit(slot.req, "error", err)
        for req in self._admissions.drain():
            req.cancel.set()
            self._emit(req, "error", err)
        return True

    async def stop(self, drain_secs: float = 0.0) -> None:
        self._ready = False
        self._stopping = True       # the watchdog must not re-mark ready
        if drain_secs > 0:
            deadline = time.monotonic() + drain_secs
            while time.monotonic() < deadline:
                busy = (any(s is not None for s in self._slots)
                        or not self._admissions.empty()
                        or self._admitting > 0 or bool(self._inflight)
                        or bool(self._parked))
                if not busy:
                    break
                await asyncio.sleep(0.05)
        self._running = False
        if self._worker is not None:
            await asyncio.to_thread(self._worker.join, 10.0)
            self._worker = None
        # The guards end at their next poll. Joined here, so a stopped
        # engine holds no live frame: the caller can free it at once
        # (its weights and KV) rather than at some later collection.
        for t in self._guards:
            await asyncio.to_thread(t.join, 2.0)
        self._guards = []
        self._profile_tick(stopping=True)    # a request the loop missed

    # ------------------------------------------------------------ serving

    def _inject_flood(self, n: int, loop) -> None:
        """The tenant:flood:<n> drill: ``n`` requests of real decode work
        under one synthetic background tenant, so fairness and
        preemption are exercisable without a load generator. A burst
        past the queue's own caps is cut there: the drill must not wedge
        the queue it stresses."""
        from ..testing.faults import FLOOD_LANE, FLOOD_TENANT

        now = time.monotonic()
        max_toks = max(1, min(32, self.max_seq_len // 2))
        # Under the grammar the burst decodes in its lane's profile like
        # any request of that lane.
        gpid = (self._grammar.resolve(lane=FLOOD_LANE)
                if self._grammar is not None else -1)
        for i in range(n):
            prompt = f"tenant flood drill {i}"
            req = _Request(
                prompt_ids=self.tokenizer.encode(prompt),
                max_tokens=max_toks, temperature=0.0,
                deadline=now + 30.0, loop=loop, out_queue=asyncio.Queue(),
                cancel=threading.Event(), t_submit=now, seed=i,
                prompt=prompt, tenant=FLOOD_TENANT, lane=FLOOD_LANE,
                gpid=gpid)
            try:
                self._admissions.put(req)
            except EngineOverloaded:
                break

    async def stream_events(self, prompt: str, *, max_tokens: int = 128,
                            temperature: float = 0.0,
                            timeout: Optional[float] = None,
                            seed: Optional[int] = None,
                            resume_ids: Optional[List[int]] = None,
                            export: Optional[RequestExport] = None):
        """The fleet's event stream (``engine/fleet.py``): the whole
        cross-replica contract — a pinned seed, ``resume_ids`` imported
        (a prefix generated on another replica re-spliced through
        ``_admit_resume``) and the live ``export`` of this request's
        generated ids and blocks, stamped with this engine's weights
        version at submit."""
        async for ev in self._stream_events(
                prompt, max_tokens=max_tokens, temperature=temperature,
                timeout=timeout, seed=seed, resume_ids=resume_ids,
                export=export):
            yield ev

    async def _stream_events(self, prompt: str, *, max_tokens: int,
                             temperature: float, timeout: Optional[float],
                             seed: Optional[int] = None,
                             resume_ids: Optional[List[int]] = None,
                             export: Optional[RequestExport] = None):
        if not self._ready:
            raise EngineUnavailable("engine not started")
        if seed is None:
            seed = default_seed(prompt)
        # QoS classification: the tenant and lane ride a contextvar from
        # the HTTP layer; a direct engine call runs in one interactive
        # anon bucket. A session over its token budget runs background.
        qctx = current_qos()
        tenant = (qctx.tenant if qctx is not None else "") or ANON_TENANT
        lane = (qctx.lane if qctx is not None and qctx.lane in LANES
                else LANE_INTERACTIVE)
        session = qctx.session if qctx is not None else ""
        lane = self._session_budgets.lane_for(session, lane)
        trace = current_trace()
        # Grammar resolution: the base profile, clamped readonly for the
        # background lane or an explicit ask, narrowed by a validated
        # allowed-verbs set. A new verb set compiles a variant (seconds
        # of CPU at a real vocabulary), so it runs off the event loop;
        # the scheduler only ever sees a profile id.
        gpid = -1
        if self._grammar is not None:
            from ..constrain import current_grammar

            gctx = current_grammar()
            if gctx is not None and gctx.allowed_verbs:
                gpid = await asyncio.to_thread(
                    self._grammar.resolve, lane=lane, ctx=gctx)
            else:
                gpid = self._grammar.resolve(lane=lane, ctx=gctx)
            if trace is not None:
                trace.event(f"grammar: profile id {gpid} (lane={lane})")
        loop = asyncio.get_running_loop()
        if self.faults is not None and not self._warming:
            # tenant:flood:<n>: a synthetic background-tenant burst lands
            # ahead of this submission, so the request that armed it
            # meets the contention under test. The warm-up generate in
            # start() must not consume the one-shot; every other seam
            # is armed through the warm-up, as in the JAX engine.
            burst = self.faults.tenant_flood()
            if burst:
                if trace is not None:
                    trace.event(f"qos: tenant:flood drill injecting "
                                f"{burst} synthetic requests")
                self._inject_flood(burst, loop)
        t_submit = time.monotonic()
        req = _Request(
            prompt_ids=self.tokenizer.encode(prompt),
            max_tokens=max(1, min(max_tokens, self.max_seq_len - 1)),
            temperature=temperature,
            deadline=(t_submit + timeout) if timeout else None,
            loop=loop,
            out_queue=asyncio.Queue(),
            cancel=threading.Event(),
            t_submit=t_submit,
            seed=int(seed) & 0x7FFFFFFF,
            trace=trace,
            tenant=tenant,
            lane=lane,
            session=session,
            prompt=prompt,
            gpid=gpid,
            # A fleet import: the prefix was decoded and billed delivered
            # on the donor replica, whose client got its first byte.
            resume_ids=list(resume_ids) if resume_ids else None,
            export=export,
            ledger_delivered=len(resume_ids) if resume_ids else 0,
            ttft_exempt=bool(resume_ids),
        )
        if export is not None:
            # The ids this engine generates are a function of THESE
            # weights: the fleet's version pinning routes on this stamp.
            export.weights_version = self.weights_version
        # Fair-share shedding at submit: past the tenant cap a 429 to the
        # flooding tenant; at MAX_QUEUE_DEPTH the dominant tenant's newest
        # request is displaced for a quieter arrival, and the arrival is
        # shed only when its own tenant is the flood. Retry-After is
        # priced from the shed lane's drain rate.
        try:
            displaced = self._admissions.put(req)
        except EngineOverloaded as e:
            self._rejections += 1
            e.retry_after = max(0.0, self.retry_after_hint(lane=lane))
            if trace is not None:
                trace.event(f"qos: shed at per-tenant cap — {e}"
                            if isinstance(e, TenantOverloaded) else
                            f"engine: admission queue full — shed ({e})")
            raise
        for victim in displaced:
            self._rejections += 1
            if victim.trace is not None:
                victim.trace.event(
                    "qos: displaced from the full admission queue "
                    f"(tenant {victim.tenant!r} holds the largest share)")
            self._emit(victim, "error", EngineOverloaded(
                f"displaced from a full admission queue (tenant "
                f"{victim.tenant!r} holds the largest queue share)",
                retry_after=self.retry_after_hint(lane=victim.lane)))
        try:
            while True:
                # The live deadline: a preemption credits its paused
                # wall time back onto it.
                if req.deadline is not None:
                    remaining = req.deadline - time.monotonic()
                    # The worker enforces the deadline too; the grace
                    # covers a chunk in flight.
                    try:
                        event, payload = await asyncio.wait_for(
                            req.out_queue.get(), remaining + 2.0)
                    except asyncio.TimeoutError:
                        raise GenerationTimeout(
                            "generation exceeded timeout") from None
                else:
                    event, payload = await req.out_queue.get()
                if event == "error":
                    raise payload
                yield (event, payload)
                if event == "done":
                    return
        finally:
            req.cancel.set()
