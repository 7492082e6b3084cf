"""The Engine protocol — the seam between the service and an inference
backend — and the packed decode-chunk contract (v3), copied from the JAX
package's ``engine/protocol.py`` so both engines speak one contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import AsyncIterator, List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np


class EngineUnavailable(RuntimeError):
    """Engine not initialized / degraded mode -> HTTP 503."""


class EngineOverloaded(EngineUnavailable):
    """Admission rejected by overload protection (bounded queue) -> a
    fast HTTP 503 with ``Retry-After`` instead of a request that waits
    until it times out. ``retry_after`` is the engine's estimate in
    seconds."""

    def __init__(self, message: str, retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = max(0.0, float(retry_after))


class TenantOverloaded(EngineOverloaded):
    """Per-tenant admission cap hit (the QoS queue, ``engine/qos.py``)
    -> HTTP 429. An ``EngineOverloaded`` subclass: to the breaker it is
    still backpressure, never a sign of engine health. The HTTP layer
    answers 429 instead of 503 — the flooding tenant is told to back
    off, everyone else keeps being served — with ``Retry-After`` priced
    from the shed lane's own drain rate."""

    def __init__(self, message: str, retry_after: float = 1.0,
                 tenant: str = "", lane: str = ""):
        super().__init__(message, retry_after=retry_after)
        self.tenant = tenant
        self.lane = lane


class GenerationTimeout(TimeoutError):
    """Generation exceeded the configured timeout -> HTTP 504."""


class RequestQuarantined(RuntimeError):
    """Terminal per-request failure: the request's own decode steps went
    bad (NaN/Inf logits, an out-of-range token id) -> HTTP 410. Not an
    ``EngineUnavailable``: the engine is healthy, and a retry of the same
    request elsewhere would only fail again."""


# ---------------------------------------------------------------------------
# Packed chunk-result contract (decode pipeline seam) — v3
#
# A decode chunk returns ONE flat int32 buffer so tokens, termination,
# occupancy and per-slot health cross the device->host link in a single
# fetch:
#
#     [ tokens (n_slots x chunk_len) | done_mask (n_slots)
#       | live_lengths (n_slots) | health (n_slots)
#       | spec_drafted (n_slots) | spec_accepted (n_slots)   (spec only)
#       | n_alive (1) ]
#
# - ``tokens[i]``: the chunk's sampled ids for slot i (entries past the
#   slot's termination point repeat its last counted token — never
#   emitted).
# - ``done_mask[i]``: slot i terminated (EOS or token budget) in or
#   before this chunk.
# - ``live_lengths[i]``: slot i's CUMULATIVE completion-token count after
#   this chunk; the consumer derives this chunk's valid tokens as
#   ``live_lengths[i] - already_emitted``.
# - ``health[i]``: bitmask of corruption detected in slot i this chunk
#   (HEALTH_NONFINITE: NaN/Inf logits; HEALTH_TOKEN_RANGE: a sampled id
#   outside [0, vocab)). A tripped slot froze inside the chunk.
# - ``spec_drafted`` / ``spec_accepted``: speculative decoding's lanes,
#   present only when ``spec=True``: draft tokens proposed and accepted
#   for each slot this chunk.
# - ``n_alive``: slots still decoding after the chunk.
# ---------------------------------------------------------------------------

PACKED_CHUNK_VERSION = 3

#: health-word bits (per slot, OR-able).
HEALTH_OK = 0
HEALTH_NONFINITE = 1      # NaN/Inf in the slot's step logits
HEALTH_TOKEN_RANGE = 2    # sampled token id outside [0, vocab_size)
HEALTH_GRAMMAR_DEAD = 4   # grammar-constrained decode: no legal token

_HEALTH_NAMES = ((HEALTH_NONFINITE, "nonfinite_logits"),
                 (HEALTH_TOKEN_RANGE, "token_out_of_range"),
                 (HEALTH_GRAMMAR_DEAD, "grammar_dead_end"))


def describe_health(word: int) -> str:
    """Label for a health bitmask (``"nonfinite_logits"``,
    ``"nonfinite_logits|token_out_of_range"``, ...)."""
    parts = [name for bit, name in _HEALTH_NAMES if word & bit]
    if int(word) and not parts:  # unknown future bit
        parts = [f"bit{int(word)}"]
    return "|".join(parts) or "ok"


def packed_chunk_size(n_slots: int, chunk_len: int,
                      spec: bool = False) -> int:
    """Flat length of one packed chunk buffer."""
    return n_slots * chunk_len + (5 if spec else 3) * n_slots + 1


@dataclass
class ChunkResult:
    """Host-side view of one unpacked decode chunk."""

    tokens: np.ndarray      # [n_slots, chunk_len] int32
    done: np.ndarray        # [n_slots] bool
    lengths: np.ndarray     # [n_slots] int32 cumulative completion tokens
    health: np.ndarray      # [n_slots] int32 health bitmask (0 = healthy)
    n_alive: int
    drafted: Optional[np.ndarray] = None   # [n_slots] int32 (spec only)
    accepted: Optional[np.ndarray] = None  # [n_slots] int32 (spec only)


def pack_chunk(tokens, done, lengths, n_alive, *, health=None,
               drafted=None, accepted=None, xp=np):
    """Flatten one chunk's results into the single-fetch buffer.

    ``xp`` is the array namespace: ``numpy`` on the host, ``torch`` for
    device tensors (the concatenation then happens on the device and the
    scheduler fetches one tensor). ``health`` defaults to all-healthy;
    ``drafted``/``accepted`` travel together or not at all."""
    i32 = xp.int32
    done = xp.asarray(done, dtype=i32)
    if health is None:
        health = xp.zeros_like(done)
    if (drafted is None) != (accepted is None):
        raise ValueError("spec lanes travel together: pass both "
                         "drafted and accepted, or neither")
    parts = [
        xp.reshape(xp.asarray(tokens, dtype=i32), (-1,)),
        done,
        xp.asarray(lengths, dtype=i32),
        xp.asarray(health, dtype=i32),
    ]
    if drafted is not None:
        parts.append(xp.asarray(drafted, dtype=i32))
        parts.append(xp.asarray(accepted, dtype=i32))
    parts.append(xp.reshape(xp.asarray(n_alive, dtype=i32), (1,)))
    return xp.concatenate(parts)


def unpack_chunk(buf, n_slots: int, chunk_len: int,
                 spec: bool = False) -> ChunkResult:
    """Inverse of ``pack_chunk`` (always numpy — this is the host side)."""
    buf = np.asarray(buf)
    want = packed_chunk_size(n_slots, chunk_len, spec=spec)
    if buf.shape != (want,):
        raise ValueError(
            f"packed chunk buffer has shape {buf.shape}, expected ({want},) "
            f"for n_slots={n_slots} chunk_len={chunk_len} spec={spec}")
    nt = n_slots * chunk_len
    drafted = accepted = None
    if spec:
        drafted = buf[nt + 3 * n_slots:nt + 4 * n_slots].astype(np.int32)
        accepted = buf[nt + 4 * n_slots:nt + 5 * n_slots].astype(np.int32)
    return ChunkResult(
        tokens=buf[:nt].reshape(n_slots, chunk_len),
        done=buf[nt:nt + n_slots].astype(bool),
        lengths=buf[nt + n_slots:nt + 2 * n_slots].astype(np.int32),
        health=buf[nt + 2 * n_slots:nt + 3 * n_slots].astype(np.int32),
        n_alive=int(buf[-1]),
        drafted=drafted,
        accepted=accepted,
    )


def consume_chunk_row(tokens_row, done: bool, length: int,
                      already_emitted: int, chunk_len: int,
                      eos_ids) -> Tuple[List[int], Optional[str]]:
    """Consume one slot's row of a packed chunk under device-side
    termination. Returns ``(new_ids, finish)`` with ``finish`` one of
    ``"stop"`` / ``"length"`` / ``None``: the host recovers the valid
    span (``length - already_emitted``) and the finish reason — a done
    slot whose next row entry is an EOS id stopped on EOS (the EOS itself
    is never emitted); any other done slot spent its token budget."""
    v = max(0, min(int(length) - already_emitted, chunk_len))
    new_ids = [int(t) for t in tokens_row[:v]]
    finish = None
    if done:
        if v < chunk_len and int(tokens_row[v]) in eos_ids:
            finish = "stop"
        else:
            finish = "length"
    return new_ids, finish


def scan_chunk_row(tokens_row, already_emitted: int, eos_ids,
                   max_tokens: int) -> Tuple[List[int], Optional[str], int]:
    """Consume one slot's row under host-side termination
    (``DEVICE_TERMINATION=false``): walk the row until EOS or the token
    budget. Returns ``(new_ids, finish, wasted_steps)``;
    ``wasted_steps`` counts the decode steps the device ran past the
    slot's finish (the waste the device-side done mask removes)."""
    new_ids: List[int] = []
    finish = None
    steps = 0
    for tid in tokens_row:
        steps += 1
        tid = int(tid)
        if tid in eos_ids:
            finish = "stop"
            break
        new_ids.append(tid)
        if already_emitted + len(new_ids) >= max_tokens:
            finish = "length"
            break
    wasted = len(tokens_row) - steps if finish is not None else 0
    return new_ids, finish, wasted


@dataclass
class RequestExport:
    """Live, host-readable view of one request's recoverable state.

    The fleet (``engine/fleet.py``) hands one of these to the engine
    when it submits a request; the engine's scheduler keeps ``ids``
    pointed at the generated-so-far token ids (a fresh list is assigned
    on every update, never mutated in place, so a reader on another
    thread always sees a settled snapshot). With the per-request
    sampling seed this is the portable half of the reset-and-replay
    contract: (prompt, generated-prefix ids, seed) is everything needed
    to re-splice the request onto another replica and continue the
    transcript as if it had never moved."""

    ids: List[int] = field(default_factory=list)
    #: the pool blocks this request's table maps on its engine, updated
    #: at admission and at every table growth. Block ids are local to
    #: the engine: a migration target re-derives its own chain through
    #: its radix tree.
    blocks: List[int] = field(default_factory=list)
    #: set by the fleet before it cancels a losing hedge branch: the
    #: tokens this dispatch emitted never reached the client, so the
    #: engine's finish bills them as hedge_loser, not delivered.
    discard: bool = False
    #: the weights version of the engine that generated ``ids``, stamped
    #: at submit. A transcript is a function of the weights, so the
    #: fleet pins migration and hedging to replicas of this version.
    weights_version: str = ""


@dataclass
class EngineResult:
    """One completed generation with phase timings."""

    text: str
    prompt_tokens: int = 0
    completion_tokens: int = 0
    queue_ms: float = 0.0
    # The continuous-batching engine reports admission latency (admit ->
    # first token) here.
    prefill_ms: float = 0.0
    decode_ms: float = 0.0
    # Host-side detokenization time, accumulated across the generation.
    detok_ms: float = 0.0
    ttft_ms: float = 0.0
    prefix_cache_hit: bool = False
    finish_reason: str = "stop"  # stop | length | abort
    engine: str = ""
    weights_version: str = ""
    # True when the engine truncated this generation short of a natural
    # finish (KV pool starvation) — the client must see the cut.
    degraded: bool = False
    # The generated token ids (the EOS that ended a generation is not
    # among them): what the parity tests and the smoke run compare.
    token_ids: Tuple[int, ...] = ()

    @property
    def tokens_per_sec(self) -> float:
        if self.decode_ms <= 0 or self.completion_tokens <= 0:
            return 0.0
        return self.completion_tokens / (self.decode_ms / 1000.0)


@runtime_checkable
class Engine(Protocol):
    """Async generation interface behind the service layer.

    ``generate`` returns the raw model text; output parsing and safety
    validation stay in the service layer so every backend shares one
    validator."""

    name: str

    @property
    def ready(self) -> bool:
        ...

    async def start(self) -> None:
        """Load weights, build kernels, warm up. Called before generate."""
        ...

    async def stop(self, drain_secs: float = 0.0) -> None:
        """Graceful drain/shutdown: with ``drain_secs > 0`` stop accepting
        work and wait up to that long for in-flight requests."""
        ...

    async def generate(
        self,
        prompt: str,
        *,
        max_tokens: int = 128,
        temperature: float = 0.0,
        timeout: Optional[float] = None,
    ) -> EngineResult:
        ...

    def generate_stream(
        self,
        prompt: str,
        *,
        max_tokens: int = 128,
        temperature: float = 0.0,
        timeout: Optional[float] = None,
    ) -> AsyncIterator[str]:
        """Yield decoded text increments."""
        ...
