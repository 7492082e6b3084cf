"""Env-selectable fault injection for the serving path: a copy of the
JAX package's ``testing/faults.py``, so a ``FAULT_POINTS`` spec parses
the same in both packages.

``FAULT_POINTS="admit:error:0.5,chunk:hang,generate:delay:2.0"`` arms named
fault points that the engine layer checks at its seams:

- ``admit``    — batcher admission (``BatchedTorchEngine._admit_guarded``)
- ``chunk``    — batched decode dispatch
  (``BatchedTorchEngine._dispatch_chunk``; a ``hang`` here blocks the
  scheduler thread exactly like a hung device dispatch, which is what
  trips the engine watchdog)
- ``decode``   — device-shaped decode faults for containment:
  ``decode:nan:<p>`` corrupts ONE slot's logits to NaN inside the decode
  chunk with probability ``p`` per dispatch (the device-side health word
  must catch it); ``decode:poison_step[:p]`` raises from the chunk
  FETCH — a step-wide poison naming no slot, which is what the bisecting
  culprit-isolation pass exists for
- ``scheduler`` — ``scheduler:die`` kills the scheduler loop thread
  (raises a BaseException the poisoned-step containment deliberately
  cannot catch); fires ONCE then disarms, so the drill tests the
  supervisor restart, not an unrecoverable crash loop
- ``tenant`` — ``tenant:flood:<n>`` enqueues a one-shot synthetic burst
  of ``n`` requests from one tenant key (``FLOOD_TENANT``, background
  lane) ahead of the next real submission, so the QoS ring's fair-share
  admission and preemptive decode are exercisable without a load
  generator
- ``draft`` — ``draft:die`` kills the speculative-decode draft engine
  (one-shot, checked at chunk dispatch: ``BatchedTorchEngine.
  _dispatch_chunk`` flips to plain chunks, transcripts unchanged)
- ``swap`` — ``swap:fail`` kills the next weight swap mid-swap
  (one-shot, checked in ``TorchEngine.swap_weights`` once the new tree
  loaded: the replica keeps no weights, stays ejected with cause
  ``swap_failed``, and the rollout rolls the fleet back)
- ``checkpoint`` — ``checkpoint:corrupt`` fails the next checkpoint
  load's integrity validation (one-shot; the swap is atomic, so the
  prior weights stay armed and the rollout rolls back onto them)
- ``offload`` — ``offload:fail`` kills the next KV-block demotion to the
  host tier (one-shot)
- ``onload`` — ``onload:corrupt`` corrupts the next host-tier page
  fetched for promotion (one-shot)
- ``generate`` — the whole engine call (applied by ``ChaosEngine``, the
  protocol wrapper the factory installs when FAULT_POINTS names it)

A ``r<idx>:`` prefix scopes a point to one fleet replica
(``r1:scheduler:die``); each replica's engine holds a ``ReplicaFaults``
view of the one injector. ``server/factory.py`` refuses at boot a drill
that can never fire: a scope at or beyond ``FLEET_SIZE``, ``draft``
unless ``SPEC_DECODE=true``, and ``offload`` or ``onload`` unless
``HOST_KV_BLOCKS`` > 0.

Modes (the third ``:``-field is mode-specific):

- ``error[:rate]``  — raise ``InjectedFault`` (an ``EngineUnavailable``),
  with optional probability ``rate`` in [0,1] (default 1.0 = always)
- ``delay:seconds`` — sleep that long, then proceed
- ``hang[:max_secs]`` — block until ``release()`` is called or ``max_secs``
  elapses (default 60); models a dispatch that never completes
- ``nan[:rate]`` — (``decode`` only) corrupt one slot's logits
- ``poison_step[:rate]`` — (``decode`` only) raise from the chunk fetch
- ``die`` — (``scheduler``/``draft`` only) kill the loop, one-shot
- ``fail`` — (``swap``/``offload``) one-shot
- ``corrupt`` — (``checkpoint``/``onload``) one-shot

Targeting: by default ``decode`` faults pick the first live slot. A
drill that needs the fault to FOLLOW one request across resets and
replays sets ``injector.target_substr`` — slots whose prompt contains
the substring are the (only) candidates, wherever quarantine or replay
re-seats them.

The same injector object drives deterministic chaos tests
programmatically (``set``/``release``/``clear``/``fired``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import re
import threading
import time
from typing import AsyncIterator, Dict, List, Optional, Sequence

from ..engine.protocol import EngineResult, EngineUnavailable

_DEFAULT_HANG_SECS = 60.0

_MODES = ("error", "delay", "hang", "nan", "poison_step", "die", "flood",
          "fail", "corrupt")

#: the closed set of check sites; a typo'd point in FAULT_POINTS must be
#: a startup error, not a silently inert game-day drill.
KNOWN_POINTS = ("admit", "chunk", "decode", "scheduler", "tenant",
                "draft", "swap", "checkpoint", "offload", "onload",
                "generate")

#: (point, mode) pairs that only make sense together — a drill spec
#: arming e.g. ``admit:nan`` is a typo, not chaos.
_POINT_ONLY_MODES = {"nan": ("decode",), "poison_step": ("decode",),
                     "die": ("scheduler", "draft"), "flood": ("tenant",),
                     "fail": ("swap", "offload"),
                     "corrupt": ("checkpoint", "onload")}
_RESTRICTED_POINTS = {"decode": ("nan", "poison_step"),
                      "scheduler": ("die",), "tenant": ("flood",),
                      "draft": ("die",), "swap": ("fail",),
                      "checkpoint": ("corrupt",),
                      "offload": ("fail",), "onload": ("corrupt",)}

#: tenant key + lane the flood drill's synthetic burst runs under —
#: fixed so fairness assertions and dashboards can name the flooder.
FLOOD_TENANT = "tenant:flood"
FLOOD_LANE = "background"


class SchedulerKilled(BaseException):
    """``scheduler:die`` — deliberately NOT an ``Exception`` so the
    scheduler's widened poisoned-step ``except`` cannot absorb it: the
    loop thread/task genuinely dies, and what's under test is the
    engine supervisor detecting the corpse and restarting the loop with
    zero dropped queued requests."""


class InjectedFault(EngineUnavailable):
    """A deliberately injected failure — maps to 503 like the real thing."""


@dataclasses.dataclass
class _Fault:
    mode: str
    arg: float          # delay seconds / max hang seconds; unused for error
    rate: float = 1.0   # firing probability (error mode)
    release_event: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )
    #: replica scope (engine/fleet.py drills): None fires everywhere; an
    #: index fires only through that replica's ``for_replica`` view — a
    #: fleet chaos drill must be able to kill ONE replica's scheduler
    #: while its siblings stay healthy.
    replica: Optional[int] = None


class FaultInjector:
    """Named fault points checked synchronously (scheduler thread) or
    asynchronously (engine wrappers)."""

    def __init__(self, seed: Optional[int] = None):
        self._faults: Dict[str, _Fault] = {}
        self._fired: Dict[str, int] = {}
        self._rng = random.Random(seed)
        #: decode-fault targeting (test hook): when set, only slots whose
        #: prompt contains this substring are candidates — the fault
        #: follows ONE request across quarantine replays and engine
        #: resets instead of whichever request happens to sit in a slot.
        self.target_substr: Optional[str] = None

    # ------------------------------------------------------------- config

    @classmethod
    def from_spec(cls, spec: str,
                  seed: Optional[int] = None) -> Optional["FaultInjector"]:
        """Parse a FAULT_POINTS spec; returns None for an empty spec."""
        spec = (spec or "").strip()
        if not spec:
            return None
        inj = cls(seed=seed)
        seen = set()
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            parts = item.split(":")
            # Replica-scoped drills (engine/fleet.py): an ``r<idx>:``
            # prefix pins the fault to ONE fleet replica, e.g.
            # "r0:scheduler:die,r0:decode:poison_step" kills replica 0's
            # scheduler while replica 1 keeps serving.
            replica = None
            if parts and re.fullmatch(r"r\d+", parts[0].strip()):
                replica = int(parts[0].strip()[1:])
                parts = parts[1:]
            if len(parts) < 2:
                raise ValueError(
                    f"FAULT_POINTS entry {item!r} must be "
                    f"[r<replica>:]point:mode[:arg]"
                )
            point, mode = parts[0].strip(), parts[1].strip().lower()
            if point in seen:
                # Last-wins would silently drop half the drill spec —
                # same fail-fast rule as unknown points/modes.
                raise ValueError(
                    f"duplicate fault point {point!r} in FAULT_POINTS"
                )
            seen.add(point)
            arg = float(parts[2]) if len(parts) > 2 else None
            inj.set(point, mode, arg, replica=replica)
        return inj

    def set(self, point: str, mode: str, arg: Optional[float] = None,
            replica: Optional[int] = None) -> None:
        """Arm ``point`` with ``mode``. ``arg`` is the error rate, delay
        seconds, or max hang seconds depending on the mode; ``replica``
        scopes the fault to one fleet replica's ``for_replica`` view
        (None = fires everywhere, the single-engine behaviour)."""
        if point not in KNOWN_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; valid: {KNOWN_POINTS}"
            )
        if mode not in _MODES:
            raise ValueError(
                f"fault mode must be one of {_MODES}, got {mode!r}"
            )
        only = _POINT_ONLY_MODES.get(mode)
        if only is not None and point not in only:
            raise ValueError(
                f"fault mode {mode!r} only applies to point(s) {only}, "
                f"got {point!r}"
            )
        restricted = _RESTRICTED_POINTS.get(point)
        if restricted is not None and mode not in restricted:
            raise ValueError(
                f"fault point {point!r} only supports mode(s) {restricted}, "
                f"got {mode!r}"
            )
        if mode == "delay" and arg is None:
            raise ValueError("delay mode needs seconds (point:delay:secs)")
        if mode == "flood" and (arg is None or arg < 1):
            # The burst size is the drill — an unsized flood is a typo.
            raise ValueError(
                "flood mode needs a burst size (tenant:flood:<n>)")
        if arg is not None and arg < 0:
            # A negative delay would raise inside the scheduler loop and
            # fail every active slot — a typo'd drill arg must be a
            # startup error, same as a typo'd point or mode.
            raise ValueError(f"fault arg must be >= 0, got {arg}")
        rate = 1.0
        if mode in ("error", "nan", "poison_step"):
            rate = 1.0 if arg is None else float(arg)
            if not 0.0 <= rate <= 1.0:
                raise ValueError(
                    f"{mode} rate must be in [0,1], got {rate}")
            arg = 0.0
        if mode == "hang":
            arg = _DEFAULT_HANG_SECS if arg is None else float(arg)
        if arg is None:   # die (one-shot) carries no argument
            arg = 0.0
        old = self._faults.get(point)
        if old is not None:
            # A thread may be blocked on the replaced fault's hang event;
            # release it so re-arming never orphans a waiter for the old
            # fault's full max_secs.
            old.release_event.set()
        self._faults[point] = _Fault(mode=mode, arg=float(arg), rate=rate,
                                     replica=replica)

    def has(self, point: str, replica: Optional[int] = None) -> bool:
        fault = self._faults.get(point)
        if fault is None:
            return False
        return self._in_scope(fault, replica)

    @staticmethod
    def _in_scope(fault: _Fault, replica: Optional[int]) -> bool:
        """A replica-scoped fault fires only through that replica's
        ``for_replica`` view; unscoped faults fire everywhere."""
        return fault.replica is None or fault.replica == replica

    def has_any(self, point: str) -> bool:
        """Scope-blind: is ``point`` armed at all (any replica)? The
        factory's inert-drill refusal needs this — a replica-scoped
        fault is invisible to ``has()`` without that replica's view."""
        return point in self._faults

    def scoped_replicas(self) -> set:
        """Replica indices named by r<idx>: scoped faults (empty for a
        plain single-engine spec)."""
        return {f.replica for f in self._faults.values()
                if f.replica is not None}

    def for_replica(self, replica: int) -> "ReplicaFaults":
        """A view of this injector for ONE fleet replica: same points,
        same counters, but faults armed with a different replica scope
        are invisible through it."""
        return ReplicaFaults(self, replica)

    def fired(self, point: str) -> int:
        """How many times ``point`` actually fired (rate misses excluded)."""
        return self._fired.get(point, 0)

    def release(self, point: str) -> None:
        """Unblock a hang at ``point`` and disarm it."""
        fault = self._faults.pop(point, None)
        if fault is not None:
            fault.release_event.set()

    def clear(self) -> None:
        for point in list(self._faults):
            self.release(point)

    # ------------------------------------------------------------ firing

    def _arm(self, point: str,
             replica: Optional[int] = None) -> Optional[_Fault]:
        fault = self._faults.get(point)
        if fault is None or not self._in_scope(fault, replica):
            return None
        if fault.rate < 1.0 and self._rng.random() >= fault.rate:
            return None
        self._fired[point] = self._fired.get(point, 0) + 1
        return fault

    def check(self, point: str, replica: Optional[int] = None) -> None:
        """Synchronous fault check — called from the scheduler thread, so a
        hang here blocks it exactly like a hung device dispatch."""
        fault = self._arm(point, replica)
        if fault is None:
            return
        if fault.mode == "error":
            raise InjectedFault(f"injected fault at {point!r}")
        if fault.mode == "delay":
            time.sleep(fault.arg)
            return
        fault.release_event.wait(timeout=fault.arg)

    async def acheck(self, point: str,
                     replica: Optional[int] = None) -> None:
        """Async fault check for coroutine call sites (ChaosEngine)."""
        fault = self._arm(point, replica)
        if fault is None:
            return
        if fault.mode == "error":
            raise InjectedFault(f"injected fault at {point!r}")
        if fault.mode == "delay":
            await asyncio.sleep(fault.arg)
            return
        deadline = time.monotonic() + fault.arg
        while (not fault.release_event.is_set()
               and time.monotonic() < deadline):
            await asyncio.sleep(0.01)

    # --------------------------------- device-shaped points (containment)

    def _targets(self, prompts: Sequence[Optional[str]]) -> List[int]:
        """Candidate slot indices for a decode fault: slots whose prompt
        matches ``target_substr`` when set, else the first live slot —
        chaos needs *a* victim, tests need *the* victim."""
        live = [i for i, p in enumerate(prompts) if p is not None]
        if self.target_substr is not None:
            return [i for i in live
                    if self.target_substr in (prompts[i] or "")]
        return live[:1]

    def decode_nan_slots(
            self, prompts: Sequence[Optional[str]],
            replica: Optional[int] = None) -> List[int]:
        """Slots whose logits this chunk dispatch should corrupt to NaN
        (``decode:nan:<p>``). ``prompts[i]`` is slot i's prompt text or
        None for a free slot. Empty list = no corruption this dispatch
        (not armed, rate miss, or no matching slot)."""
        fault = self._faults.get("decode")
        if (fault is None or fault.mode != "nan"
                or not self._in_scope(fault, replica)):
            return []
        targets = self._targets(prompts)
        if not targets:
            return []
        if fault.rate < 1.0 and self._rng.random() >= fault.rate:
            return []
        self._fired["decode"] = self._fired.get("decode", 0) + 1
        return targets

    def poison_fetch(self, prompts: Sequence[Optional[str]],
                     replica: Optional[int] = None) -> None:
        """``decode:poison_step`` — raise from the chunk FETCH, the
        step-wide poison that names no slot (the bisect pass's target
        scenario). ``prompts`` is the fetched chunk's snapshot; with a
        ``target_substr`` the poison only fires while the target rides
        the chunk, so innocents replayed without it drain clean."""
        fault = self._faults.get("decode")
        if fault is None or fault.mode != "poison_step":
            return
        if not self._in_scope(fault, replica):
            return
        if not self._targets(prompts):
            return
        if fault.rate < 1.0 and self._rng.random() >= fault.rate:
            return
        self._fired["decode"] = self._fired.get("decode", 0) + 1
        raise InjectedFault("injected poisoned step at chunk fetch")

    def tenant_flood(self, replica: Optional[int] = None) -> int:
        """``tenant:flood:<n>`` — one-shot synthetic tenant flood: the
        next submission through an armed engine is preceded by ``n``
        queued requests from one synthetic tenant (``FLOOD_TENANT``,
        lane ``FLOOD_LANE``), so chaos tests
        can exercise fair-share admission and preemption without a load
        generator. Returns the burst size (0 = not armed / out of
        scope) and disarms itself, like ``scheduler:die``."""
        fault = self._faults.get("tenant")
        if fault is None or fault.mode != "flood":
            return 0
        if not self._in_scope(fault, replica):
            return 0
        del self._faults["tenant"]
        self._fired["tenant"] = self._fired.get("tenant", 0) + 1
        return int(fault.arg)

    def draft_die(self, replica: Optional[int] = None) -> bool:
        """``draft:die`` — one-shot: returns True exactly once, telling
        the engine its draft model just died. Never raises — the whole
        point of the drill is that losing the draft engine is NOT an
        error path: the scheduler flips to plain decode mid-stream and
        every in-flight request finishes byte-identically (exact-match
        verification means no transcript ever depended on a draft)."""
        fault = self._faults.get("draft")
        if fault is None or fault.mode != "die":
            return False
        if not self._in_scope(fault, replica):
            return False
        del self._faults["draft"]
        self._fired["draft"] = self._fired.get("draft", 0) + 1
        return True

    def _one_shot(self, point: str, mode: str,
                  replica: Optional[int]) -> bool:
        """Shared one-shot check (swap:fail / checkpoint:corrupt):
        fires at most once, disarms itself, returns whether it fired."""
        fault = self._faults.get(point)
        if fault is None or fault.mode != mode:
            return False
        if not self._in_scope(fault, replica):
            return False
        del self._faults[point]
        self._fired[point] = self._fired.get(point, 0) + 1
        return True

    def swap_fail(self, replica: Optional[int] = None) -> bool:
        """``swap:fail`` — one-shot: the next weight swap
        through an armed engine dies MID-swap (old buffers released,
        new ones never armed). The engine raises ``SwapFailed``, the
        replica stays ejected with cause ``swap_failed``, and the
        rollout controller auto-aborts and rolls the fleet back."""
        return self._one_shot("swap", "fail", replica)

    def checkpoint_corrupt(self, replica: Optional[int] = None) -> bool:
        """``checkpoint:corrupt`` — one-shot: the next
        checkpoint LOAD through an armed engine fails integrity
        validation. Unlike ``swap:fail`` the swap is atomic — the prior
        weights stay armed, the engine raises ``CheckpointCorrupt``,
        and the rollout rolls back with the prior weights restored."""
        return self._one_shot("checkpoint", "corrupt", replica)

    def offload_fail(self, replica: Optional[int] = None) -> bool:
        """``offload:fail`` — one-shot: the next KV-page
        demotion to the host tier through an armed engine fails, and the
        radix eviction falls back to the plain discard it always did —
        what's under test is that a broken host tier degrades to exactly
        the ``HOST_KV_BLOCKS=0`` device-tier behaviour, never an error."""
        return self._one_shot("offload", "fail", replica)

    def onload_corrupt(self, replica: Optional[int] = None) -> bool:
        """``onload:corrupt`` — one-shot: the next host-tier
        page fetched for promotion reads back corrupted. The demote-time
        CRC32 must catch it, the tainted host subtree drops, and the
        request completes byte-identically via ordinary suffix prefill
        with the books still balanced across both tiers."""
        return self._one_shot("onload", "corrupt", replica)

    def check_scheduler_die(self, replica: Optional[int] = None) -> None:
        """``scheduler:die`` — one-shot: raises ``SchedulerKilled`` (a
        BaseException) so the scheduler loop genuinely dies; disarms
        itself so the supervisor's restarted loop survives."""
        fault = self._faults.get("scheduler")
        if fault is None or fault.mode != "die":
            return
        if not self._in_scope(fault, replica):
            return
        del self._faults["scheduler"]
        self._fired["scheduler"] = self._fired.get("scheduler", 0) + 1
        raise SchedulerKilled("injected scheduler death")

    def describe(self) -> str:
        return ",".join(
            (f"r{f.replica}:" if f.replica is not None else "")
            + f"{p}:{f.mode}"
            + (f":{f.rate}"
               if f.mode in ("error", "nan", "poison_step")
               and f.rate < 1.0 else "")
            for p, f in self._faults.items()
        ) or "none"


class ReplicaFaults:
    """Per-replica view of a shared :class:`FaultInjector` — handed to
    each fleet replica's engine so replica-scoped drills (``r0:...``)
    fire only inside the replica they name, while unscoped faults and
    all counters/targeting stay on the ONE underlying injector (a drill
    still has one ``fired()`` ledger and one ``target_substr``)."""

    def __init__(self, inner: FaultInjector, replica: int):
        self.inner = inner
        self.replica = replica

    @property
    def target_substr(self) -> Optional[str]:
        return self.inner.target_substr

    @target_substr.setter
    def target_substr(self, value: Optional[str]) -> None:
        self.inner.target_substr = value

    def has(self, point: str) -> bool:
        return self.inner.has(point, replica=self.replica)

    def fired(self, point: str) -> int:
        return self.inner.fired(point)

    def release(self, point: str) -> None:
        self.inner.release(point)

    def clear(self) -> None:
        self.inner.clear()

    def check(self, point: str) -> None:
        self.inner.check(point, replica=self.replica)

    async def acheck(self, point: str) -> None:
        await self.inner.acheck(point, replica=self.replica)

    def decode_nan_slots(self, prompts) -> List[int]:
        return self.inner.decode_nan_slots(prompts, replica=self.replica)

    def poison_fetch(self, prompts) -> None:
        self.inner.poison_fetch(prompts, replica=self.replica)

    def check_scheduler_die(self) -> None:
        self.inner.check_scheduler_die(replica=self.replica)

    def draft_die(self) -> bool:
        return self.inner.draft_die(replica=self.replica)

    def swap_fail(self) -> bool:
        return self.inner.swap_fail(replica=self.replica)

    def checkpoint_corrupt(self) -> bool:
        return self.inner.checkpoint_corrupt(replica=self.replica)

    def offload_fail(self) -> bool:
        return self.inner.offload_fail(replica=self.replica)

    def onload_corrupt(self) -> bool:
        return self.inner.onload_corrupt(replica=self.replica)

    def tenant_flood(self) -> int:
        return self.inner.tenant_flood(replica=self.replica)

    def describe(self) -> str:
        return f"replica {self.replica} view of [{self.inner.describe()}]"


class ChaosEngine:
    """Engine-protocol wrapper applying ``generate`` faults around any
    backend — how env-driven chaos reaches engines that have no internal
    fault points (openai) and how tests break an otherwise-healthy
    engine on demand. The port's app reads a few views the JAX wrapper
    does not forward (``device``, ``kv_pool_health``, ``profile``, the
    chunk ring, the supervisor): every attribute the wrapper does not
    define passes through to the wrapped engine."""

    def __init__(self, inner, faults: FaultInjector):
        self.inner = inner
        self.faults = faults

    def __getattr__(self, name):
        if name in ("inner", "faults"):     # not yet set: no recursion
            raise AttributeError(name)
        return getattr(self.inner, name)

    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def ready(self) -> bool:
        return self.inner.ready

    @property
    def weights_version(self) -> str:
        """Forward the served checkpoint version so the
        X-Model-Version header survives the wrapper."""
        return str(getattr(self.inner, "weights_version", "") or "")

    async def start(self) -> None:
        await self.inner.start()

    async def stop(self, drain_secs: float = 0.0) -> None:
        await self.inner.stop(drain_secs)

    def stats(self) -> dict:
        fn = getattr(self.inner, "stats", None)
        return fn() if callable(fn) else {}

    def retry_after_hint(self) -> float:
        fn = getattr(self.inner, "retry_after_hint", None)
        return float(fn()) if callable(fn) else 1.0

    def fleet_health(self) -> dict:
        """Forward the per-replica /health view when the wrapped engine
        is an EngineFleet (generate-point drills wrap the whole fleet)."""
        fn = getattr(self.inner, "fleet_health", None)
        return fn() if callable(fn) else {}

    def qos_health(self) -> dict:
        """Forward the QoS /health section past the wrapper."""
        fn = getattr(self.inner, "qos_health", None)
        return fn() if callable(fn) else {}

    def slo_health(self) -> dict:
        """Forward the SLO burn-rate /health section."""
        fn = getattr(self.inner, "slo_health", None)
        return fn() if callable(fn) else {}

    def spec_health(self) -> dict:
        """Forward the speculative-decode /health section."""
        fn = getattr(self.inner, "spec_health", None)
        return fn() if callable(fn) else {}

    def steptime_health(self) -> dict:
        """Forward the step-time sentinel view — the
        incident watcher reads it through whatever wrapper serves."""
        fn = getattr(self.inner, "steptime_health", None)
        return fn() if callable(fn) else {}

    def ledger_snapshot(self) -> dict:
        """Forward the goodput ledger (/debug/ledger)."""
        fn = getattr(self.inner, "ledger_snapshot", None)
        return fn() if callable(fn) else {}

    def set_reset_listener(self, fn) -> None:
        """Forward the containment reset→breaker hookup to the wrapped
        engine (the supervisor lives below this wrapper)."""
        hook = getattr(self.inner, "set_reset_listener", None)
        if callable(hook):
            hook(fn)

    async def generate(self, prompt: str, **kwargs) -> EngineResult:
        await self.faults.acheck("generate")
        return await self.inner.generate(prompt, **kwargs)

    async def generate_stream(self, prompt: str,
                              **kwargs) -> AsyncIterator[str]:
        await self.faults.acheck("generate")
        async for piece in self.inner.generate_stream(prompt, **kwargs):
            yield piece
