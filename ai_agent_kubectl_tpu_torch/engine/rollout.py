"""Zero-downtime weight rollout: versioned checkpoints, canary replicas,
an SLO-burn promotion gate, and automatic rollback (a copy of the JAX
package's ``engine/rollout.py``).

The controller is composition, not a new serving mechanism: the fleet's
``drain()`` migrates in-flight work off a replica, the goodput ledger
and the multi-window SLO burn rates are the promotion gate, and the
engine's ``swap_weights`` changes the weights of a stopped engine:

    drain → swap → warmup → rejoin → observe → promote-or-rollback

1. **Versioned checkpoints** — a weights version is a content
   fingerprint of the checkpoint path (``checkpoint_version``, kept in
   ``models/convert.py`` and re-exported here): path + file manifest
   (names, sizes, mtimes), 12 hex chars. Every engine stamps the
   version it serves (``engine.weights_version``) into ``/health``,
   per replica, and the service echoes the fleet's as the
   ``X-Model-Version`` response header.
2. **Canary phase** — exactly ONE replica is drained, swapped to the
   new weights, warmed (its restart rebuilds every structure that holds
   KV computed under the old weights: the pool and radix tree with the
   preloaded system prompt, the host tier, the dense prefix cache, the
   draft's cache), and rejoined. The fleet router then steers a bounded
   fraction of FRESH traffic (``ROLLOUT_CANARY_SHARE``, clamped so the
   canary can never starve the interactive lane) at it.
3. **Promotion gate** — over ``ROLLOUT_OBSERVE_SECS`` the canary is
   compared against the stable cohort on SLO burn (the fast window's
   ``fast_burn``), goodput ratio (delivered / total ledger steps),
   quarantine + grammar-dead-end counter deltas, and its breaker. A
   healthy canary promotes: the remaining replicas swap one at a time
   (each a drain → swap → rejoin cycle; established streams finish in
   place on the draining replica — see the version-pinning rule below).
4. **Automatic rollback** — on any gate breach, operator abort, or
   mid-swap fault the fleet is rolled back: every replica already on
   the new version drains, restores the prior checkpoint, and rejoins;
   ``rollout_rollbacks_total{cause}`` names why. A replica that died
   MID-swap (``swap:fail``) stays ejected with cause ``swap_failed`` —
   its weights are gone; resurrecting it with unknown weights would be
   worse than serving degraded on N-1 replicas.

Correctness spine (enforced in ``engine/fleet.py``): a cross-version
replay cannot be byte-identical — the transcript is a function of the
weights — so migration, hedging, and replay failover are pinned to
same-version replicas only. An ESTABLISHED stream (any generated or
delivered prefix) is unroutable to a version-mismatched candidate; a
fresh request (nothing generated) routes freely and replays from
scratch on the new version as a fresh request. Never a cross-version
splice.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..models.convert import checkpoint_version

logger = logging.getLogger(__name__)

#: rollout lifecycle states (closed set — the ``rollout_state`` gauge
#: encodes them by index, so order is part of the metric contract).
STATE_IDLE = "idle"
STATE_DRAINING = "draining"
STATE_SWAPPING = "swapping"
STATE_WARMING = "warming"
STATE_OBSERVING = "observing"
STATE_PROMOTING = "promoting"
STATE_ROLLING_BACK = "rolling_back"
STATE_ROLLED_BACK = "rolled_back"
STATE_COMPLETE = "complete"
STATE_FAILED = "failed"
ROLLOUT_STATES = (STATE_IDLE, STATE_DRAINING, STATE_SWAPPING,
                  STATE_WARMING, STATE_OBSERVING, STATE_PROMOTING,
                  STATE_ROLLING_BACK, STATE_ROLLED_BACK, STATE_COMPLETE,
                  STATE_FAILED)

#: rollback cause labels (``rollout_rollbacks_total{cause}`` — closed
#: here so metric cardinality is bounded by construction).
CAUSE_BURN_GATE = "burn_gate"            # canary SLO burn breached
CAUSE_GOODPUT_GATE = "goodput_gate"      # canary goodput ratio collapsed
CAUSE_COUNTER_GATE = "counter_gate"      # quarantines / grammar dead ends
CAUSE_CANARY_DOWN = "canary_down"        # canary ejected / breaker open
CAUSE_SWAP_FAILED = "swap_failed"        # replica died mid-swap
CAUSE_CHECKPOINT_CORRUPT = "checkpoint_corrupt"  # rejected at load
CAUSE_WARMUP_FAILED = "warmup_failed"    # rejoin/start failed post-swap
CAUSE_STEPTIME_GATE = "steptime_gate"    # canary decode p95 regressed
CAUSE_ABORTED = "aborted"                # operator POST /admin/rollout/abort
ROLLBACK_CAUSES = (CAUSE_BURN_GATE, CAUSE_GOODPUT_GATE,
                   CAUSE_COUNTER_GATE, CAUSE_CANARY_DOWN,
                   CAUSE_SWAP_FAILED, CAUSE_CHECKPOINT_CORRUPT,
                   CAUSE_WARMUP_FAILED, CAUSE_STEPTIME_GATE,
                   CAUSE_ABORTED)


class RolloutError(RuntimeError):
    """Rollout lifecycle misuse (already in progress, nothing to abort,
    same-version no-op) — maps to HTTP 409 at the admin endpoint."""


class CheckpointCorrupt(RolloutError):
    """The new checkpoint failed integrity validation at LOAD time
    (unreadable, wrong tree structure/shapes for the serving model, or
    the ``checkpoint:corrupt`` drill). The swap is atomic: the engine
    still holds — and keeps serving — the prior weights."""


class SwapFailed(RolloutError):
    """The replica died MID-swap (``swap:fail`` drill, or a real device
    fault between releasing the old buffers and arming the new ones).
    Unlike :class:`CheckpointCorrupt` the prior weights are NOT intact:
    the replica stays ejected with cause ``swap_failed`` until an
    operator re-swaps or replaces it."""


def fast_burn_from_snapshot(snap: Optional[dict]) -> Optional[float]:
    """Worst fast-window burn rate across every (slo, lane) of an
    ``slo_health()`` snapshot — the promotion gate's burn signal. None
    when the snapshot has no samples (no data must not read as healthy
    OR as breaching, same rule as ``SloEngine.fast_burn``)."""
    if not snap:
        return None
    windows = snap.get("windows") or []
    if not windows:
        return None
    fast = windows[0]
    best: Optional[float] = None
    for body in (snap.get("slos") or {}).values():
        for row in (body.get("lanes") or {}).values():
            win = (row.get("windows") or {}).get(fast)
            if win and win.get("total"):
                burn = float(win.get("burn_rate", 0.0))
                best = burn if best is None else max(best, burn)
    return best


def _merge_slo(snaps: List[dict]) -> dict:
    from ..obs import slo as obs_slo

    return obs_slo.merge_snapshots([s for s in snaps if s])


class RolloutController:
    """Drives one weight rollout at a time over an :class:`EngineFleet`
    (or, degenerately, a single swap-capable engine).

    The controller owns POLICY (which replica is the canary, when the
    gate breaches, what rolls back); the MECHANISM stays where it
    already lives — ``fleet.drain/rejoin`` for lifecycle,
    ``engine.swap_weights`` for the buffer swap, the router's
    version-pinning for stream correctness."""

    #: gate poll cadence while observing (fraction of the observe
    #: window, clamped to a sane range so tests with sub-second windows
    #: still poll several times).
    GATE_POLL_MIN_SECS = 0.02
    GATE_POLL_MAX_SECS = 1.0
    #: minimum canary ledger steps before the goodput gate may judge —
    #: a 3-step sample must not roll back a healthy checkpoint.
    MIN_GATE_STEPS = 20
    #: canary goodput must stay above this fraction of stable's.
    GOODPUT_GATE_FACTOR = 0.5

    def __init__(self, engine, *,
                 canary_share: float = 0.1,
                 observe_secs: float = 60.0,
                 burn_gate: float = 2.0,
                 steptime_gate: float = 0.0,
                 drain_secs: float = 10.0):
        # Clamp the canary share away from interactive-lane starvation:
        # at most half the fresh traffic may be steered at one replica,
        # and a zero share still routes *pinned* work correctly (the
        # canary then only sees traffic the accumulator never sends —
        # i.e. none — which makes the observe phase meaningless, so the
        # floor is a nominal trickle).
        self.canary_share = min(max(float(canary_share), 0.01), 0.5)
        self.observe_secs = max(0.0, float(observe_secs))
        self.burn_gate = max(1.0, float(burn_gate))
        # Optional canary-vs-stable STEP-TIME verdict: the
        # canary rolls back when its decode/spec_verify p95 reaches
        # this multiple of the stable cohort's on the same (phase,
        # bucket) key (obs/steptime.py canary_vs_stable). 0 = off —
        # the burn gate already catches latency the client can feel;
        # this one catches "the canary is 30% slower per step" before
        # any SLO breaches.
        self.steptime_gate = (0.0 if steptime_gate <= 0
                              else max(1.0, float(steptime_gate)))
        self.drain_secs = max(0.0, float(drain_secs))
        self.engine = engine
        self.state = STATE_IDLE
        self.target_version: Optional[str] = None
        self.target_checkpoint: Optional[str] = None
        self.prior_version: Optional[str] = None
        self.prior_checkpoint: Optional[str] = None
        self.canary_idx: Optional[int] = None
        self.started_wall: Optional[float] = None
        self.observe_deadline: Optional[float] = None   # monotonic
        self.last_gate: Optional[dict] = None
        self.last_rollback_cause: Optional[str] = None
        self.last_error: Optional[str] = None
        #: cumulative rollbacks by cause — the /metrics delta-mirror
        #: source (totals never go backwards).
        self.rollbacks: Dict[str, int] = {}
        self.rollouts_started = 0
        self.rollouts_completed = 0
        #: rollout timeline (drain/swap/rejoin/promote per replica) —
        #: the controller runs outside any request, so it keeps its own
        #: link log in lieu of a request trace; status() exposes it.
        self.events: deque = deque(maxlen=256)
        self.history: deque = deque(maxlen=16)
        self._task: Optional[asyncio.Task] = None
        self._abort = asyncio.Event()

    # ------------------------------------------------------------- seams

    @property
    def _fleet(self):
        """The EngineFleet when the engine is one (duck-typed on
        ``replicas``); None for a bare swap-capable engine."""
        return self.engine if hasattr(self.engine, "replicas") else None

    def _replica_engines(self) -> List[Tuple[int, object]]:
        fleet = self._fleet
        if fleet is None:
            return [(0, self.engine)]
        return [(rep.idx, rep.engine) for rep in fleet.replicas]

    def _version_of(self, engine) -> str:
        return str(getattr(engine, "weights_version", "") or "")

    def _link(self, link_type: str, **meta) -> None:
        """One timeline event (the rollout's own stitched trace)."""
        entry = {"t": round(time.time(), 3), "type": link_type, **meta}
        self.events.append(entry)
        logger.info("rollout: %s %s", link_type,
                    {k: v for k, v in meta.items()})

    # ----------------------------------------------------------- surface

    @property
    def active(self) -> bool:
        return self._task is not None and not self._task.done()

    def replica_versions(self) -> Dict[str, str]:
        return {str(idx): self._version_of(eng)
                for idx, eng in self._replica_engines()}

    def health(self) -> dict:
        """Cheap view for /health and the metrics mirror (never calls
        engine stats())."""
        return {
            "state": self.state,
            "active": self.active,
            "target_version": self.target_version,
            "stable_version": self._stable_version(),
            "canary_replica": self.canary_idx,
            "canary_share": self.canary_share,
            "replica_versions": self.replica_versions(),
            "rollbacks_total": dict(self.rollbacks),
            "rollouts_started": self.rollouts_started,
            "rollouts_completed": self.rollouts_completed,
            "last_rollback_cause": self.last_rollback_cause,
        }

    def status(self) -> dict:
        """Full operator view for GET /admin/rollout."""
        body = self.health()
        body.update({
            "target_checkpoint": self.target_checkpoint,
            "prior_version": self.prior_version,
            "prior_checkpoint": self.prior_checkpoint,
            "observe_secs": self.observe_secs,
            "observe_remaining": (
                round(max(0.0, self.observe_deadline - time.monotonic()), 3)
                if (self.observe_deadline is not None
                    and self.state == STATE_OBSERVING) else None),
            "burn_gate": self.burn_gate,
            "last_gate": self.last_gate,
            "last_error": self.last_error,
            "events": list(self.events),
            "history": list(self.history),
        })
        return body

    def _stable_version(self) -> Optional[str]:
        fleet = self._fleet
        if fleet is not None:
            v = getattr(fleet, "weights_version", None)
            return v or None
        return self._version_of(self.engine) or None

    # --------------------------------------------------------- lifecycle

    async def start_rollout(self, checkpoint: str,
                            version: Optional[str] = None) -> dict:
        """Begin a rollout to ``checkpoint``. Returns the initial
        status; the state machine runs as a background task."""
        if self.active:
            raise RolloutError(
                f"a rollout to {self.target_version} is already in "
                f"progress ({self.state}); abort it first")
        if not checkpoint or not str(checkpoint).strip():
            raise RolloutError("rollout needs a checkpoint path")
        # Every replica must actually be swappable BEFORE anything
        # drains: accepting the rollout and then discovering a
        # swap-less engine mid-cycle would eject a healthy replica
        # (the mid-swap-death arm) over an operator typo.
        unswappable = [idx for idx, eng in self._replica_engines()
                       if not callable(getattr(eng, "swap_weights",
                                               None))]
        if unswappable:
            raise RolloutError(
                f"replica(s) {unswappable} run an engine without "
                f"swap_weights support; rollout refused")
        checkpoint = str(checkpoint).strip()
        version = version or checkpoint_version(checkpoint)
        stable = self._stable_version()
        if stable == version:
            raise RolloutError(
                f"fleet already serves weights version {version}")
        self.rollouts_started += 1
        self.state = STATE_DRAINING
        self.target_version = version
        self.target_checkpoint = checkpoint
        self.prior_version = stable
        # The prior checkpoint path is whatever the (first) stable
        # replica loaded — swap_weights keeps engine.checkpoint_path
        # current, and _load seeds it from MODEL_PATH.
        self.prior_checkpoint = next(
            (getattr(eng, "checkpoint_path", None)
             for _, eng in self._replica_engines()
             if self._version_of(eng) == (stable or "")), None)
        self.last_rollback_cause = None
        self.last_error = None
        self.last_gate = None
        self.started_wall = time.time()
        self._abort.clear()
        self._link("rollout_started", version=version,
                   checkpoint=checkpoint, prior=stable)
        self._task = asyncio.create_task(self._run())
        return self.status()

    async def abort(self) -> dict:
        """Operator abort: the running rollout rolls back (cause
        ``aborted``); a finished one is a 409."""
        if not self.active:
            raise RolloutError("no rollout in progress")
        self._abort.set()
        try:
            await asyncio.wait_for(asyncio.shield(self._task), 30.0)
        except asyncio.TimeoutError:  # pragma: no cover - hung engine stop
            pass
        return self.status()

    # ------------------------------------------------------ the machine

    async def _run(self) -> None:
        try:
            await self._run_inner()
        except asyncio.CancelledError:  # pragma: no cover - teardown
            raise
        except Exception as e:  # pragma: no cover - defensive backstop
            logger.exception("rollout: unexpected failure")
            self.last_error = f"{type(e).__name__}: {e}"
            self.state = STATE_FAILED
            self._finish_history()

    async def _run_inner(self) -> None:
        fleet = self._fleet
        replicas = self._replica_engines()
        version = self.target_version
        path = self.target_checkpoint

        # Canary pick: least-loaded active replica (ties by index, so an
        # idle fleet deterministically canaries replica 0).
        if fleet is not None:
            active = [rep for rep in fleet.replicas
                      if rep.state == "active"]
            if not active:
                self.last_error = "no active replica to canary"
                self.state = STATE_FAILED
                self._finish_history()
                return
            canary = min(active, key=lambda r: (r.inflight, r.idx))
            self.canary_idx = canary.idx
        else:
            self.canary_idx = 0

        # ---- canary: drain → swap → warmup → rejoin --------------------
        ok = await self._swap_one(self.canary_idx, path, version,
                                  first=True)
        if not ok:
            return   # _swap_one already rolled back / recorded the cause

        single = len(replicas) <= 1
        if single:
            # Degenerate fleet: there is no stable cohort to gate the
            # canary against — the in-place swap IS the rollout.
            self._link("promote", replica=self.canary_idx,
                       version=version, note="single replica; canary "
                       "gate skipped (no stable cohort)")
            self._complete()
            return

        # ---- observe: canary serves a bounded share ---------------------
        self.state = STATE_OBSERVING
        baseline = self._gate_baseline()
        if fleet is not None:
            fleet.set_canary(self.canary_idx, self.canary_share)
        self.observe_deadline = time.monotonic() + self.observe_secs
        poll = min(max(self.observe_secs / 20.0, self.GATE_POLL_MIN_SECS),
                   self.GATE_POLL_MAX_SECS)
        self._link("observe", replica=self.canary_idx, version=version,
                   secs=self.observe_secs, share=self.canary_share)
        try:
            while time.monotonic() < self.observe_deadline:
                if self._abort.is_set():
                    await self._rollback(CAUSE_ABORTED)
                    return
                gate = self._evaluate_gate(baseline)
                self.last_gate = gate
                if gate["breach"]:
                    await self._rollback(gate["cause"])
                    return
                await asyncio.sleep(poll)
            # Final evaluation at the deadline: the gate must PASS to
            # promote, not merely never have been polled breaching.
            gate = self._evaluate_gate(baseline)
            self.last_gate = gate
            if gate["breach"]:
                await self._rollback(gate["cause"])
                return
        finally:
            if fleet is not None:
                fleet.clear_canary()
            self.observe_deadline = None

        # ---- promote: roll the stable cohort one replica at a time ------
        self.state = STATE_PROMOTING
        for idx, eng in replicas:
            if idx == self.canary_idx:
                continue
            if self._abort.is_set():
                await self._rollback(CAUSE_ABORTED)
                return
            if self._version_of(eng) == version:
                continue
            ok = await self._swap_one(idx, path, version, first=False)
            if not ok:
                return
            self._link("promote", replica=idx, version=version)
        self._complete()

    def _complete(self) -> None:
        self.state = STATE_COMPLETE
        self.rollouts_completed += 1
        self._link("rollout_complete", version=self.target_version)
        self._finish_history()

    def _finish_history(self) -> None:
        self.history.append({
            "version": self.target_version,
            "prior": self.prior_version,
            "state": self.state,
            "cause": self.last_rollback_cause,
            "started": self.started_wall,
            "finished": time.time(),
        })

    # -------------------------------------------------- swap + rollback

    async def _swap_one(self, idx: int, path: str, version: str, *,
                        first: bool, rolling_back: bool = False) -> bool:
        """One replica's drain → swap → warmup → rejoin. Returns False
        after handling the failure (rollback recorded) — except while
        already rolling back, where failures just log and continue."""
        fleet = self._fleet
        eng = dict(self._replica_engines())[idx]
        hint = max(2.0, self.drain_secs / 2.0)

        def phase(state: str) -> None:
            # Only the CANARY's cycle narrates the fine-grained states;
            # promote/rollback cycles keep the coarse machine state.
            if first and not rolling_back:
                self.state = state

        phase(STATE_DRAINING)
        self._link("drain", replica=idx,
                   to_version=version)
        try:
            try:
                if fleet is not None:
                    fleet.swap_hint = hint
                    await fleet.drain(idx, drain_secs=self.drain_secs)
                else:
                    setattr(self.engine, "swap_hint", hint)
                    await eng.stop(drain_secs=self.drain_secs)
            except Exception as e:
                # A drain that raises leaves the engine half-stopped:
                # treat it like a mid-swap death (replica out of
                # rotation, attributably; the rollout rolls back) — NOT
                # the generic backstop, which would strand the replica
                # in `draining` with no rollback at all.
                self.last_error = f"{type(e).__name__}: {e}"
                self._link("drain_failed", replica=idx, error=str(e))
                if fleet is not None:
                    rep = fleet.replicas[idx]
                    rep.state = "ejected"
                    rep.eject_cause = "drain_failed"
                    rep.last_error = self.last_error
                if not rolling_back:
                    await self._rollback(CAUSE_SWAP_FAILED)
                return False
            phase(STATE_SWAPPING)
            self._link("swap", replica=idx, to_version=version)
            try:
                await asyncio.to_thread(eng.swap_weights, path,
                                        version=version)
            except CheckpointCorrupt as e:
                # Atomic swap: the prior weights are still armed — the
                # replica rejoins on them and the rollout rolls back.
                self.last_error = str(e)
                self._link("swap_rejected", replica=idx, error=str(e))
                try:
                    if fleet is not None:
                        await fleet.rejoin(idx)
                    else:
                        await eng.start()
                except Exception:  # pragma: no cover - engine-dependent
                    logger.exception(
                        "rollout: replica %d rejoin after corrupt "
                        "checkpoint failed", idx)
                if not rolling_back:
                    await self._rollback(CAUSE_CHECKPOINT_CORRUPT)
                return False
            except Exception as e:
                # Mid-swap death: the replica's buffers are in an
                # unknown state. It stays ejected, attributably.
                self.last_error = f"{type(e).__name__}: {e}"
                self._link("swap_failed", replica=idx, error=str(e))
                if fleet is not None:
                    rep = fleet.replicas[idx]
                    rep.state = "ejected"
                    rep.eject_cause = "swap_failed"
                    rep.last_error = self.last_error
                if not rolling_back:
                    await self._rollback(CAUSE_SWAP_FAILED)
                return False
            phase(STATE_WARMING)
            self._link("warmup", replica=idx, version=version)
            try:
                if fleet is not None:
                    await fleet.rejoin(idx)
                else:
                    await eng.start()
            except Exception as e:
                self.last_error = f"{type(e).__name__}: {e}"
                self._link("warmup_failed", replica=idx, error=str(e))
                if not rolling_back:
                    await self._rollback(CAUSE_WARMUP_FAILED)
                return False
            self._link("rejoin", replica=idx, version=version)
            return True
        finally:
            if fleet is not None:
                fleet.swap_hint = 0.0
            else:
                setattr(self.engine, "swap_hint", 0.0)

    async def _rollback(self, cause: str) -> None:
        """Restore every replica serving the target version to the
        prior checkpoint; replicas that died mid-swap stay ejected."""
        fleet = self._fleet
        self.state = STATE_ROLLING_BACK
        self.last_rollback_cause = cause
        self.rollbacks[cause] = self.rollbacks.get(cause, 0) + 1
        if fleet is not None:
            fleet.clear_canary()
        self._link("rollback", cause=cause,
                   from_version=self.target_version,
                   to_version=self.prior_version)
        prior_path = self.prior_checkpoint
        for idx, eng in self._replica_engines():
            if self._version_of(eng) != (self.target_version or ""):
                continue
            if not getattr(eng, "ready", False) and fleet is not None \
                    and fleet.replicas[idx].eject_cause == "swap_failed":
                continue   # dead mid-swap: stays ejected, documented
            if prior_path is None:
                # Nothing to restore onto (the prior engine ran without
                # a checkpoint path and no registry entry survived):
                # leave the replica serving the new weights but record
                # the failure loudly.
                self.last_error = ("rollback has no prior checkpoint "
                                  "path to restore")
                logger.error("rollout: %s", self.last_error)
                continue
            ok = await self._swap_one(idx, prior_path,
                                      self.prior_version
                                      or checkpoint_version(prior_path),
                                      first=False, rolling_back=True)
            if not ok:  # pragma: no cover - double fault
                logger.error("rollout: rollback of replica %d failed",
                             idx)
        self.state = STATE_ROLLED_BACK
        self._link("rollback_complete", cause=cause)
        self._finish_history()

    # -------------------------------------------------------- the gate

    def _gate_baseline(self) -> dict:
        """Counter snapshot at observe start: the gate judges DELTAS
        (a canary must not be blamed for quarantines that predate it)."""
        base: Dict[int, dict] = {}
        for idx, eng in self._replica_engines():
            base[idx] = self._replica_counters(eng)
        return base

    @staticmethod
    def _replica_counters(eng) -> dict:
        sup = getattr(eng, "supervisor", None)
        quar = sum(getattr(sup, "quarantined", {}).values()) if sup else 0
        dead = 0
        gh = getattr(eng, "grammar_health", None)
        if callable(gh):
            try:
                g = gh() or {}
            except Exception:   # pragma: no cover - stopped replica
                g = {}
            dead = sum((g.get("dead_ends_total") or {}).values())
        delivered = total = 0
        ls = getattr(eng, "ledger_snapshot", None)
        if callable(ls):
            try:
                snap = ls() or {}
            except Exception:   # pragma: no cover - stopped replica
                snap = {}
            classes = snap.get("classes") or {}
            delivered = int(classes.get("delivered", 0))
            total = int(snap.get("total_steps", 0))
        return {"quarantined": quar, "dead_ends": dead,
                "delivered": delivered, "total": total}

    def _evaluate_gate(self, baseline: dict) -> dict:
        """Canary-vs-stable verdict. Returns ``{"breach": bool,
        "cause": str | None, ...detail}`` and never raises — a gate that
        crashes must not wedge the state machine."""
        fleet = self._fleet
        detail: dict = {"breach": False, "cause": None}
        if fleet is None:
            return detail
        canary = fleet.replicas[self.canary_idx]
        stable = [rep for rep in fleet.replicas
                  if rep.idx != self.canary_idx
                  and rep.state == "active"]
        # 1. The canary fell over outright: ejected, not ready, or its
        # breaker opened — no statistics needed.
        if (canary.state != "active"
                or not getattr(canary.engine, "ready", False)
                or canary.breaker.state == "open"):
            detail.update(breach=True, cause=CAUSE_CANARY_DOWN,
                          canary_state=canary.state,
                          canary_breaker=canary.breaker.state)
            return detail
        # 2. Counter gate: new quarantines / grammar dead ends on the
        # canary in excess of the stable per-replica average.
        cnow = self._replica_counters(canary.engine)
        cbase = baseline.get(self.canary_idx,
                             {"quarantined": 0, "dead_ends": 0,
                              "delivered": 0, "total": 0})
        c_bad = ((cnow["quarantined"] - cbase["quarantined"])
                 + (cnow["dead_ends"] - cbase["dead_ends"]))
        s_bad = 0.0
        s_delivered = s_total = 0
        for rep in stable:
            snow = self._replica_counters(rep.engine)
            sbase = baseline.get(rep.idx, snow)
            s_bad += ((snow["quarantined"] - sbase["quarantined"])
                      + (snow["dead_ends"] - sbase["dead_ends"]))
            s_delivered += snow["delivered"] - sbase["delivered"]
            s_total += snow["total"] - sbase["total"]
        s_bad_avg = s_bad / max(1, len(stable))
        detail["canary_bad_counters"] = c_bad
        detail["stable_bad_counters_avg"] = round(s_bad_avg, 3)
        if c_bad > 0 and c_bad > s_bad_avg:
            detail.update(breach=True, cause=CAUSE_COUNTER_GATE)
            return detail
        # 3. Burn gate: the canary's fast-window burn vs the stable
        # cohort's (merged — rates recompute from summed counts). The
        # canary breaches when it burns >= ROLLOUT_BURN_GATE times the
        # worse of (sustainable rate 1.0, stable's own burn) — a fleet
        # already burning from ambient load must not auto-roll a canary
        # back for matching it.
        c_burn = self._safe_fast_burn(canary.engine)
        s_burn = fast_burn_from_snapshot(_merge_slo(
            [self._safe_slo(rep.engine) for rep in stable]))
        detail["canary_fast_burn"] = c_burn
        detail["stable_fast_burn"] = s_burn
        if c_burn is not None \
                and c_burn >= self.burn_gate * max(1.0, s_burn or 0.0):
            detail.update(breach=True, cause=CAUSE_BURN_GATE)
            return detail
        # 3b. Step-time gate (optional): canary-vs-stable
        # decode p95 on matching (phase, bucket) keys — a per-step
        # regression is visible long before enough requests breach an
        # SLO to move the burn rate. No comparable key ⇒ no verdict.
        if self.steptime_gate > 0:
            from ..obs import steptime as obs_steptime

            cmp = obs_steptime.canary_vs_stable(
                self._safe_steptime(canary.engine),
                [self._safe_steptime(rep.engine) for rep in stable])
            detail["steptime"] = cmp
            if cmp is not None and cmp["ratio"] >= self.steptime_gate:
                detail.update(breach=True, cause=CAUSE_STEPTIME_GATE)
                return detail
        # 4. Goodput gate: the canary's delivered fraction of ledger
        # steps since observe start vs stable's, once both cohorts have
        # a meaningful sample.
        c_delivered = cnow["delivered"] - cbase["delivered"]
        c_total = cnow["total"] - cbase["total"]
        detail["canary_goodput"] = (round(c_delivered / c_total, 4)
                                    if c_total else None)
        detail["stable_goodput"] = (round(s_delivered / s_total, 4)
                                    if s_total else None)
        if (c_total >= self.MIN_GATE_STEPS
                and s_total >= self.MIN_GATE_STEPS and s_delivered > 0):
            c_ratio = c_delivered / c_total
            s_ratio = s_delivered / s_total
            if c_ratio < self.GOODPUT_GATE_FACTOR * s_ratio:
                detail.update(breach=True, cause=CAUSE_GOODPUT_GATE)
                return detail
        return detail

    @staticmethod
    def _safe_slo(eng) -> dict:
        fn = getattr(eng, "slo_health", None)
        if not callable(fn):
            return {}
        try:
            return fn() or {}
        except Exception:   # pragma: no cover - stopped replica
            return {}

    @staticmethod
    def _safe_steptime(eng) -> dict:
        fn = getattr(eng, "steptime_health", None)
        if not callable(fn):
            return {}
        try:
            return fn() or {}
        except Exception:   # pragma: no cover - stopped replica
            return {}

    def _safe_fast_burn(self, eng) -> Optional[float]:
        return fast_burn_from_snapshot(self._safe_slo(eng))
