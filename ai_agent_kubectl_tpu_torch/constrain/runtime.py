"""Grammar runtime: compiled variants, per-request resolution, and the
stacked device tables the decode chunk gathers from.

One engine owns one :class:`GrammarRuntime`. It compiles the base
profile (``GRAMMAR_PROFILE``) and the ``readonly`` clamp target at
startup, and installs per-request *variants* (an allowed-verbs subset)
on demand into a bounded set of profile slots. All variants
are padded into ONE stacked table set —

    ``tok_class``  [P, vocab]        token → class, per profile slot
    ``class_ok``   [P·S_max, C_max]  legality, rows keyed by the
    ``class_next`` [P·S_max, C_max]  *global* state ``pid·S_max + s``

— with fixed shapes, so installing a variant updates device table
CONTENTS but never changes the chunk's shapes. A slot's FSM
word in the decode carry is the global state; profile identity rides
inside it (``gs // S_max``).

Per-request resolution policy (mirrors the X-Priority clamp semantics,
engine/qos.py): a request may *lower* itself to ``readonly`` (header)
and is force-clamped there when its QoS lane is ``background`` (the
TENANT_TIERS floor tier — the lowest tier must not mutate the
cluster); an allowed-verbs restriction must be a subset of the clamped
profile's verbs (validated at admission, HTTP 400 otherwise) and can
only narrow, never widen.

Thread model: ``resolve``/``install`` run on the event loop at submit
time under a lock; the scheduler thread reads the numpy tables and the
``dirty`` flag at dispatch to refresh its device copies. Table writes
happen before the flag flips, and a stale read only delays a variant
one chunk — requests carrying a pid never run before their tables are
uploaded because the pid is handed out after the install completes.
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, FrozenSet, Optional, Sequence

import numpy as np

from ..engine.tokenizer import Tokenizer
from .fsm import TokenFSM, compile_permissive_fsm, compile_token_fsm
from .grammar import (DEAD, START, build_kubectl_dfa, profile_verbs)

#: named profiles an operator/request can ask for by name.
PROFILES = ("default", "readonly", "permissive")

#: headroom over the base grammar's compiled size: verb-subset variants
#: are structurally smaller, but class counts are not strictly
#: monotone, so padding carries a margin; a variant that still exceeds
#: it falls back to the clamped base profile (logged, never an error).
_STATE_MARGIN = 8
_CLASS_MARGIN = 16


@dataclasses.dataclass(frozen=True)
class GrammarContext:
    """Per-request grammar intent, carried HTTP → engine on a
    contextvar (same channel as QoSContext): the requested profile (may
    only lower) and an optional allowed-verbs narrowing."""

    profile: Optional[str] = None
    allowed_verbs: Optional[FrozenSet[str]] = None


_grammar_var: ContextVar[Optional[GrammarContext]] = ContextVar(
    "grammar_context", default=None)


def current_grammar() -> Optional[GrammarContext]:
    return _grammar_var.get()


@contextmanager
def use_grammar(ctx: GrammarContext):
    token = _grammar_var.set(ctx)
    try:
        yield ctx
    finally:
        _grammar_var.reset(token)


def clamped_profile(base: str, lane: Optional[str],
                    ctx: Optional[GrammarContext]) -> str:
    """The ONE clamp rule, shared by per-request resolution, header
    validation, and the response-cache scope: a ``background``-lane
    request (the TENANT_TIERS floor tier) or an explicit ``readonly``
    ask lowers the base profile to ``readonly``; nothing ever raises
    it. ``permissive`` (the A/B instrument) is never clamped."""
    if base == "permissive":
        return base
    requested = ctx.profile if ctx is not None else None
    if requested == "readonly" or lane == "background":
        return "readonly"
    return base


def validate_restriction(base: str, lane: Optional[str],
                         ctx: Optional[GrammarContext]) -> Optional[str]:
    """THE admission-time validation of a request's grammar intent,
    shared by the HTTP middleware and GrammarRuntime.validate_verbs so
    the two can never disagree. Returns an error string (HTTP 400) or
    None. Rules: the requested profile must be a known name; an
    allowed-verbs narrowing must stay inside the request's CLAMPED
    profile; and under the ``permissive`` base (the mask-everything
    A/B) verb restrictions are refused outright — permissive runs the
    unconstrained language, so the restriction could not be enforced,
    and a restriction the engine cannot enforce must never be silently
    dropped."""
    requested = (ctx.profile if ctx is not None else None)
    if requested is not None and requested not in PROFILES:
        return f"grammar profile must be one of {PROFILES}"
    verbs = ctx.allowed_verbs if ctx is not None else None
    if not verbs:
        return None
    name = clamped_profile(base, lane, ctx)
    if name == "permissive":
        return ("allowed-verbs cannot be enforced under the "
                "'permissive' grammar profile (it runs the "
                "unconstrained language)")
    bad = sorted(set(verbs) - set(profile_verbs(name)))
    if bad:
        return f"allowed-verbs {bad} not in the {name!r} grammar profile"
    return None


def cache_scope(base: str, lane: Optional[str],
                ctx: Optional[GrammarContext]) -> str:
    """Response-cache key suffix for one request's grammar identity.

    The query→command cache predates per-request grammars; without this
    scope a command generated under one tenant's grammar would be
    served verbatim to another — including an interactive tenant's
    MUTATING command served from cache to a readonly-clamped tenant,
    a clean bypass of the whole clamp. Empty when grammar is off (the
    plain query key, cache behaviour unchanged)."""
    prof = clamped_profile(base, lane, ctx)
    verbs = ""
    if ctx is not None and ctx.allowed_verbs:
        verbs = ",".join(sorted(ctx.allowed_verbs))
    return f"\x00grammar:{prof}:{verbs}"


class GrammarRuntime:
    """Compiled-variant registry + stacked device-table source."""

    def __init__(self, tokenizer: Tokenizer, vocab_size: int,
                 eos_ids: Sequence[int], *, profile: str = "default",
                 forced_run_min: int = 4, max_profiles: int = 6):
        if profile not in PROFILES:
            raise ValueError(
                f"GRAMMAR_PROFILE must be one of {PROFILES}, "
                f"got {profile!r}")
        self.tokenizer = tokenizer
        self.vocab_size = int(vocab_size)
        self.eos_ids = tuple(eos_ids)
        self.profile = profile
        self.forced_run_min = max(1, int(forced_run_min))
        self._lock = threading.Lock()
        self._fsms: Dict[int, TokenFSM] = {}
        self._keys: Dict[object, int] = {}
        self._base_dfa = build_kubectl_dfa(profile_verbs("default"))
        base_fsm = self._compile_named(profile)
        # Padding envelope: the full default grammar + margin (verb
        # subsets compile smaller; permissive is 2 states).
        if profile == "default":
            envelope = base_fsm
        else:
            envelope = compile_token_fsm(
                self._base_dfa, tokenizer, self.vocab_size, self.eos_ids)
        self.S_max = envelope.n_states + _STATE_MARGIN
        self.C_max = envelope.n_classes + _CLASS_MARGIN
        self.max_profiles = max(2, int(max_profiles))
        P, S, C = self.max_profiles, self.S_max, self.C_max
        self.tok_class = np.zeros((P, self.vocab_size), np.int32)
        self.class_ok = np.zeros((P * S, C), bool)
        self.class_next = np.zeros((P * S, C), np.int32)
        #: bumped on every install; engines compare against their last
        #: uploaded version to refresh device copies.
        self.version = 0
        self.fallbacks = 0     # variants rejected (overflow / no slot)
        self._install(("profile", profile), base_fsm)
        if profile != "readonly":
            self._install(("profile", "readonly"),
                          self._compile_named("readonly"))

    # ---------------------------------------------------------- compile

    def _compile_named(self, name: str) -> TokenFSM:
        if name == "permissive":
            return compile_permissive_fsm(self.vocab_size, self.eos_ids)
        return compile_token_fsm(
            build_kubectl_dfa(profile_verbs(name)), self.tokenizer,
            self.vocab_size, self.eos_ids)

    def _install(self, key, fsm: TokenFSM) -> Optional[int]:
        """Write one compiled variant into the next free profile slot.
        Caller holds the lock (or is the ctor). Returns the pid, or
        None when the variant does not fit the padded envelope / no
        slot is free."""
        if fsm.n_states > self.S_max or fsm.n_classes > self.C_max:
            self.fallbacks += 1
            return None
        pid = len(self._fsms)
        if pid >= self.max_profiles:
            self.fallbacks += 1
            return None
        S = self.S_max
        base = pid * S
        self.tok_class[pid, :] = 0
        self.tok_class[pid, :fsm.tok_class.shape[0]] = fsm.tok_class
        ns, nc = fsm.n_states, fsm.n_classes
        self.class_ok[base:base + S, :] = False
        self.class_next[base:base + S, :] = base + DEAD
        self.class_ok[base:base + ns, :nc] = fsm.class_ok
        self.class_next[base:base + ns, :nc] = base + fsm.class_next
        self._fsms[pid] = fsm
        self._keys[key] = pid
        self.version += 1
        return pid

    # ---------------------------------------------------------- resolve

    def resolve(self, lane: Optional[str] = None,
                ctx: Optional[GrammarContext] = None) -> int:
        """Profile id for one request. Clamp order: start from the
        configured base profile; a ``background``-lane request (the
        TENANT_TIERS floor tier) or an explicit ``readonly`` ask clamps
        to readonly; an allowed-verbs narrowing compiles/installs a
        variant (subset-validated by :meth:`validate_verbs` at the HTTP
        layer — unknown verbs never reach here). Falls back to the
        clamped named profile when the variant can't be installed."""
        name = clamped_profile(self.profile, lane, ctx)
        verbs = ctx.allowed_verbs if ctx is not None else None
        if verbs and name != "permissive":
            verbs = frozenset(verbs) & set(profile_verbs(name))
        with self._lock:
            base_pid = self._keys.get(("profile", name))
            if base_pid is None:     # readonly asked under readonly base
                base_pid = self._keys[("profile", self.profile)]
            if not verbs or name == "permissive":
                return base_pid
            key = ("verbs", name, verbs)
            pid = self._keys.get(key)
            if pid is not None:
                return pid
            if len(self._fsms) >= self.max_profiles:
                self.fallbacks += 1
                return base_pid
        # Compile OUTSIDE the lock: a cold variant compile takes seconds
        # at a 256k vocab, and holding the lock would stall every
        # concurrent cached-pid resolve meanwhile. (Callers with a
        # possibly-novel verb set additionally run resolve() off the
        # event loop — see the engines' submit paths.)
        fsm = compile_token_fsm(
            build_kubectl_dfa(sorted(verbs)), self.tokenizer,
            self.vocab_size, self.eos_ids)
        with self._lock:
            pid = self._keys.get(key)      # raced install: reuse theirs
            if pid is None:
                pid = self._install(key, fsm)
            return pid if pid is not None else base_pid

    def validate_verbs(self, verbs, lane: Optional[str] = None,
                       ctx: Optional[GrammarContext] = None) -> Optional[str]:
        """Admission-time validation of a per-request allowed-verbs
        restriction (delegates to the module-level rule the HTTP
        middleware also runs). Returns an error string (400) or None."""
        merged = GrammarContext(
            profile=ctx.profile if ctx is not None else None,
            allowed_verbs=frozenset(verbs))
        return validate_restriction(self.profile, lane, merged)

    # ------------------------------------------------------------ views

    def snapshot_tables(self) -> tuple:
        """(version, tok_class, class_ok, class_next) as a CONSISTENT
        copy taken under the install lock — an engine refreshing its
        device tables must never capture a half-written variant row (a
        torn mask samples off-grammar tokens or wrongly dead-ends a
        slot) nor stamp a post-install version on pre-install contents.
        Copies are a few MB and only happen when the version moved."""
        with self._lock:
            return (self.version, self.tok_class.copy(),
                    self.class_ok.copy(), self.class_next.copy())

    def fsm(self, pid: int) -> TokenFSM:
        return self._fsms[pid]

    def start_state(self, pid: int) -> int:
        return pid * self.S_max + START

    def local(self, gs: int) -> tuple:
        return gs // self.S_max, gs % self.S_max

    def allowed_np(self, gs: int) -> np.ndarray:
        """[vocab] bool mask from a global state (host-side: the
        admission first-token mask)."""
        pid, s = self.local(gs)
        return self._fsms[pid].allowed(s)

    def advance(self, gs: int, tok: int) -> int:
        pid, s = self.local(gs)
        return pid * self.S_max + self._fsms[pid].advance(s, int(tok))

    def run(self, pid: int, ids: Sequence[int]) -> int:
        return pid * self.S_max + self._fsms[pid].run(ids)

    def is_dead(self, gs: int) -> bool:
        return gs % self.S_max == DEAD

    def forced_run(self, gs: int, cap: int) -> tuple:
        """(run_ids, ends_eos, end_gs) from a global state, honouring
        ``forced_run_min`` at the CALLER (this returns the raw chain —
        the scheduler compares it against in-flight speculation)."""
        pid, s = self.local(gs)
        run, ends_eos, end = self._fsms[pid].forced_run(s, cap)
        return run, ends_eos, pid * self.S_max + end

    def in_grammar(self, pid: int, ids: Sequence[int]) -> bool:
        return self._fsms[pid].in_grammar(ids)

    def health(self) -> dict:
        """Cheap /health section: which grammar this engine enforces."""
        base = self._keys[("profile", self.profile)]
        fsm = self._fsms[base]
        return {
            "enabled": True,
            "profile": self.profile,
            "grammar_hash": fsm.grammar_hash,
            "states": fsm.n_states,
            "classes": fsm.n_classes,
            "variants": len(self._fsms),
            "forced_run_min": self.forced_run_min,
            "variant_fallbacks": self.fallbacks,
        }
