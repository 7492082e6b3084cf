"""The kubectl grammar: a byte-level DFA over the one command shape the
service is allowed to emit.

The service's entire product is a single ``kubectl ...`` line. Decoded
unconstrained from the full vocab, malformed output could only be
rejected *post hoc* by ``server/safety.py``. This module
makes unsafe output unrepresentable instead: the grammar admits exactly

    "kubectl " verb (" " arg)*

where ``verb`` comes from an enumerated verb set (profile-dependent:
the read-only profile drops every mutating verb), the first argument of
core resource verbs must be an enumerated resource kind (optionally
``kind/name``), flags come from an enumerated long/short flag vocabulary
(``--flag``, ``--flag=value``, ``-n``), and free arguments (names,
namespaces, selector values) are drawn from conservative character
classes that exclude every shell metacharacter and quote. By
construction every accepted string passes ``server/safety.py`` — the
grammar ⊆ safety inclusion is asserted by a property test and a
boot-time cross-check
(:func:`assert_safety_consistent`).

The DFA is built host-side as plain dict tries, then frozen to a numpy
``[n_states, 256]`` byte-transition table (state 0 = DEAD, state 1 =
START). ``constrain/fsm.py`` composes it with a tokenizer into the
token-level FSM the decode chunk enforces on device.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

#: DFA state conventions (shared with fsm.py / runtime.py): the dead
#: state must be 0 so a zero-initialized table row is safely "reject".
DEAD = 0
START = 1

# --------------------------------------------------------------- verbs

#: read-only verbs: observation only — no write, no exec, no tunnel.
READONLY_VERBS = (
    "api-resources", "api-versions", "cluster-info", "describe", "diff",
    "explain", "get", "logs", "top", "version", "wait",
)

#: mutating verbs the DEFAULT profile additionally allows (cluster
#: writes a kubectl NL service legitimately performs).
MUTATING_VERBS = (
    "annotate", "apply", "autoscale", "cordon", "create", "delete",
    "drain", "expose", "label", "patch", "rollout", "run", "scale",
    "set", "taint", "uncordon",
)

#: verbs NO grammar profile may ever contain — they open interactive
#: shells or tunnels into the cluster (``server/safety.py`` blocks them
#: too; :func:`assert_safety_consistent` keeps the two lists honest).
BLOCKED_VERBS = (
    "attach", "cp", "debug", "edit", "exec", "port-forward", "proxy",
)

DEFAULT_VERBS = tuple(sorted(READONLY_VERBS + MUTATING_VERBS))

#: verbs whose FIRST argument must be an enumerated resource kind (or a
#: flag) — the shape "kubectl get pods ..." the service overwhelmingly
#: emits. Other verbs go straight to the generic argument machine
#: ("kubectl logs web-1", "kubectl version").
RESOURCE_VERBS = frozenset((
    "annotate", "apply", "autoscale", "create", "delete", "describe",
    "edit", "expose", "get", "label", "patch", "rollout", "scale",
    "set", "top", "wait",
))

#: resource kinds (singular, plural, and short forms).
RESOURCE_KINDS = (
    "all", "cj", "clusterrole", "clusterroles", "cm", "configmap",
    "configmaps", "cronjob", "cronjobs", "daemonset", "daemonsets",
    "deploy", "deployment", "deployments", "ds", "endpoints", "ep",
    "ev", "event", "events", "hpa", "ing", "ingress", "ingresses",
    "job", "jobs", "limitrange", "limits", "namespace", "namespaces",
    "netpol", "networkpolicies", "networkpolicy", "no", "node", "nodes",
    "ns", "po", "pod", "pods", "pv", "pvc", "persistentvolume",
    "persistentvolumeclaim", "persistentvolumeclaims",
    "persistentvolumes", "quota", "rc", "replicaset", "replicasets",
    "replicationcontroller", "replicationcontrollers",
    "resourcequota", "resourcequotas", "role", "rolebinding",
    "rolebindings", "roles", "rs", "sa", "secret", "secrets", "service",
    "serviceaccount", "serviceaccounts", "services", "statefulset",
    "statefulsets", "sts", "svc",
)

#: long flag vocabulary (the ``--`` prefix is structural, not listed).
LONG_FLAGS = (
    "all", "all-namespaces", "cascade", "containers", "container",
    "context", "cpu-percent", "current-replicas", "dry-run", "env",
    "field-selector", "filename", "follow", "force", "grace-period",
    "help", "ignore-not-found", "image", "kubeconfig", "labels",
    "limit", "max", "min", "name", "namespace", "no-headers",
    "output", "overwrite", "port", "previous", "record", "replicas",
    "resource-version", "restart", "revision", "selector", "show-labels",
    "since", "sort-by", "tail", "timeout", "to-revision", "type",
    "watch",
)

#: single-letter flags ("-n kube-system", "-o wide", "-f app.yaml").
SHORT_FLAGS = "AfhlnopRvw"

#: free-argument characters (names, namespaces, selector/flag values).
#: Deliberately excludes every ``server/safety.py`` forbidden
#: metacharacter (``; & | ` $ ( ) < >``), whitespace, and both quote
#: kinds — an accepted string can never fail shell lexing.
NAME_CHARS = (
    "abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "0123456789"
    ".-_/:=,%+*[]{}!@^~"
)
_SAFETY_FORBIDDEN = ";&|`$()<>"
assert not set(NAME_CHARS) & set(_SAFETY_FORBIDDEN)
assert not set(NAME_CHARS) & set(" \t'\"")


@dataclass
class CharDFA:
    """Frozen byte-level DFA: ``next[state, byte]`` (0 = DEAD), the
    accept mask, and the identity hash of the grammar that built it."""

    next: np.ndarray          # [n_states, 256] int32
    accept: np.ndarray        # [n_states] bool
    grammar_hash: str         # 12-hex sha256 of the grammar content
    n_verbs: int

    @property
    def n_states(self) -> int:
        return int(self.next.shape[0])

    def run(self, data: bytes, state: int = START) -> int:
        for b in data:
            state = int(self.next[state, b])
            if state == DEAD:
                return DEAD
        return state


class _StateTrie:
    """Mutable trie of byte-labelled states, frozen into a
    :class:`CharDFA`.

    States are dicts byte→state; building is pure host-side Python, so
    clarity beats speed (a full grammar compiles in milliseconds)."""

    def __init__(self):
        self.trans: List[Dict[int, int]] = [dict(), dict()]  # DEAD, START
        self.accept: set = set()

    def new_state(self) -> int:
        self.trans.append({})
        return len(self.trans) - 1

    def edge(self, src: int, ch: str, dst: Optional[int] = None) -> int:
        b = ord(ch)
        nxt = self.trans[src].get(b)
        if nxt is not None and dst is not None and nxt != dst:
            raise ValueError(f"conflicting edge from {src} on {ch!r}")
        if nxt is None:
            nxt = dst if dst is not None else self.new_state()
            self.trans[src][b] = nxt
        return nxt

    def literal(self, src: int, text: str) -> int:
        for ch in text:
            src = self.edge(src, ch)
        return src

    def char_loop(self, state: int, chars: str) -> None:
        for ch in chars:
            self.edge(state, ch, state)

    def freeze(self, grammar_hash: str, n_verbs: int) -> CharDFA:
        n = len(self.trans)
        nxt = np.zeros((n, 256), np.int32)
        for s, edges in enumerate(self.trans):
            for b, d in edges.items():
                nxt[s, b] = d
        acc = np.zeros((n,), bool)
        acc[sorted(self.accept)] = True
        acc[DEAD] = False
        return CharDFA(next=nxt, accept=acc, grammar_hash=grammar_hash,
                       n_verbs=n_verbs)


def grammar_hash(verbs: Iterable[str]) -> str:
    """12-hex identity of one grammar variant's full content — surfaces
    in /health so an operator can tell which grammar a replica runs."""
    h = hashlib.sha256()
    for part in ("v1", ",".join(sorted(verbs)), ",".join(RESOURCE_KINDS),
                 ",".join(LONG_FLAGS), SHORT_FLAGS, NAME_CHARS):
        h.update(part.encode())
        h.update(b"\x00")
    return h.hexdigest()[:12]


def build_kubectl_dfa(verbs: Iterable[str] = DEFAULT_VERBS) -> CharDFA:
    """Compile the kubectl grammar over ``verbs`` to a byte DFA.

    Shape: ``"kubectl " verb (" " arg)*`` with

    - arg after a RESOURCE_VERBS verb's first space: resource kind
      (optionally ``kind/name``) or a flag;
    - generic args: free name (NAME_CHARS+, not starting with ``-``) or
      a vocabulary flag (``--long``, ``--long=value``, ``-X``,
      ``-X=value``);
    - accept exactly after a complete verb, kind, name, flag, or value
      — never on a trailing space or bare dash, so every accepted
      string survives ``server/safety.py``'s strip + shlex checks.
    """
    verbs = tuple(sorted(set(verbs)))
    blocked = set(BLOCKED_VERBS) & set(verbs)
    if blocked:
        raise ValueError(
            f"grammar may not contain blocked verbs: {sorted(blocked)}")
    unknown = set(verbs) - set(DEFAULT_VERBS)
    if unknown:
        raise ValueError(f"unknown kubectl verbs: {sorted(unknown)}")
    b = _StateTrie()

    verb_start = b.literal(START, "kubectl ")

    # Shared argument machines. ``gen_arg``: start of a generic argument
    # (name or flag); ``res_arg``: start of the first argument after a
    # resource verb (resource kind or flag).
    gen_arg = b.new_state()
    res_arg = b.new_state()

    # Generic free name: NAME_CHARS+ (first char not '-').
    name_body = b.new_state()
    for ch in NAME_CHARS:
        if ch != "-":
            b.edge(gen_arg, ch, name_body)
    b.char_loop(name_body, NAME_CHARS)
    b.accept.add(name_body)
    b.edge(name_body, " ", gen_arg)

    # Flag values after '=': free value characters.
    value_body = b.new_state()
    b.char_loop(value_body, NAME_CHARS)
    b.accept.add(value_body)
    b.edge(value_body, " ", gen_arg)

    # Flag vocabulary, built once and shared by both argument-start
    # states (duplicating the trie would double the DFA for no language
    # difference).
    dash = b.edge(gen_arg, "-")
    b.edge(res_arg, "-", dash)
    dash2 = b.edge(dash, "-")
    for flag in LONG_FLAGS:
        end = b.literal(dash2, flag)
        b.accept.add(end)
        b.edge(end, " ", gen_arg)
        eq = b.edge(end, "=")
        for ch in NAME_CHARS:
            b.edge(eq, ch, value_body)
    for ch in SHORT_FLAGS:
        end = b.edge(dash, ch)
        b.accept.add(end)
        b.edge(end, " ", gen_arg)
        eq = b.edge(end, "=")
        for ch2 in NAME_CHARS:
            b.edge(eq, ch2, value_body)

    # Resource kinds (first arg of resource verbs): trie; a complete
    # kind accepts, continues into generic args, or takes "/name".
    for kind in RESOURCE_KINDS:
        end = b.literal(res_arg, kind)
        b.accept.add(end)
        b.edge(end, " ", gen_arg)
        slash = b.edge(end, "/")
        for ch in NAME_CHARS:
            if ch != "/":
                b.edge(slash, ch, name_body)

    # Verb trie.
    for verb in verbs:
        end = b.literal(verb_start, verb)
        b.accept.add(end)
        b.edge(end, " ", res_arg if verb in RESOURCE_VERBS else gen_arg)

    return b.freeze(grammar_hash(verbs), len(verbs))


def profile_verbs(profile: str) -> Tuple[str, ...]:
    """Verb set of a named grammar profile. ``default`` = read-only +
    mutating; ``readonly`` = observation only (the TENANT_TIERS clamp
    target); ``permissive`` is resolved by the runtime to a
    mask-everything FSM (A/B: constrained plumbing, unconstrained
    language) and has no verb set here."""
    if profile == "default":
        return DEFAULT_VERBS
    if profile == "readonly":
        return tuple(READONLY_VERBS)
    raise ValueError(f"unknown grammar profile {profile!r}")


def sample_accepted(dfa: CharDFA, seed: int, max_len: int = 96) -> str:
    """Draw one random accepted string (the safety property test's
    generator): random-walk the live edges, biased toward stopping once
    in an accept state, never entering DEAD."""
    rng = np.random.default_rng(seed)
    out: List[int] = []
    state = START
    for _ in range(max_len):
        if dfa.accept[state] and (len(out) >= max_len - 8
                                  or rng.random() < 0.18):
            break
        choices = np.nonzero(dfa.next[state] != DEAD)[0]
        if choices.size == 0:
            break
        byte = int(rng.choice(choices))
        out.append(byte)
        state = int(dfa.next[state, byte])
    # Walk back to the last accepting prefix (a mid-token stop is not a
    # sentence of the language).
    while out:
        s = dfa.run(bytes(out))
        if s != DEAD and dfa.accept[s]:
            break
        out.pop()
    return bytes(out).decode("ascii")


def assert_safety_consistent() -> None:
    """Boot-time cross-check: every verb
    ``server/safety.py`` blocks must be absent from every grammar
    profile — the grammar makes unsafe commands unrepresentable, and
    safety stays an outer ring that agrees with it."""
    from ..server import safety

    for profile in ("default", "readonly"):
        verbs = set(profile_verbs(profile))
        overlap = verbs & set(safety.BLOCKED_VERBS)
        if overlap:
            raise RuntimeError(
                f"grammar profile {profile!r} contains safety-blocked "
                f"verbs {sorted(overlap)} — the two lists must agree")
    missing = set(BLOCKED_VERBS) - set(safety.BLOCKED_VERBS)
    if missing:
        raise RuntimeError(
            f"safety.BLOCKED_VERBS is missing grammar-blocked verbs "
            f"{sorted(missing)} — defense-in-depth requires both rings")
