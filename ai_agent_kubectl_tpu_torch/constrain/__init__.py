"""Grammar-constrained decoding: the port's own copy of the JAX
package's ``constrain/`` (numpy only; the tables come out equal).

``grammar``  — the kubectl byte-level DFA (verbs, resource kinds, flag
               vocabulary, name character classes) and the safety
               cross-check.
``fsm``      — the tokenizer-composed token FSM (SGLang's compressed
               FSM: token equivalence classes + per-state legality)
               with precomputed forced runs.
``runtime``  — per-engine variant registry, per-request resolution
               (tenant-tier clamp, allowed-verbs narrowing), and the
               stacked fixed-shape device tables the decode chunk
               gathers from.
"""

from .grammar import (BLOCKED_VERBS, DEFAULT_VERBS, READONLY_VERBS,
                      assert_safety_consistent, build_kubectl_dfa,
                      profile_verbs, sample_accepted)
from .fsm import TokenFSM, compile_permissive_fsm, compile_token_fsm
from .runtime import (PROFILES, GrammarContext, GrammarRuntime,
                      cache_scope, clamped_profile, current_grammar,
                      use_grammar, validate_restriction)

__all__ = [
    "BLOCKED_VERBS", "DEFAULT_VERBS", "READONLY_VERBS", "PROFILES",
    "GrammarContext", "GrammarRuntime", "TokenFSM",
    "assert_safety_consistent", "build_kubectl_dfa", "cache_scope",
    "clamped_profile", "compile_permissive_fsm", "compile_token_fsm",
    "current_grammar", "profile_verbs", "sample_accepted", "use_grammar",
    "validate_restriction",
]
