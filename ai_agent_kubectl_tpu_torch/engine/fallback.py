"""FallbackEngine — deterministic rule-based degradation path (the JAX
package's ``engine/fallback.py``).

When the engine is failing (circuit breaker open, an engine error,
EngineUnavailable) and ``DEGRADED_FALLBACK=true``, the service routes
queries here instead of hard-failing with 503: a curated
pattern→command table answers the common read-only queries the
reference service was mostly used for, and anything unmatched degrades
to the safe ``kubectl get all``. Responses are marked ``degraded: true``
with ``engine_metadata.engine == "fallback-rules"`` so clients and
dashboards can tell a rule hit from a real generation.

The same table, its mutating rules included, answers ``ENGINE=fake``
(``engine/fake.py``), so the two can never drift; the fallback serves
only the read-only half.
"""

from __future__ import annotations

import re
import time

from .protocol import EngineResult

#: Read-only pattern → command template; groups feed ``str.format``. The
#: degraded fallback serves ONLY these: a blind keyword match must never
#: mint a mutating command ("why did the autoscaler delete pod web-1?"
#: must not answer "kubectl delete pod web-1") — without the model's
#: contextual judgment, degraded mode is strictly observational.
READ_ONLY_RULES = [
    (re.compile(r"\b(list|get|show)\b.*\bpods?\b", re.I), "kubectl get pods"),
    (re.compile(r"\b(list|get|show)\b.*\bnodes?\b", re.I), "kubectl get nodes"),
    (re.compile(r"\b(list|get|show)\b.*\b(deployments?|deploys?)\b", re.I),
     "kubectl get deployments"),
    (re.compile(r"\b(list|get|show)\b.*\bservices?\b", re.I), "kubectl get services"),
    (re.compile(r"\b(list|get|show)\b.*\bnamespaces?\b", re.I), "kubectl get namespaces"),
    (re.compile(r"\blogs?\b.*?(?:\bof\b|\bfor\b|\bfrom\b)\s+(\S+)", re.I),
     "kubectl logs {0}"),
    (re.compile(r"\bdescribe\b.*\bpod\b\s+(\S+)", re.I), "kubectl describe pod {0}"),
]

#: Mutating rules: part of FakeEngine's table (the reference service's
#: full query surface) but never served by the fallback.
MUTATING_RULES = [
    (re.compile(r"\bdelete\b.*\bpod\b\s+(\S+)", re.I), "kubectl delete pod {0}"),
    (re.compile(r"\bscale\b.*\bdeployment\b\s+(\S+).*?\b(\d+)\b", re.I),
     "kubectl scale deployment {0} --replicas={1}"),
]

#: FakeEngine's full table.
RULES = READ_ONLY_RULES + MUTATING_RULES

_QUERY_RE = re.compile(
    r"User Request:\s*(.*?)\s*(?:\nKubectl Command:|\Z)", re.S
)


def extract_query(prompt: str) -> str:
    """Recover the user query from a rendered prompt (engine/prompts.py
    renders "...User Request: <query>\\nKubectl Command:")."""
    m = _QUERY_RE.search(prompt)
    return m.group(1) if m else prompt


def rule_command(query: str, rules=RULES) -> str:
    """First matching rule's command, or the safe catch-all."""
    for pattern, template in rules:
        hit = pattern.search(query)
        if hit:
            return template.format(*hit.groups())
    return "kubectl get all"


class FallbackEngine:
    """The rule table behind ``generate``: always ready, never fails,
    sub-millisecond — none of the real engine's failure modes."""

    name = "fallback-rules"

    async def generate(self, prompt: str) -> EngineResult:
        t0 = time.monotonic()
        # Read-only rules only: degraded mode never mints a mutation.
        text = rule_command(extract_query(prompt), rules=READ_ONLY_RULES)
        elapsed_ms = (time.monotonic() - t0) * 1000.0
        return EngineResult(
            text=text,
            prompt_tokens=len(prompt.split()),
            completion_tokens=len(text.split()),
            decode_ms=elapsed_ms,
            ttft_ms=elapsed_ms,
            engine=self.name,
        )
