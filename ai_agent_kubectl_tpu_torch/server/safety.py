"""Command safety validation (reference app.py:72-88).

The contract: a generated command is acceptable only if it
1. starts with ``"kubectl "``,
2. contains none of the shell metacharacters ``; & | ` $ ( ) < >``
   (the reference checks the two-char forms ``&&``/``||``; we reject single
   ``&``/``|`` too — strictly safer, and pipes/background jobs are never
   legitimate in a single kubectl invocation),
3. parses cleanly with ``shlex.split`` (catches unclosed quotes).

Returns a reason string for observability rather than logging inside the
predicate; ``is_safe_kubectl_command`` keeps the reference's bool signature.
"""

from __future__ import annotations

import shlex
from typing import Optional

# Reference list (app.py:79) plus single & and |.
_FORBIDDEN_CHARS = (";", "&", "|", "`", "$", "(", ")", "<", ">")

#: verbs that open interactive shells or tunnels into the cluster — a
#: natural-language command service must never execute them. The
#: grammar subsystem (ai_agent_kubectl_tpu/constrain) makes them
#: UNREPRESENTABLE when GRAMMAR_DECODE is on; this check is the outer
#: defense-in-depth ring for the unconstrained path, and
#: ``constrain.assert_safety_consistent`` cross-checks at boot that no
#: grammar profile contains any of them.
BLOCKED_VERBS = frozenset((
    "attach", "cp", "debug", "edit", "exec", "port-forward", "proxy",
))


def unsafe_reason(command: str) -> Optional[str]:
    """Return None if safe, else a human-readable reason."""
    command = command.strip()
    if not command.startswith("kubectl "):
        return "command does not start with 'kubectl '"
    found = [c for c in _FORBIDDEN_CHARS if c in command]
    if found:
        return f"command contains forbidden shell metacharacters: {' '.join(found)}"
    try:
        parts = shlex.split(command)
    except ValueError as e:
        return f"command failed shell lexing: {e}"
    if not parts or parts[0] != "kubectl":
        return "command does not tokenize to a kubectl invocation"
    if len(parts) > 1 and parts[1] in BLOCKED_VERBS:
        return (f"verb {parts[1]!r} is blocked (interactive shells and "
                "tunnels are never executed by this service)")
    return None


def is_safe_kubectl_command(command: str) -> bool:
    """Bool form matching the reference's API (app.py:72)."""
    return unsafe_reason(command) is None
