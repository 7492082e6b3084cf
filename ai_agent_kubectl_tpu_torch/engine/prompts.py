"""Prompt construction (reference app.py:50-57).

The system persona is kept verbatim from the reference — it is also the
shared prefix that the engine's prefix-KV cache precomputes once and splices
ahead of every request (SURVEY.md §5, long-context row; BASELINE north
star).
"""

from __future__ import annotations

SYSTEM_PROMPT = """\
You are a Kubernetes CLI specialist.
When given a user request, output exactly one valid, single-line `kubectl` command that fulfils it.
Do not include comments, explanations, or shell operators (`;`, `&&`, `||`, (```) etc.).
Only output the command itself, nothing else.
"""

USER_TEMPLATE = "User Request: {query}\nKubectl Command:"


def render_prompt(query: str) -> str:
    """Full prompt = shared system prefix + per-request suffix."""
    return SYSTEM_PROMPT + USER_TEMPLATE.format(query=query)


def split_prompt(query: str) -> tuple[str, str]:
    """(shared_prefix, per_request_suffix) — the prefix half is what the
    prefix-KV cache keys on."""
    return SYSTEM_PROMPT, USER_TEMPLATE.format(query=query)
