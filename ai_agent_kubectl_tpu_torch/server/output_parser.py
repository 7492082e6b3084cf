"""LLM output parsing + validation (reference app.py:90-104).

Replaces LangChain's ``StrOutputParser`` subclass with a plain function.
Improvements over the reference (documented quirk B5, SURVEY.md §2.3):
- strips ```` ``` ```` fences *with* language tags (``​```bash``), which the
  reference's leading/trailing-pair check missed;
- strips a leading ``$ `` shell-prompt artifact;
- collapses the output to the first non-empty line (the prompt demands a
  single-line command; chatty models sometimes append explanations).
"""

from __future__ import annotations

from .safety import unsafe_reason


class UnsafeCommandError(ValueError):
    """Raised when the model's output fails safety validation
    (maps to HTTP 422, reference app.py:192-194)."""


def _strip_fences(text: str) -> str:
    """Strip markdown code fences, including ```bash-style language tags.

    A single-line ``​```kubectl get pods```​`` must NOT treat ``kubectl`` as
    a language tag — the first-line token after the backticks is only a tag
    when dropping it still leaves a kubectl command behind.
    """
    if not text.startswith("```"):
        return text
    body = text[3:]
    if body.endswith("```"):
        body = body[:-3]
    body = body.strip()
    first_line, _, rest = body.partition("\n")
    first_line = first_line.strip()
    if rest and not first_line.lower().startswith("kubectl"):
        # Multi-line fence whose first line is a language tag ("bash").
        return rest.strip()
    return body


def parse_llm_output(text: str) -> str:
    """Extract a validated single-line kubectl command from raw model text."""
    command = _strip_fences(text.strip()).strip()
    # Drop a leading shell prompt marker if the model emitted one.
    if command.startswith("$ "):
        command = command[2:].lstrip()
    # Keep the first non-empty line only.
    for line in command.splitlines():
        line = line.strip()
        if line:
            command = line
            break
    reason = unsafe_reason(command)
    if reason is not None:
        raise UnsafeCommandError(
            f"Generated command failed safety checks ({reason}): {command}"
        )
    return command
