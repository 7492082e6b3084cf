"""Async kubectl execution layer (reference app.py:205-281).

Executes a validated kubectl command as an argv-exec subprocess (never a
shell), with timeout + terminate/kill escalation, structured stdout parsing,
and structured error mapping.

Deliberate fixes over the reference (SURVEY.md §2.3):
- **B2 fixed**: every error path returns a complete ``metadata`` block, so
  the endpoint never KeyErrors into a 500. Timeout / missing-binary /
  bad-command all produce structured ``execution_error`` dicts with
  ``type``/``code``/``message`` (the reference returned bare strings).
- **B6 fixed**: the table parser aligns columns by header character
  positions instead of whitespace-splitting every row, so values containing
  spaces (``NOMINATED NODE``, age like "2d 3h") stay intact; ``-o json``
  output is detected and returned as parsed JSON.
- Timeout escalation: terminate(), 2 s grace (reference app.py:269), then
  kill() — the reference could leak a process that ignored SIGTERM.
"""

from __future__ import annotations

import asyncio
import datetime
import json
import logging
import re
import shlex
import time
from typing import Any, Dict, List, Optional

from ..obs.trace import trace_event

logger = logging.getLogger(__name__)


def utcnow_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def build_metadata(
    start_iso: str,
    start_ts: float,
    success: bool,
    error_type: Optional[str] = None,
    error_code: Optional[str] = None,
) -> Dict[str, Any]:
    md: Dict[str, Any] = {
        "start_time": start_iso,
        "end_time": utcnow_iso(),
        "duration_ms": (time.monotonic() - start_ts) * 1000.0,
        "success": success,
    }
    if error_type is not None:
        md["error_type"] = error_type
    if error_code is not None:
        md["error_code"] = error_code
    return md


_COLUMN_RE = re.compile(r"\S+(?: \S+)*")  # runs of non-space, single-space joined


def _header_spans(header: str) -> List[tuple]:
    """Column spans from a kubectl table header.

    kubectl separates columns by >=2 spaces (wide columns) or aligns them at
    fixed offsets; single spaces occur *inside* a header name ("NOMINATED
    NODE"). A span runs from its column's start to the next column's start.
    """
    spans = []
    for m in _COLUMN_RE.finditer(header):
        spans.append([m.start(), m.end(), m.group(0)])
    out = []
    for i, (start, _end, name) in enumerate(spans):
        next_start = spans[i + 1][0] if i + 1 < len(spans) else None
        out.append((start, next_start, name))
    return out


def parse_kubectl_stdout(stdout: str) -> Dict[str, Any]:
    """Structure kubectl stdout: JSON → parsed, table → rows, else raw.

    Rebuilt table parser (fixes quirk B6, reference app.py:236-249).
    """
    text = stdout.strip()
    if not text:
        return {"type": "raw", "data": ""}
    if text[0] in "{[":
        try:
            return {"type": "json", "data": json.loads(text)}
        except (json.JSONDecodeError, ValueError):
            pass
    if "\n" not in text:
        return {"type": "raw", "data": text}
    lines = text.splitlines()
    header = lines[0]
    spans = _header_spans(header)
    # Heuristic: a real kubectl table has an ALL-CAPS-ish header with >=2 cols.
    looks_tabular = len(spans) >= 2 and header == header.upper()
    if not looks_tabular:
        return {"type": "raw", "data": text}
    try:
        items = []
        for line in lines[1:]:
            if not line.strip():
                continue
            row: Dict[str, str] = {}
            for start, next_start, name in spans:
                cell = line[start:next_start] if next_start is not None else line[start:]
                row[name.lower()] = cell.strip()
            items.append(row)
        return {"type": "table", "data": items}
    except Exception as parse_err:  # pragma: no cover - defensive, matches app.py:247
        logger.warning("Failed to parse kubectl output: %s", parse_err)
        return {"type": "raw", "data": text}


class CommandExecutor:
    """Executes kubectl commands via asyncio subprocess with a timeout.

    ``kubectl_binary`` is injectable for tests (the reference hardcoded
    ``kubectl``, app.py:213); argv[0] is still re-asserted to be kubectl's
    basename as defense in depth.
    """

    def __init__(self, timeout: float = 30.0, kubectl_binary: str = "kubectl"):
        self.timeout = timeout
        self.kubectl_binary = kubectl_binary

    async def execute(self, command: str) -> Dict[str, Any]:
        start_iso = utcnow_iso()
        start_ts = time.monotonic()
        logger.info("Attempting to execute command: %s", command)
        try:
            args = shlex.split(command)
        except ValueError as ve:
            return {
                "execution_error": {
                    "type": "invalid_command",
                    "code": "parse_error",
                    "message": f"Invalid command format: {ve}",
                },
                "metadata": build_metadata(start_iso, start_ts, False, "invalid_command", "parse_error"),
            }
        if not args or args[0] != "kubectl":
            return {
                "execution_error": {
                    "type": "invalid_command",
                    "code": "not_kubectl",
                    "message": "Command does not start with kubectl",
                },
                "metadata": build_metadata(start_iso, start_ts, False, "invalid_command", "not_kubectl"),
            }
        args[0] = self.kubectl_binary

        trace_event(f"exec: spawning kubectl ({len(args) - 1} args)")
        try:
            process = await asyncio.create_subprocess_exec(
                *args,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE,
            )
        except FileNotFoundError:
            logger.error("kubectl binary not found. Is it installed and in PATH?")
            return {
                "execution_error": {
                    "type": "environment_error",
                    "code": "kubectl_not_found",
                    "message": "kubectl command not found",
                },
                "metadata": build_metadata(
                    start_iso, start_ts, False, "environment_error", "kubectl_not_found"
                ),
            }

        try:
            stdout, stderr = await asyncio.wait_for(
                process.communicate(), timeout=self.timeout
            )
        except asyncio.TimeoutError:
            logger.error(
                "Command execution timed out after %ss: %s", self.timeout, command
            )
            trace_event(f"exec: timed out after {self.timeout:g}s; reaping")
            await self._reap(process)
            return {
                "execution_error": {
                    "type": "timeout",
                    "code": "execution_timeout",
                    "message": f"Command execution timed out after {self.timeout:g}s",
                },
                "metadata": build_metadata(start_iso, start_ts, False, "timeout", "execution_timeout"),
            }

        trace_event(f"exec: kubectl exited rc={process.returncode}")
        if process.returncode == 0:
            result_stdout = stdout.decode(errors="replace").strip()
            logger.info("Command executed successfully (%d bytes stdout)", len(result_stdout))
            return {
                "execution_result": parse_kubectl_stdout(result_stdout),
                "metadata": build_metadata(start_iso, start_ts, True),
            }

        result_stderr = stderr.decode(errors="replace").strip()
        code = str(process.returncode)
        logger.error("Command failed with code %s: %s", code, result_stderr)
        return {
            "execution_error": {
                "type": "kubectl_error",
                "code": code,
                "message": result_stderr,
            },
            "metadata": build_metadata(start_iso, start_ts, False, "kubectl_error", code),
        }

    @staticmethod
    async def _reap(process: asyncio.subprocess.Process) -> None:
        """terminate → 2 s grace → kill (reference app.py:267-271, plus the
        missing SIGKILL escalation)."""
        try:
            process.terminate()
        except ProcessLookupError:
            return
        try:
            await asyncio.wait_for(process.wait(), timeout=2)
        except asyncio.TimeoutError:
            try:
                process.kill()
                await process.wait()
            except ProcessLookupError:
                pass
        except Exception as kill_err:  # pragma: no cover
            logger.error("Error terminating timed-out process: %s", kill_err)
