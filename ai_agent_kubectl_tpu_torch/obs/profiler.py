"""On-demand ``torch.profiler`` capture for a live server, and the
scopes the forward is annotated with.

``POST /debug/profile?seconds=N`` lands in ``capture``: a fresh
directory under the temp dir, a profiler running N seconds while live
traffic keeps decoding, and its Chrome-trace JSON exported into that
directory (``chrome://tracing``/Perfetto-loadable; ``obs/attribution.py``
parses it). The answer is ``{"trace_dir", "seconds"}``, as the JAX
package's; the newest ``KEEP_TRACES`` captures are kept.

Which thread profiles: ``torch.profiler`` records the
``record_function`` ranges of the thread that started it and no other,
while the forwards run on the engine's own thread (the batched engine's
scheduler, the single-sequence engine's generation thread). So the
capture is handed to the engine (``engine.profile(seconds, trace_dir)``),
which starts and stops a ``ProfilerSession`` on that thread; CUPTI then
records every kernel of the process and Kineto lays the ranges over
the card's timeline as ``gpu_user_annotation`` spans. The activities
follow the engine's device: a CUDA engine captures
``ProfilerActivity.CUDA`` or answers an error, never the CPU alone.

``scope(name)`` is the one helper every annotated region goes through
(the counterpart of ``jax.named_scope``, which costs XLA nothing at run
time): a ``record_function`` while a profiler is active, else one shared
no-op context, so serving pays a module-attribute read per scope.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import tempfile
import time

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger(__name__)

#: traces are tens of MB each; keep the newest few and reap the rest.
KEEP_TRACES = 4

#: capture length clamp (seconds): long enough for a few decode chunks,
#: short enough that an operator typo can't profile for an hour.
MIN_SECONDS = 0.1
MAX_SECONDS = 30.0

#: the file a capture writes into its directory.
TRACE_FILE = "trace.pt.trace.json"

_NO_SCOPE = contextlib.nullcontext()


def scope(name: str):
    """``record_function(name)`` while a profiler is active, else a
    shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SCOPE


def clamp_seconds(seconds: float) -> float:
    return min(max(float(seconds), MIN_SECONDS), MAX_SECONDS)


def trace_base_dir() -> str:
    return os.path.join(tempfile.gettempdir(),
                        "ai-agent-kubectl-torch-traces")


def _reap_old(base: str) -> None:
    old = sorted(
        d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d))
    )
    if len(old) > KEEP_TRACES:
        for d in old[:-KEEP_TRACES]:
            shutil.rmtree(os.path.join(base, d), ignore_errors=True)


def activities_for(device: torch.device) -> list:
    """The profiler activities for an engine on ``device``: the CPU's,
    plus CUDA's on a CUDA engine. Raises when the CUDA activity is not
    available: a card's capture without its kernels is no capture."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        cuda = torch.profiler.ProfilerActivity.CUDA
        if cuda not in torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot trace the CUDA "
                               "device in this build (no CUPTI)")
        acts.append(cuda)
    return acts


class ProfilerSession:
    """One capture, started and stopped on the thread that runs the
    forwards. On a card each end waits for the card first: the capture
    opens on an idle card, whatever work earlier callers left queued on
    any stream, and closes only once every kernel it launched has ended,
    so that CUPTI holds each one's record when the capture flushes."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.activities = activities_for(self.device)
        self._prof = None

    def _drain(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._drain()
        self._prof = torch.profiler.profile(activities=self.activities)
        self._prof.__enter__()

    def stop(self, trace_dir: str) -> str:
        """Stop the capture and export its Chrome trace; returns the
        file's path."""
        prof, self._prof = self._prof, None
        self._drain()
        prof.__exit__(None, None, None)
        path = os.path.join(trace_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        return path


async def capture(seconds: float, engine) -> dict:
    """Run one profiler capture through ``engine.profile``; returns
    ``{"trace_dir", "seconds"}``. The caller serializes captures (one
    at a time)."""
    seconds = clamp_seconds(seconds)
    base = trace_base_dir()
    os.makedirs(base, exist_ok=True)
    _reap_old(base)
    trace_dir = tempfile.mkdtemp(
        prefix=f"{time.strftime('%Y%m%d-%H%M%S')}-", dir=base
    )
    logger.info("profiler: capturing %.1fs trace into %s", seconds,
                trace_dir)
    await engine.profile(seconds, trace_dir)
    return {"trace_dir": trace_dir, "seconds": seconds}
