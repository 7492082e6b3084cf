"""The entry point's shutdown against the JAX package's, on the CPU: each
package's server entry point (``<package>.server.__main__.main``, what
``python -m <package>.server`` runs) as a subprocess, SIGTERM sent while
a request is in flight.

Both packages must show the same sequence: after the first SIGTERM the
listening socket stays open and ``/health`` answers 503 (the engine is
no longer ready) while the request finishes 200; the process exits 0
once the drain ends, within ``DRAIN_TIMEOUT_SECS`` and a margin. A
second SIGTERM during a long drain stops the engine at once: the request
in flight fails 503 and the process exits 0 promptly.

The engine is each package's rule-table ``FakeEngine`` (``ENGINE=fake``)
with every answer held ``HOLD_SECS`` (``_DRIVER``'s ``HeldEngine``): its
``stop(drain_secs)`` waits for the held answers as a real engine's drain
waits for its slots, and ``stop(0)`` fails them, as the real engines'
shutdown does. Both packages' processes run side by side; every wait has
a deadline.
"""

import asyncio
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import aiohttp
from test_torch_env import KNOBS

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("ai_agent_kubectl_tpu_torch", "ai_agent_kubectl_tpu")
#: seconds a process may take to answer /health 200
START_S = 60.0
#: seconds past the drain a process may take to exit
EXIT_MARGIN_S = 10.0

#: run as ``python -c _DRIVER <package>``: the package's entry point with
#: its factory building a HeldEngine
_DRIVER = r'''
import asyncio, importlib, os, sys

root = sys.argv[1]
del sys.argv[1:]
fake = importlib.import_module(root + ".engine.fake")
protocol = importlib.import_module(root + ".engine.protocol")
factory = importlib.import_module(root + ".server.factory")
entry = importlib.import_module(root + ".server.__main__")
HOLD_SECS = float(os.environ["HOLD_SECS"])
HELD_FILE = os.environ["HELD_FILE"]


class HeldEngine(fake.FakeEngine):
    """The rule table's answer, held HOLD_SECS before it is returned."""

    def __init__(self):
        super().__init__()
        self.held = 0
        self.abort = asyncio.Event()

    async def generate(self, prompt, **kw):
        result = await super().generate(prompt, **kw)
        self.held += 1
        open(HELD_FILE, "a").close()
        try:
            await asyncio.wait_for(self.abort.wait(), HOLD_SECS)
        except asyncio.TimeoutError:
            return result
        finally:
            self.held -= 1
        raise protocol.EngineUnavailable("engine stopped")

    async def stop(self, drain_secs=0.0):
        self._ready = False
        if drain_secs <= 0:
            self.abort.set()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + drain_secs
        while self.held and not self.abort.is_set() and loop.time() < deadline:
            await asyncio.sleep(0.01)


factory._build_inner = lambda *args, **kwargs: HeldEngine()
entry.main()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _wait_exit(proc: subprocess.Popen, seconds: float):
    """The exit code, or None when the process is still up after
    ``seconds``."""
    end = time.monotonic() + seconds
    while proc.poll() is None and time.monotonic() < end:
        await asyncio.sleep(0.05)
    return proc.poll()


async def _health(http, url: str):
    """/health's status, or "refused" when nothing listens."""
    try:
        async with http.get(f"{url}/health") as r:
            return r.status
    except aiohttp.ClientConnectionError:
        return "refused"


async def _drive(package: str, work: Path, hold: float, drain: float,
                 force: bool) -> dict:
    """One process of ``package``: a request held in flight, SIGTERM (and
    a second one when ``force``), and what a client saw."""
    port = _free_port()
    held = work / f"{package}.held"
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env.update(ENGINE="fake", TORCH_DEVICE="cpu", JAX_PLATFORMS="cpu",
               HOST="127.0.0.1", PORT=str(port), RATE_LIMIT="1000/minute",
               DRAIN_TIMEOUT_SECS=str(drain), HOLD_SECS=str(hold),
               HELD_FILE=str(held), PYTHONPATH=str(ROOT))
    log = open(work / f"{package}.log", "w")
    proc = subprocess.Popen([sys.executable, "-c", _DRIVER, package],
                            env=env, cwd=str(work), stdout=log,
                            stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    out: dict = {}
    try:
        async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=hold + drain + 30)
        ) as http:
            end = time.monotonic() + START_S
            while await _health(http, url) != 200:
                assert proc.poll() is None, f"{package} exited at start"
                assert time.monotonic() < end, f"{package} did not start"
                await asyncio.sleep(0.1)

            async def ask():
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": "list all pods"}) as r:
                    return r.status, (await r.json()).get("kubectl_command")

            request = asyncio.ensure_future(ask())
            end = time.monotonic() + 30
            while not held.exists():
                assert not request.done(), await request
                assert time.monotonic() < end, f"{package}: nothing held"
                await asyncio.sleep(0.02)
            proc.send_signal(signal.SIGTERM)
            t_signal = time.monotonic()
            # /health while the request is in flight: the drain window
            seen = []
            while not request.done() and len(seen) < 200:
                seen.append(await _health(http, url))
                if force and seen[-1] == 503:
                    break
                await asyncio.sleep(0.05)
            out["health_in_drain"] = sorted(set(seen), key=str)
            if force:
                proc.send_signal(signal.SIGTERM)
            out["request"] = await asyncio.wait_for(request, hold + 30)
            out["request_done_s"] = time.monotonic() - t_signal
        rc = await _wait_exit(proc, drain + EXIT_MARGIN_S)
        out["exit"] = rc
        out["exit_s"] = time.monotonic() - t_signal
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        log.close()
    out["log"] = (work / f"{package}.log").read_text()[-3000:]
    return out


def _both(tmp_path, **kw) -> dict:
    async def go():
        return await asyncio.gather(*[_drive(p, tmp_path, **kw)
                                      for p in PACKAGES])

    return dict(zip(PACKAGES, asyncio.run(go())))


def _seen(run: dict) -> tuple:
    """What a client and the parent observe, times aside."""
    return run["health_in_drain"], run["request"], run["exit"]


def test_sigterm_drains_with_the_socket_open_as_the_jax_entry_point(
        tmp_path):
    """A 3 s request in flight at SIGTERM, a 20 s drain budget: /health
    503 through the window, the request 200, exit 0 once it is done."""
    hold, drain = 3.0, 20.0
    runs = _both(tmp_path, hold=hold, drain=drain, force=False)
    port, jax = (runs[p] for p in PACKAGES)
    assert _seen(jax) == ([503], (200, "kubectl get pods"), 0), jax["log"]
    assert _seen(port) == _seen(jax), port["log"]
    for run in runs.values():
        assert run["exit_s"] <= hold + EXIT_MARGIN_S, run["log"]
        assert run["exit_s"] >= run["request_done_s"]


def test_a_second_sigterm_cuts_the_drain_short_as_the_jax_entry_point(
        tmp_path):
    """A 60 s request and a 60 s drain budget: the second SIGTERM, once
    /health answers 503, fails the request 503 and the process exits 0
    within seconds."""
    hold, drain = 60.0, 60.0
    runs = _both(tmp_path, hold=hold, drain=drain, force=True)
    port, jax = (runs[p] for p in PACKAGES)
    assert _seen(jax) == ([503], (503, None), 0), jax["log"]
    assert _seen(port) == _seen(jax), port["log"]
    for run in runs.values():
        assert run["exit_s"] <= EXIT_MARGIN_S, run["log"]

