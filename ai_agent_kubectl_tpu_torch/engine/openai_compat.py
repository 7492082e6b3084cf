"""OpenAI-compatible remote engine (``ENGINE=openai``): a copy of the
JAX package's ``engine/openai_compat.py``.

The reference service's own generation path: a ChatCompletions call over
httpx, to the OpenAI API or to any OpenAI-compatible server named by
``OPENAI_BASE_URL`` (a local stub in the tests). Greedy by default
(temperature 0). It runs no model, so it has no device path.
"""

from __future__ import annotations

import asyncio
import json
import time
import weakref
from typing import AsyncIterator, Optional

import httpx

from .protocol import EngineResult, EngineUnavailable, GenerationTimeout


class OpenAICompatEngine:
    name = "openai"

    def __init__(
        self,
        api_key: Optional[str],
        model: str = "gpt-3.5-turbo",
        base_url: Optional[str] = None,
        timeout: float = 60.0,
    ):
        self.api_key = api_key
        self.model = model
        self.base_url = (base_url or "https://api.openai.com/v1").rstrip("/")
        self.timeout = timeout
        self._client: Optional[httpx.AsyncClient] = None
        self._inflight = 0
        self._draining = False
        self._stop_now = False      # force-stop: ends an in-progress drain

    @property
    def ready(self) -> bool:
        return (self._client is not None and bool(self.api_key)
                and not self._draining)

    async def start(self) -> None:
        self._draining = False
        headers = {}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        self._client = httpx.AsyncClient(
            base_url=self.base_url, headers=headers, timeout=self.timeout
        )

    async def stop(self, drain_secs: float = 0.0) -> None:
        # Drain: stop accepting (ready drops), wait for in-flight proxied
        # requests before closing the shared httpx client under them.
        if self._draining and drain_secs <= 0:
            # Force path (second signal): make the in-progress drain below
            # finish promptly and let IT own the single client close —
            # closing here would yank the shared client out from under the
            # very streams the drain exists to protect.
            self._stop_now = True
            return
        self._draining = True
        self._stop_now = False
        if drain_secs > 0:
            deadline = time.monotonic() + drain_secs
            while (self._inflight > 0 and not self._stop_now
                   and time.monotonic() < deadline):
                await asyncio.sleep(0.05)
        if self._client is not None:
            await self._client.aclose()
            self._client = None

    async def generate(
        self,
        prompt: str,
        *,
        max_tokens: int = 128,
        temperature: float = 0.0,
        timeout: Optional[float] = None,
    ) -> EngineResult:
        if self._client is None or not self.api_key or self._draining:
            raise EngineUnavailable("OpenAI engine not initialized (missing key?)"
                                    if not self._draining else
                                    "engine draining")
        t0 = time.monotonic()
        self._inflight += 1
        try:
            resp = await self._client.post(
                "/chat/completions",
                json={
                    "model": self.model,
                    "messages": [{"role": "user", "content": prompt}],
                    "temperature": temperature,
                    "max_tokens": max_tokens,
                },
                timeout=timeout or self.timeout,
            )
        except httpx.TimeoutException as e:
            raise GenerationTimeout(str(e)) from e
        except httpx.HTTPError as e:
            # Connect/read/protocol failures map to the same degraded-mode
            # exception as initialization failures (reference 503 path).
            raise EngineUnavailable(f"upstream request failed: {e}") from e
        finally:
            self._inflight -= 1
        if resp.status_code >= 400:
            # Same mapping as the streaming path: upstream HTTP errors are
            # engine unavailability, not an internal 500.
            raise EngineUnavailable(
                f"upstream returned {resp.status_code}: {resp.text[:200]}"
            )
        data = resp.json()
        text = data["choices"][0]["message"]["content"]
        usage = data.get("usage", {})
        elapsed_ms = (time.monotonic() - t0) * 1000.0
        return EngineResult(
            text=text,
            prompt_tokens=usage.get("prompt_tokens", 0),
            completion_tokens=usage.get("completion_tokens", 0),
            decode_ms=elapsed_ms,
            ttft_ms=elapsed_ms,
            engine=self.name,
        )

    def generate_stream(
        self,
        prompt: str,
        *,
        max_tokens: int = 128,
        temperature: float = 0.0,
        timeout: Optional[float] = None,
    ) -> AsyncIterator[str]:
        """True token streaming: ``stream: true`` ChatCompletions request,
        SSE ``data:`` chunks parsed incrementally (delta.content pieces).

        A thin NON-generator wrapper: the readiness check and
        the ``_inflight`` increment run at CALL time, so a stream that has
        been created but not yet iterated when ``stop(drain_secs)`` fires
        is already visible to the drain — the httpx client can't be closed
        under it. A stream that is created but NEVER iterated would leak
        the increment permanently (an unstarted async generator's body —
        and its ``finally`` — never runs, even on aclose/GC), so a GC
        finalizer releases the slot for exactly that case."""
        if self._client is None or not self.api_key or self._draining:
            raise EngineUnavailable("OpenAI engine not initialized (missing key?)"
                                    if not self._draining else
                                    "engine draining")
        self._inflight += 1
        started = {"flag": False}
        agen = self._generate_stream_impl(
            started, prompt, max_tokens=max_tokens, temperature=temperature,
            timeout=timeout)
        weakref.finalize(agen, self._release_unstarted, started)
        return agen

    def _release_unstarted(self, started: dict) -> None:
        # Runs at the stream generator's GC. If the body ever started, its
        # own finally released the slot; otherwise do it here.
        if not started["flag"]:
            self._inflight -= 1

    async def _generate_stream_impl(
        self,
        started: dict,
        prompt: str,
        *,
        max_tokens: int,
        temperature: float,
        timeout: Optional[float],
    ) -> AsyncIterator[str]:
        started["flag"] = True
        try:
            async with self._client.stream(
                "POST",
                "/chat/completions",
                json={
                    "model": self.model,
                    "messages": [{"role": "user", "content": prompt}],
                    "temperature": temperature,
                    "max_tokens": max_tokens,
                    "stream": True,
                },
                timeout=timeout or self.timeout,
            ) as resp:
                if resp.status_code >= 400:
                    body = (await resp.aread()).decode(errors="replace")
                    raise EngineUnavailable(
                        f"upstream returned {resp.status_code}: {body[:200]}"
                    )
                ctype = resp.headers.get("content-type", "")
                if "text/event-stream" not in ctype:
                    # Upstream ignored stream:true (minimal OpenAI-compat
                    # stubs, the OPENAI_BASE_URL escape hatch): fall back to
                    # the one-shot completion body.
                    data = json.loads(await resp.aread())
                    text = data["choices"][0]["message"]["content"]
                    if text:
                        yield text
                    return
                async for line in resp.aiter_lines():
                    line = line.strip()
                    if not line.startswith("data:"):
                        continue  # comments / blank keep-alives
                    data = line[len("data:"):].strip()
                    if data == "[DONE]":
                        break
                    try:
                        choices = json.loads(data).get("choices", [])
                    except json.JSONDecodeError:
                        continue  # tolerate malformed keep-alive frames
                    if not choices:
                        continue
                    piece = (choices[0].get("delta") or {}).get("content")
                    if piece:
                        yield piece
        except httpx.TimeoutException as e:
            raise GenerationTimeout(str(e)) from e
        except httpx.HTTPError as e:
            # ConnectError before the stream opens, ReadError/protocol
            # errors mid-stream: surface as EngineUnavailable so callers
            # keying fallback on engine exception types catch them, matching
            # the initialization and >=400 paths above.
            raise EngineUnavailable(f"upstream stream failed: {e}") from e
        finally:
            self._inflight -= 1
