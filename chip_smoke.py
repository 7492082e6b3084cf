#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, in order; any failure raises and the script exits non-zero:

1. build    -- compile every CUDA kernel of the serving path from the
               sources in ``ai_agent_kubectl_tpu_torch/csrc`` (one nvcc
               per source, all started together) and print the build time.
2. kernel   -- hold each kernel against its plain PyTorch version on the
               card, in bf16, at Gemma-2B's attention shapes (H=8, KV=1,
               head_dim 256, page 16, 8 slots): decode at mixed positions,
               a 5-wide verify window, prefill spans of 64 and 512, a
               q_len=0 slot, sentinel table entries and an unmapped block
               full of NaN. The wrapper's launch counter must grow.
3. serve    -- build the port's server from the environment-style config
               (MODEL_NAME=gemma-2b-it, random bf16 weights from a fixed
               seed, DECODE_BATCH_SIZE=8, the default pool and radix
               settings), start it on 127.0.0.1 and send 8 concurrent
               POST /kubectl-command requests plus 2 repeats over HTTP.
               Launch counters are zeroed just before and read just after.
4. timing   -- time each kernel, its plain version, one PyTorch library
               call computing the same function, and its bound, at the
               shapes the serving path gives it.

The line before the last is the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them; before it, one ``{"kernels": [...]}`` JSON line. The last line is
``{"ok": true, "device": {...}}``. With no CUDA device, or without the
package beside this file, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "ai_agent_kubectl_tpu_torch"
PHASES = ("build", "kernel", "serve", "timing")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16
# tensor-core FLOP/s. The bound of a kernel is the larger of its bytes
# over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# Gemma-2B attention geometry and the serving pool's page.
N_SLOTS, N_HEADS, N_KV, HEAD_DIM, PAGE = 8, 8, 1, 256, 16
MAX_PAGES = 64                       # 1024 positions per slot

# Kernel vs plain, both bf16 in and out: |kernel - plain| <= ATOL +
# RTOL * |plain|. The two round at different places: the kernel rounds
# the unnormalised probabilities exp(s - m_running) to bf16 before P.V
# (as the TPU kernel does), the plain version the normalised ones, and
# each rounds its output to bf16 (half an ulp is 2^-9 relative).
ATOL, RTOL = 1e-2, 2e-2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


# ------------------------------------------------------------ ragged cases

def ragged_case(torch, gen, *, W, positions, q_lens, nan_block=True,
                device="cuda"):
    """One ragged-attention call at Gemma-2B's shapes: a pool of
    N*MAX_PAGES+1 blocks whose last block (the one a clamped sentinel
    entry lands on) is NaN, tables that map each slot's live pages to
    distinct blocks (slot 1 shares slot 0's first block) and hold the
    sentinel past them."""
    N = len(positions)
    n_blocks = N * MAX_PAGES + 1
    shape = (n_blocks, PAGE, N_KV, HEAD_DIM)
    k = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    if nan_block:
        k[n_blocks - 1] = float("nan")
        v[n_blocks - 1] = float("nan")
    q = torch.randn((N, W, N_HEADS, HEAD_DIM), generator=gen,
                    device=device).to(torch.bfloat16)
    sentinel = n_blocks + 7
    tables = torch.full((N, MAX_PAGES), sentinel, dtype=torch.int32)
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator()
                          .manual_seed(0)).to(torch.int32)
    used = 0
    for n, (p, ql) in enumerate(zip(positions, q_lens)):
        live = -(-(p + max(ql, 1)) // PAGE)
        assert live <= MAX_PAGES, (p, ql)
        tables[n, :live] = perm[used:used + live]
        used += live
    tables[1, 0] = tables[0, 0]          # a shared prefix page
    return dict(
        q=q, k=k, v=v,
        q_lens=torch.tensor(q_lens, dtype=torch.int32, device=device),
        positions=torch.tensor(positions, dtype=torch.int32, device=device),
        block_tables=tables.to(device))


def ragged_cases(torch, gen):
    """The shapes of phase 2: (label, case)."""
    return [
        ("decode", ragged_case(
            torch, gen, W=1,
            positions=[0, 15, 16, 100, 255, 511, 700, 1000],
            q_lens=[1, 1, 1, 0, 1, 1, 1, 1])),
        ("verify5", ragged_case(
            torch, gen, W=5,
            positions=[11, 30, 64, 127, 300, 0, 900, 1017],
            q_lens=[5, 5, 3, 5, 0, 5, 1, 5])),
        ("prefill64", ragged_case(
            torch, gen, W=64,
            positions=[0, 0, 64, 17, 300, 0, 500, 900],
            q_lens=[64, 40, 64, 1, 64, 0, 33, 64])),
        ("prefill512", ragged_case(
            torch, gen, W=512,
            positions=[0, 100, 0, 256, 0, 0, 500, 0],
            q_lens=[512, 512, 300, 512, 0, 1, 512, 200])),
    ]


def ragged_live_work(case) -> tuple:
    """(bytes, flops) the call needs for THIS data: q read and out
    written once, the live K/V rows (pos + q_len per slot) read once, the
    index vectors; 4 * hd * H FLOPs per attended (query column, key)."""
    q = case["q"]
    N, W, H, hd = q.shape
    KV = case["k"].shape[2]
    pos = case["positions"].tolist()
    ql = case["q_lens"].tolist()
    kv_rows = sum(p + l for p, l in zip(pos, ql) if l > 0)
    pairs = sum(sum(p + j + 1 for j in range(l)) for p, l in zip(pos, ql))
    nbytes = (2 * q.numel() * q.element_size()          # q in, out
              + 2 * kv_rows * KV * hd * 2               # live K and V
              + 4 * (2 * N + case["block_tables"].numel()))
    flops = 4 * pairs * H * hd
    return nbytes, flops


def sdpa_inputs(torch, case):
    """The library yardstick's inputs: each slot's live pages gathered
    into a contiguous [N, KV, S, hd] view and the causal-in-window mask.
    Built once; only the library call itself is timed."""
    q, k, v = case["q"], case["k"], case["v"]
    N, W, H, hd = q.shape
    n_blocks, page, KV, _ = k.shape
    pos = case["positions"].long()
    ql = case["q_lens"].long()
    S = int(((pos + ql.clamp(min=1)).max().item() + page - 1) // page * page)
    idx = case["block_tables"][:, :S // page].long().clamp(0, n_blocks - 1)
    kc = k[idx].reshape(N, S, KV, hd).transpose(1, 2).contiguous()
    vc = v[idx].reshape(N, S, KV, hd).transpose(1, 2).contiguous()
    cols = torch.arange(W, device=q.device)
    kv = torch.arange(S, device=q.device)
    mask = ((kv[None, None, :] <= (pos[:, None] + cols[None, :])[:, :, None])
            & (cols[None, :] < ql[:, None])[:, :, None])[:, None]
    return q.transpose(1, 2).contiguous(), kc, vc, mask


# ------------------------------------------------------------------ timing

def time_cuda(torch, fn, *, iters: int, warmup: int = 3,
              flush: bool = True) -> float:
    """Mean device milliseconds per call of ``fn``, from CUDA events
    around each call alone. With ``flush`` a 64 MB buffer is rewritten
    between calls, so every call finds the 50 MB L2 cold, as the serving
    path does (each layer's pool slice was last touched a whole forward
    ago)."""
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        if flush:
            scratch.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


# ------------------------------------------------------------------ phases

def phase_build() -> dict:
    from ai_agent_kubectl_tpu_torch.ops import _cuda

    t0 = time.monotonic()
    took = _cuda.build(_cuda.SOURCES)
    wall = time.monotonic() - t0
    for name in _cuda.SOURCES:
        log_path = _cuda.library_path(name).with_name(
            _cuda.library_path(name).name + ".log")
        if log_path.is_file():
            log(f"[build] ptxas for {name}:\n"
                + log_path.read_text(errors="replace").strip())
    log(f"[build] {len(took)} source(s) compiled in {wall:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in took.items()) or 'cached'})")
    return {"build_s": wall}


def phase_kernel(torch) -> dict:
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool, ragged_attention_pool_plain)

    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst = 0.0
    before = ragged_attention_pool.launches
    for label, case in ragged_cases(torch, gen):
        out = ragged_attention_pool(**case, page_size=PAGE)
        ref = ragged_attention_pool_plain(**case, page_size=PAGE)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"ragged kernel [{label}]: non-finite "
                                 f"output (a dead or NaN page leaked)")
        if not torch.isfinite(ref).all():
            raise AssertionError(f"plain ragged [{label}]: non-finite")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        bad = diff > ATOL + RTOL * ref.float().abs()
        frozen = case["q_lens"] == 0
        pad = (torch.arange(out.shape[1], device="cuda")[None, :]
               >= case["q_lens"][:, None])
        log(f"[kernel] ragged {label}: max |kernel - plain| = {err:.3e} "
            f"over {out.numel()} values")
        if bad.any():
            raise AssertionError(
                f"ragged kernel [{label}] disagrees with its plain version "
                f"at {int(bad.sum())} values (max abs err {err:.3e}; "
                f"tolerance {ATOL} + {RTOL}*|plain|)")
        if (out[frozen] != 0).any() or (out[pad] != 0).any():
            raise AssertionError(f"ragged kernel [{label}]: q_len=0 slots "
                                 f"and padded columns must be exact zeros")
        worst = max(worst, err)
    grew = ragged_attention_pool.launches - before
    if grew != 4:
        raise AssertionError(f"launch counter grew by {grew}, expected 4")
    return {"ragged_attention": {"max_abs_err": worst}}


QUERIES = [
    "list all pods in the default namespace",
    "show the nodes with their labels",
    "describe the deployment named web",
    "get services in kube-system",
    "scale deployment api to 3 replicas",
    "show logs of pod db-0",
    "list configmaps in namespace prod",
    "get events sorted by time",
]
REPEATS = [0, 3]            # served again after the burst: radix hits

# Served-path logits (kernel attention) against the same forward with the
# plain attention, both bf16 on the card: |kernel - plain| <= LOGIT_RTOL
# * rms(plain logits). The two differ only in where attention rounds to
# bf16; the difference compounds over 18 layers and the tied head.
LOGIT_RTOL = 0.05


# The served configuration, as the server reads it from the environment.
# Every other knob keeps its default: the block pool and radix cache on,
# ragged attention, 16-token pages and chunks, 128 new tokens, greedy.
SERVE_ENV = {
    "ENGINE": "torch", "TORCH_DEVICE": "cuda",
    "MODEL_NAME": "gemma-2b-it", "DTYPE": "bfloat16",
    "DECODE_BATCH_SIZE": str(N_SLOTS),
    # The `tokenizers` package imports on the card: the BPE asset serves.
    "TOKENIZER_PATH": str(ROOT / PACKAGE / "assets" / "tokenizer-k8s.json"),
}


class RecordingEngine:
    """The served engine with every ``generate`` result kept, so the
    smoke run can hold each HTTP status against the text the engine
    produced. Everything else passes through."""

    def __init__(self, inner):
        self.inner = inner
        self.results = []            # (prompt, EngineResult)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    async def generate(self, prompt, **kw):
        result = await self.inner.generate(prompt, **kw)
        self.results.append((prompt, result))
        return result


def phase_serve(torch, profile: bool = False) -> dict:
    return asyncio.run(_serve(torch, profile))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _serve(torch, profile: bool) -> dict:
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool)
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    port = _free_port()
    os.environ.update(SERVE_ENV, HOST="127.0.0.1", PORT=str(port))
    cfg = ServiceConfig.from_env()
    inner = build_engine(cfg)
    if not isinstance(inner, BatchedTorchEngine):
        raise AssertionError(f"engine construction failed: {inner!r}")
    engine = RecordingEngine(inner)
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    t0 = time.monotonic()
    await runner.setup()                 # starts the engine (warm-up too)
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    startup_s = time.monotonic() - t0
    log(f"[serve] {cfg.model_name} up on {cfg.host}:{port} in "
        f"{startup_s:.1f} s ({inner.device}, {inner.batch_size} slots, "
        f"pool {inner._pool_n_blocks} blocks)")
    url = f"http://{cfg.host}:{port}"
    try:
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{url}/health") as r:
                health = await r.json()
                if r.status != 200 or health["devices"] != 1:
                    raise AssertionError(f"/health: {r.status} {health}")

            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, await r.json()

            engine.results.clear()
            ragged_attention_pool.launches = 0
            steps0 = inner.forward_steps
            t_burst = time.monotonic()
            burst = await asyncio.gather(*[ask(q) for q in QUERIES])
            burst_s = time.monotonic() - t_burst
            t_rep = time.monotonic()
            repeats = [await ask(QUERIES[i]) for i in REPEATS]
            repeat_s = time.monotonic() - t_rep
            launches = ragged_attention_pool.launches
            steps = inner.forward_steps - steps0
            async with http.post(f"{url}/kubectl-command",
                                 json={"query": "x"}) as r:
                if r.status != 400:
                    raise AssertionError(f"short query gave {r.status}")
            profiled = (await _profile_burst(torch, inner, ask)
                        if profile else None)
    finally:
        await runner.cleanup()           # drains and stops the engine

    cfg_model = inner.model_cfg
    results = {}
    for prompt, res in engine.results:
        results.setdefault(prompt, []).append(res)
    statuses = [s for s, _ in burst + repeats]
    for query, (status, body) in zip(QUERIES + [QUERIES[i] for i in REPEATS],
                                     burst + repeats):
        res = results[render_prompt(query)][0]
        if res.completion_tokens <= 0:
            raise AssertionError(f"{query!r}: no tokens generated")
        want = status_for_text(res.text)
        if status != want:
            raise AssertionError(f"{query!r}: HTTP {status}, the service "
                                 f"gives {want} for {res.text!r}: {body}")
    for i in REPEATS:
        first, again = results[render_prompt(QUERIES[i])]
        if again.token_ids != first.token_ids:
            raise AssertionError(f"repeat of {QUERIES[i]!r} changed its "
                                 f"greedy tokens")
        if not again.prefix_cache_hit:
            raise AssertionError(f"repeat of {QUERIES[i]!r} missed the "
                                 f"radix cache")
    if launches < cfg_model.n_layers * steps or steps <= 0:
        raise AssertionError(f"attention kernel launched {launches} times "
                             f"for {steps} forward steps x "
                             f"{cfg_model.n_layers} layers")
    # The pool's books after the drain: every block free or held by the
    # radix tree, exactly.
    holders: dict = {}
    for slot in inner._slots:
        for b in (slot.blocks or []) if slot is not None else []:
            holders[b] = holders.get(b, 0) + 1
    if inner._radix is not None:
        for b, n in inner._radix._held.items():
            holders[b] = holders.get(b, 0) + n
    inner._pool.check(holders)

    logit_check = _check_served_logits(torch, inner, results)
    firsts = [results[render_prompt(q)][0] for q in QUERIES]
    n_tok = sum(r.completion_tokens for r in firsts)
    ttft = sorted(r.ttft_ms for r in firsts)
    info = {
        "startup_s": startup_s,
        "launches": launches,
        "forward_steps": steps,
        "launches_per_step": launches / steps,
        "statuses": statuses,
        "burst_requests": len(QUERIES),
        "burst_s": burst_s,
        "burst_tokens": n_tok,
        "burst_tok_per_s": n_tok / burst_s,
        "ttft_ms_p50": ttft[len(ttft) // 2],
        "ttft_ms_max": ttft[-1],
        "repeat_s": repeat_s,
        "repeat_prefix_hits": len(REPEATS),
        "logits": logit_check,
        "decode_positions": [r.prompt_tokens + r.completion_tokens // 2
                             for r in firsts],
        "profile": profiled,
    }
    log(f"[serve] statuses {statuses}; {n_tok} tokens in {burst_s:.2f} s "
        f"({n_tok / burst_s:.1f} tok/s), TTFT p50 {info['ttft_ms_p50']:.0f}"
        f" ms max {info['ttft_ms_max']:.0f} ms; kernel launches {launches} "
        f"over {steps} forward steps ({launches / steps:.0f} per step)")
    return info


async def _profile_burst(torch, inner, ask) -> dict:
    """Another burst of 8 fresh queries under ``torch.profiler`` (after
    the counted run): the device's busy share of the wall time and the
    kernels that take it, logged as a table and as one ``[profile] json``
    line. Only with ``--profile``."""
    from torch.profiler import ProfilerActivity, profile

    queries = [q + " now" for q in QUERIES]
    steps0 = inner.forward_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        await asyncio.gather(*[ask(q) for q in queries])
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    steps = inner.forward_steps - steps0
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                     # host ops: their kernels count
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((e.key, float(dev_us), int(e.count)))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) / 1e3
    out = {
        "wall_ms": wall_s * 1e3, "forward_steps": steps,
        "device_ms": device_ms,
        "device_busy_share": device_ms / (wall_s * 1e3),
        "kernel_calls_per_step": sum(r[2] for r in rows) / max(steps, 1),
        "top": [{"name": k[:120], "device_ms": us / 1e3, "calls": n,
                 "share_of_device": us / 1e3 / device_ms if device_ms else 0}
                for k, us, n in rows[:15]],
    }
    log(f"[profile] {len(queries)} requests, {steps} forward steps in "
        f"{wall_s * 1e3:.0f} ms wall; device busy {device_ms:.0f} ms "
        f"({out['device_busy_share']:.1%}); "
        f"{out['kernel_calls_per_step']:.0f} kernels per step")
    for r in out["top"]:
        log(f"[profile]   {r['device_ms']:9.2f} ms {r['calls']:7d} calls "
            f"{r['share_of_device']:6.1%}  {r['name']}")
    log("[profile] json " + json.dumps(out))
    return out


def _check_served_logits(torch, engine, results) -> dict:
    """First-step logits of one served prompt through the serving forward
    (kernel attention) against the same forward with the plain attention,
    on the card; and the served first token must be the kernel forward's
    argmax up to that tolerance."""
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.models import transformer
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool_plain)

    res = results[render_prompt(QUERIES[0])][0]
    ids = engine.tokenizer.encode(render_prompt(QUERIES[0]))
    P = len(ids)
    pages = -(-P // PAGE)
    dev = engine.device
    tokens = torch.tensor([ids], device=dev)
    positions = torch.arange(P, dtype=torch.int32, device=dev)[None]
    tables = torch.arange(pages, dtype=torch.int32, device=dev)[None]

    def run():
        cache = transformer.KVCache.pool(engine.model_cfg, pages, PAGE,
                                         dtype=engine.dtype, device=dev)
        logits, _ = transformer.forward(
            engine.params, engine.model_cfg, tokens, positions, cache,
            block_tables=tables,
            logits_at=torch.tensor([P - 1], device=dev))
        return logits[0, 0].float()

    with torch.no_grad():
        kernel = run()
        saved = transformer.ragged_attention_pool
        transformer.ragged_attention_pool = ragged_attention_pool_plain
        try:
            plain = run()
        finally:
            transformer.ragged_attention_pool = saved
    rms = float(plain.pow(2).mean().sqrt())
    err = float((kernel - plain).abs().max())
    tol = LOGIT_RTOL * rms
    top = float(kernel.max())
    served = int(res.token_ids[0])
    gap = top - float(kernel[served])
    log(f"[serve] first-step logits over {P} prompt tokens: max |kernel - "
        f"plain| {err:.4f} (rms {rms:.3f}, tolerance {tol:.4f}); served "
        f"token {served} sits {gap:.4f} below the kernel argmax "
        f"{int(kernel.argmax())}")
    if not torch.isfinite(kernel).all() or err > tol:
        raise AssertionError(f"served-path logits disagree with the plain "
                             f"forward: {err} > {tol}")
    if gap > tol:
        raise AssertionError(f"served first token {served} is {gap} below "
                             f"the argmax (tolerance {tol})")
    return {"prompt_tokens": P, "max_abs_err": err, "rms": rms,
            "tolerance": tol, "served_gap": gap}


def phase_timing(torch, serve_info: dict) -> dict:
    import torch.nn.functional as F

    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool, ragged_attention_pool_plain)

    gen = torch.Generator(device="cuda").manual_seed(99)
    decode_pos = serve_info.get("decode_positions") or [
        96, 112, 128, 144, 160, 176, 192, 208]
    shapes = {
        # The serving loop's decode step: one query per slot.
        "decode": ragged_case(torch, gen, W=1, positions=decode_pos,
                              q_lens=[1] * N_SLOTS, nan_block=False),
        # A prefill span of 512 in every slot.
        "prefill512": ragged_case(torch, gen, W=512,
                                  positions=[0] * N_SLOTS,
                                  q_lens=[512] * N_SLOTS, nan_block=False),
    }
    saved = ragged_attention_pool.launches
    out = {}
    for label, case in shapes.items():
        iters = 50 if label == "decode" else 10
        q, kc, vc, mask = sdpa_inputs(torch, case)
        kernel_ms = time_cuda(torch, lambda: ragged_attention_pool(
            **case, page_size=PAGE), iters=iters)
        plain_ms = time_cuda(torch, lambda: ragged_attention_pool_plain(
            **case, page_size=PAGE), iters=iters)
        library_ms = time_cuda(torch, lambda: F.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask, enable_gqa=True), iters=iters)
        kernel_ms2 = time_cuda(torch, lambda: ragged_attention_pool(
            **case, page_size=PAGE), iters=iters)
        nbytes, flops = ragged_live_work(case)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        out[label] = {
            "kernel_ms": (kernel_ms + kernel_ms2) / 2,
            "kernel_ms_runs": [kernel_ms, kernel_ms2],
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        }
        log(f"[timing] ragged {label}: kernel {kernel_ms:.4f}/"
            f"{kernel_ms2:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{library_ms:.4f} ms, bound {max(t_bytes, t_ops):.5f} ms "
            f"({out[label]['bound_by']})")
    ragged_attention_pool.launches = saved   # timing launches do not count
    return out


def kernel_lines(results: dict) -> list:
    """One entry per kernel of the serving path for the ``kernels`` line:
    launches from the serving run, the worst error of phase 2, and the
    decode-shape times at the top level (every shape under ``shapes``)."""
    timing = results.get("timing", {})
    main = timing.get("decode", {})
    entry = {
        "name": "ragged_attention_pool",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/ragged_attention.cu",
        "replaces": "ai_agent_kubectl_tpu/ops/ragged_attention.py:137",
        "launches": results.get("serve", {}).get("launches"),
        "max_abs_err": results.get("kernel", {}).get(
            "ragged_attention", {}).get("max_abs_err"),
        "tolerance": f"|kernel - plain| <= {ATOL} + {RTOL}*|plain| (bf16)",
        "ms": main.get("kernel_ms"),
        "kernel_ms": main.get("kernel_ms"),
        "plain_ms": main.get("plain_ms"),
        "bound_ms": main.get("bound_ms"),
        "bound_by": main.get("bound_by"),
        "library_ms": main.get("library_ms"),
        "library": "torch.nn.functional.scaled_dot_product_attention over "
                   "the gathered contiguous view",
        "shapes": timing,
    }
    return [entry]


# -------------------------------------------------------------------- main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="after the serving run, profile one more burst")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not (ROOT / PACKAGE / "__init__.py").is_file():
        log(f"{PACKAGE}/ is not beside {Path(__file__).name}: run this "
            f"script from a checkout of the repository")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this smoke run needs a "
            "CUDA device")
        return 2
    sys.path.insert(0, str(ROOT))
    # Every float32 comparison on the card runs in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    results: dict = {}
    t_all = time.monotonic()
    if "build" in phases:
        results["build"] = phase_build()
    if "kernel" in phases:
        results["kernel"] = phase_kernel(torch)
    if "serve" in phases:
        results["serve"] = phase_serve(torch, args.profile)
    if "timing" in phases:
        results["timing"] = phase_timing(torch, results.get("serve", {}))
    log(f"[done] phases {phases} in {time.monotonic() - t_all:.1f} s")

    print(json.dumps({"kernels": kernel_lines(results)}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
