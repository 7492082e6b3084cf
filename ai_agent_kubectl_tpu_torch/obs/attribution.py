"""Decode-step cost attribution: a torch.profiler trace → a per-op-category
table that sums to the measured step.

The counterpart of the JAX package's ``obs/attribution.py``, with its
schema (``decode-step-attribution/v2``), categories and rule order. What
names a span differs:

- The model code runs its regions under ``obs/profiler.py::scope``
  (``embed``, ``attn_norm``, ``qkv_proj``, ``rope``, ``kv_write``,
  ``attention``, ``o_proj``, ``mlp``, ``final_norm``, ``lm_head``,
  ``sampling``, ``kv_splice``: the JAX ``named_scope`` names letter for
  letter). While a profiler records, each scope is a ``record_function``
  range, which Kineto lays over the card's timeline as a
  ``gpu_user_annotation`` span covering the kernels it launched.
- **On the card** (``span_source`` ``"cuda_device"``) the spans are the
  trace's device events: ``cat`` ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``. Each is billed by the path of ranges open on the host
  thread that launched it, at its launch call (the ``cuda_runtime`` or
  ``cuda_driver`` event of the same ``correlation``), outermost to
  innermost, and its own name: the scope that launched it, as a JAX op
  carries its ``named_scope``. (A span whose launch is not in the trace
  takes the ``gpu_user_annotation`` ranges that cover it on the card's
  timeline instead; such a range runs from the first to the last of its
  kernels' timestamps, so one kernel stamped out of its stream's order
  stretches it over every kernel between.) The JAX scope rules match on
  that text first. A kernel no range covers falls to name rules, the counterpart of ``_HLO_RULES``: the port's own
  kernel symbols (``csrc/ragged_attention.cu``, ``paged_attention.cu``,
  ``flash_attention.cu`` to ``attention``; ``int4_matmul.cu`` to
  ``weight_gemms``), cuBLAS/CUTLASS GEMMs to ``weight_gemms``, and copy,
  convert and elementwise kernels to ``data_movement``.
- **On the CPU** (``"host_ops"``) the spans are the ``cpu_op`` events
  inside the ``user_annotation`` ranges of their own thread: not device
  time, but the same parse and rules run end to end (the counterpart of
  the JAX ``host_xla_ops``).

Device idle inside the capture window is ``gaps``; ``coverage_pct``
counts the recognized categories only (``other_device`` and ``gaps``
excluded), computed as the JAX package computes it.

Two entry points, as in the JAX package:

- ``run_attribution(...)`` builds the batched engine and runs its decode
  chunk (``BatchedTorchEngine._run_chunk``, the scheduler's own code)
  ``reps`` times under the profiler; returns the validated artifact.
  ``python -m ai_agent_kubectl_tpu_torch.obs.attribution`` is its CLI.
- ``attribute_trace(trace_dir, steps)`` parses a capture that exists
  (what ``POST /debug/profile`` wrote, or a synthetic trace in tests).
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

SCHEMA_ID = "decode-step-attribution/v2"

#: category order is presentation order; "gaps" is computed (window −
#: device-busy union), everything else from span durations.
CATEGORIES = (
    "weight_gemms",        # qkv/o/mlp/moe projections + embedding read
    "attention",           # score/probs dots over the live KV span
    "lm_head_sampling",    # vocab head projection + sampling chain
    "kv_write_splice",     # per-layer KV scatter + admission splices
    "norm_rope_residual",  # layernorms, RoPE, residual adds
    "all_reduce",          # TP collectives fused into the GEMM outputs
    "data_movement",       # copies, transposes, converts, layout changes
    "other_device",        # device-busy spans nothing above matched
    "gaps",                # device idle inside the capture window
)

#: the span sources the artifact may name: the JAX package's three and
#: the port's two.
SPAN_SOURCES = ("tpu_device", "host_xla_ops", "cuda_device", "host_ops",
                "none")

#: scope-path keywords, checked in order — first hit wins (the JAX rules
#: verbatim: "attn_norm"/"mlp_norm" land in norms before the weight-GEMM
#: rule's enclosing "mlp" scope could take them).
_SCOPE_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("all_reduce", ("all_reduce",)),
    ("lm_head_sampling", ("lm_head", "sampling")),
    ("kv_write_splice", ("kv_write", "kv_splice", "splice")),
    ("attention", ("attention", "flash", "paged", "ring")),
    ("norm_rope_residual", ("attn_norm", "mlp_norm", "final_norm",
                            "rms_norm", "rope")),
    ("weight_gemms", ("qkv_proj", "o_proj", "mlp", "embed", "moe",
                      "expert")),
)

#: kernel-name fallbacks for a device span no scope range covers, the
#: counterpart of the JAX ``_HLO_RULES``: the port's own kernel symbols
#: first, then the GEMM libraries, then data movement. (The scope rules
#: above still see the name first, so ``ragged_mma_kernel`` — "ragged"
#: is no scope keyword — is taken here, and ``paged_decode_kernel`` and
#: the flash kernels by the attention scope rule's own keywords.)
_KERNEL_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("attention", ("ragged_mma_kernel", "ragged_combine_kernel",
                   "paged_decode_kernel",
                   "flash_mma_kernel", "flash_combine_kernel")),
    ("weight_gemms", ("int4_wgmma_kernel",)),
    ("weight_gemms", ("gemm", "gemv", "matmul", "nvjet", "cutlass",
                      "xmma", "cublas", "splitkreduce", "dot_kernel")),
    ("data_movement", ("memcpy", "memset", "copy", "convert", "cast",
                       "transpose", "cat", "index", "gather", "scatter",
                       "fill", "elementwise", "arange")),
)

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host API calls that launch a device span (its ``correlation``)
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def categorize(text: str) -> str:
    """Category for one span, from its scope path and name: the JAX
    scope rules, then the kernel-name rules."""
    t = text.lower()
    for rules in (_SCOPE_RULES, _KERNEL_RULES):
        for cat, keys in rules:
            if any(k in t for k in keys):
                return cat
    return "other_device"


# ------------------------------------------------------------- trace parse

def _load_trace_events(trace_dir: str) -> List[dict]:
    """All traceEvents from every Chrome-trace file under ``trace_dir``
    (``*.json`` or ``*.json.gz``, any depth)."""
    events: List[dict] = []
    paths = sorted(set(
        glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
        + glob.glob(os.path.join(trace_dir, "**", "*.json.gz"),
                    recursive=True)))
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            data = json.load(f)
        if isinstance(data, dict):
            events.extend(data.get("traceEvents", []))
    return events


def _complete(events: Iterable[dict], cats: Tuple[str, ...]) -> List[dict]:
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in cats
            and float(e.get("dur", 0.0)) > 0.0]


def _paths(points: List[Tuple[object, float]],
           ranges: List[Tuple[object, float, float, str]]) -> List[str]:
    """Per ``(key, ts)`` point, in input order: the names of the
    ``(key, start_us, end_us, name)`` ranges of its key that cover
    ``ts``, outermost first, joined by "/" ("" when none covers it)."""
    by_key: Dict[object, List[Tuple[float, float, str]]] = {}
    for k, ts, te, name in ranges:
        by_key.setdefault(k, []).append((ts, te, name))
    for rs in by_key.values():
        rs.sort()
    out = [""] * len(points)
    cursor: Dict[object, int] = {}
    active: Dict[object, list] = {}
    for j in sorted(range(len(points)), key=lambda j: points[j][1]):
        k, ts = points[j]
        rs = by_key.get(k, [])
        i = cursor.get(k, 0)
        act = active.setdefault(k, [])
        while i < len(rs) and rs[i][0] <= ts:
            act.append(rs[i])
            i += 1
        cursor[k] = i
        act[:] = [r for r in act if r[1] > ts]
        out[j] = "/".join(r[2] for r in sorted(act,
                                               key=lambda r: r[0] - r[1]))
    return out


def _ranges(events: List[dict], key) -> list:
    """(key(e), start_us, end_us, name) per range event."""
    return [(key(e), float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             str(e.get("name", ""))) for e in events]


def _thread(e: dict) -> tuple:
    return (e.get("pid"), e.get("tid"))


def _card(e: dict) -> tuple:
    return ("card", e.get("pid"))


def _select_spans(events: List[dict]
                  ) -> Tuple[List[Tuple[float, float, str, str]], str]:
    """(spans, source): (start_us, end_us, text, op name) per span, in
    start order; ``text`` is the scope path, then the span's own name.
    The card's kernels, copies and sets when the trace has any
    ("cuda_device"): each under the ``user_annotation`` ranges open on
    its launching thread at its launch call (found by ``correlation``),
    so it bills to the scope that launched it; a span whose launch is
    not in the trace, under the ``gpu_user_annotation`` ranges covering
    its start on the card's timeline. (Those ranges run from the first
    to the last of their kernels' timestamps, so one kernel stamped out
    of its stream's order stretches a range over every kernel between:
    never the first choice.) Else the host's ``cpu_op`` events inside
    ``user_annotation`` ranges of their own thread ("host_ops"); else
    none."""
    device = _complete(events, _DEVICE_CATS)
    ranges = _ranges(_complete(events, ("user_annotation",)), _thread)
    if device:
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("ph") == "X" and e.get("cat") in _LAUNCH_CATS
                    and "correlation" in e.get("args", {})}
        own = [launches.get(e.get("args", {}).get("correlation"))
               for e in device]
        points = [(_thread(l), float(l["ts"])) if l is not None
                  else (_card(e), float(e["ts"]))
                  for e, l in zip(device, own)]
        ranges += _ranges(_complete(events, ("gpu_user_annotation",)),
                          _card)
        spans = device
        source = "cuda_device"
    else:
        spans = _complete(events, ("cpu_op",))
        points = [(_thread(e), float(e["ts"])) for e in spans]
        source = "host_ops"
    out = []
    for e, path in zip(spans, _paths(points, ranges)):
        if path or source == "cuda_device":
            name = str(e.get("name", "")) or "?"
            ts = float(e["ts"])
            out.append((ts, ts + float(e["dur"]),
                        f"{path} {name}" if path else name, name))
    if not out:
        source = "none"
    return sorted(out), source


def _union_ms(intervals: List[Tuple[float, float]]) -> float:
    """Total length (ms) of the union of [start, end] microsecond
    intervals (overlap-safe — nested ops must not double-count)."""
    total = 0.0
    end: Optional[float] = None
    for s, t in sorted(intervals):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total / 1000.0


def attribute_trace(trace_dir: str, steps: int, *,
                    meta: Optional[dict] = None) -> dict:
    """Parse ``trace_dir`` and bill device time to categories.

    ``steps`` = decode steps executed inside the capture; per-step
    numbers divide by it. Returns the artifact dict (schema
    ``decode-step-attribution/v2``), NOT yet validated — callers run
    ``validate_attribution``."""
    if steps < 1:
        raise ValueError("steps must be >= 1")
    spans, span_source = _select_spans(_load_trace_events(trace_dir))

    per_cat: Dict[str, List[Tuple[float, float]]] = {c: [] for c in CATEGORIES}
    per_op: Dict[str, Dict[str, float]] = {c: {} for c in CATEGORIES}
    for ts, te, text, op in spans:
        cat = categorize(text)
        per_cat[cat].append((ts, te))
        per_op[cat][op] = per_op[cat].get(op, 0.0) + (te - ts) / 1000.0

    busy_ms = _union_ms([(s, t) for s, t, _, _ in spans])
    window_ms = ((max(t for _, t, _, _ in spans)
                  - min(s for s, _, _, _ in spans)) / 1000.0
                 if spans else 0.0)
    gaps_ms = max(window_ms - busy_ms, 0.0)

    # Coverage is the UNION of every recognized category's intervals,
    # not their sum (host ops nest and overlap across categories).
    recognized_iv: List[Tuple[float, float]] = []
    categories = []
    for cat in CATEGORIES:
        ms = gaps_ms if cat == "gaps" else _union_ms(per_cat[cat])
        if cat not in ("other_device", "gaps"):
            recognized_iv.extend(per_cat[cat])
        top = sorted(per_op[cat].items(), key=lambda kv: -kv[1])[:5]
        categories.append({
            "name": cat,
            "ms_per_step": round(ms / steps, 4),
            "pct_of_step": round(100.0 * ms / window_ms, 2) if window_ms
            else 0.0,
            "top_ops": [{"name": n, "ms_per_step": round(v / steps, 4)}
                        for n, v in top],
        })

    recognized_ms = min(_union_ms(recognized_iv), window_ms)
    out = {
        "schema": SCHEMA_ID,
        "steps_measured": steps,
        "span_source": span_source,
        "n_device_spans": len(spans),
        "wall_ms_total": round(window_ms, 3),
        "device_busy_ms_total": round(busy_ms, 3),
        "step_ms": round(window_ms / steps, 4),
        "device_busy_ms_per_step": round(busy_ms / steps, 4),
        "categories": categories,
        "coverage_pct": round(100.0 * recognized_ms / window_ms, 2)
        if window_ms else 0.0,
        "unattributed_ms_per_step": round(
            (window_ms - recognized_ms) / steps, 4),
    }
    out.update(meta or {})
    return out


def validate_attribution(obj: dict) -> None:
    """Schema check for the attribution artifact. Raises ``ValueError``
    on any violation."""
    if not isinstance(obj, dict):
        raise ValueError("artifact must be a dict")
    if obj.get("schema") != SCHEMA_ID:
        raise ValueError(f"schema must be {SCHEMA_ID!r}, "
                         f"got {obj.get('schema')!r}")
    if obj.get("span_source") not in SPAN_SOURCES:
        raise ValueError(f"bad span_source {obj.get('span_source')!r}")
    for key, typ in (("steps_measured", int), ("n_device_spans", int),
                     ("wall_ms_total", (int, float)),
                     ("device_busy_ms_total", (int, float)),
                     ("step_ms", (int, float)),
                     ("coverage_pct", (int, float)),
                     ("unattributed_ms_per_step", (int, float)),
                     ("categories", list)):
        if not isinstance(obj.get(key), typ):
            raise ValueError(f"missing/mistyped field {key!r}")
    names = []
    for cat in obj["categories"]:
        if not isinstance(cat, dict):
            raise ValueError("category entries must be dicts")
        if cat.get("name") not in CATEGORIES:
            raise ValueError(f"unknown category {cat.get('name')!r}")
        names.append(cat["name"])
        for key in ("ms_per_step", "pct_of_step"):
            if not isinstance(cat.get(key), (int, float)) or cat[key] < 0:
                raise ValueError(f"category {cat['name']}: bad {key!r}")
        if not isinstance(cat.get("top_ops"), list):
            raise ValueError(f"category {cat['name']}: top_ops must be a list")
    if names != list(CATEGORIES):
        raise ValueError(
            f"categories must be exactly {list(CATEGORIES)} in order, "
            f"got {names}")
    if not (0.0 <= obj["coverage_pct"] <= 100.0):
        raise ValueError("coverage_pct out of [0, 100]")
    # The table must SUM to the step on a serial device stream; host ops
    # nest, so their per-category sums can exceed wall time.
    total_pct = sum(c["pct_of_step"] for c in obj["categories"])
    if (obj["span_source"] in ("tpu_device", "cuda_device")
            and obj["wall_ms_total"] > 0
            and not (95.0 <= total_pct <= 105.0)):
        raise ValueError(
            f"category percentages sum to {total_pct:.1f}, not ~100 — "
            "the table no longer sums to the measured step")


def short_name(op: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::
    ragged_mma_kernel<256>(...)`` reads ``ragged_mma_kernel``."""
    name = op[5:] if op.startswith("void ") else op
    for ns in ("(anonymous namespace)::", "at::native::"):
        name = name.replace(ns, "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0),
              default=len(name))
    return name[:cut][:64]


def render_markdown(obj: dict) -> str:
    """A Markdown table for one attribution artifact."""
    lines = [
        "| Category | ms/step | % of step | top ops |",
        "|---|---|---|---|",
    ]
    for cat in obj["categories"]:
        tops = ", ".join(
            f"{short_name(o['name'])} {o['ms_per_step']:.3f}"
            for o in cat["top_ops"][:3]
        ) or "—"
        lines.append(
            f"| {cat['name']} | {cat['ms_per_step']:.3f} "
            f"| {cat['pct_of_step']:.1f}% | {tops} |"
        )
    lines.append(
        f"| **step total** | **{obj['step_ms']:.3f}** | 100% "
        f"| coverage {obj['coverage_pct']:.1f}%, "
        f"unattributed {obj['unattributed_ms_per_step']:.3f} ms/step |"
    )
    return "\n".join(lines)


# --------------------------------------------------- the engine's chunk

def run_attribution(*, model: str = "gemma-7b-it", quant: str = "int8",
                    kv_quant: str = "", dtype: str = "bfloat16",
                    batch_size: int = 48, chunk_len: int = 16,
                    max_seq: int = 192, reps: int = 6,
                    device: str = "cuda", keep_trace: bool = False) -> dict:
    """Profile the batched engine's decode chunk and attribute it.

    The engine is ``BatchedTorchEngine`` built as a server builds it
    (random weights from seed 0, the pool in the regime it resolves on
    ``device``), every slot armed mid-life at a position where ``reps +
    2`` chunks stay inside the table, all live with an unreachable
    budget. ``_run_chunk`` — the scheduler's own chunk — runs once
    outside the capture (the kernels build on first use), then ``reps``
    times inside it with one sync at the end, every slot re-armed live
    before each (a random-weight EOS must not time a masked step)."""
    import shutil
    import tempfile
    import time

    import numpy as np
    import torch

    from ..engine.batcher import BatchedTorchEngine
    from ..models.config import get_config
    from .profiler import ProfilerSession

    cfg = get_config(model)
    tokenizer_path = None
    if not cfg.name.startswith("toy"):
        tokenizer_path = os.path.join(os.path.dirname(__file__), "..",
                                      "assets", "tokenizer-k8s.json")
    eng = BatchedTorchEngine(
        cfg, batch_size=batch_size, chunk_len=chunk_len, dtype=dtype,
        quant=quant, kv_quant=kv_quant, max_seq_len=max_seq,
        tokenizer_path=tokenizer_path, device=device)
    eng._load()
    eng._resolve_regime()
    if not eng.kv_pool:   # pragma: no cover - the pool is the default
        eng._init_prefix_cache()
    eng._eos_d = torch.tensor(sorted(set(cfg.eos_ids)), dtype=torch.int32,
                              device=eng.device)
    eng._init_decode_state()
    N = batch_size
    S_alloc = eng._S_alloc
    if S_alloc < (reps + 2) * chunk_len + 1:
        raise ValueError(
            f"max_seq {max_seq} too short for reps={reps} × "
            f"chunk={chunk_len}: timed KV writes would run past the "
            f"table")
    pos0 = max(0, min(320, S_alloc - (reps + 2) * chunk_len - 1))
    for i in range(N):
        blocks = eng._pool_alloc(eng._pool_max_pages)
        eng._tables[i, :] = blocks
    tables = eng._tables_d(eng._tables)
    force = torch.ones((N,), dtype=torch.bool, device=eng.device)

    def arm() -> None:
        eng._tok_d.zero_()
        eng._pos_d.fill_(pos0)
        eng._active_d.fill_(True)
        eng._ngen_d.zero_()
        eng._budget_d.fill_(1 << 30)

    kv_limit = eng._kv_buckets[-1]
    arm()
    packed = eng._run_chunk(force, tables, None, kv_limit=kv_limit)
    packed.cpu()                                        # build + warm
    session = ProfilerSession(eng.device)
    trace_dir = tempfile.mkdtemp(prefix="attr_step_")
    arm()
    try:
        t0 = time.perf_counter()
        session.start()
        try:
            for _ in range(reps):
                eng._active_d.fill_(True)
                eng._ngen_d.zero_()
                packed = eng._run_chunk(force, tables, None,
                                        kv_limit=kv_limit)
            np.asarray(packed.cpu())
        finally:
            session.stop(trace_dir)
        wall_s = time.perf_counter() - t0
        steps = reps * chunk_len
        out = attribute_trace(trace_dir, steps, meta={
            "model": cfg.name,
            "backend": eng.device.type,
            "quant": quant or "-",
            "kv_quant": kv_quant or "-",
            "dtype": dtype,
            "batch_size": N,
            "chunk_len": chunk_len,
            "max_seq": max_seq,
            "kv_limit": kv_limit,
            "attention_regime": eng._attention_regime,
            "reps": reps,
            "wall_ms_per_step_host": round(wall_s * 1000.0 / steps, 4),
        })
        validate_attribution(out)
        if keep_trace:
            out["trace_dir"] = trace_dir
        return out
    finally:
        if not keep_trace:
            shutil.rmtree(trace_dir, ignore_errors=True)


# --------------------------------------------------------------------- CLI

def main(argv: Optional[List[str]] = None) -> int:
    """The port's ``tools/attribute_step.py``: the same flags, on
    ``--device`` (the card unless asked otherwise)."""
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    ap = argparse.ArgumentParser(
        prog="python -m ai_agent_kubectl_tpu_torch.obs.attribution")
    ap.add_argument("--model", default="gemma-7b-it")
    ap.add_argument("--quant", default="int8",
                    choices=["", "int8", "int4"])
    ap.add_argument("--kv-quant", default="", choices=["", "int8"])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--bs", type=int, default=48)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=192)
    ap.add_argument("--reps", type=int, default=6,
                    help="traced chunk executions (steps = reps x chunk)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None,
                    help="write the JSON artifact here")
    ap.add_argument("--keep-trace", action="store_true",
                    help="keep the raw profiler trace dir (path in JSON)")
    ap.add_argument("--require-coverage", type=float, default=None,
                    help="exit 1 unless coverage_pct >= this")
    ap.add_argument("--dryrun", action="store_true",
                    help="toy model on the CPU: trace + parse + schema, "
                         "not coverage")
    ap.add_argument("--check", default=None, metavar="FILE",
                    help="validate an existing artifact and exit")
    args = ap.parse_args(argv)

    if args.check:
        with open(args.check) as f:
            obj = json.load(f)
        validate_attribution(obj)
        log(f"attribution: {args.check} is a valid {obj['schema']} "
            f"artifact (coverage {obj['coverage_pct']:.1f}%)")
        return 0
    if args.dryrun:
        args.model, args.quant, args.kv_quant = "toy-8m", "", ""
        args.dtype, args.device = "float32", "cpu"
        args.bs, args.chunk, args.max_seq, args.reps = 2, 4, 64, 2

    out = run_attribution(
        model=args.model, quant=args.quant, kv_quant=args.kv_quant,
        dtype=args.dtype, batch_size=args.bs, chunk_len=args.chunk,
        max_seq=args.max_seq, reps=args.reps, device=args.device,
        keep_trace=args.keep_trace)
    log(f"attribution: {out['model']} on {out['backend']} bs={args.bs} "
        f"chunk={args.chunk} — step {out['step_ms']:.3f} ms (host wall "
        f"{out['wall_ms_per_step_host']:.3f}), {out['n_device_spans']} "
        f"spans ({out['span_source']}), coverage "
        f"{out['coverage_pct']:.1f}%")
    log(render_markdown(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        log(f"attribution: artifact -> {args.out}")
    print(json.dumps(out), flush=True)
    if (args.require_coverage is not None
            and out["coverage_pct"] < args.require_coverage):
        log(f"attribution: coverage {out['coverage_pct']:.1f}% below the "
            f"required {args.require_coverage:.0f}%")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
