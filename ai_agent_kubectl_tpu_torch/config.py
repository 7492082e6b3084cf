"""Typed environment-variable configuration for the port.

The knobs the port reads, under the JAX package's environment variable
names and with its defaults and validation, plus ``TORCH_DEVICE`` — the
counterpart of ``JAX_PLATFORMS``: the server runs on ``cuda`` unless it
is set to ``cpu``. Every other knob of the JAX package names a feature
the port does not serve yet: it would be listed in ``UNSERVED_KNOBS``
(empty now: every knob is served) and refused at boot when set to
anything but the value the port serves, so a deployment never silently
gets less than it asked for. ``ENGINE``
takes the port's engines (``torch``, ``torch-batched``), the remote
``openai`` engine and the rule-table ``fake`` engine (no model, no
device); the JAX package's ``jax`` and ``jax-batched`` engines are
refused by name.
``from_env`` first reads a ``.env`` file in the working directory
(``load_env_file``, the JAX package's loader and rules): the process
environment wins over the file, and a knob set only in the file is read
and refused as one set in the environment.
``COMPILE_CACHE_DIR`` has no counterpart: nothing compiles in eager
PyTorch, so the knob is not read.

The telemetry plane is served: the goodput ledger (``LEDGER_ENABLE``),
the SLO burn rates (``SLO_*``), the step-time sentinel
(``SENTINEL_*``, ``PERF_BASELINES``), incident capture
(``INCIDENT_*``), the ``/debug/*`` token (``DEBUG_TOKEN``) and JSON
logs (``LOG_FORMAT``), all with the JAX defaults (the ledger and the
sentinel on). So is containment: the scheduler watchdog
(``ENGINE_WATCHDOG_SECS``, ``ENGINE_STARTUP_GRACE_SECS``), the
per-request replay budget (``QUARANTINE_RETRY_BUDGET``), the reset rate
limit (``ENGINE_RESET_MAX_PER_MIN``) and the fault drills
(``FAULT_POINTS``, parsed by ``server/factory.py``), and the remote
engine's ``OPENAI_API_KEY``, ``OPENAI_MODEL`` and ``OPENAI_BASE_URL``,
all with the JAX defaults. Grammar-constrained decoding
(``GRAMMAR_DECODE``, ``GRAMMAR_PROFILE``, ``GRAMMAR_FORCED_RUN_MIN``)
is read with the JAX errors and the boot-time safety cross-check. It
lives in the continuous-batching engine only: where the JAX
single-sequence engine ignores ``GRAMMAR_DECODE=true``, the port
refuses it at boot for an engine that would not enforce it (the
single-sequence engine at ``DECODE_BATCH_SIZE=1``, or ``ENGINE=openai``).
Speculative decoding (``SPEC_DECODE``, ``SPEC_DRAFT_K``,
``SPEC_DRAFT_MODEL``, ``SPEC_DRAFT_PATH``) is read with the JAX
defaults and errors, and refused likewise where no engine would run it:
the single-sequence engine, ``ENGINE=openai``, and ``KV_POOL=false``
(where the JAX batcher logs a warning and serves plain decode). The
two-tier host KV (``HOST_KV_BLOCKS``) is read with the JAX errors (it
needs ``KV_POOL=true`` and ``RADIX_CACHE=true``), and refused likewise
where no engine would serve it (the single-sequence engine and
``ENGINE=openai``). The engine fleet (``FLEET_SIZE``, ``FLEET_HEDGE_MS``,
``FLEET_AFFINITY``, ``FLEET_MIGRATION_BUDGET``, ``FLEET_REJOIN_SECS``)
and the weight rollout (``ROLLOUT_CANARY_SHARE``,
``ROLLOUT_OBSERVE_SECS``, ``ROLLOUT_BURN_GATE``,
``ROLLOUT_STEPTIME_GATE``) are read with the JAX defaults and errors;
``server/factory.py`` refuses ``FLEET_SIZE`` > 1 with ``ENGINE=openai``,
as the JAX factory does. The decode chunk pipeline
(``CHUNK_PIPE_DEPTH``, default 3: chunks dispatched ahead of the one the
host reads) and device-side termination (``DEVICE_TERMINATION``,
default true; false serves the host-scan path) are read with the JAX
defaults and errors: ``GRAMMAR_DECODE`` and ``SPEC_DECODE`` need device
termination, and the batched engine refuses a depth below 1. Group
admission's scratch budget (``ADMIT_SCRATCH_MB``, default 512, 0 =
uncapped) is read with the JAX parsing; it caps the group sizes of the
batched engine on the dense KV ladder (``KV_POOL=false``), and the pool
has no scratch to cap. ``MESH_SHAPE`` serves every axis (dp/ep/pp/sp/tp;
the engines check a pipe axis against the layers). The DCN and
distributed knobs (``DCN_MESH_SHAPE``, ``DISTRIBUTED_INIT``,
``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``) are read with
the JAX defaults and parsing, and ``SPEC_DECODE``'s refusal counts the
DCN spec's data/pipe/seq axes as the JAX one does. On a mesh that spans
processes (a DCN spec over more than one device) what rank 0 cannot
mirror to the other processes is refused at boot, each naming its
ROADMAP.md row: the host KV tier (A12 row 2) and a fleet (A12 row 3);
so is an engine without a mesh (``ENGINE=openai|fake``) when
``NUM_PROCESSES`` > 1. A seq axis across processes (A12 row 1) is
served: its ring prefill crosses them.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Optional, Tuple

from .engine.kv_pool import check_host_tier
from .engine.qos import LANES, parse_lane_weights, parse_tenant_tiers
from .obs.slo import parse_slo_windows
from .obs.steptime import load_baselines


#: JAX-package knobs whose features wait for a later slice, each with
#: the value the port serves (its "off" default): none since the DCN and
#: distributed knobs are served.
UNSERVED_KNOBS: dict = {}


#: ``parallel/mesh.py::MeshConfig.parse``'s alias map, for validation.
_MESH_AXIS_ALIASES = {
    "dp": "data", "data": "data",
    "ep": "expert", "expert": "expert",
    "pp": "pipe", "pipe": "pipe",
    "sp": "seq", "seq": "seq",
    "tp": "model", "model": "model",
}


def _mesh_size(spec: str) -> int:
    """The device count of a mesh spec (unknown names or sizes are the
    engine's error and count 1 here)."""
    n = 1
    for part in filter(None, (p.strip() for p in (spec or "").split(","))):
        _, _, val = part.replace(":", "=").partition("=")
        n *= int(val) if val.strip().isdigit() else 1
    return n


def _mesh_axes_over_one(spec: str) -> set:
    """Canonical names of the >1 axes a MESH_SHAPE spec asks for;
    unknown names are the engine's error and are ignored here."""
    out = set()
    for part in filter(None, (p.strip() for p in (spec or "").split(","))):
        name, _, val = part.replace(":", "=").partition("=")
        canon = _MESH_AXIS_ALIASES.get(name.strip().lower())
        try:
            size = int(val)
        except ValueError:
            continue
        if canon is not None and size > 1:
            out.add(canon)
    return out


#: The JAX package's engines that the port does not serve, and why.
UNSERVED_ENGINES = {
    "jax": "the JAX package's engine: the port serves ENGINE=torch",
    "jax-batched": "the JAX package's engine: the port serves "
                   "ENGINE=torch-batched",
}

_BOOL_WORDS = {"1": True, "true": True, "yes": True, "on": True,
               "0": False, "false": False, "no": False, "off": False}


def _same_value(raw: str, served: str) -> bool:
    """Whether an environment value asks for what the port serves: the
    same word, number or boolean as ``served`` (case and spelling
    aside)."""
    val = raw.strip().lower()
    if val == served:
        return True
    if served in _BOOL_WORDS:
        return _BOOL_WORDS.get(val) is _BOOL_WORDS[served]
    try:
        return float(val) == float(served)
    except ValueError:
        return False


def load_env_file(path: str | os.PathLike = ".env", *,
                  override: bool = False) -> dict:
    """Parse a ``.env`` file into ``os.environ`` and return what it
    parsed, as the JAX package's loader does: lines of ``KEY=VALUE``,
    ``#`` comments, an optional ``export`` prefix, one pair of matching
    quotes stripped, and an inline `` #`` comment cut from an unquoted
    value. A missing file is not an error. A variable already in the
    process environment wins unless ``override``."""
    parsed: dict[str, str] = {}
    p = Path(path)
    if not p.is_file():
        return parsed
    for raw in p.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("export "):
            line = line[len("export "):].lstrip()
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip()
        if (len(value) >= 2 and value[0] == value[-1]
                and value[0] in ("'", '"')):
            value = value[1:-1]
        else:
            value = value.split(" #", 1)[0].rstrip()
        if not key:
            continue
        parsed[key] = value
        if override or key not in os.environ:
            os.environ[key] = value
    return parsed


_RATE_RE = re.compile(
    r"^\s*(\d+)\s*(?:/|\s+per\s+)\s*(\d*)\s*(second|minute|hour|day)s?\s*$",
    re.IGNORECASE,
)

_PERIOD_SECONDS = {"second": 1, "minute": 60, "hour": 3600, "day": 86400}


def parse_rate_limit(spec: str) -> Tuple[int, float]:
    """Parse a slowapi-style rate string ("10/minute", "5 per 30 second")
    into (count, window_seconds), as the JAX package does."""
    m = _RATE_RE.match(spec)
    if not m:
        raise ValueError(f"Invalid rate limit spec: {spec!r}")
    count = int(m.group(1))
    multiple = int(m.group(2)) if m.group(2) else 1
    window = multiple * _PERIOD_SECONDS[m.group(3).lower()]
    return count, float(window)


def _env_str(name: str, default: Optional[str]) -> Optional[str]:
    v = os.getenv(name)
    return v if v not in (None, "") else default


def _env_int(name: str, default: int) -> int:
    v = os.getenv(name)
    return int(v) if v not in (None, "") else default


def _env_float(name: str, default: float) -> float:
    v = os.getenv(name)
    return float(v) if v not in (None, "") else default


def _env_bool(name: str, default: bool) -> bool:
    v = os.getenv(name)
    if v in (None, ""):
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclass(frozen=True)
class ServiceConfig:
    """What the port's server and engine read."""

    api_auth_key: Optional[str] = None      # API_AUTH_KEY; auth off if unset
    cache_maxsize: int = 100                # CACHE_MAXSIZE
    cache_ttl: float = 300.0                # CACHE_TTL seconds
    llm_timeout: float = 60.0               # LLM_TIMEOUT seconds
    execution_timeout: float = 30.0         # EXECUTION_TIMEOUT seconds
    rate_limit: str = "10/minute"           # RATE_LIMIT
    log_level: str = "INFO"                 # LOG_LEVEL
    # Log line format: "text" keeps the human format; "json" emits one
    # JSON object per line, stamped with the request ID, hashed tenant,
    # lane and open incident (logging_setup.py).
    log_format: str = "text"                # LOG_FORMAT: text | json
    host: str = "0.0.0.0"                   # HOST
    port: int = 8000                        # PORT
    # Key the rate limit by the leftmost X-Forwarded-For hop (behind a
    # fronting router tier); off, the peer address keys it.
    trust_proxy_headers: bool = False       # TRUST_PROXY_HEADERS

    # ENGINE: torch | torch-batched | openai | fake. "torch" serves
    # through the continuous-batching scheduler when DECODE_BATCH_SIZE >
    # 1; "openai" calls an OpenAI-compatible ChatCompletions endpoint;
    # "fake" answers from the rule table (engine/fake.py, no model).
    engine: str = "torch"
    torch_device: str = "cuda"              # TORCH_DEVICE: cuda | cpu
    # Serving on a mesh: "dp=2,ep=2,tp=2" style (or "data:2,..."), every
    # axis (dp/ep/pp/sp/tp), multiplied across processes by the DCN spec.
    mesh_shape: str = ""                    # MESH_SHAPE
    dcn_mesh_shape: str = ""                # DCN_MESH_SHAPE (across processes)
    distributed_init: bool = False          # DISTRIBUTED_INIT
    coordinator_address: Optional[str] = None   # COORDINATOR_ADDRESS
    num_processes: int = 1                  # NUM_PROCESSES
    process_id: int = 0                     # PROCESS_ID
    model_name: str = "toy-8m"              # MODEL_NAME (registry key)
    model_path: Optional[str] = None        # MODEL_PATH (HF safetensors)
    tokenizer_path: Optional[str] = None    # TOKENIZER_PATH
    dtype: str = "bfloat16"                 # DTYPE
    quant: str = ""                         # QUANT: "" | int8 | int4
    # int8 KV cache (ops/quant.py::QuantKV): 132 bytes a (position, head)
    # at head_dim 128 against 256 in bf16, in both engines and every
    # regime; no kernel reads it, so the pool serves the gather path and
    # the dense ladder the dense read, flash prefill resolving to dense.
    kv_quant: str = ""                      # KV_QUANT: "" | int8
    max_seq_len: int = 1024                 # MAX_SEQ_LEN
    max_new_tokens: int = 128               # MAX_NEW_TOKENS
    decode_batch_size: int = 8              # DECODE_BATCH_SIZE
    chunk_len: int = 16                     # CHUNK_LEN
    # Decode chunks kept in flight ahead of the one the host reads: the
    # host dispatches chunk N+1 (and N+2) before it reads chunk N's
    # packed buffer, so its reads and its next dispatch overlap the
    # device's work. With device-side termination a deeper pipe wastes
    # no step on a finished slot; 2 suits DEVICE_TERMINATION=false.
    chunk_pipe_depth: int = 3               # CHUNK_PIPE_DEPTH
    # Device-side termination: the chunk folds EOS and each slot's token
    # budget into its carry and freezes finished slots mid-chunk; false
    # restores the host-scan path (every dispatched slot decodes the
    # whole chunk, the host scans for EOS and the budget, and
    # wasted_decode_steps_total shows what the device mask saves).
    device_termination: bool = True         # DEVICE_TERMINATION
    # Group admission's scratch budget (MB) on the dense KV ladder: a
    # burst of prefix hits sharing one suffix shape prefills as one
    # group of kpad rows, and the kpads whose suffix-depth scratch
    # exceeds it are dropped per depth (0 = uncapped).
    admit_scratch_mb: int = 512             # ADMIT_SCRATCH_MB
    prefill_buckets: str = "64,128,256,512,1024"  # PREFILL_BUCKETS
    temperature: float = 0.0                # TEMPERATURE (0 = greedy)
    top_k: int = 0                          # TOP_K
    top_p: float = 1.0                      # TOP_P
    # Prefill attention of the single-sequence engine: auto = flash on
    # cuda, dense on the CPU.
    attn_impl: str = "auto"                 # ATTN_IMPL: auto | dense | flash
    # The MoE MLP: dense evaluates every expert and mixes by the router's
    # top-k weights (parallel/moe.py::dense_moe); ep always serves the
    # expert-parallel dispatch (a one-device expert mesh on one card);
    # auto serves it on an expert mesh, else dense.
    moe_impl: str = "auto"                  # MOE_IMPL: auto | ep | dense
    # Decode attention of the batched engine: auto = paged for a GQA model
    # on cuda (the page raised to >= 64), dense otherwise.
    decode_attn: str = "auto"               # DECODE_ATTN: auto | dense | paged
    kv_page_size: int = 16                  # KV_PAGE_SIZE (dense KV ladder)
    # Ragged attention over the pool: auto = on in this port (the JAX
    # package turns it on only on its accelerator); off = the legacy
    # prefill ladder and the DECODE_ATTN decode over the pool.
    ragged_attention: str = "auto"          # RAGGED_ATTENTION: auto | on | off
    kv_pool: bool = True                    # KV_POOL (false = dense KV ladder)
    kv_pool_page: int = 16                  # KV_POOL_PAGE
    kv_pool_blocks: int = 0                 # KV_POOL_BLOCKS (0 = auto)
    radix_cache: bool = True                # RADIX_CACHE
    radix_lru_blocks: int = 0               # RADIX_LRU_BLOCKS (0 = auto)
    # The host-RAM second KV tier behind the radix tree (blocks): pool
    # pressure demotes cold cached pages there (CRC32-stamped) instead of
    # dropping them, and a returning match onloads them back, checksum
    # verified. 0 disables it.
    host_kv_blocks: int = 0                 # HOST_KV_BLOCKS
    hbm_prefix_cache: bool = True           # HBM_PREFIX_CACHE
    max_queue_depth: int = 64               # MAX_QUEUE_DEPTH
    # Generation requests in flight at the HTTP layer; beyond it a fast
    # 503 with Retry-After (<= 0: unlimited).
    max_inflight_requests: int = 256        # MAX_INFLIGHT_REQUESTS
    # Serve rule-based answers (degraded: true, HTTP 200) instead of 503
    # while the engine fails or the breaker is open.
    degraded_fallback: bool = False         # DEGRADED_FALLBACK
    # Circuit breaker around the engine: opens after this many engine
    # failures within breaker_window_secs (0 disables); after
    # breaker_recovery_secs one half-open probe re-closes it on success.
    breaker_threshold: int = 5              # BREAKER_THRESHOLD
    breaker_window_secs: float = 30.0       # BREAKER_WINDOW_SECS
    breaker_recovery_secs: float = 15.0     # BREAKER_RECOVERY_SECS
    slot_health_check: bool = True          # SLOT_HEALTH_CHECK
    # Blast-radius containment (engine/containment.py): how many times
    # one request may be solo-implicated in a poisoned step (health bit,
    # or isolated by bisection) and still be replayed; past it HTTP 410.
    # 0 = quarantine on the first trip.
    quarantine_retry_budget: int = 1        # QUARANTINE_RETRY_BUDGET
    # Engine resets per rolling minute; past it the engine fails the
    # affected requests fast and their errors feed the breaker
    # (0 = unlimited).
    engine_reset_max_per_min: int = 12      # ENGINE_RESET_MAX_PER_MIN
    # Scheduler watchdog: no scheduler progress for this long with work
    # in flight marks the engine degraded and fails every waiting
    # request (0 disables). Until the first chunk is consumed, and while
    # an admission runs, the limit widens to the startup grace.
    engine_watchdog_secs: float = 120.0     # ENGINE_WATCHDOG_SECS
    engine_startup_grace_secs: float = 900.0  # ENGINE_STARTUP_GRACE_SECS
    # Fault drills (testing/faults.py): "decode:nan:<p>",
    # "decode:poison_step", "scheduler:die", "chunk:hang",
    # "admit:error:<p>", "tenant:flood:<n>", "generate:<mode>". Empty
    # disables.
    fault_points: str = ""                  # FAULT_POINTS
    # The remote engine (ENGINE=openai): the key, the model and the
    # endpoint (unset = https://api.openai.com/v1).
    openai_api_key: Optional[str] = None    # OPENAI_API_KEY
    openai_model: str = "gpt-3.5-turbo"     # OPENAI_MODEL
    openai_base_url: Optional[str] = None   # OPENAI_BASE_URL
    # Grammar-constrained decoding (constrain/): the kubectl grammar
    # compiled against the tokenizer into a token FSM, illegal logits
    # masked on the device (unsafe commands cannot be produced), forced
    # runs spliced as one prefill. The batched engine only; off by
    # default. The base profile: default (read-only and mutating verbs),
    # readonly (what a background-tier tenant is clamped to), or
    # permissive (the plumbing on, the language unconstrained). The
    # shortest forced run worth a splice.
    grammar_decode: bool = False            # GRAMMAR_DECODE
    grammar_profile: str = "default"        # GRAMMAR_PROFILE
    grammar_forced_run_min: int = 4         # GRAMMAR_FORCED_RUN_MIN
    # Speculative decoding (engine/batcher.py): a draft model proposes
    # SPEC_DRAFT_K tokens a verify iteration and ONE target forward over
    # the k + 1-token window verifies them by exact match against the
    # target's own seeded draw, so transcripts equal SPEC_DECODE=false
    # at any k. The continuous-batching engine over the KV pool only.
    # The draft shares the target's vocabulary; SPEC_DRAFT_PATH is its
    # checkpoint (unset: random init, toy/dev mode only).
    spec_decode: bool = False               # SPEC_DECODE
    spec_draft_k: int = 4                   # SPEC_DRAFT_K
    spec_draft_model: str = "gemma-2b-it"   # SPEC_DRAFT_MODEL
    spec_draft_path: Optional[str] = None   # SPEC_DRAFT_PATH
    # The engine fleet (engine/fleet.py): N engine replicas behind one
    # facade with health-aware routing, cross-replica migration (seeded
    # replay keeps a migrated transcript byte-identical), zero-downtime
    # drains and hedged re-dispatch; 1 = one engine, no fleet layer. A
    # replica that gives no event within FLEET_HEDGE_MS is raced by a
    # second one (0 disables); affinity keeps multi-turn agent loops on
    # the replica holding their prefix; a request migrates at most
    # FLEET_MIGRATION_BUDGET times; an ejected replica restarts after
    # FLEET_REJOIN_SECS (0 = manual rejoin only).
    fleet_size: int = 1                     # FLEET_SIZE
    fleet_hedge_ms: float = 0.0             # FLEET_HEDGE_MS
    fleet_affinity: bool = True             # FLEET_AFFINITY
    fleet_migration_budget: int = 3         # FLEET_MIGRATION_BUDGET
    fleet_rejoin_secs: float = 0.0          # FLEET_REJOIN_SECS
    # Zero-downtime weight rollout (engine/rollout.py, /admin/rollout):
    # the share of fresh traffic steered at the canary, in (0, 0.5]; how
    # long the canary serves it before the promotion gate's verdict; the
    # canary rolls back when its fast-window burn reaches BURN_GATE x
    # max(1, the stable cohort's burn), or (STEPTIME_GATE >= 1; 0 = off)
    # when its decode p95 reaches that multiple of the stable cohort's.
    rollout_canary_share: float = 0.1       # ROLLOUT_CANARY_SHARE
    rollout_observe_secs: float = 60.0      # ROLLOUT_OBSERVE_SECS
    rollout_burn_gate: float = 2.0          # ROLLOUT_BURN_GATE
    rollout_steptime_gate: float = 0.0      # ROLLOUT_STEPTIME_GATE

    # QoS ring (engine/qos.py), as in the JAX package. TENANT_TIERS maps
    # a tenant key (a registered API key, else the client IP) to the
    # highest lane it may claim (interactive | batch | background);
    # X-Priority can lower a request below its tier, never raise it.
    tenant_tiers: str = ""                  # TENANT_TIERS
    qos_default_lane: str = "interactive"   # QOS_DEFAULT_LANE
    # WDRR lane weights: requests per lane in one saturated round.
    lane_weights: str = ""                  # LANE_WEIGHTS
    # Per-tenant in-queue cap: past it a fast 429 (0 = no cap below
    # MAX_QUEUE_DEPTH).
    tenant_max_queue: int = 0               # TENANT_MAX_QUEUE
    # Delivered completion tokens after which a session's (X-Session-ID)
    # later requests run in the background lane (0 disables).
    qos_session_token_budget: int = 0       # QOS_SESSION_TOKEN_BUDGET
    # A higher-lane request queued this long with every slot busy
    # preempts the cheapest lower-lane slot (0 disables preemption).
    preempt_wait_ms: float = 500.0          # PREEMPT_WAIT_MS
    # Preemptions one request may take before it is never picked again.
    preempt_budget: int = 2                 # PREEMPT_BUDGET
    # Interactive queue-wait p95 target of the brownout controller (0
    # disables it).
    slo_interactive_ms: float = 2000.0      # SLO_INTERACTIVE_MS
    flight_recorder_size: int = 256         # FLIGHT_RECORDER_SIZE
    # Goodput ledger (obs/ledger.py): every device decode step billed
    # delivered or to a waste class, per lane (metrics) and per hashed
    # tenant (/debug/ledger only); false disables the accounting.
    ledger_enable: bool = True              # LEDGER_ENABLE
    # SLO burn-rate engine (obs/slo.py): the TTFT target (0 disables it;
    # queue-wait burn runs off SLO_INTERACTIVE_MS), the turn-N TTFT of
    # radix-warm session re-admissions (0 disables), the windows
    # (seconds, ascending, at most 4) and the objective.
    slo_ttft_ms: float = 5000.0             # SLO_TTFT_MS
    slo_session_ttft_ms: float = 0.0        # SLO_SESSION_TTFT_MS
    slo_windows: str = "300,3600"           # SLO_WINDOWS
    slo_objective: float = 0.99             # SLO_OBJECTIVE
    # Step-time sentinel (obs/steptime.py): a baseline envelope file
    # (JSON step_time_ms table; empty = every digest self-calibrates),
    # the switch, the per-digest window, the breach factor, the samples
    # a digest needs, and the incident watcher's period (0 = evaluate at
    # scrapes and /debug/incidents reads only).
    perf_baselines: str = ""                # PERF_BASELINES
    sentinel_enable: bool = True            # SENTINEL_ENABLE
    sentinel_window: int = 256              # SENTINEL_WINDOW
    sentinel_factor: float = 2.0            # SENTINEL_FACTOR
    sentinel_min_samples: int = 16          # SENTINEL_MIN_SAMPLES
    sentinel_eval_secs: float = 2.0         # SENTINEL_EVAL_SECS
    # Incident capture (obs/incidents.py): the ring, the per-trigger
    # cooldown, the fast-burn threshold (0 disables), a torch.profiler
    # capture attached to each new bundle (seconds; 0 = off), and the
    # host-tier thrash sensitivity (0 disables).
    incident_ring: int = 8                  # INCIDENT_RING
    incident_cooldown_secs: float = 60.0    # INCIDENT_COOLDOWN_SECS
    incident_burn_threshold: float = 2.0    # INCIDENT_BURN_THRESHOLD
    incident_profile_secs: float = 0.0      # INCIDENT_PROFILE_SECS
    incident_thrash_min_blocks: int = 8     # INCIDENT_THRASH_MIN_BLOCKS
    # /debug/* additionally requires a matching X-Debug-Token when set.
    debug_token: Optional[str] = None       # DEBUG_TOKEN
    drain_timeout_secs: float = 10.0        # DRAIN_TIMEOUT_SECS

    # Parsed from rate_limit.
    rate_limit_count: int = field(init=False, default=10)
    rate_limit_window: float = field(init=False, default=60.0)

    def __post_init__(self):
        count, window = parse_rate_limit(self.rate_limit)
        object.__setattr__(self, "rate_limit_count", count)
        object.__setattr__(self, "rate_limit_window", window)
        if self.engine in UNSERVED_ENGINES:
            raise ValueError(
                f"ENGINE={self.engine} ({UNSERVED_ENGINES[self.engine]}) "
                f"is not served by the PyTorch port")
        if self.engine not in ("torch", "torch-batched", "openai", "fake"):
            raise ValueError(f"ENGINE must be torch|torch-batched|openai|"
                             f"fake, got {self.engine!r}")
        if self.torch_device not in ("cuda", "cpu"):
            raise ValueError(f"TORCH_DEVICE must be cuda|cpu, got "
                             f"{self.torch_device!r}")
        if self.quant not in ("", "int8", "int4"):
            raise ValueError(f"QUANT must be ''|int8|int4, got "
                             f"{self.quant!r}")
        if self.kv_quant not in ("", "int8"):
            raise ValueError(f"KV_QUANT must be '' or 'int8', got "
                             f"{self.kv_quant!r}")
        if self.attn_impl not in ("auto", "dense", "flash"):
            raise ValueError(f"ATTN_IMPL must be auto|dense|flash, got "
                             f"{self.attn_impl!r}")
        if self.moe_impl not in ("auto", "ep", "dense"):
            raise ValueError(f"MOE_IMPL must be auto|ep|dense, got "
                             f"{self.moe_impl!r}")
        if self.decode_attn not in ("auto", "dense", "paged"):
            raise ValueError(f"DECODE_ATTN must be auto|dense|paged, got "
                             f"{self.decode_attn!r}")
        if self.kv_page_size < 1:
            raise ValueError(f"KV_PAGE_SIZE must be >= 1, got "
                             f"{self.kv_page_size}")
        if self.ragged_attention not in ("auto", "on", "off"):
            raise ValueError(f"RAGGED_ATTENTION must be auto|on|off, got "
                             f"{self.ragged_attention!r}")
        if self.ragged_attention == "on" and not self.kv_pool:
            raise ValueError(
                "RAGGED_ATTENTION=on requires KV_POOL=true (the ragged "
                "kernel reads per-slot block tables over the shared pool; "
                "the dense ladder has no ragged variant)")
        if self.kv_pool_page < 1 or 128 % self.kv_pool_page:
            raise ValueError(
                f"KV_POOL_PAGE must divide the 128-token tile "
                f"(8|16|32|64|128), got {self.kv_pool_page}")
        if self.kv_pool_blocks < 0 or self.radix_lru_blocks < 0:
            raise ValueError("KV_POOL_BLOCKS and RADIX_LRU_BLOCKS must be "
                             ">= 0 (0 = auto)")
        check_host_tier(self.host_kv_blocks, self.kv_pool, self.radix_cache)
        if self.decode_batch_size < 1 or self.chunk_len < 1:
            raise ValueError("DECODE_BATCH_SIZE and CHUNK_LEN must be >= 1")
        if self.top_k < 0 or not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"TOP_K must be >= 0 and TOP_P in (0, 1], got "
                             f"{self.top_k}/{self.top_p}")
        # A typo'd tier or weight refuses to boot, with the JAX messages.
        self.tenant_tier_map
        self.lane_weight_map
        if self.qos_session_token_budget < 0:
            raise ValueError(
                f"QOS_SESSION_TOKEN_BUDGET must be >= 0 (0 disables), "
                f"got {self.qos_session_token_budget}")
        # The telemetry knobs, with the JAX validation and messages.
        self.slo_window_list
        if not 0.0 < self.slo_objective < 1.0:
            raise ValueError(
                f"SLO_OBJECTIVE must be in (0, 1), got {self.slo_objective}")
        if self.slo_ttft_ms < 0:
            raise ValueError(
                f"SLO_TTFT_MS must be >= 0, got {self.slo_ttft_ms}")
        if self.sentinel_window < 8:
            raise ValueError(
                f"SENTINEL_WINDOW must be >= 8 samples, "
                f"got {self.sentinel_window}")
        if self.sentinel_factor < 1.0:
            raise ValueError(
                f"SENTINEL_FACTOR must be >= 1 (a factor below 1 would "
                f"trip on every healthy step), got {self.sentinel_factor}")
        if self.sentinel_min_samples < 1:
            raise ValueError(
                f"SENTINEL_MIN_SAMPLES must be >= 1, "
                f"got {self.sentinel_min_samples}")
        if self.sentinel_eval_secs < 0:
            raise ValueError(
                f"SENTINEL_EVAL_SECS must be >= 0 (0 = scrape-driven "
                f"only), got {self.sentinel_eval_secs}")
        if self.incident_ring < 1:
            raise ValueError(
                f"INCIDENT_RING must be >= 1, got {self.incident_ring}")
        if self.incident_cooldown_secs < 0:
            raise ValueError(
                f"INCIDENT_COOLDOWN_SECS must be >= 0, "
                f"got {self.incident_cooldown_secs}")
        if self.incident_burn_threshold < 0:
            raise ValueError(
                f"INCIDENT_BURN_THRESHOLD must be >= 0 (0 disables), "
                f"got {self.incident_burn_threshold}")
        if not 0.0 <= self.incident_profile_secs <= 30.0:
            raise ValueError(
                f"INCIDENT_PROFILE_SECS must be in [0, 30] (captures "
                f"are tens of MB each), got {self.incident_profile_secs}")
        if self.rollout_steptime_gate != 0.0 \
                and self.rollout_steptime_gate < 1.0:
            raise ValueError(
                f"ROLLOUT_STEPTIME_GATE must be 0 (off) or >= 1 (a "
                f"factor below 1 would roll back every healthy canary), "
                f"got {self.rollout_steptime_gate}")
        if self.perf_baselines:
            try:
                load_baselines(self.perf_baselines)
            except (OSError, ValueError, KeyError) as e:
                raise ValueError(
                    f"PERF_BASELINES {self.perf_baselines!r} failed to "
                    f"load: {e}") from e
        if self.slo_session_ttft_ms < 0:
            raise ValueError(
                f"SLO_SESSION_TTFT_MS must be >= 0 (0 disables), "
                f"got {self.slo_session_ttft_ms}")
        if self.incident_thrash_min_blocks < 0:
            raise ValueError(
                f"INCIDENT_THRASH_MIN_BLOCKS must be >= 0 (0 disables), "
                f"got {self.incident_thrash_min_blocks}")
        # The grammar knobs, with the JAX errors: a typo'd profile must
        # refuse to boot, not serve unconstrained output behind a knob
        # that says otherwise.
        from .constrain.runtime import PROFILES

        if self.grammar_profile not in PROFILES:
            raise ValueError(
                f"GRAMMAR_PROFILE must be one of {PROFILES}, "
                f"got {self.grammar_profile!r}")
        if self.grammar_forced_run_min < 1:
            raise ValueError(
                f"GRAMMAR_FORCED_RUN_MIN must be >= 1, "
                f"got {self.grammar_forced_run_min}")
        if self.grammar_decode and not self.device_termination:
            raise ValueError(
                "GRAMMAR_DECODE requires DEVICE_TERMINATION=true (the "
                "FSM state word rides the decode chunk's carry)")
        if self.grammar_decode and not self.batched_engine:
            raise ValueError(
                f"GRAMMAR_DECODE=true is enforced by the continuous-"
                f"batching engine only (ENGINE=torch with "
                f"DECODE_BATCH_SIZE>1, or ENGINE=torch-batched); "
                f"ENGINE={self.engine} with DECODE_BATCH_SIZE="
                f"{self.decode_batch_size} would serve unconstrained "
                f"output")
        if self.grammar_decode:
            # The boot-time cross-check: every safety-blocked verb is
            # absent from every profile.
            from .constrain import assert_safety_consistent

            assert_safety_consistent()
        # The weight-rollout knobs, with the JAX errors: a canary share
        # outside (0, 0.5] either disables the observe phase or lets the
        # canary starve the stable cohort.
        if not 0.0 < self.rollout_canary_share <= 0.5:
            raise ValueError(
                f"ROLLOUT_CANARY_SHARE must be in (0, 0.5] (the canary "
                f"may never take more fresh traffic than the stable "
                f"cohort), got {self.rollout_canary_share}")
        if self.rollout_observe_secs < 0:
            raise ValueError(
                f"ROLLOUT_OBSERVE_SECS must be >= 0, "
                f"got {self.rollout_observe_secs}")
        if self.rollout_burn_gate < 1.0:
            raise ValueError(
                f"ROLLOUT_BURN_GATE must be >= 1 (a factor below the "
                f"sustainable burn rate would roll back every healthy "
                f"canary), got {self.rollout_burn_gate}")
        # The speculative-decode knobs, with the JAX errors: an
        # impossible combination or an unknown or mismatched draft must
        # refuse to boot, not serve plain decode behind a knob that says
        # otherwise.
        if self.spec_decode:
            if not self.device_termination:
                raise ValueError(
                    "SPEC_DECODE requires DEVICE_TERMINATION=true (the "
                    "accept/reject fold rides the decode chunk's carry)")
            from .models.config import get_config as _get_model_config
            from .models.config import spec_draft_config

            try:
                target = _get_model_config(self.model_name)
            except KeyError:
                target = None   # MODEL_NAME errors are the engine's job
            spec_draft_config(self.spec_draft_k, self.spec_draft_model,
                              target, self.kv_pool)
            if not self.batched_engine:
                raise ValueError(
                    f"SPEC_DECODE=true is served by the continuous-"
                    f"batching engine only (ENGINE=torch with "
                    f"DECODE_BATCH_SIZE>1, or ENGINE=torch-batched); "
                    f"ENGINE={self.engine} with DECODE_BATCH_SIZE="
                    f"{self.decode_batch_size} would serve plain decode")
            # The draft world shards over tp/ep; the pool the spec chunk
            # needs never splits over data (nor pipe/seq), as in JAX:
            # the DCN spec's axes count too.
            bad = sorted((_mesh_axes_over_one(self.mesh_shape)
                          | _mesh_axes_over_one(self.dcn_mesh_shape))
                         & {"data", "pipe", "seq"})
            if bad:
                raise ValueError(
                    f"SPEC_DECODE does not compose with a mesh that has "
                    f"a >1 {'/'.join(bad)} axis (MESH_SHAPE="
                    f"{self.mesh_shape!r} DCN_MESH_SHAPE="
                    f"{self.dcn_mesh_shape!r}): the spec KV pool's "
                    f"blocks and the draft verify window shard over "
                    f"tp/ep only — use a tensor/expert-parallel mesh or "
                    f"disable one of them")
        # Only the continuous-batching engine has the radix tree the host
        # tier hangs off (the JAX single-sequence engine ignores the knob).
        if self.host_kv_blocks > 0 and not self.batched_engine:
            raise ValueError(
                f"HOST_KV_BLOCKS={self.host_kv_blocks} is served by the "
                f"continuous-batching engine only (ENGINE=torch with "
                f"DECODE_BATCH_SIZE>1, or ENGINE=torch-batched); "
                f"ENGINE={self.engine} with DECODE_BATCH_SIZE="
                f"{self.decode_batch_size} has no radix tree to demote from")
        self._check_processes()

    def _check_processes(self) -> None:
        """The refusals of a mesh that spans processes: what rank 0
        cannot mirror to the other processes' shards, each naming its
        ROADMAP.md row."""
        if self.num_processes > 1 and self.engine not in ("torch",
                                                          "torch-batched"):
            raise ValueError(
                f"NUM_PROCESSES={self.num_processes} serves one mesh over "
                f"the processes; ENGINE={self.engine} has no mesh (use "
                f"ENGINE=torch or torch-batched)")
        if _mesh_size(self.dcn_mesh_shape) <= 1:
            return
        if self.host_kv_blocks > 0:
            raise ValueError(
                f"HOST_KV_BLOCKS={self.host_kv_blocks} with DCN_MESH_SHAPE="
                f"{self.dcn_mesh_shape!r} is not served (ROADMAP.md A12 row "
                f"2): a demote reads every shard's block, and another "
                f"process's shards are not rank 0's to read")
        if self.fleet_size > 1:
            raise ValueError(
                f"FLEET_SIZE={self.fleet_size} with DCN_MESH_SHAPE="
                f"{self.dcn_mesh_shape!r} is not served (ROADMAP.md A12 row "
                f"3): each replica would need a follower stream of its own "
                f"in every process")

    @property
    def batched_engine(self) -> bool:
        """Whether the factory builds the continuous-batching engine:
        ``ENGINE=torch-batched``, or ``torch`` at ``DECODE_BATCH_SIZE`` >
        1 (the JAX factory's rule)."""
        return self.engine == "torch-batched" or (
            self.engine == "torch" and self.decode_batch_size > 1)

    @property
    def slo_window_list(self) -> Tuple[int, ...]:
        return parse_slo_windows(self.slo_windows)

    def describe(self) -> dict:
        """Loggable, secret-free view of the config (the incident
        bundles' config fingerprint hashes it)."""
        d = {f.name: getattr(self, f.name) for f in fields(self) if f.init}
        for secret in ("api_auth_key", "openai_api_key", "debug_token"):
            if d.get(secret):
                d[secret] = "***"
        if d.get("tenant_tiers"):
            # Tenant keys are API keys; log only the lane assignments.
            d["tenant_tiers"] = ",".join(
                f"***:{lane}" for lane in self.tenant_tier_map.values())
        return d

    @property
    def auth_enabled(self) -> bool:
        return bool(self.api_auth_key)

    @property
    def tenant_tier_map(self) -> dict:
        if self.qos_default_lane not in LANES:
            raise ValueError(
                f"QOS_DEFAULT_LANE must be one of {LANES}, "
                f"got {self.qos_default_lane!r}")
        return parse_tenant_tiers(self.tenant_tiers)

    @property
    def lane_weight_map(self) -> dict:
        return parse_lane_weights(self.lane_weights)

    @property
    def prefill_bucket_list(self) -> Tuple[int, ...]:
        return tuple(sorted(int(b) for b in self.prefill_buckets.split(",")
                            if b.strip()))

    @classmethod
    def from_env(cls, env_file: str | os.PathLike | None = ".env"
                 ) -> "ServiceConfig":
        """The knobs of the process environment, after ``env_file``
        (``None`` reads no file) has filled in those it does not set:
        a knob set only in the file is read, or refused, as one set in
        the environment."""
        if env_file is not None:
            load_env_file(env_file)
        for name, served in UNSERVED_KNOBS.items():
            raw = os.getenv(name)
            if raw not in (None, "") and not _same_value(raw, served):
                raise ValueError(f"{name}={raw!r} is not served by the "
                                 f"PyTorch port yet")
        moe_impl = (_env_str("MOE_IMPL", "auto") or "auto").lower()
        return cls(
            api_auth_key=_env_str("API_AUTH_KEY", None),
            cache_maxsize=_env_int("CACHE_MAXSIZE", 100),
            cache_ttl=_env_float("CACHE_TTL", 300.0),
            llm_timeout=_env_float("LLM_TIMEOUT", 60.0),
            execution_timeout=_env_float("EXECUTION_TIMEOUT", 30.0),
            rate_limit=_env_str("RATE_LIMIT", "10/minute"),
            log_level=(_env_str("LOG_LEVEL", "INFO") or "INFO").upper(),
            log_format=(_env_str("LOG_FORMAT", "text") or "text").lower(),
            host=_env_str("HOST", "0.0.0.0"),
            port=_env_int("PORT", 8000),
            # TRUST_PROXY is the short alias; TRUST_PROXY_HEADERS wins
            # when both are set.
            trust_proxy_headers=_env_bool(
                "TRUST_PROXY_HEADERS", _env_bool("TRUST_PROXY", False)),
            engine=(_env_str("ENGINE", "torch") or "torch").lower(),
            torch_device=(_env_str("TORCH_DEVICE", "cuda") or "cuda").lower(),
            model_name=_env_str("MODEL_NAME", "toy-8m"),
            model_path=_env_str("MODEL_PATH", None),
            tokenizer_path=_env_str("TOKENIZER_PATH", None),
            dtype=_env_str("DTYPE", "bfloat16"),
            quant=(_env_str("QUANT", "") or "").lower(),
            kv_quant=(_env_str("KV_QUANT", "") or "").lower(),
            max_seq_len=_env_int("MAX_SEQ_LEN", 1024),
            max_new_tokens=_env_int("MAX_NEW_TOKENS", 128),
            decode_batch_size=_env_int("DECODE_BATCH_SIZE", 8),
            chunk_len=_env_int("CHUNK_LEN", 16),
            chunk_pipe_depth=_env_int("CHUNK_PIPE_DEPTH", 3),
            admit_scratch_mb=_env_int("ADMIT_SCRATCH_MB", 512),
            device_termination=_env_bool("DEVICE_TERMINATION", True),
            prefill_buckets=_env_str("PREFILL_BUCKETS",
                                     "64,128,256,512,1024"),
            temperature=_env_float("TEMPERATURE", 0.0),
            top_k=_env_int("TOP_K", 0),
            top_p=_env_float("TOP_P", 1.0),
            attn_impl=(_env_str("ATTN_IMPL", "auto") or "auto").lower(),
            moe_impl=moe_impl,
            decode_attn=(_env_str("DECODE_ATTN", "auto") or "auto").lower(),
            kv_page_size=_env_int("KV_PAGE_SIZE", 16),
            ragged_attention=(_env_str("RAGGED_ATTENTION", "auto")
                              or "auto").lower(),
            kv_pool=_env_bool("KV_POOL", True),
            kv_pool_page=_env_int("KV_POOL_PAGE", 16),
            kv_pool_blocks=_env_int("KV_POOL_BLOCKS", 0),
            radix_cache=_env_bool("RADIX_CACHE", True),
            radix_lru_blocks=_env_int("RADIX_LRU_BLOCKS", 0),
            host_kv_blocks=_env_int("HOST_KV_BLOCKS", 0),
            hbm_prefix_cache=_env_bool("HBM_PREFIX_CACHE", True),
            max_queue_depth=_env_int("MAX_QUEUE_DEPTH", 64),
            max_inflight_requests=_env_int("MAX_INFLIGHT_REQUESTS", 256),
            degraded_fallback=_env_bool("DEGRADED_FALLBACK", False),
            breaker_threshold=_env_int("BREAKER_THRESHOLD", 5),
            breaker_window_secs=_env_float("BREAKER_WINDOW_SECS", 30.0),
            breaker_recovery_secs=_env_float("BREAKER_RECOVERY_SECS", 15.0),
            slot_health_check=_env_bool("SLOT_HEALTH_CHECK", True),
            quarantine_retry_budget=_env_int("QUARANTINE_RETRY_BUDGET", 1),
            engine_reset_max_per_min=_env_int("ENGINE_RESET_MAX_PER_MIN",
                                              12),
            engine_watchdog_secs=_env_float("ENGINE_WATCHDOG_SECS", 120.0),
            engine_startup_grace_secs=_env_float(
                "ENGINE_STARTUP_GRACE_SECS", 900.0),
            fault_points=_env_str("FAULT_POINTS", "") or "",
            openai_api_key=_env_str("OPENAI_API_KEY", None),
            openai_model=_env_str("OPENAI_MODEL", "gpt-3.5-turbo"),
            openai_base_url=_env_str("OPENAI_BASE_URL", None),
            grammar_decode=_env_bool("GRAMMAR_DECODE", False),
            grammar_profile=(_env_str("GRAMMAR_PROFILE", "default")
                             or "default").lower(),
            grammar_forced_run_min=_env_int("GRAMMAR_FORCED_RUN_MIN", 4),
            spec_decode=_env_bool("SPEC_DECODE", False),
            spec_draft_k=_env_int("SPEC_DRAFT_K", 4),
            spec_draft_model=_env_str("SPEC_DRAFT_MODEL", "gemma-2b-it"),
            spec_draft_path=_env_str("SPEC_DRAFT_PATH", None),
            mesh_shape=_env_str("MESH_SHAPE", "") or "",
            dcn_mesh_shape=_env_str("DCN_MESH_SHAPE", "") or "",
            distributed_init=_env_bool("DISTRIBUTED_INIT", False),
            coordinator_address=_env_str("COORDINATOR_ADDRESS", None),
            num_processes=_env_int("NUM_PROCESSES", 1),
            process_id=_env_int("PROCESS_ID", 0),
            fleet_size=_env_int("FLEET_SIZE", 1),
            fleet_hedge_ms=_env_float("FLEET_HEDGE_MS", 0.0),
            fleet_affinity=_env_bool("FLEET_AFFINITY", True),
            fleet_migration_budget=_env_int("FLEET_MIGRATION_BUDGET", 3),
            fleet_rejoin_secs=_env_float("FLEET_REJOIN_SECS", 0.0),
            rollout_canary_share=_env_float("ROLLOUT_CANARY_SHARE", 0.1),
            rollout_observe_secs=_env_float("ROLLOUT_OBSERVE_SECS", 60.0),
            rollout_burn_gate=_env_float("ROLLOUT_BURN_GATE", 2.0),
            rollout_steptime_gate=_env_float("ROLLOUT_STEPTIME_GATE", 0.0),
            tenant_tiers=_env_str("TENANT_TIERS", "") or "",
            qos_default_lane=(
                _env_str("QOS_DEFAULT_LANE", "interactive")
                or "interactive").lower(),
            lane_weights=_env_str("LANE_WEIGHTS", "") or "",
            tenant_max_queue=_env_int("TENANT_MAX_QUEUE", 0),
            qos_session_token_budget=_env_int(
                "QOS_SESSION_TOKEN_BUDGET", 0),
            preempt_wait_ms=_env_float("PREEMPT_WAIT_MS", 500.0),
            preempt_budget=_env_int("PREEMPT_BUDGET", 2),
            slo_interactive_ms=_env_float("SLO_INTERACTIVE_MS", 2000.0),
            flight_recorder_size=_env_int("FLIGHT_RECORDER_SIZE", 256),
            ledger_enable=_env_bool("LEDGER_ENABLE", True),
            slo_ttft_ms=_env_float("SLO_TTFT_MS", 5000.0),
            slo_session_ttft_ms=_env_float("SLO_SESSION_TTFT_MS", 0.0),
            slo_windows=_env_str("SLO_WINDOWS", "300,3600") or "300,3600",
            slo_objective=_env_float("SLO_OBJECTIVE", 0.99),
            perf_baselines=_env_str("PERF_BASELINES", "") or "",
            sentinel_enable=_env_bool("SENTINEL_ENABLE", True),
            sentinel_window=_env_int("SENTINEL_WINDOW", 256),
            sentinel_factor=_env_float("SENTINEL_FACTOR", 2.0),
            sentinel_min_samples=_env_int("SENTINEL_MIN_SAMPLES", 16),
            sentinel_eval_secs=_env_float("SENTINEL_EVAL_SECS", 2.0),
            incident_ring=_env_int("INCIDENT_RING", 8),
            incident_cooldown_secs=_env_float(
                "INCIDENT_COOLDOWN_SECS", 60.0),
            incident_burn_threshold=_env_float(
                "INCIDENT_BURN_THRESHOLD", 2.0),
            incident_profile_secs=_env_float(
                "INCIDENT_PROFILE_SECS", 0.0),
            incident_thrash_min_blocks=_env_int(
                "INCIDENT_THRASH_MIN_BLOCKS", 8),
            debug_token=_env_str("DEBUG_TOKEN", None),
            drain_timeout_secs=_env_float("DRAIN_TIMEOUT_SECS", 10.0),
        )
