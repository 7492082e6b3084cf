"""TorchEngine — the single-sequence GPU inference engine behind the
service seam.

The counterpart of the JAX package's ``engine/jax_engine.py``. It holds
what every engine of the port shares — the constructor's knobs, the
tokenizer and the weights (``_load``: an HF checkpoint at ``MODEL_PATH``
or a random init from ``seed``; plain, int8 or packed int4), the ``start``/``stop`` lifecycle and the
``Engine`` protocol surface — and it serves one request at a time
(``DECODE_BATCH_SIZE=1``):

    tokenize -> bucketed prefill (flash) -> decode chunks -> detokenize

- **Bucketed prefill** into a fresh dense per-request cache
  ([L, 1, max_seq + 1, KV, hd]): prompts pad to the next
  ``PREFILL_BUCKETS`` length; the prefill attends through the flash
  kernel where ``flash_supported`` tiles the shape (the JAX engine's
  per-shape choice, ``_prefill_impl_for``), the dense reference
  otherwise.
- **Prefix-KV cache**: the shared system prompt is prefilled once at
  start (``engine/prefix_cache.py``); a prompt that extends it copies
  its K/V and prefills only the suffix at offset positions. A prompt
  (or suffix) beyond the largest bucket prefills in sequential chunks at
  absolute offsets.
- **Decode chunks** of ``CHUNK_SIZES`` steps (forward one token, sample
  the next) run back to back on the device with no host read inside;
  each chunk's tokens are copied to the host asynchronously and fetched
  once, and the next chunk is enqueued before the current one is read
  (two in flight). Attention in a decode step is the dense reference
  over the smallest KV-ladder bucket covering the positions the chunk
  can reach. On EOS the chunk in flight is abandoned.
- Greedy at temperature 0, byte-identical to the JAX engine. A sampled
  request follows the JAX engine's split-chained threefry key schedule
  (``engine/sampling.py::split``): ``PRNGKey(seed)`` (the request's
  seed, else the engine seed plus the prompt length) splits into the
  first token's key and a chain key, and each decode step splits the
  chain key and draws with its second half, so the same seed gives the
  JAX engine's transcript.
- A mixture-of-experts model (Mixtral) runs its MLP through
  ``parallel/moe.py::dense_moe`` (``moe_impl`` auto or dense), or the
  expert-parallel dispatch on an expert mesh; ``MOE_IMPL=ep`` on one
  card builds the JAX engine's one-device expert mesh for it.
- ``KV_QUANT=int8`` stores the cache and the prefix as int8 with one
  f32 scale per (position, head) (``ops/quant.py::QuantKV``), read by
  ``dense_attention_quant``. The flash kernel reads bf16 KV, so prefill
  attention resolves to dense under it, with the JAX engine's log line.

- ``swap_weights`` changes the weights of a stopped engine in place,
  atomically (the new tree loads and is checked against the live one
  before the old one goes), for the weight rollout
  (``engine/rollout.py``). Every engine stamps the version it serves
  (``weights_version``, the JAX package's fingerprint of ``MODEL_PATH``
  or of the ``dev:<model>:seed=<n>:quant=<q>`` sentinel without one).

- ``MESH_SHAPE`` serves over every axis (``_setup_mesh``, the JAX
  engine's): the weights split per ``parallel/sharding.py``
  (``shard_params``: Megatron over ``model``, experts over ``expert``,
  layers over ``pipe``), the cache per shard, every forward over the
  shards (``models/transformer.py::_forward_tp``). The mesh's devices
  are the distinct cards of the serving type, or the constructor's
  ``devices`` list, which may repeat a device (``[cuda:0] * 2`` puts
  two shards on one card). ``QUANT=int4`` serves int8 under a
  multi-device mesh, with the JAX warning (int4 on the one-device
  expert mesh).
- **Ring prefill** on a ``seq`` axis: a prompt beyond the largest
  bucket that does not extend the cached prefix prefills in one pass
  (``_prefill_ring``), the padded prompt cut into one block per seq row
  and the blocks joined by ring attention
  (``parallel/ring_attention.py``); where the axis does not divide the
  padded length it prefills in chunks. Every other forward runs on the
  seq-0 row.
- **Pipeline stages** on a ``pipe`` axis (``parallel/pipeline.py``):
  the layers must divide over the stages, ``MOE_IMPL=ep`` is refused
  and an expert axis runs its MoE layers dense (warned), as in JAX.

- ``DCN_MESH_SHAPE`` multiplies each axis across processes joined by
  ``parallel/distributed.py::init_distributed`` (the hybrid mesh of
  ``parallel/mesh.py``). Rank 0 runs this engine; every other rank
  builds its own shards (``build_shards``) and follows rank 0's calls
  (``serve_follower``). Every call that touches shards — each forward,
  each sharded cache's allocation, the prefix's trim and splice — goes
  through the one dispatch point (``_shards``), which posts it to the
  followers first on a mesh that spans processes. A seq axis with a DCN
  factor puts seq rows in other processes than the seq-0 row: their
  process holds their weights and no cache, runs its rows of each ring
  prefill (the hops, the K/V bound for the seq-0 row's cache and the
  final hidden states crossing processes) and idles through every
  other forward.

The continuous-batching engine (``engine/batcher.py::
BatchedTorchEngine``) builds on this class and replaces the serving
path. Left out of the JAX engine: the float32 forcing of a CPU pipe mesh
(XLA:CPU's workaround; PyTorch serves the asked dtype), and the compile
cache and ladder warm threads (nothing compiles in eager PyTorch).

Everything runs on ``device`` — ``cuda`` unless the caller asks for the
CPU, as the tests do. A CUDA request with no card raises
(``device.resolve_device``); nothing moves to the CPU on its own.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import logging
import threading
import time
from collections import deque
from typing import AsyncIterator, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig, get_config
from ..models.convert import checkpoint_version, convert_hf_checkpoint
from ..models.transformer import KVCache, Params, forward, init_params
from ..obs.profiler import ProfilerSession
from ..ops.flash_attention import flash_supported
from ..ops.quant import is_quantized, kv_map, quantize_params_int8, \
    random_params_int8
from ..ops.quant4 import quantize_params_int4
from ..parallel import distributed
from ..parallel.mesh import MeshConfig, build_mesh, distinct_devices
from ..parallel.sharding import ShardedParams, residual_fraction, \
    shard_params
from .prefix_cache import PrefixKV, round_kv_limit
from .protocol import EngineResult, EngineUnavailable, GenerationTimeout
from .sampling import eos_mask, prng_key, sample_token_keyed, split
from .tokenizer import StreamDecoder, Tokenizer, load_tokenizer

logger = logging.getLogger(__name__)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def kv_bucket_ladder(top: int, start: int = 128) -> tuple:
    """Pow2 KV-span ladder topped by ``top``: a decode step attends over
    the smallest bucket covering its positions, so its cost tracks the
    live length, not the cache size."""
    ladder, b = [], start
    while b < top:
        ladder.append(b)
        b *= 2
    return tuple(ladder) + (top,)


class TorchEngine:
    name = "torch"

    #: decode chunk sizes (tokens per chunk), largest first: the remaining
    #: budget is decomposed greedily over these, so a 20-token request runs
    #: 8+8+1+1+1+1 rather than a 32-step chunk whose tail it would discard.
    CHUNK_SIZES = (32, 8, 1)

    def __init__(
        self,
        model_cfg: ModelConfig,
        *,
        tokenizer: Optional[Tokenizer] = None,
        params: Optional[Params] = None,
        model_path: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        dtype: str = "bfloat16",
        quant: str = "",
        kv_quant: str = "",
        max_seq_len: int = 1024,
        prefill_buckets: tuple = (64, 128, 256, 512, 1024),
        top_k: int = 0,
        top_p: float = 1.0,
        attn_impl: str = "auto",
        moe_impl: str = "auto",
        prefix_cache: bool = True,
        seed: int = 0,
        device: DeviceLike = None,
        mesh_shape: str = "",
        dcn_mesh_shape: str = "",
        devices: Optional[list] = None,
    ):
        if dtype not in DTYPES:
            raise ValueError(f"DTYPE must be one of {sorted(DTYPES)}, got "
                             f"{dtype!r}")
        if quant not in ("", "int8", "int4"):
            raise ValueError(f"QUANT must be ''|int8|int4, got {quant!r}")
        if kv_quant not in ("", "int8"):
            raise ValueError(f"KV_QUANT must be '' or 'int8', got "
                             f"{kv_quant!r}")
        if attn_impl not in ("auto", "dense", "flash"):
            raise ValueError(
                f"ATTN_IMPL must be auto|dense|flash, got {attn_impl!r}")
        if top_k < 0 or not (0.0 < top_p <= 1.0):
            raise ValueError(
                f"TOP_K must be >= 0 and TOP_P in (0, 1], got "
                f"{top_k}/{top_p}")
        if moe_impl not in ("auto", "ep", "dense"):
            raise ValueError(
                f"MOE_IMPL must be auto|ep|dense, got {moe_impl!r}")
        self.model_cfg = model_cfg
        # An explicit device list names the mesh's devices; its first
        # is the serving device (scheduler state, logits, sampling).
        self.devices = ([resolve_device(d) for d in devices] if devices
                        else None)
        self.device = (self.devices[0] if self.devices
                       else resolve_device(device))
        self.mesh_shape = mesh_shape or ""
        self.dcn_mesh_shape = dcn_mesh_shape or ""
        self.mesh = None
        self.model_path = model_path
        self.tokenizer_path = tokenizer_path
        self.dtype = DTYPES[dtype]
        self.quant = quant
        self.kv_quant = kv_quant
        # auto: the flash kernel on the card; on the CPU the plain version
        # would stand in for it, so the dense reference serves there (as
        # the JAX engine picks flash only on its accelerator).
        if attn_impl == "auto":
            attn_impl = "flash" if self.device.type == "cuda" else "dense"
        self.attn_impl = attn_impl
        self.moe_impl = moe_impl
        self.max_seq_len = min(max_seq_len, model_cfg.max_seq_len)
        self.prefill_buckets = tuple(
            b for b in sorted(prefill_buckets) if b <= self.max_seq_len
        ) or (self.max_seq_len,)
        self.top_k = top_k
        self.top_p = top_p
        self.use_prefix_cache = prefix_cache
        self.seed = seed
        self.tokenizer = tokenizer
        self.params = params
        # The weights version this engine serves (stamped by _load or a
        # swap, kept across restarts) and the checkpoint path it came
        # from: a dev sentinel without MODEL_PATH, restorable by a swap.
        self.weights_version = ""
        self.checkpoint_path = model_path
        self._ready = False
        self._shutdown = False
        self._lock: Optional[asyncio.Lock] = None
        self._gen_inflight = 0       # accepted requests incl. lock waiters
        # Generation steps run on one thread of their own, so a
        # torch.profiler capture started there (profile()) records them.
        self._gen_thread = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torch-engine")
        self._prefix: Optional[PrefixKV] = None
        self._kv_buckets = kv_bucket_ladder(self.max_seq_len)
        self._impl_for: dict = {}    # (q_len, kv_len) -> attn impl
        self.ring_prefills = 0       # prompts prefilled by the ring
        self._eos_d = torch.tensor(sorted(set(model_cfg.eos_ids)),
                                   dtype=torch.int32, device=self.device)

    @classmethod
    def from_config(cls, cfg, devices: Optional[list] = None
                    ) -> "TorchEngine":
        """``devices``: the mesh's devices, one per shard, when they are
        not the distinct cards (``[cuda:0] * 2`` puts two shards of
        ``MESH_SHAPE=tp=2`` on one card)."""
        return cls(get_config(cfg.model_name), devices=devices,
                   **engine_kwargs(cfg))

    # ------------------------------------------------------------ startup

    @property
    def ready(self) -> bool:
        return self._ready

    async def start(self) -> None:
        self._shutdown = False       # allow stop() -> start() restarts
        await asyncio.to_thread(self._start_blocking)
        self._lock = asyncio.Lock()
        self._ready = True
        # One generation through the real serving path before the first
        # user request: it builds the kernels (first use) and runs every
        # code path a request takes. As in the JAX engine, a failing
        # warm-up (a drill armed at boot) is logged and never kills
        # startup: the requests that follow meet the same fault.
        try:
            await self.generate("warmup: list pods", max_tokens=2,
                                temperature=0.0)
        except Exception:
            logger.exception("warmup generation failed")
        # Every rank's launch counts from here on are the serving's own
        # (``distributed.report``).
        self._shards(distributed.mark_served)

    def _start_blocking(self) -> None:
        t0 = time.monotonic()
        self._setup_mesh()
        self._load()
        self._init_prefix_cache()
        logger.info("TorchEngine ready on %s in %.1fs: %s (quant=%s, "
                    "prefill %s, buckets %s)", self.device,
                    time.monotonic() - t0, self.model_cfg.name,
                    self.quant or "-", self.attn_impl, self.prefill_buckets)

    def _setup_mesh(self) -> None:
        """The serving mesh from ``mesh_shape`` and ``dcn_mesh_shape``
        (the JAX engine's ``_setup_mesh``). An empty spec or a one-device
        mesh keeps ``self.mesh = None``: every path then runs exactly as
        on one card; except that ``MOE_IMPL=ep`` on an MoE model builds a
        one-device expert mesh, so the dispatch itself serves (its
        all-to-alls degenerate to the shard's own buffers), as in the
        JAX engine. A larger spec builds the mesh over the constructor's
        ``devices``, else the distinct devices of the serving type, and
        raises when there are too few, when its pipe axis (the DCN factor
        counted) does not divide the layers, and for ``MOE_IMPL=ep`` with
        a pipe axis (the JAX engine's checks and messages). A DCN spec
        over more than one device takes this process's first ICI-count
        devices and every other process's (``global_devices``): the
        device total is ``MESH_SHAPE x DCN_MESH_SHAPE``; a process group
        of another size than the DCN spec's is refused. A DCN seq axis
        puts seq rows in other processes than the seq-0 row, which alone
        holds the cache: their process takes part in ring prefills only.
        Idempotent: a restart keeps the mesh."""
        spec = self.mesh_shape.strip()
        dcn_spec = self.dcn_mesh_shape.strip()
        force_ep_mesh = self.moe_impl == "ep" and self.model_cfg.is_moe
        if self.mesh is not None:
            return
        mesh_cfg = MeshConfig.parse(spec)
        dcn_cfg = MeshConfig.parse(dcn_spec) if dcn_spec else None
        n_dcn = dcn_cfg.n_devices if dcn_cfg else 1
        world = distributed.world_size()
        if world > 1 and n_dcn != world:
            raise ValueError(
                f"NUM_PROCESSES={world} serves one mesh over every process: "
                f"DCN_MESH_SHAPE must multiply to {world} (got "
                f"{dcn_spec!r})")
        if not spec and not dcn_spec and not force_ep_mesh:
            return
        total = mesh_cfg.n_devices * n_dcn
        if total == 1 and not force_ep_mesh:
            return
        if total == 1:
            logger.info("MOE_IMPL=ep: building 1-device expert mesh")
        n_pipe = mesh_cfg.pipe * (dcn_cfg.pipe if dcn_cfg else 1)
        if n_pipe > 1 and self.model_cfg.n_layers % n_pipe:
            raise ValueError(
                f"MESH_SHAPE pipe={n_pipe} does not divide "
                f"{self.model_cfg.name}'s {self.model_cfg.n_layers} layers")
        if n_pipe > 1 and self.model_cfg.is_moe and self.moe_impl == "ep":
            raise ValueError(
                "MOE_IMPL=ep does not compose with a pipe mesh axis: the "
                "EP all-to-all dispatch can't nest under the pipeline "
                "stage shard_map. Use ep×tp without pp (MoE models "
                "shard better over expert+model than pipe), or drop "
                "MOE_IMPL to auto to accept dense per-stage experts.")
        if n_pipe > 1 and self.model_cfg.is_moe and mesh_cfg.expert > 1:
            logger.warning(
                "pipe>1 disables expert-parallel MoE dispatch: MoE layers "
                "run dense (all experts) inside each pipeline stage; "
                "prefer ep×tp without pp for MoE serving")
        devices = self.devices or distinct_devices(self.device.type)
        if n_dcn > 1:
            devices = distributed.global_devices(
                devices[:mesh_cfg.n_devices])
        if total > len(devices):
            raise ValueError(
                f"MESH_SHAPE={spec!r} DCN_MESH_SHAPE={dcn_spec!r} wants "
                f"{total} devices; only {len(devices)} present")
        self.mesh = build_mesh(mesh_cfg, devices[:total], dcn=dcn_cfg)
        self.device = self.mesh.home
        if self.mesh.hybrid:
            distributed.HANDS.adopt("mesh", self.mesh)

    def build_shards(self) -> None:
        """A follower rank's part of ``start``: the mesh and this
        process's weight shards. Everything else on its shards (caches,
        the prefix, every forward) arrives as rank 0's calls
        (``parallel/distributed.py::serve_follower``)."""
        self._setup_mesh()
        self._load()

    def _shards(self, fn, /, *args, keep: bool = False, **kwargs):
        """The engine's one dispatch point of work on shards
        (``parallel/distributed.py::dispatch``): ``fn``, a module-level
        function, posted to the other processes first on a mesh that
        spans them; ``keep`` for a result that later calls name (a
        cache, the prefix)."""
        return distributed.dispatch(self.mesh, fn, *args, keep=keep,
                                    **kwargs)

    def sharding_health(self) -> Optional[dict]:
        """The sharding view for /health (the JAX engine's keys): mesh
        shape, device count and the residual fraction at this engine's
        decode shape (one sequence: the residual cannot split over the
        batch). The batched engine overrides it with its pool's and its
        draft's flags."""
        if self.mesh is None:
            return None
        return {
            "mesh": dict(self.mesh.shape),
            "devices": int(self.mesh.size),
            "residual_tp_fraction": residual_fraction(
                self.mesh, 1, self.model_cfg.dim),
            "pool_sharded": False,
            "kv_pool_mesh_fallback": False,
            "draft_sharded": False,
            "draft_kv_fallback": False,
        }

    def _load(self) -> None:
        """Tokenizer and weights: the caller's parameters (quantized here
        if ``quant`` asks and they are not yet); else the checkpoint at
        ``model_path``, streamed onto the serving device and quantized
        layer by layer under ``quant`` (``convert_hf_checkpoint``); else a
        random init drawn from a ``torch.Generator`` seeded with ``seed``
        on the serving device — directly in quantized form under
        ``quant``. Either way no full-precision 7B tree is ever built.
        Under ``KV_QUANT=int8`` flash prefill resolves to dense first:
        the flash kernel reads bf16 KV. Under a mesh the tree is then
        split over its shards (``shard_params``), and ``QUANT=int4``
        serves int8, as in the JAX engine."""
        if (self.quant == "int4" and self.mesh is not None
                and self.mesh.size > 1):
            logger.warning("QUANT=int4 does not compose with a multi-"
                           "device mesh; serving int8 weights instead")
            self.quant = "int8"
        if self.kv_quant and self.attn_impl == "flash":
            logger.info("KV_QUANT=int8: prefill attention uses dense "
                        "(fusable dequant) instead of flash")
            self.attn_impl = "dense"
        if self.tokenizer is None:
            self.tokenizer = load_tokenizer(self.model_cfg,
                                            self.tokenizer_path)
        # The embedding is stored per-row int8 whenever the projections
        # are quantized (the JAX engine's _quantize_embed).
        quantize_embed = bool(self.quant)
        if self.params is None and self.model_path:
            logger.info("Loading checkpoint from %s onto %s (quant=%s)",
                        self.model_path, self.device, self.quant or "-")
            self.params = convert_hf_checkpoint(
                self.model_cfg, self.model_path, dtype=self.dtype,
                quant=self.quant, quantize_embed=quantize_embed,
                device=self.device)
        elif self.params is None:
            logger.warning("No MODEL_PATH; random-initializing %s on %s "
                           "(seed %d, quant=%s)", self.model_cfg.name,
                           self.device, self.seed, self.quant or "-")
            self.params = self._random_params(self.seed)
        elif (self.quant and not isinstance(self.params, ShardedParams)
              and not is_quantized(self.params)):
            quantize = (quantize_params_int4 if self.quant == "int4"
                        else quantize_params_int8)
            self.params = quantize(self.params,
                                   quantize_embed=quantize_embed)
            logger.info("Weights quantized to %s (weight-only; embedding "
                        "per-row int8)", self.quant)
        if not self.weights_version:
            # Version the weights served, as the JAX engine does: a
            # checkpoint by its content manifest, a random init by (model,
            # seed, quant), so two replicas built alike share a version
            # (migration and hedging need it). The dev sentinel doubles
            # as a restorable checkpoint path: a swap onto it parses the
            # seed back out and re-derives the same init. A version a
            # swap stamped survives a restart.
            dev_id = (f"dev:{self.model_cfg.name}:seed={self.seed}"
                      f":quant={self.quant}")
            if not self.checkpoint_path:
                self.checkpoint_path = self.model_path or dev_id
            self.weights_version = checkpoint_version(
                self.model_path or dev_id)
        self.params = self._placed(self.params)
        if self.mesh is not None and self.mesh.hybrid:
            distributed.HANDS.adopt("params", self.params)

    def _placed(self, params):
        """A parameter tree as this engine serves it: split over the
        mesh's shards when there is one."""
        if (self.mesh is None or self.mesh.size == 1
                or isinstance(params, ShardedParams)):
            return params
        return shard_params(params, self.mesh, self.model_cfg)

    def _random_params(self, seed: int):
        """A random init drawn from a ``torch.Generator`` seeded with
        ``seed`` on the serving device, directly in quantized form under
        ``quant`` (the embedding per-row int8 then)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.quant:
            return random_params_int8(
                gen, self.model_cfg, dtype=self.dtype,
                quantize_embed=True, int4=self.quant == "int4",
                device=self.device)
        return init_params(gen, self.model_cfg, dtype=self.dtype,
                           device=self.device)

    def swap_weights(self, path: str, *, version: Optional[str] = None
                     ) -> str:
        """Swap the served checkpoint in place on a stopped (drained)
        engine: the rollout's mechanism (``engine/rollout.py``).

        The swap is atomic: the new tree loads fully, and every leaf
        (quantized ``q`` and ``scale`` included) is checked for shape and
        dtype against the live tree, before the old tree is released. Any
        failure raises ``CheckpointCorrupt`` and the engine keeps the old
        weights. The restart that follows (``start``) rebuilds every
        structure holding KV computed under the old weights.

        A path that exists loads through ``convert_hf_checkpoint`` onto
        the serving device; one that does not serves a random init keyed
        on the path (a ``dev:`` sentinel gives back its ``:seed=N``, so
        a rollback onto the original sentinel restores the same bytes).
        ``checkpoint:corrupt`` rejects the load; ``swap:fail`` kills the
        engine mid-swap: it keeps no weights, and its version and path
        are cleared, so a restart loads and stamps afresh."""
        from .rollout import CheckpointCorrupt, RolloutError, SwapFailed

        if self._ready:
            raise RolloutError(
                "swap_weights requires a stopped (drained) engine")
        version = version or checkpoint_version(path)
        faults = getattr(self, "faults", None)
        if faults is not None and faults.checkpoint_corrupt():
            raise CheckpointCorrupt(
                f"checkpoint {path!r} failed integrity validation "
                f"(injected checkpoint:corrupt drill)")
        try:
            new_params = self._placed(self._load_swap_params(path))
        except CheckpointCorrupt:
            raise
        except Exception as e:
            raise CheckpointCorrupt(
                f"checkpoint {path!r} failed to load: "
                f"{type(e).__name__}: {e}") from e
        if self.params is not None and not tree_matches(self.params,
                                                        new_params):
            # Wrong model or geometry: the serving tree stays as it is.
            del new_params
            raise CheckpointCorrupt(
                f"checkpoint {path!r} does not match the serving "
                f"model's parameter tree "
                f"({self.model_cfg.name}, quant={self.quant or '-'})")
        if faults is not None and faults.swap_fail():
            # Mid-swap death: the old tree is released here and the new
            # one is not armed. The replica has no weights until a
            # restart reloads them; its stamps go with them, so a restart
            # re-stamps truthfully in _load.
            del new_params
            self.params = None
            self.weights_version = ""
            self.checkpoint_path = None
            raise SwapFailed("injected swap:fail — replica died mid-swap")
        self.params = new_params
        self.weights_version = version
        self.checkpoint_path = path
        logger.info("weights swapped: %s now serves version %s (%s)",
                    self.model_cfg.name, version, path)
        return version

    def _load_swap_params(self, path: str):
        """Load (or dev-init) a parameter tree for ``swap_weights``
        without touching the live ``self.params``."""
        import os
        import re
        import zlib

        from .rollout import CheckpointCorrupt

        if not path or not str(path).strip():
            raise CheckpointCorrupt("swap needs a checkpoint path")
        path = str(path)
        if os.path.exists(path):
            logger.info("Loading swap checkpoint from %s onto %s "
                        "(quant=%s)", path, self.device, self.quant or "-")
            return convert_hf_checkpoint(
                self.model_cfg, path, dtype=self.dtype, quant=self.quant,
                quantize_embed=bool(self.quant), device=self.device)
        logger.warning(
            "Swap checkpoint %s does not exist; random-initializing %s "
            "keyed on the path (toy/dev mode)", path, self.model_cfg.name)
        m = re.search(r":seed=(\d+)", path) if path.startswith("dev:") \
            else None
        seed = (int(m.group(1)) if m
                else zlib.crc32(path.encode("utf-8", "surrogatepass"))
                & 0x7FFFFFFF)
        return self._random_params(seed)

    async def stop(self, drain_secs: float = 0.0) -> None:
        self._ready = False          # new generate() calls now fail
        if drain_secs > 0 and self._lock is not None:
            # Drain on the accepted-request count (lock waiters included),
            # not on the lock itself.
            deadline = time.monotonic() + drain_secs
            while (self._gen_inflight > 0 and not self._shutdown
                   and time.monotonic() < deadline):
                await asyncio.sleep(0.05)
        self._shutdown = True

    async def profile(self, seconds: float, trace_dir: str) -> None:
        """One ``torch.profiler`` capture of ``seconds`` into
        ``trace_dir``, started and stopped on the generation thread
        between two of its steps (the profiler records the ranges of the
        thread that starts it). Raises when the engine's device cannot
        be traced."""
        session = ProfilerSession(self.device)
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(self._gen_thread, session.start)
        try:
            await asyncio.sleep(seconds)
        finally:
            await loop.run_in_executor(self._gen_thread, session.stop,
                                       trace_dir)

    # ------------------------------------------------------------ prefill

    def _new_cache(self) -> KVCache:
        return self._shards(KVCache.zeros, self.model_cfg, 1,
                            self.max_seq_len, dtype=self.dtype,
                            device=self.device, kv_quant=self.kv_quant,
                            mesh=self.mesh, keep=True)

    def _prefill_impl_for(self, q_len: int, kv_len: int) -> str:
        """Attention for a prefill shape: flash where the kernel's gate
        tiles it, else dense (logged once per shape)."""
        impl = self._impl_for.get((q_len, kv_len))
        if impl is None:
            impl = self.attn_impl
            if impl == "flash" and not flash_supported(
                    q_len, kv_len, self.model_cfg.head_dim):
                logger.warning("Prefill %dq/%dkv: shapes not flash-tileable,"
                               " using dense", q_len, kv_len)
                impl = "dense"
            self._impl_for[(q_len, kv_len)] = impl
        return impl

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"Prompt of {n} tokens exceeds the largest prefill bucket "
            f"{self.prefill_buckets[-1]}")

    def _prefill(self, ids, offset: int, bucket: int, kv_limit: int,
                 cache: KVCache) -> torch.Tensor:
        """One bucketed prefill: ``ids`` at positions ``offset..`` padded
        to ``bucket`` (padding keeps its natural positions; its K/V lands
        past the prompt, where decode overwrites it before any query can
        attend to it), attending over ``cache[:, :kv_limit]``. Returns
        the last valid position's logits [1, vocab]."""
        n = len(ids)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :n] = ids
        dev = self.device
        cols = torch.arange(bucket, dtype=torch.int32, device=dev)
        logits, _ = self._shards(
            forward, self.params, self.model_cfg,
            self._h2d(tokens), (offset + cols)[None], cache,
            kv_limit=kv_limit, attn_impl=self._prefill_impl_for(
                bucket, kv_limit),
            token_mask=(cols < n)[None], moe_impl=self.moe_impl,
            logits_at=torch.full((1,), max(n - 1, 0), dtype=torch.int64,
                                 device=dev), mesh=self.mesh)
        return logits[:, 0]

    def _init_prefix_cache(self) -> None:
        """Prefill the shared system prompt once and keep its K/V on the
        device (engine/prefix_cache.py)."""
        if not self.use_prefix_cache:
            return
        from .prompts import SYSTEM_PROMPT

        ids = self.tokenizer.encode(SYSTEM_PROMPT)
        P = len(ids)
        if P + self.prefill_buckets[0] > self.max_seq_len:
            logger.warning(
                "Prefix cache disabled: system prompt is %d tokens; no room "
                "for a suffix bucket within max_seq %d", P, self.max_seq_len)
            return
        bucket = next((b for b in self.prefill_buckets if b >= P), None)
        if bucket is not None:
            cache = self._new_cache()
            self._prefill(ids, 0, bucket, bucket, cache)
        else:
            # System prompt beyond the largest bucket: build it in chunks.
            _, cache, _ = self._prefill_chunked(list(ids))
        # Trim to the true prefix length: the padding slots' K/V is never
        # copied into request caches.
        self._prefix = self._shards(trim_prefix, cache, list(ids),
                                    keep=True)
        logger.info("Prefix-KV cache ready: %d tokens resident on %s", P,
                    self.device)

    def _splice_prefix(self, cache: KVCache) -> None:
        self._shards(splice_prefix, cache, self._prefix)

    def _prefill_prompt(self, prompt_ids, max_tokens: int):
        """Prefill one prompt into a fresh cache. Returns (last_logits
        [1, V], cache, n_prompt, prefix_hit).

        Routing (the JAX engine's): a prompt that extends the cached
        system prefix prefills only its suffix; one that fits a bucket
        prefills in one pass; a longer one prefills by ring attention
        when the mesh has a seq axis > 1 (``_prefill_ring``), else (or
        where the ring cannot shard its padded length) in sequential
        chunks at absolute offsets. Only prompts beyond the KV capacity
        (max_seq - budget) are left-truncated (the query tail is the
        informative part)."""
        max_prompt = self.max_seq_len - max(1, max_tokens)
        if len(prompt_ids) > max_prompt:
            prompt_ids = prompt_ids[-max_prompt:]
        n_prompt = len(prompt_ids)
        if self._prefix is not None and self._prefix.matches(prompt_ids):
            return self._prefill_suffix(prompt_ids)
        if n_prompt > self.prefill_buckets[-1]:
            if self.mesh is not None and self.mesh.shape["seq"] > 1:
                out = self._prefill_ring(prompt_ids)
                if out is not None:
                    return out
            logits, cache, n = self._prefill_chunked(prompt_ids)
            return logits, cache, n, False
        bucket = self._bucket_for(n_prompt)
        cache = self._new_cache()
        logits = self._prefill(prompt_ids, 0, bucket, bucket, cache)
        return logits, cache, n_prompt, False

    def _suffix_plan(self, prompt_ids):
        """(sbucket, kv_limit, n_suffix) of a prefix-matched prompt's
        suffix prefill, or None when the suffix does not fit one bucket
        (the chunked suffix path instead)."""
        n_suffix = len(prompt_ids) - self._prefix.n
        sbucket = next((b for b in self.prefill_buckets if b >= n_suffix),
                       None)
        if sbucket is None:
            return None
        kv_limit = round_kv_limit(self._prefix.n + sbucket, self.max_seq_len)
        if kv_limit is None:
            return None
        return sbucket, kv_limit, n_suffix

    def _prefill_suffix(self, prompt_ids):
        """Prefix-cache hit: splice the resident system-prompt K/V and
        prefill only the suffix at offset positions (in chunks when it
        exceeds the largest bucket)."""
        prefix = self._prefix
        cache = self._new_cache()
        self._splice_prefix(cache)
        plan = self._suffix_plan(prompt_ids)
        if plan is None:
            logits, cache, n = self._prefill_chunked(prompt_ids, cache=cache,
                                                     start=prefix.n)
            return logits, cache, n, True
        sbucket, kv_limit, n_suffix = plan
        logits = self._prefill(prompt_ids[prefix.n:], prefix.n, sbucket,
                               kv_limit, cache)
        return logits, cache, prefix.n + n_suffix, True

    def _prefill_ring(self, prompt_ids):
        """Ring-attention prefill of a prompt beyond the largest bucket on
        a ``seq`` axis (the JAX ``_prefill_ring``): the prompt padded to
        the next power of two (at least the axis size, at most
        ``max_seq_len``), in one forward whose seq rows each project one
        block and join by the ring; every position's K/V lands in the
        cache. Returns the ``_prefill_prompt`` tuple, or None when the
        padded length is short of the prompt or not divisible by the
        axis (the caller prefills in chunks)."""
        n = len(prompt_ids)
        sp = self.mesh.shape["seq"]
        s_pad = max(sp, 1 << (n - 1).bit_length())   # next pow2 >= n
        if s_pad > self.max_seq_len:
            s_pad = self.max_seq_len
        if s_pad < n or s_pad % sp:
            return None
        tokens = np.zeros((1, s_pad), np.int32)
        tokens[0, :n] = prompt_ids
        dev = self.device
        cols = torch.arange(s_pad, dtype=torch.int32, device=dev)
        cache = self._new_cache()
        logits, _ = self._shards(
            forward, self.params, self.model_cfg, self._h2d(tokens),
            cols[None], cache, kv_limit=s_pad, attn_impl="ring",
            token_mask=(cols < n)[None], moe_impl=self.moe_impl,
            logits_at=torch.full((1,), n - 1, dtype=torch.int64,
                                 device=dev), mesh=self.mesh)
        self.ring_prefills += 1
        return logits[:, 0], cache, n, False

    def _prefill_chunked(self, prompt_ids, cache: Optional[KVCache] = None,
                         start: int = 0):
        """Sequential multi-bucket prefill at absolute offsets: the prompt
        in largest-bucket chunks, each attending over the span written so
        far (a chunk is a suffix of everything before it). ``cache`` and
        ``start`` continue from spliced context. Returns (last_logits
        [1, V], cache, n_prompt)."""
        n = len(prompt_ids)
        big = self.prefill_buckets[-1]
        if cache is None:
            cache = self._new_cache()
        offset, logits = start, None
        while offset < n:
            L = min(big, n - offset)
            bucket = next(b for b in self.prefill_buckets if b >= L)
            # Attend over [0, offset + bucket), tile-rounded, clamped to
            # the cache (the tail past the written span is masked).
            if offset == 0:
                kv_limit = bucket
            else:
                kv_limit = (round_kv_limit(offset + bucket, self.max_seq_len)
                            or self.max_seq_len)
            logits = self._prefill(prompt_ids[offset:offset + L], offset,
                                   bucket, kv_limit, cache)
            offset += L
        return logits, cache, n

    # ------------------------------------------------------------- decode

    def _decode_chunk(self, chunk_len: int, kv_limit: int,
                      tok: torch.Tensor, pos: torch.Tensor, cache: KVCache,
                      temperature: float, key: Optional[tuple],
                      done: torch.Tensor):
        """``chunk_len`` decode steps (forward one token at ``pos``,
        sample the next) enqueued back to back with no host read,
        attending over ``cache[:, :kv_limit]``. A sampled step splits the
        chain ``key`` and draws with the second half (the JAX chunk's
        ``key, sub = split(key)``). Returns ``(toks [1, T] int32 — all -1
        when ``done`` came in set —, tok [1, 1], pos [1, 1], key,
        done)``; tokens after a mid-chunk EOS are garbage the host
        discards."""
        steps = []
        for _ in range(chunk_len):
            logits, _ = self._shards(
                forward, self.params, self.model_cfg, tok, pos, cache,
                kv_limit=kv_limit, attn_impl="dense", moe_impl=self.moe_impl,
                mesh=self.mesh)
            sub = None
            if temperature > 0.0:
                key, sub = split(key)
            nxt = sample_token_keyed(logits[:, 0], sub, temperature,
                                     top_k=self.top_k, top_p=self.top_p)
            steps.append(nxt)
            tok = nxt[:, None]
            pos = pos + 1
        toks = torch.stack(steps, dim=1)
        new_done = done | eos_mask(toks, self._eos_d).any()
        toks = torch.where(done, torch.full_like(toks, -1), toks)
        return toks, tok, pos, key, new_done

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the serving device, in its own dtype. On the
        card the bytes go through pinned staging and a non-blocking copy
        queued on the current stream: a copy from pageable memory waits
        for the whole stream, so the host would stall behind every chunk
        still in flight. The staging block belongs to PyTorch's pinned
        host allocator, which records the copy's event on it and hands
        the block out again only once that event has passed, so it is
        never rewritten before the copy has run. On the CPU the tensor
        is a private copy (the caller may rewrite ``arr`` later)."""
        src = torch.from_numpy(np.array(arr, order="C", copy=True))
        if self.device.type != "cuda":
            return src
        return src.pin_memory().to(self.device, non_blocking=True)

    def _to_host_async(self, t: torch.Tensor):
        """Start the device->host copy of a chunk's tokens without
        waiting: the read that consumes it then waits for this chunk
        only, not for the chunk enqueued after it."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _fetch(self, handle) -> np.ndarray:
        """THE host read of a chunk: one per chunk consumed."""
        host, event = handle
        if event is not None:
            event.synchronize()
        return host.numpy()

    # ----------------------------------------------------------- generate

    def _generate_blocking(self, prompt: str, max_tokens: int,
                           temperature: float, deadline: Optional[float],
                           cancel: Optional[threading.Event] = None,
                           seed: Optional[int] = None):
        """Runs on a worker thread. Yields (event, payload) tuples:
        ("token", text_piece) ... ("done", EngineResult)."""
        cfg = self.model_cfg
        t_start = time.monotonic()
        # Clamp the budget so the prompt keeps >= 1 slot and decode
        # positions never run past the cache.
        max_tokens = max(1, min(max_tokens, self.max_seq_len - 1))

        t_prefill0 = time.monotonic()
        last_logits, cache, n_prompt, prefix_hit = self._prefill_prompt(
            self.tokenizer.encode(prompt), max_tokens)

        # Per-request sampling seed: an explicit seed pins the stream;
        # the default derives it from the engine seed and prompt length,
        # as the JAX engine does. The first token draws with ``key``,
        # the decode steps with splits of ``chunk_key``.
        key = chunk_key = None
        if temperature > 0.0:
            key, chunk_key = split(prng_key(torch.tensor(
                [self.seed + n_prompt if seed is None
                 else int(seed) & 0x7FFFFFFF], device=self.device)))

        detok = StreamDecoder(self.tokenizer)
        detok_ms = 0.0
        finish = "length"

        # First token: sampled from the prefill logits and read at once —
        # this IS time to first token.
        next_tok = sample_token_keyed(last_logits, key, temperature,
                                      top_k=self.top_k, top_p=self.top_p)
        first_id = int(next_tok[0])
        t_first = time.monotonic()
        prefill_ms = (t_first - t_prefill0) * 1000.0
        t_decode0 = t_first
        stopped = False
        if first_id in cfg.eos_ids:
            finish = "stop"
            stopped = True
        else:
            t_dk = time.monotonic()
            piece = detok.push(first_id)
            detok_ms += (time.monotonic() - t_dk) * 1000.0
            if piece is not None:
                yield ("token", piece)
            if max_tokens <= 1:
                stopped = True

        # Decode chunks, two in flight: the next chunk is enqueued before
        # the current one's tokens are read. Chunk sizes decompose the
        # remaining budget greedily, never past max_tokens or the cache.
        if not stopped:
            tok_d = next_tok[:, None].to(torch.int32)
            pos_d = torch.full((1, 1), n_prompt, dtype=torch.int32,
                               device=self.device)
            done_d = torch.zeros((), dtype=torch.bool, device=self.device)
            budget = max_tokens - len(detok.ids)
            sched = 0                # tokens scheduled in chunks
            sched_pos = n_prompt     # cache slot the next chunk writes first
            inflight: deque = deque()
            while True:
                while len(inflight) < 2 and sched < budget:
                    chunk_len = next(
                        (s for s in self.CHUNK_SIZES
                         if s <= budget - sched
                         and sched_pos + s <= self.max_seq_len), 0)
                    if chunk_len == 0:
                        break  # KV capacity exhausted
                    kv_b = next(b for b in self._kv_buckets
                                if b >= sched_pos + chunk_len)
                    toks_d, tok_d, pos_d, chunk_key, done_d = (
                        self._decode_chunk(chunk_len, kv_b, tok_d, pos_d,
                                           cache, temperature, chunk_key,
                                           done_d))
                    inflight.append(self._to_host_async(toks_d))
                    sched += chunk_len
                    sched_pos += chunk_len
                if not inflight:
                    break
                # Deadline and cancel granularity is one chunk.
                if deadline is not None and time.monotonic() > deadline:
                    raise GenerationTimeout("generation exceeded timeout")
                if (cancel is not None and cancel.is_set()) or self._shutdown:
                    finish = "abort"
                    break
                chunk_ids = self._fetch(inflight.popleft())[0]
                new_ids = []
                for tid in chunk_ids:
                    tid = int(tid)
                    if tid < 0:  # the chunk came after an EOS
                        break
                    if tid in cfg.eos_ids:
                        finish = "stop"
                        stopped = True
                        break
                    new_ids.append(tid)
                    if len(detok.ids) + len(new_ids) >= max_tokens:
                        stopped = True
                        break
                t_dk = time.monotonic()
                piece = detok.push(*new_ids) if new_ids else None
                detok_ms += (time.monotonic() - t_dk) * 1000.0
                if piece is not None:
                    yield ("token", piece)
                if stopped:
                    break

        t_dk = time.monotonic()
        piece = detok.flush()
        detok_ms += (time.monotonic() - t_dk) * 1000.0
        if piece is not None:
            yield ("token", piece)

        t_end = time.monotonic()
        yield ("done", EngineResult(
            text=detok.text,
            prompt_tokens=n_prompt,
            completion_tokens=len(detok.ids),
            prefill_ms=prefill_ms,
            decode_ms=(t_end - t_decode0) * 1000.0,
            detok_ms=detok_ms,
            ttft_ms=(t_first - t_start) * 1000.0,
            prefix_cache_hit=prefix_hit,
            finish_reason=finish,
            engine=self.name,
            weights_version=self.weights_version,
            token_ids=tuple(detok.ids),
        ))

    async def generate(self, prompt: str, *, max_tokens: int = 128,
                       temperature: float = 0.0,
                       timeout: Optional[float] = None,
                       seed: Optional[int] = None) -> EngineResult:
        result: Optional[EngineResult] = None
        async for event, payload in self._stream_events(
                prompt, max_tokens=max_tokens, temperature=temperature,
                timeout=timeout, seed=seed):
            if event == "done":
                result = payload
        assert result is not None
        return result

    async def generate_stream(self, prompt: str, *, max_tokens: int = 128,
                              temperature: float = 0.0,
                              timeout: Optional[float] = None,
                              seed: Optional[int] = None
                              ) -> AsyncIterator[str]:
        async for event, payload in self._stream_events(
                prompt, max_tokens=max_tokens, temperature=temperature,
                timeout=timeout, seed=seed):
            if event == "token":
                yield payload

    async def stream_events(self, prompt: str, *, max_tokens: int = 128,
                            temperature: float = 0.0,
                            timeout: Optional[float] = None,
                            seed: Optional[int] = None,
                            resume_ids=None, export=None):
        """The fleet's event stream (``engine/fleet.py``), token by
        token. The single-sequence engine imports and exports nothing
        across replicas, as the JAX one: a request migrated in replays
        from scratch under its pinned seed (the fleet's relay drops the
        prefix it re-emits). The batched engine overrides this with the
        whole resume/export contract."""
        del resume_ids, export
        async for ev in self._stream_events(
                prompt, max_tokens=max_tokens, temperature=temperature,
                timeout=timeout, seed=seed):
            yield ev

    async def _stream_events(self, prompt: str, *, max_tokens: int,
                             temperature: float, timeout: Optional[float],
                             seed: Optional[int] = None):
        if not self._ready:
            raise EngineUnavailable("engine not started")
        t_queue0 = time.monotonic()
        deadline = (t_queue0 + timeout) if timeout else None
        # In flight from acceptance, the lock wait included, so that
        # stop(drain_secs) lets queued requests finish. One generator on
        # purpose: an abandoned stream's cleanup (cancel, close the inner
        # generation), the lock release and the count run in that order.
        self._gen_inflight += 1
        try:
            async with self._lock:
                if self._shutdown:
                    raise EngineUnavailable("engine stopped")
                queue_ms = (time.monotonic() - t_queue0) * 1000.0
                loop = asyncio.get_running_loop()
                cancel = threading.Event()
                gen = self._generate_blocking(prompt, max_tokens,
                                              temperature, deadline, cancel,
                                              seed=seed)
                try:
                    while True:
                        fut = loop.run_in_executor(self._gen_thread, next,
                                                   gen, None)
                        try:
                            item = await fut
                        except asyncio.CancelledError:
                            # The worker may still be inside next(gen):
                            # signal the decode loop and wait it out.
                            cancel.set()
                            try:
                                await asyncio.shield(fut)
                            except BaseException:
                                pass
                            raise
                        if item is None:
                            break
                        event, payload = item
                        if event == "done":
                            payload.queue_ms = queue_ms
                        yield (event, payload)
                finally:
                    cancel.set()
                    try:
                        gen.close()  # suspended here: safe
                    except ValueError:  # pragma: no cover - defensive
                        pass
        finally:
            self._gen_inflight -= 1


# ---------------------------------------------------- calls on shards
#
# Module-level, so that the dispatch point names them by reference: on a
# mesh that spans processes each runs on every process over its shards.

def trim_prefix(cache: KVCache, ids: list) -> PrefixKV:
    """The system prompt's K/V, trimmed to its length (the padding
    slots' K/V is never copied into request caches)."""
    P = len(ids)

    def trim(leaf):
        return leaf[:, :, :P].clone()

    return PrefixKV(ids=list(ids), k=kv_map(trim, cache.k),
                    v=kv_map(trim, cache.v))


def splice_prefix(cache: KVCache, prefix: PrefixKV) -> None:
    """The resident prefix's K/V into a fresh cache's first rows."""
    P = prefix.n
    for dst, src in ((cache.k, prefix.k), (cache.v, prefix.v)):
        kv_map(lambda d, p: d[:, :, :P].copy_(p), dst, src)


def tree_matches(live, new) -> bool:
    """Whether two parameter trees have one structure and every tensor
    (quantized leaves' ``q`` and ``scale`` included) one shape and
    dtype: the swap's check that a checkpoint fits the serving model."""
    if isinstance(live, torch.Tensor) or isinstance(new, torch.Tensor):
        return (isinstance(live, torch.Tensor)
                and isinstance(new, torch.Tensor)
                and live.shape == new.shape and live.dtype == new.dtype)
    if type(live) is not type(new):
        return False
    if isinstance(live, dict):
        return (live.keys() == new.keys()
                and all(tree_matches(live[k], new[k]) for k in live))
    if isinstance(live, (list, tuple)):
        return (len(live) == len(new)
                and all(tree_matches(a, b) for a, b in zip(live, new)))
    if dataclasses.is_dataclass(live):
        return all(tree_matches(getattr(live, f.name), getattr(new, f.name))
                   for f in dataclasses.fields(live))
    return live == new


def engine_kwargs(cfg) -> dict:
    """Constructor keywords every engine of the port takes, from the
    service config."""
    return dict(
        model_path=cfg.model_path,
        tokenizer_path=cfg.tokenizer_path,
        dtype=cfg.dtype,
        quant=cfg.quant,
        kv_quant=cfg.kv_quant,
        max_seq_len=cfg.max_seq_len,
        prefill_buckets=cfg.prefill_bucket_list,
        top_k=cfg.top_k,
        top_p=cfg.top_p,
        attn_impl=cfg.attn_impl,
        moe_impl=cfg.moe_impl,
        prefix_cache=cfg.hbm_prefix_cache,
        device=cfg.torch_device,
        mesh_shape=cfg.mesh_shape,
        dcn_mesh_shape=cfg.dcn_mesh_shape,
    )
