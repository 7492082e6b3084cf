"""Model architecture configs.

One ``ModelConfig`` parameterizes every family in BASELINE.json's eval
matrix (Gemma-2B/7B, Llama-3-8B/70B, Mixtral-8x7B) plus tiny deterministic
test models. Family differences are expressed as data, not subclasses:

- Gemma:   (1+w) RMSNorm, sqrt(dim) embedding scale, GeGLU, tied embeddings,
           head_dim 256, MHA (7B) / MQA (2B)
- Llama-3: plain RMSNorm, SiLU-GLU, GQA 8 KV heads, theta 500k, untied
- Mixtral: Llama geometry + 8-expert top-2 MoE MLP
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    mlp_hidden: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    rms_offset: float = 0.0          # 1.0 for Gemma's (1+w) norm
    activation: str = "silu"         # silu | gelu (Gemma uses gelu_tanh)
    tie_embeddings: bool = False
    embed_scale: bool = False        # Gemma multiplies embeddings by sqrt(dim)
    # MoE (0 experts = dense MLP)
    n_experts: int = 0
    experts_per_token: int = 0
    # Special tokens (tokenizer-dependent; defaults overridden per family)
    bos_id: int = 1
    eos_ids: Tuple[int, ...] = (2,)
    pad_id: int = 0
    max_seq_len: int = 8192

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        embed = self.vocab_size * self.dim
        attn = self.n_layers * (
            self.dim * self.n_heads * self.head_dim          # wq
            + 2 * self.dim * self.n_kv_heads * self.head_dim  # wk, wv
            + self.n_heads * self.head_dim * self.dim         # wo
        )
        mlp_units = max(self.n_experts, 1)
        mlp = self.n_layers * mlp_units * 3 * self.dim * self.mlp_hidden
        router = self.n_layers * self.dim * self.n_experts
        norms = self.n_layers * 2 * self.dim + self.dim
        head = 0 if self.tie_embeddings else self.vocab_size * self.dim
        return embed + attn + mlp + router + norms + head


_CONFIGS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    _CONFIGS[cfg.name] = cfg
    return cfg


# --- Test models (deterministic, CPU-fast) ---
TOY_8M = _register(ModelConfig(
    name="toy-8m", vocab_size=512, dim=256, n_layers=4, n_heads=4,
    n_kv_heads=2, head_dim=64, mlp_hidden=704, max_seq_len=2048,
))
TOY_MOE = _register(ModelConfig(
    name="toy-moe", vocab_size=512, dim=256, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=64, mlp_hidden=448, n_experts=4,
    experts_per_token=2, max_seq_len=2048,
))

# --- Gemma (HF: google/gemma-{2b,7b}-it) ---
GEMMA_2B = _register(ModelConfig(
    name="gemma-2b-it", vocab_size=256000, dim=2048, n_layers=18, n_heads=8,
    n_kv_heads=1, head_dim=256, mlp_hidden=16384, rms_offset=1.0,
    activation="gelu", tie_embeddings=True, embed_scale=True,
    bos_id=2, eos_ids=(1, 107), pad_id=0, max_seq_len=8192,
))
GEMMA_7B = _register(ModelConfig(
    name="gemma-7b-it", vocab_size=256000, dim=3072, n_layers=28, n_heads=16,
    n_kv_heads=16, head_dim=256, mlp_hidden=24576, rms_offset=1.0,
    activation="gelu", tie_embeddings=True, embed_scale=True,
    bos_id=2, eos_ids=(1, 107), pad_id=0, max_seq_len=8192,
))

# --- Llama 3 (HF: meta-llama/Meta-Llama-3-{8B,70B}-Instruct) ---
LLAMA3_8B = _register(ModelConfig(
    name="llama-3-8b-instruct", vocab_size=128256, dim=4096, n_layers=32,
    n_heads=32, n_kv_heads=8, head_dim=128, mlp_hidden=14336,
    rope_theta=500000.0, rms_eps=1e-5,
    bos_id=128000, eos_ids=(128001, 128009), pad_id=128001, max_seq_len=8192,
))
LLAMA3_70B = _register(ModelConfig(
    name="llama-3-70b-instruct", vocab_size=128256, dim=8192, n_layers=80,
    n_heads=64, n_kv_heads=8, head_dim=128, mlp_hidden=28672,
    rope_theta=500000.0, rms_eps=1e-5,
    bos_id=128000, eos_ids=(128001, 128009), pad_id=128001, max_seq_len=8192,
))

# --- Mixtral (HF: mistralai/Mixtral-8x7B-Instruct-v0.1) ---
MIXTRAL_8X7B = _register(ModelConfig(
    name="mixtral-8x7b-instruct", vocab_size=32000, dim=4096, n_layers=32,
    n_heads=32, n_kv_heads=8, head_dim=128, mlp_hidden=14336,
    rope_theta=1e6, rms_eps=1e-5, n_experts=8, experts_per_token=2,
    bos_id=1, eos_ids=(2,), pad_id=0, max_seq_len=32768,
))


def get_config(name: str, **overrides) -> ModelConfig:
    try:
        cfg = _CONFIGS[name]
    except KeyError:
        raise KeyError(
            f"Unknown model {name!r}; known: {sorted(_CONFIGS)}"
        ) from None
    return replace(cfg, **overrides) if overrides else cfg


def spec_draft_config(k: int, draft_model: str,
                      target: Optional[ModelConfig],
                      kv_pool: bool = True) -> ModelConfig:
    """The draft of a speculative-decode deployment, after its checks:
    the block-paged KV pool (``KV_POOL``), which alone runs the spec
    chunk (where the JAX batcher logs a warning and serves plain
    decode), then the JAX config's, with its errors: ``k``
    (``SPEC_DRAFT_K``) at least 1, a registry model, and the target's
    vocabulary (a ``target`` of None, one the registry does not know, is
    not compared)."""
    if not kv_pool:
        raise ValueError(
            "SPEC_DECODE=true needs the block-paged KV pool (KV_POOL=true); "
            "the dense KV ladder would serve plain decode")
    if k < 1:
        raise ValueError(f"SPEC_DRAFT_K must be >= 1, got {k}")
    try:
        draft = get_config(draft_model)
    except KeyError:
        raise ValueError(
            f"SPEC_DRAFT_MODEL {draft_model!r} is not a known model "
            f"registry name") from None
    if target is not None and draft.vocab_size != target.vocab_size:
        raise ValueError(
            f"SPEC_DRAFT_MODEL {draft_model!r} (vocab {draft.vocab_size}) "
            f"does not share {target.name!r}'s vocab ({target.vocab_size}) "
            f"— draft and verifier must use one tokenizer")
    return draft


def list_configs() -> Dict[str, ModelConfig]:
    return dict(_CONFIGS)
