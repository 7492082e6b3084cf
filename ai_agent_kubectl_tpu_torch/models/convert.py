"""Parameter conversion into the port's tree.

``params_from_jax`` maps the JAX package's parameter tree (the dict
``ai_agent_kubectl_tpu/models/transformer.py::init_params`` returns,
or its int8/int4-quantized form, with every array converted to numpy)
onto the port's tree: the same keys, shapes and values, as torch
tensors. A quantized leaf (an object with ``q`` and ``scale`` arrays —
and ``group_in``/``block_out`` for packed int4) becomes the port's
``QuantInt8``/``QuantInt4`` holding the same bytes. With it both
packages compute the same function, which is what the parity tests
hold them to.
Loading HF checkpoints (``convert_hf_checkpoint``) waits for a later
slice of the port.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..ops.quant import QuantInt8
from ..ops.quant4 import QuantInt4
from .config import ModelConfig
from .transformer import Params


def _tensor(arr, dtype, device) -> torch.Tensor:
    a = np.array(arr)                    # a writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16: reinterpret
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _is_quantized(node) -> bool:
    return hasattr(node, "q") and hasattr(node, "scale")


def _logical_shape(node) -> tuple:
    """A leaf's weight shape: packed int4 stores OUT/2 byte columns."""
    if _is_quantized(node):
        q = tuple(np.shape(node.q))
        return q[:-1] + (q[-1] * 2,) if hasattr(node, "group_in") else q
    return tuple(np.shape(node))


def expected_shapes(cfg: ModelConfig) -> dict:
    """Leaf shapes of a dense model's tree, keyed like the tree."""
    d, hd, H, KV, F_, L = (cfg.dim, cfg.head_dim, cfg.n_heads,
                           cfg.n_kv_heads, cfg.mlp_hidden, cfg.n_layers)
    shapes = {
        "embed": (cfg.vocab_size, d),
        "final_norm": (d,),
        "layers": {
            "attn_norm": (L, d), "wq": (L, d, H * hd),
            "wk": (L, d, KV * hd), "wv": (L, d, KV * hd),
            "wo": (L, H * hd, d), "mlp_norm": (L, d),
            "w_gate": (L, d, F_), "w_up": (L, d, F_), "w_down": (L, F_, d),
        },
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def params_from_jax(tree: Mapping, cfg: Optional[ModelConfig] = None, *,
                    dtype: Optional[torch.dtype] = None,
                    device=None) -> Params:
    """Numpy tree -> torch tree. ``dtype`` (default: each leaf's own)
    casts every plain leaf (quantized payloads and scales keep theirs);
    ``cfg`` checks the keys and (logical) shapes first and raises
    ``ValueError`` on any mismatch."""
    if cfg is not None:
        want = expected_shapes(cfg)

        def check(node, spec, path):
            if set(node) != set(spec):
                raise ValueError(f"{path or 'tree'} keys {sorted(node)} != "
                                 f"{sorted(spec)}")
            for key, sub in spec.items():
                if isinstance(sub, dict):
                    check(node[key], sub, f"{path}{key}/")
                elif _logical_shape(node[key]) != sub:
                    raise ValueError(f"{path}{key}: shape "
                                     f"{_logical_shape(node[key])} != {sub}")

        check(tree, want, "")

    def convert(node):
        if isinstance(node, Mapping):
            return {key: convert(val) for key, val in node.items()}
        if _is_quantized(node):
            q = _tensor(node.q, None, device)
            scale = _tensor(node.scale, None, device)
            if hasattr(node, "group_in"):
                return QuantInt4(q=q, scale=scale,
                                 group_in=int(node.group_in),
                                 block_out=int(node.block_out))
            return QuantInt8(q=q, scale=scale)
        return _tensor(node, dtype, device)

    return convert(tree)
