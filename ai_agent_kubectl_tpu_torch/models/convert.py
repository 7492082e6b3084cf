"""Parameter conversion into the port's tree.

``params_from_jax`` maps the JAX package's parameter tree (the dict
``ai_agent_kubectl_tpu/models/transformer.py::init_params`` returns,
with every leaf converted to a numpy array) onto the port's tree: the
same keys, shapes and values, as torch tensors. With it both packages
compute the same function, which is what the parity tests hold them to.
Loading HF checkpoints (``convert_hf_checkpoint``) waits for a later
slice of the port.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .config import ModelConfig
from .transformer import Params


def _tensor(arr, dtype, device) -> torch.Tensor:
    a = np.array(arr)                    # a writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16: reinterpret
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


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
    casts every leaf; ``cfg`` checks the keys and shapes first and
    raises ``ValueError`` on any mismatch."""
    if cfg is not None:
        want = expected_shapes(cfg)

        def check(node, spec, path):
            if set(node) != set(spec):
                raise ValueError(f"{path or 'tree'} keys {sorted(node)} != "
                                 f"{sorted(spec)}")
            for key, sub in spec.items():
                if isinstance(sub, dict):
                    check(node[key], sub, f"{path}{key}/")
                elif tuple(np.shape(node[key])) != sub:
                    raise ValueError(f"{path}{key}: shape "
                                     f"{tuple(np.shape(node[key]))} != {sub}")

        check(tree, want, "")

    def convert(node):
        if isinstance(node, Mapping):
            return {key: convert(val) for key, val in node.items()}
        return _tensor(node, dtype, device)

    return convert(tree)
