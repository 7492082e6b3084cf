"""RMSNorm (Gemma, Llama and Mixtral alike).

Statistics accumulate in float32 whatever the activation dtype, as in
the JAX package's ``ops/norms.py``.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """y = x / rms(x) * (offset + weight).

    ``offset=1.0`` gives Gemma's (1 + w) parameterization; 0.0 gives
    Llama/Mixtral's plain w."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (offset + weight.float())).to(x.dtype)
