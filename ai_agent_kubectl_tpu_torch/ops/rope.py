"""Rotary position embeddings with explicit absolute positions.

Split-halves convention (dims [0:d/2] pair with [d/2:d]), angles in
float32 — the JAX package's ``ops/rope.py`` exactly.
"""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> tuple:
    """(cos, sin), each [batch, seq, 1, head_dim // 2] float32, for
    absolute ``positions`` [batch, seq]: computed once per forward and
    shared by every layer's q and k."""
    inv_freq = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., None].float() * inv_freq        # [b, s, d/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Apply precomputed ``rope_tables`` to q or k [batch, seq, heads, d]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate q or k.

    x:          [batch, seq, n_heads, head_dim]
    positions:  [batch, seq] absolute token positions (int)
    """
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))
