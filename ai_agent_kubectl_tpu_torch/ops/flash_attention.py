"""Causal flash attention over a KV cache region (the prefill path): the
Hopper kernel, its plain PyTorch version, and the wrapper.

Replaces the Pallas TPU kernel ``ai_agent_kubectl_tpu/ops/
flash_attention.py::flash_attention_cached`` (body ``_flash_kernel``).
Query row (b, s, h) sits at absolute position ``positions[b, s]`` and
attends the cache slots ``kv <= positions[b, s]`` of KV head
``h // (H / KV)``:

- scores, the running max and sum, and the accumulator in f32; the
  probabilities rounded to the value dtype before P.V, the normaliser
  summing the unrounded ones (the TPU kernel's numerics);
- an optional tanh softcap (``tanh(s / c) * c``) before the mask;
- a row with no visible key (position < 0) writes exact zeros;
- no key at or past KVLEN is read, whatever the positions say.

Shapes (the JAX package's): q ``[B, S, H, hd]``, k/v ``[B, KVLEN, KV,
hd]`` (cache slots = absolute positions; a ``cache[:, :kv_limit]``
view is read by its batch stride, never copied), positions ``[B, S]``
int -> ``[B, S, H, hd]`` in q's dtype.

The kernel (``csrc/flash_attention.cu``, CUDA C++ for sm_90a) runs for
CUDA tensors; its source note gives its design and what bounds it. The
plain version runs for CPU tensors only. A CUDA tensor launches the
kernel or raises — nothing falls back to the plain version.
``flash_attention_cached.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .ragged_attention import HEAD_DIMS


def _auto_block(dim: int, cap: int) -> Optional[int]:
    """Largest power-of-two divisor of ``dim``, capped at ``cap``; None if
    no divisor >= 8 exists."""
    b = dim & -dim
    b = min(b, cap)
    return b if b >= 8 else None


def flash_supported(seq_len: int, kv_len: int, head_dim: int) -> bool:
    """The JAX package's gate, kept as it is so the engine picks flash or
    dense per prefill shape exactly as the JAX engine does."""
    return (
        head_dim % 128 == 0
        and _auto_block(seq_len, 128) is not None
        and _auto_block(kv_len, 128) is not None
    )


def flash_attention_cached_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, positions: torch.Tensor,
                                 *, scale: Optional[float] = None,
                                 logit_softcap: float = 0.0) -> torch.Tensor:
    """Dense masked softmax with the kernel's numerics: f32 scores, the
    probabilities rounded to v's dtype before P.V while the normaliser
    sums the unrounded ones, zeros for rows with no visible key."""
    B, S, H, hd = q.shape
    KVLEN, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if logit_softcap > 0.0:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    kv_pos = torch.arange(KVLEN, device=q.device)
    mask = (kv_pos[None, None, :] <= positions.long()[:, :, None])
    mask = mask[:, None, None]                           # [B,1,1,S,KVLEN]
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(),
                       v.float())
    out = out / denom.permute(0, 3, 1, 2, 4)             # [B,S,KV,G,1]
    return out.reshape(B, S, H, hd).to(q.dtype)


def split_plan(B: int, S: int, H: int, KV: int, KVLEN: int) -> tuple:
    """``(splits, keys_per_split, ws_rows)`` for a call: the KVLEN keys
    cut into ranges of ``keys_per_split`` (a multiple of 64) when the
    (batch, KV head, 64-row tile) blocks alone are under one per SM, and
    the rows of each split's workspaces. The kernel's own rule
    (``flash_attention_plan`` in ``csrc/flash_attention.cu``), read from
    its library, so it builds the kernel first. A function of the shapes
    only, never of positions. The source note bounds the workspaces
    (26.2 MB at head_dim 256)."""
    from ._cuda import split_plan as read_plan

    return read_plan("flash_attention", "flash_attention_plan", B, S, H,
                     KV, KVLEN)


def _check_cuda_args(q, k, v, positions) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if positions.dtype != torch.int32:
        raise TypeError(f"positions must be int32, got {positions.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, S, H, hd] and k/v [B, KVLEN, KV, "
                         f"hd]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    _, KVLEN, KV, khd = k.shape
    if k.shape[0] != B or positions.shape != (B, S):
        raise ValueError("k/v batch and positions [B, S] must match q")
    if hd not in HEAD_DIMS or khd != hd:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS} for q and "
                         f"k/v, got {hd} and {khd}")
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if not q.is_contiguous() or not positions.is_contiguous():
        raise ValueError("q and positions must be contiguous")
    for name, t in (("k", k), ("v", v)):
        # [B, KVLEN, KV, hd] with a dense inner [KVLEN, KV, hd]; the batch
        # stride is free (a cache[:, :kv_limit] view).
        if t.stride()[1:] != (KV * hd, hd, 1):
            raise ValueError(f"{name}'s inner [KVLEN, KV, hd] must be dense")
        if t.data_ptr() % 16 or t.stride(0) % 8:
            raise ValueError(f"{name} must be 16-byte aligned per batch row")


def flash_attention_cached(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, positions: torch.Tensor, *,
                           scale: Optional[float] = None,
                           logit_softcap: float = 0.0) -> torch.Tensor:
    """Causal flash attention over a cache region (see the module
    docstring). CPU tensors take the plain version; CUDA tensors launch
    the Hopper kernel (bf16 q/k/v, int32 positions, head_dim 64/128/256)
    and raise on anything else."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_cached_plain(q, k, v, positions, scale=scale,
                                            logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cached runs on cuda or cpu, "
                         f"not {q.device}")
    _check_cuda_args(q, k, v, positions)
    from ._cuda import load, split_workspaces

    lib = load("flash_attention")
    fn = lib.flash_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_longlong] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, S, H, hd = q.shape
    KVLEN, KV = k.shape[1], k.shape[2]
    splits, kps, rows = split_plan(B, S, H, KV, KVLEN)
    out = torch.empty_like(q)
    ws_o, ws_ml, _keep = split_workspaces(splits, rows, hd, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 positions.data_ptr(), out.data_ptr(), ws_o, ws_ml,
                 B, S, H, KV, hd, KVLEN, k.stride(0), v.stride(0),
                 float(scale), float(logit_softcap), kps, splits, stream)
    if err != 0:
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash attention kernel launch failed: {msg} "
                           f"(cudaError {err})")
    flash_attention_cached.launches += 1
    return out


flash_attention_cached.launches = 0
