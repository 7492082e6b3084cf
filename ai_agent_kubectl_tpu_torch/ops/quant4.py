"""Weight-only int4 quantization: the packed format, its plain PyTorch
matmul, and the wrapper over the Hopper kernel.

Replaces the Pallas TPU kernel ``ai_agent_kubectl_tpu/ops/quant4.py::
qmatmul4`` (launcher ``_int4_matmul_2d``, body ``_int4_matmul_kernel``)
and keeps its storage format byte for byte, so both packages compute
with the same packed bytes:

- ``q``: int8 ``[..., IN, OUT/2]`` — two 4-bit values per byte, packed
  along the OUTPUT axis in ``block_out``-column blocks: for out-block
  ``n``, byte column ``n*block_out/2 + j`` holds column ``n*block_out +
  j`` in its low nibble and column ``n*block_out + block_out/2 + j`` in
  its high nibble. The nibbles are NOT interleaved pairs.
- ``scale``: f32 ``[..., IN/group_in, OUT]`` — group-wise symmetric
  scales over the contraction axis.
- Values lie in [-7, 7]; the low nibble unpacks as ``(b << 28) >> 28``
  and the high one as ``b >> 4``, arithmetic shifts on the
  sign-extended byte.

``y[t, o] = sum_g scale[g, o] * sum_{i in g} x[t, i] * w[i, o]``: each
group's partial sum in f32, the scale applied to it, the output in x's
dtype. The kernel (``csrc/int4_matmul.cu``, CUDA C++ for sm_90a) runs
for CUDA tensors; its source note gives its design and what bounds it.
The plain version (``qmatmul4_plain``, the JAX ``_xla_int4_matmul``)
runs for CPU tensors only. A CUDA tensor launches the kernel or raises —
nothing falls back to the plain version. ``qmatmul4.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

#: format defaults — every 7B/70B-class projection dim divides these
GROUP_IN = 512
BLOCK_OUT = 512

#: up to this many rows the kernel runs as a GEMV: 8 token columns a
#: block (wgmma m64n8k16), one consumer warpgroup unpacking two byte
#: columns a thread, three blocks an SM. More rows take token tiles of
#: round_up(T, 8) up to 64 and of 128 above, two consumer warpgroups a
#: block. A small grid cuts the contraction across a thread-block
#: cluster. One launch either way; the source note of
#: ``csrc/int4_matmul.cu`` gives the design.
SKINNY_MAX_T = 8


@dataclasses.dataclass
class QuantInt4:
    """Packed int4 weight (see the module docstring for the layout).

    q:     int8 [..., IN, OUT/2]
    scale: f32  [..., IN/group_in, OUT]
    group_in / block_out: the format the payload was packed with.
    """

    q: torch.Tensor
    scale: torch.Tensor
    group_in: int = GROUP_IN
    block_out: int = BLOCK_OUT

    @property
    def shape(self):
        """Logical (unpacked) weight shape."""
        return tuple(self.q.shape[:-1]) + (self.q.shape[-1] * 2,)

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __getitem__(self, i) -> "QuantInt4":
        """One layer of a stacked leaf (a view, no copy)."""
        return QuantInt4(q=self.q[i], scale=self.scale[i],
                         group_in=self.group_in, block_out=self.block_out)


def int4_supported(in_dim: int, out_dim: int, group_in: int = GROUP_IN,
                   block_out: int = BLOCK_OUT) -> bool:
    """Whether (in, out) packs into the kernel's format (the JAX gate)."""
    return (in_dim % group_in == 0 and out_dim % block_out == 0
            and group_in % 128 == 0 and (block_out // 2) % 128 == 0)


def pick_format(in_dim: int, out_dim: int):
    """Largest tileable (group_in, block_out) for a weight shape, or None
    (the caller then falls back to int8). Prefers 512/512."""
    group = next((g for g in (GROUP_IN, 256, 128) if in_dim % g == 0), None)
    block = next((b for b in (BLOCK_OUT, 256) if out_dim % b == 0), None)
    if group is None or block is None:
        return None
    return group, block


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a correctly rounded division on every device. A CUDA
    tensor divided by a Python number is multiplied by the number's
    reciprocal, which can miss the quotient by one ulp; a divisor on the
    tensor's own device takes the division kernel, so the card
    quantizes to the CPU's (and the JAX package's) bytes."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def quantize_int4(w: torch.Tensor, group_in: int = GROUP_IN,
                  block_out: int = BLOCK_OUT) -> QuantInt4:
    """[..., IN, OUT] float -> QuantInt4 (group-wise symmetric, [-7, 7]),
    bit-identical to the JAX ``quantize_int4``. Stacked leaves quantize
    one leading index at a time to bound the f32 transient."""
    *lead, IN, OUT = w.shape
    if IN % group_in or OUT % block_out:
        raise ValueError(
            f"weight [{IN}, {OUT}] does not tile into group_in={group_in}"
            f" x block_out={block_out}")
    if lead:
        parts = [quantize_int4(w[i], group_in, block_out)
                 for i in range(w.shape[0])]
        return QuantInt4(q=torch.stack([p.q for p in parts]),
                         scale=torch.stack([p.scale for p in parts]),
                         group_in=group_in, block_out=block_out)
    G = IN // group_in
    wf = w.float().reshape(G, group_in, OUT)
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax > 0, true_div(absmax, 7.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int32)
    q = q.reshape(IN, OUT // block_out, block_out)
    half = block_out // 2
    lo, hi = q[..., :half], q[..., half:]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8)
    return QuantInt4(q=packed.view(torch.int8).reshape(IN, OUT // 2),
                     scale=scale.reshape(G, OUT).float(),
                     group_in=group_in, block_out=block_out)


def _unpack_nibbles(packed: torch.Tensor):
    """int8 [..., half] -> (lo, hi) int32 [..., half], sign-extended."""
    pi = packed.to(torch.int32)
    return (pi << 28) >> 28, pi >> 4


def unpack_int4(w: QuantInt4) -> torch.Tensor:
    """Packed payload -> int8 [..., IN, OUT] (the raw [-7, 7] values)."""
    *lead, IN, OH = w.q.shape
    half = w.block_out // 2
    lo, hi = _unpack_nibbles(w.q.reshape(*lead, IN, OH // half, half))
    full = torch.cat([lo, hi], dim=-1)                   # [..., NO, bo]
    return full.reshape(*lead, IN, OH * 2).to(torch.int8)


def dequantize_int4(w: QuantInt4, dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize the weight (tests and yardsticks only: the serving
    path reads packed bytes)."""
    *lead, IN, _ = w.q.shape
    G = IN // w.group_in
    q = unpack_int4(w).float()
    q = q.reshape(*lead, G, w.group_in, q.shape[-1])
    return (q * w.scale[..., :, None, :]).reshape(
        *lead, IN, q.shape[-1]).to(dtype)


def qmatmul4_plain(x: torch.Tensor, w: QuantInt4) -> torch.Tensor:
    """The plain version (the JAX ``_xla_int4_matmul``): per-group
    f32-accumulated products, scaled, then summed over groups; the output
    in x's dtype. It materializes the unpacked weight."""
    *lead, IN = x.shape
    G = IN // w.group_in
    q = unpack_int4(w)                                   # [IN, OUT] int8
    OUT = q.shape[-1]
    # Both operands widen to f32 exactly (x is bf16 or f32, q in [-7, 7])
    # and the product accumulates in f32, as preferred_element_type=f32.
    qg = q.reshape(G, w.group_in, OUT).to(x.dtype).float()
    xg = x.reshape(*lead, G, w.group_in).float()
    partial = torch.einsum("...gi,gio->...go", xg, qg)
    return (partial * w.scale).sum(dim=-2).to(x.dtype)


_LIB = None


def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, its C functions typed
    once."""
    global _LIB
    if _LIB is None:
        from ._cuda import load

        lib = load("int4_matmul")
        lib.int4_matmul_plan.argtypes = [ctypes.c_int] * 4
        lib.int4_matmul_plan.restype = ctypes.c_int
        lib.int4_matmul_bf16.argtypes = ([ctypes.c_void_p] * 4
                                         + [ctypes.c_int] * 6
                                         + [ctypes.c_void_p])
        lib.int4_matmul_bf16.restype = ctypes.c_int
        lib.int4_matmul_geometry.argtypes = ([ctypes.c_int] * 4
                                             + [ctypes.c_void_p] * 3)
        lib.int4_matmul_geometry.restype = ctypes.c_int
        lib.int4_matmul_error_string.argtypes = [ctypes.c_int]
        lib.int4_matmul_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def split_plan(T: int, IN: int, OUT: int, group_in: int) -> int:
    """How many slices of whole scale groups the kernel cuts the
    contraction into for these shapes (1: none), which is the size of
    the thread-block cluster that sums them: the kernel's own rule
    (``int4_matmul_plan`` in ``csrc/int4_matmul.cu``; it splits only a
    grid under half a wave of resident blocks, into at most one wave, at
    most 16 slices and only as many clusters as the current device holds
    at once), read from its library, so it builds the kernel first. Kept
    per shape: a call reads it from here."""
    splits = _lib().int4_matmul_plan(T, IN, OUT, group_in)
    if splits <= 0:
        raise ValueError(f"the kernel takes no plan for T={T}, "
                         f"[{IN}, {OUT}], group_in={group_in}")
    return splits


def kernel_geometry(T: int, IN: int, OUT: int, group_in: int) -> tuple:
    """``(bn, splits, (grid_x, grid_y))`` of the kernel's launch for these
    shapes, from its library (``int4_matmul_geometry``): the token tile,
    the cluster size and the grid (token tiles x cluster ranks, output
    tiles)."""
    bn, gx, gy = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    splits = _lib().int4_matmul_geometry(
        T, IN, OUT, group_in, ctypes.addressof(bn), ctypes.addressof(gx),
        ctypes.addressof(gy))
    if splits <= 0:
        raise ValueError(f"the kernel takes no plan for T={T}, "
                         f"[{IN}, {OUT}], group_in={group_in}")
    return bn.value, splits, (gx.value, gy.value)


def _check_cuda_args(x2: torch.Tensor, w: QuantInt4) -> None:
    for name, t in (("x", x2), ("q", w.q), ("scale", w.scale)):
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x2.dtype}")
    if w.q.dtype != torch.int8 or w.scale.dtype != torch.float32:
        raise TypeError(f"q must be int8 and scale float32, got "
                        f"{w.q.dtype}/{w.scale.dtype}")
    IN = x2.shape[1]
    if w.q.dim() != 2 or w.q.shape[0] != IN:
        raise ValueError(f"q must be [IN={IN}, OUT/2], got "
                         f"{tuple(w.q.shape)}")
    OUT = w.q.shape[1] * 2
    if not int4_supported(IN, OUT, w.group_in, w.block_out):
        raise ValueError(f"[{IN}, {OUT}] does not tile group_in="
                         f"{w.group_in} x block_out={w.block_out}")
    if w.group_in > 512 or w.block_out not in (256, 512):
        raise ValueError(f"the kernel takes group_in <= 512 and block_out "
                         f"256/512, got {w.group_in}/{w.block_out}")
    if tuple(w.scale.shape) != (IN // w.group_in, OUT):
        raise ValueError(f"scale must be [{IN // w.group_in}, {OUT}], got "
                         f"{tuple(w.scale.shape)}")
    # The kernel reads x and q through TMA: 16-byte aligned bases and row
    # strides that are multiples of 16 bytes.
    if x2.data_ptr() % 16 or w.q.data_ptr() % 16 or w.scale.data_ptr() % 16:
        raise ValueError("x, q and scale must be 16-byte aligned")
    if (x2.stride(0) * x2.element_size()) % 16 or w.q.stride(0) % 16:
        raise ValueError(f"the rows of x ({x2.stride(0)} values) and q "
                         f"({w.q.stride(0)} bytes) must be multiples of 16 "
                         f"bytes apart")


def qmatmul4(x: torch.Tensor, w: QuantInt4) -> torch.Tensor:
    """``x @ w`` for a packed int4 weight; x [..., IN], any leading dims.
    CPU tensors take the plain version; CUDA tensors launch the Hopper
    kernel (bf16 x, a 2-D contiguous layer slice of the payload, a
    tileable format, 16-byte aligned rows for its TMA copies) and raise
    on anything else: one launch, whose contraction split (a cluster's
    size, kept per shape) the kernel's own plan gives; no workspace."""
    if x.device.type == "cpu":
        return qmatmul4_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"qmatmul4 runs on cuda or cpu, not {x.device}")
    *lead, IN = x.shape
    T = 1
    for d in lead:
        T *= d
    x2 = x.reshape(T, IN)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    _check_cuda_args(x2, w)
    OUT = w.q.shape[1] * 2
    lib = _lib()
    out = torch.empty((T, OUT), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        # The plan asks the current device how many clusters fit at once.
        splits = split_plan(T, IN, OUT, w.group_in)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int4_matmul_bf16(
            x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(),
            out.data_ptr(), T, IN, OUT, w.group_in, w.block_out, splits,
            stream)
    if err != 0:
        msg = lib.int4_matmul_error_string(err).decode()
        raise RuntimeError(f"int4 matmul kernel launch failed: {msg} "
                           f"(cudaError {err})")
    qmatmul4.launches += 1
    return out.reshape(*lead, OUT)


qmatmul4.launches = 0


# ------------------------------------------------- param-tree quantizers

def quantize_params_int4(params: Dict[str, Any],
                         quantize_embed: bool = False) -> Dict[str, Any]:
    """Quantize the projection weights of an ``init_params`` tree to
    packed int4; leaves that don't tile the format fall back to
    per-channel int8 (``qmatmul`` dispatches per leaf). The embedding,
    when quantized, is per-row int8."""
    from .quant import _QUANT_KEYS, quantize_embed_int8, quantize_int8

    def q4_or_q8(w):
        # MoE expert stacks (rank 4) stay int8, as in the JAX package:
        # the int4 kernel serves 2-D slices, parallel/moe.py int8 ones.
        fmt = (pick_format(w.shape[-2], w.shape[-1])
               if w.dim() <= 3 else None)
        if fmt is None:
            return quantize_int8(w)
        return quantize_int4(w, group_in=fmt[0], block_out=fmt[1])

    out = dict(params)
    layers = dict(params["layers"])
    for key in _QUANT_KEYS:
        if key in layers and layers[key].dim() in (3, 4):
            layers[key] = q4_or_q8(layers[key])
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = q4_or_q8(params["lm_head"])
    if quantize_embed:
        out["embed"] = quantize_embed_int8(params["embed"])
    return out


def random_params_int4(generator: torch.Generator, cfg, dtype=None,
                       quantize_embed: bool = False,
                       device: Optional[torch.device] = None):
    """Random-init a tree directly in packed int4 form on ``device`` (the
    twin of ``ops/quant.py::random_params_int8``): uniform random bytes,
    scales at the init magnitude, non-tileable leaves int8."""
    from .quant import random_params_int8

    return random_params_int8(generator, cfg, dtype=dtype,
                              quantize_embed=quantize_embed, int4=True,
                              device=device)
