"""Parameter conversion into the port's tree.

``convert_hf_checkpoint`` loads a HuggingFace Llama, Gemma or Mixtral
checkpoint (``*.safetensors``, one file or a directory of shards) onto
the serving device, the counterpart of the JAX package's
``models/convert.py``: HF ``[out, in]`` projections are transposed,
per-layer tensors stacked on a leading ``n_layers`` axis, the ``model.``
prefix is optional, and an untied ``lm_head`` comes from the file or is
tied to the embedding. Mixtral's ``block_sparse_moe.gate`` becomes the
full-precision ``router`` [L, D, E] and ``experts.{e}.w1/w3/w2`` the
expert stacks ``w_gate``/``w_up`` [L, E, D, F] and ``w_down`` [L, E, F,
D], int8 per (layer, expert, out-channel) under either ``quant``. The
load streams: one layer's (or one expert's) slice of a leaf at a time
goes to the device (and, under ``quant``, is quantized there and freed),
written into the preallocated stacked leaf, so the full-precision tree
never exists whole on the device. The files are read with
``safetensors.safe_open(framework="pt")``: the package imports on the
card's machine as on the CPU test machines, so the port keeps no reader
of its own.

``params_from_jax`` maps the JAX package's parameter tree (the dict
``ai_agent_kubectl_tpu/models/transformer.py::init_params`` returns,
or its int8/int4-quantized form, with every array converted to numpy)
onto the port's tree: the same keys, shapes and values, as torch
tensors. A quantized leaf (an object with ``q`` and ``scale`` arrays —
and ``group_in``/``block_out`` for packed int4) becomes the port's
``QuantInt8``/``QuantInt4`` holding the same bytes. With it both
packages compute the same function, which is what the parity tests
hold them to.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.quant import QuantInt8, quantize_embed_int8, quantize_int8
from ..ops.quant4 import QuantInt4, pick_format, quantize_int4
from .config import ModelConfig
from .transformer import Params

logger = logging.getLogger(__name__)

#: embedding rows quantized per device transfer under quantize_embed
#: (bounds the f32 transient; the result is per row, so any chunk gives
#: the same bytes)
EMBED_CHUNK_ROWS = 8192


def _open_checkpoint(path) -> Tuple[Callable[[str], torch.Tensor],
                                    List[str]]:
    """(tensor getter, key list) over one or many .safetensors files; the
    getter returns a CPU tensor in the file's dtype."""
    from safetensors import safe_open

    path = Path(path)
    files = sorted(path.glob("*.safetensors")) if path.is_dir() else [path]
    if not files:
        raise FileNotFoundError(f"No .safetensors files under {path}")
    index: Dict[str, Any] = {}
    for f in files:
        handle = safe_open(str(f), framework="pt")
        for key in handle.keys():
            index[key] = handle
    keys = list(index)

    def get(key: str) -> torch.Tensor:
        return index[key].get_tensor(key)

    return get, keys


def checkpoint_version(path) -> str:
    """12-hex fingerprint of a checkpoint path: the path string plus a
    manifest of its files (relative name, size, mtime), as the JAX
    package versions its weights; no tensor data is read. A path that
    does not exist still versions deterministically (a dev sentinel or
    a random init keyed on the path), and None versions as ""."""
    p = str(path or "")
    h = hashlib.sha256(p.encode("utf-8", "surrogatepass"))
    try:
        if p and os.path.isdir(p):
            for root, _dirs, files in sorted(os.walk(p)):
                for name in sorted(files):
                    full = os.path.join(root, name)
                    st = os.stat(full)
                    h.update(f"{os.path.relpath(full, p)}:{st.st_size}:"
                             f"{st.st_mtime_ns}".encode())
        elif p and os.path.isfile(p):
            st = os.stat(p)
            h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
    except OSError:  # pragma: no cover - racing filesystem change
        pass
    return h.hexdigest()[:12]


def _stacked_like(leaf, lead: Tuple[int, ...]):
    """An empty ``lead + leaf.shape`` stack for per-layer (or per-layer,
    per-expert) leaves shaped like ``leaf`` (a tensor, or a quantized
    leaf's ``q`` and ``scale``)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.new_empty(lead + tuple(leaf.shape))
    return dataclasses.replace(leaf, **{
        f: getattr(leaf, f).new_empty(lead + tuple(getattr(leaf, f).shape))
        for f in ("q", "scale")})


def _put(stack, index, leaf) -> None:
    """Copy ``leaf`` into ``stack[index]`` (an int or a tuple)."""
    if isinstance(leaf, torch.Tensor):
        stack[index].copy_(leaf)
    else:
        for f in ("q", "scale"):
            getattr(stack, f)[index].copy_(getattr(leaf, f))


def convert_hf_checkpoint(cfg: ModelConfig, path, dtype=torch.bfloat16,
                          quant: str = "", quantize_embed: bool = False,
                          device: DeviceLike = None) -> Params:
    """Load an HF checkpoint directory or file into the port's tree on
    ``device`` (``cuda`` unless the caller asks for the CPU).

    ``quant`` ("" | "int8" | "int4") quantizes each projection during
    the load, one layer's slice at a time, with the port's
    ``quantize_int8``/``quantize_int4``; int4 falls back per leaf to
    int8 where ``pick_format`` cannot tile the shape. MoE expert slices
    quantize one (layer, expert) at a time, int8 under either ``quant``.
    ``quantize_embed`` (with ``quant``) stores the embedding per-row
    int8, quantized in row chunks. The result equals ``params_from_jax``
    of the JAX function's output on the same file, leaf for leaf."""
    if quant not in ("", "int8", "int4"):
        raise ValueError(f"quant must be ''|int8|int4, got {quant!r}")
    dev = resolve_device(device)
    get, keys = _open_checkpoint(path)
    pfx = "model." if any(k.startswith("model.") for k in keys) else ""
    L = cfg.n_layers

    def load(key: str) -> torch.Tensor:
        return get(key).to(device=dev, dtype=dtype)

    def quantize_slice(w: torch.Tensor):
        """One layer's [in, out] projection slice -> its stored leaf."""
        if quant == "int4":
            fmt = pick_format(w.shape[-2], w.shape[-1])
            if fmt is not None:
                return quantize_int4(w, group_in=fmt[0], block_out=fmt[1])
            return quantize_int8(w)
        if quant == "int8":
            return quantize_int8(w)
        return w

    def stack(name: Callable[[int], str], projection: bool):
        """Layer by layer into one preallocated [L, ...] leaf; a
        projection is transposed to [in, out] and quantized first."""
        out = None
        for i in range(L):
            leaf = load(name(i))
            if projection:
                leaf = quantize_slice(leaf.T)
            if out is None:
                out = _stacked_like(leaf, (L,))
            _put(out, i, leaf)
        return out

    def expert_stack(part: str):
        """One MoE projection: every (layer, expert) ``[in, out]`` slice
        into one preallocated [L, E, ...] leaf, int8 under any
        ``quant`` (the JAX loader's ``eslice_q``)."""
        out = None
        for i in range(L):
            for e in range(cfg.n_experts):
                leaf = load(f"{pfx}layers.{i}.block_sparse_moe.experts."
                            f"{e}.{part}.weight").T
                if quant:
                    leaf = quantize_int8(leaf)
                if out is None:
                    out = _stacked_like(leaf, (L, cfg.n_experts))
                _put(out, (i, e), leaf)
        return out

    def lay(i: int, part: str) -> str:
        return f"{pfx}layers.{i}.{part}.weight"

    layers: Dict[str, Any] = {
        "attn_norm": stack(lambda i: lay(i, "input_layernorm"), False),
        "mlp_norm": stack(lambda i: lay(i, "post_attention_layernorm"),
                          False),
    }
    for leaf, part in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                       ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj")):
        layers[leaf] = stack(lambda i, part=part: lay(i, part), True)
    if cfg.is_moe:
        # The router, transposed to [D, E], stays in full precision.
        gate = stack(lambda i: lay(i, "block_sparse_moe.gate"), False)
        layers["router"] = gate.transpose(1, 2).contiguous()
        # experts.{e}.w1 = gate [F, D], w3 = up [F, D], w2 = down [D, F]
        for leaf, part in (("w_gate", "w1"), ("w_up", "w3"),
                           ("w_down", "w2")):
            layers[leaf] = expert_stack(part)
    else:
        for leaf, part in (("w_gate", "mlp.gate_proj"),
                           ("w_up", "mlp.up_proj"),
                           ("w_down", "mlp.down_proj")):
            layers[leaf] = stack(lambda i, part=part: lay(i, part), True)

    embed_key = f"{pfx}embed_tokens.weight"
    if quantize_embed and quant:
        host = get(embed_key)
        embed = None
        for r0 in range(0, host.shape[0], EMBED_CHUNK_ROWS):
            part = quantize_embed_int8(
                host[r0:r0 + EMBED_CHUNK_ROWS].to(device=dev, dtype=dtype))
            if embed is None:
                embed = QuantInt8(
                    q=part.q.new_empty((host.shape[0],) + part.q.shape[1:]),
                    scale=part.scale.new_empty((host.shape[0], 1)))
            embed.q[r0:r0 + len(part.q)].copy_(part.q)
            embed.scale[r0:r0 + len(part.q)].copy_(part.scale)
        del host
    else:
        embed = load(embed_key)

    params: Dict[str, Any] = {
        "embed": embed,
        "layers": layers,
        "final_norm": load(f"{pfx}norm.weight"),
    }
    if not cfg.tie_embeddings:
        if "lm_head.weight" in keys:
            head = load("lm_head.weight")
        else:
            logger.warning("lm_head.weight absent; tying to embeddings")
            # A per-row-quantized embedding has row scales, not column
            # ones: the head is read again in full precision then.
            head = embed if isinstance(embed, torch.Tensor) \
                else load(embed_key)
        params["lm_head"] = quantize_slice(head.T.contiguous())

    _validate_shapes(cfg, params)
    return params


def _validate_shapes(cfg: ModelConfig, params: Dict[str, Any]) -> None:
    d, hd, H, KV, L = (cfg.dim, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads,
                       cfg.n_layers)
    expect = {
        ("embed",): (cfg.vocab_size, d),
        ("final_norm",): (d,),
        ("layers", "wq"): (L, d, H * hd),
        ("layers", "wk"): (L, d, KV * hd),
        ("layers", "wv"): (L, d, KV * hd),
        ("layers", "wo"): (L, H * hd, d),
    }
    for keypath, shape in expect.items():
        node: Any = params
        for k in keypath:
            node = node[k]
        if tuple(node.shape) != shape:
            raise ValueError(
                f"Checkpoint/config mismatch at {'.'.join(keypath)}: "
                f"got {tuple(node.shape)}, expected {shape} for {cfg.name}"
            )


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
    """Leaf shapes of a model's tree, keyed like the tree (an MoE
    model's router and expert stacks included)."""
    d, hd, H, KV, F_, L = (cfg.dim, cfg.head_dim, cfg.n_heads,
                           cfg.n_kv_heads, cfg.mlp_hidden, cfg.n_layers)
    shapes = {
        "embed": (cfg.vocab_size, d),
        "final_norm": (d,),
        "layers": {
            "attn_norm": (L, d), "wq": (L, d, H * hd),
            "wk": (L, d, KV * hd), "wv": (L, d, KV * hd),
            "wo": (L, H * hd, d), "mlp_norm": (L, d),
        },
    }
    if cfg.is_moe:
        E = cfg.n_experts
        shapes["layers"].update(router=(L, d, E), w_gate=(L, E, d, F_),
                                w_up=(L, E, d, F_), w_down=(L, E, F_, d))
    else:
        shapes["layers"].update(w_gate=(L, d, F_), w_up=(L, d, F_),
                                w_down=(L, F_, d))
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
