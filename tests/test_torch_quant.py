"""The port's weight quantization against the JAX package's
``ops/quant.py`` and ``ops/quant4.py``, on the CPU.

- ``quantize_int4`` packs the same bytes as JAX's (exact), at every
  format the kernel takes, stacked leaves included; unpacking and
  dequantizing agree exactly, and weights whose columns differ by
  construction pin the nibble layout (column j low, j + block_out/2
  high — not interleaved pairs).
- ``qmatmul4_plain`` matches the Pallas kernel in interpret mode (as
  ``tests/test_quant4.py`` runs it) at formats 512/512 and 256/256 with
  T in {1, 5, 64}, and at the kernel's path edges (T 8, 9, 65; format
  128/256 too): float32 within 1e-5 (summation order only), bf16 within
  one bf16 ulp of the output (2e-2 relative).
- The int8 leaves (``quantize_int8``, ``embed_lookup``, ``tied_head``,
  ``qmatmul``) match exactly or to float32 round-off (1e-5).
- ``quantize_params_int4`` / ``random_params_int4`` give the JAX tree's
  structure, leaf types, shapes, dtypes and formats.

The CUDA kernel is held against ``qmatmul4_plain`` on the card by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.models import transformer as jt
from ai_agent_kubectl_tpu.ops import quant as jq
from ai_agent_kubectl_tpu.ops import quant4 as jq4
from ai_agent_kubectl_tpu_torch.models import config as tconfig
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.ops import quant as tq
from ai_agent_kubectl_tpu_torch.ops import quant4 as tq4

torch.set_num_threads(1)

F32 = dict(atol=1e-5, rtol=1e-5)


def _w(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.05
            ).astype(np.float32)


def _port_leaf(jleaf):
    """A JAX quantized leaf carried over as the port's (same bytes)."""
    tree = params_from_jax({"w": jax.tree.map(np.asarray, jleaf)})
    return tree["w"]


@pytest.mark.parametrize("shape,fmt", [
    ((512, 512), (512, 512)), ((512, 1024), (256, 256)),
    ((256, 768), (128, 256)), ((2, 512, 512), (256, 512))],
    ids=["512x512", "256x256", "128x256", "stacked"])
def test_quantize_int4_packs_jax_bytes(shape, fmt):
    w = _w(shape, 0)
    want = jq4.quantize_int4(jnp.asarray(w), *fmt)
    got = tq4.quantize_int4(torch.from_numpy(w), *fmt)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert (got.group_in, got.block_out) == fmt
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tq4.unpack_int4(got).numpy(),
                                  np.asarray(jq4.unpack_int4(want)))
    np.testing.assert_array_equal(
        tq4.dequantize_int4(got, torch.float32).numpy(),
        np.asarray(jq4.dequantize_int4(want, jnp.float32)))


@pytest.mark.parametrize("block_out", [256, 512])
def test_nibble_layout_is_halves_not_pairs(block_out):
    """Row i >= 1, column o holds +-((o % 15) - 7) steps of one scale
    (row 0 holds 7 everywhere, so every column's scale is that step):
    exact in int4, and no two neighbouring columns alike. Unpacking must
    give every column back in place, the bytes must pair column j with
    column j + block_out/2, and a product with one-hot rows must pick
    whole weight rows in column order."""
    IN, OUT, step = 128, 2 * block_out, 0.01
    cols = (np.arange(OUT) % 15 - 7).astype(np.float32)
    sign = np.where(np.arange(IN) % 2, 1.0, -1.0)[:, None]
    steps = (sign * cols[None, :]).astype(np.float32)
    steps[0] = 7.0
    w = (steps * step).astype(np.float32)
    qw = tq4.quantize_int4(torch.from_numpy(w), 128, block_out)
    np.testing.assert_array_equal(tq4.unpack_int4(qw).numpy(),
                                  steps.astype(np.int8))
    half = block_out // 2
    vals = steps.astype(np.int8).view(np.uint8).astype(np.int32)
    want = (vals[1, :half] & 0xF) | ((vals[1, half:block_out] & 0xF) << 4)
    np.testing.assert_array_equal(qw.q.numpy().view(np.uint8)[1, :half],
                                  want.astype(np.uint8))
    x = np.zeros((3, IN), np.float32)
    x[0, 0] = x[1, 5] = x[2, 64] = 1.0
    y = tq4.qmatmul4_plain(torch.from_numpy(x), qw).numpy()
    np.testing.assert_allclose(y, w[[0, 5, 64]], **F32)


@pytest.mark.parametrize("T", [1, 5, 64])
@pytest.mark.parametrize("IN,OUT,fmt", [(512, 1024, (512, 512)),
                                        (512, 512, (256, 256))],
                         ids=["512x512", "256x256"])
def test_plain_matches_pallas_interpret(T, IN, OUT, fmt):
    w = _w((IN, OUT), 1)
    x = _w((T, IN), 2)
    jw = jq4.quantize_int4(jnp.asarray(w), *fmt)
    want = np.asarray(jq4.qmatmul4_interpret(jnp.asarray(x), jw))
    tw = _port_leaf(jw)
    got = tq4.qmatmul4(torch.from_numpy(x), tw)       # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, **F32)


# The kernel's path edges (T 8 | 9: the GEMV and the tiled path; 40, 48:
# token tiles of round_up(T, 8), no power of two; 64 | 65 and 128 | 129:
# the token tile of 128 and its second tile) at the format with the most
# groups a row and at 512/512.
@pytest.mark.parametrize("T,IN,OUT,fmt", [
    (8, 256, 768, (128, 256)), (9, 256, 768, (128, 256)),
    (65, 256, 768, (128, 256)), (9, 512, 1024, (512, 512)),
    (65, 512, 1024, (512, 512)),
    (40, 512, 1024, (512, 512)), (48, 512, 1024, (512, 512)),
    (128, 512, 1024, (512, 512)), (129, 512, 1024, (512, 512)),
    (40, 256, 768, (128, 256)), (48, 256, 768, (128, 256)),
    (128, 256, 768, (128, 256)), (129, 256, 768, (128, 256))],
    ids=["128x256_T8", "128x256_T9", "128x256_T65", "512x512_T9",
         "512x512_T65", "512x512_T40", "512x512_T48", "512x512_T128",
         "512x512_T129", "128x256_T40", "128x256_T48", "128x256_T128",
         "128x256_T129"])
def test_plain_matches_pallas_interpret_at_path_edges(T, IN, OUT, fmt):
    w = _w((IN, OUT), 5)
    x = _w((T, IN), 6)
    jw = jq4.quantize_int4(jnp.asarray(w), *fmt)
    want = np.asarray(jq4.qmatmul4_interpret(jnp.asarray(x), jw))
    got = tq4.qmatmul4(torch.from_numpy(x), _port_leaf(jw))
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_plain_matches_pallas_interpret_bf16():
    w = _w((512, 1024), 3)
    x = _w((5, 512), 4)
    jw = jq4.quantize_int4(jnp.asarray(w))
    want = jq4.qmatmul4_interpret(jnp.asarray(x, jnp.bfloat16), jw)
    assert want.dtype == jnp.bfloat16
    got = tq4.qmatmul4_plain(torch.from_numpy(x).to(torch.bfloat16),
                             _port_leaf(jw))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-3, rtol=2e-2)


def test_int8_leaves_match_jax():
    w = _w((3, 64, 96), 5)
    want = jq.quantize_int8(jnp.asarray(w))
    got = tq.quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tq.dequantize(got, torch.float32).numpy(),
                                  np.asarray(jq.dequantize(want,
                                                           jnp.float32)))
    x = _w((4, 64), 6)
    leaf = _port_leaf(want)
    np.testing.assert_allclose(
        tq.qmatmul(torch.from_numpy(x), leaf[1]).numpy(),
        np.asarray(jq.qmatmul(jnp.asarray(x),
                              jq.QuantInt8(q=want.q[1],
                                           scale=want.scale[1]))), **F32)

    emb = _w((300, 64), 7)
    jemb = jq.quantize_embed_int8(jnp.asarray(emb), chunk=128)
    temb = tq.quantize_embed_int8(torch.from_numpy(emb), chunk=128)
    np.testing.assert_array_equal(temb.q.numpy(), np.asarray(jemb.q))
    np.testing.assert_array_equal(temb.scale.numpy(), np.asarray(jemb.scale))
    tokens = np.array([[0, 5, 299], [17, 17, 2]], np.int32)
    np.testing.assert_array_equal(
        tq.embed_lookup(temb, torch.from_numpy(tokens),
                        dtype=torch.float32).numpy(),
        np.asarray(jq.embed_lookup(jemb, jnp.asarray(tokens),
                                   dtype=jnp.float32)))
    h = _w((2, 1, 64), 8)
    np.testing.assert_allclose(
        tq.tied_head(torch.from_numpy(h), temb).numpy(),
        np.asarray(jq.tied_head(jnp.asarray(h), jemb)), **F32)
    np.testing.assert_allclose(
        tq.tied_head(torch.from_numpy(h), torch.from_numpy(emb)).numpy(),
        np.asarray(jq.tied_head(jnp.asarray(h), jnp.asarray(emb))), **F32)


def _describe(tree):
    """{path: (kind, shape, dtype, format)} of a JAX or port tree."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, val in node.items():
                walk(val, f"{path}{key}/")
            return
        q = getattr(node, "q", None)
        if q is None:
            out[path] = ("plain", tuple(node.shape), str(node.dtype))
            return
        scale = node.scale
        kind = "int4" if hasattr(node, "group_in") else "int8"
        fmt = ((node.group_in, node.block_out) if kind == "int4" else None)
        out[path] = (kind, tuple(q.shape), str(q.dtype).split(".")[-1],
                     tuple(scale.shape), str(scale.dtype).split(".")[-1],
                     fmt)
    walk(tree, "")
    return out


def _norm_dtypes(desc):
    return {k: tuple(str(x).replace("torch.", "") for x in v)
            for k, v in desc.items()}


@pytest.mark.parametrize("overrides", [
    dict(head_dim=128),
    dict(dim=512, n_heads=4, head_dim=128, n_kv_heads=2, mlp_hidden=512)],
    ids=["toy-8m-hd128", "int4-toy"])
def test_quantized_trees_match_jax(overrides):
    jcfg = jconfig.get_config("toy-8m", **overrides)
    tcfg = tconfig.get_config("toy-8m", **overrides)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    jtree = jq4.quantize_params_int4(jparams, quantize_embed=True)
    ttree = tq4.quantize_params_int4(
        params_from_jax(jax.tree.map(np.asarray, jparams), tcfg),
        quantize_embed=True)
    assert _norm_dtypes(_describe(ttree)) == _norm_dtypes(
        _describe(jax.tree.map(np.asarray, jtree)))
    # Same bytes, not only the same structure.
    for key, leaf in jtree["layers"].items():
        if hasattr(leaf, "q"):
            np.testing.assert_array_equal(ttree["layers"][key].q.numpy(),
                                          np.asarray(leaf.q))
    # The random init in packed form: the JAX twin's structure exactly.
    jrand = jq4.random_params_int4(jax.random.PRNGKey(1), jcfg,
                                   dtype=jnp.float32, quantize_embed=True)
    trand = tq4.random_params_int4(torch.Generator().manual_seed(1), tcfg,
                                   dtype=torch.float32, quantize_embed=True)
    assert _norm_dtypes(_describe(trand)) == _norm_dtypes(
        _describe(jax.tree.map(np.asarray, jrand)))
    q = trand["layers"]["wq"]
    assert isinstance(q, tq4.QuantInt4)
    assert int(q.q.min()) >= -127 and int(q.q.max()) <= 127
    jrand8 = jq.random_params_int8(jax.random.PRNGKey(1), jcfg,
                                   dtype=jnp.float32)
    trand8 = tq.random_params_int8(torch.Generator().manual_seed(1), tcfg,
                                   dtype=torch.float32)
    assert _norm_dtypes(_describe(trand8)) == _norm_dtypes(
        _describe(jax.tree.map(np.asarray, jrand8)))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    w = tq4.quantize_int4(torch.from_numpy(_w((512, 512), 9)))
    x = torch.zeros((3, 512), dtype=torch.bfloat16)
    tq4._check_cuda_args(x, w)                         # accepted
    with pytest.raises(TypeError, match="bfloat16"):
        tq4._check_cuda_args(x.float(), w)
    with pytest.raises(ValueError, match="IN"):
        tq4._check_cuda_args(torch.zeros((3, 256), dtype=torch.bfloat16), w)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tq4.qmatmul4(x.to("meta"), w)
    before = tq4.qmatmul4.launches
    tq4.qmatmul4(x, w)                                 # CPU: no launch
    assert tq4.qmatmul4.launches == before
