"""The port's HF checkpoint loader (``models/convert.py::
convert_hf_checkpoint``) against the JAX package's on the same files.

Tiny Llama, Gemma and Mixtral (4 experts, 2 routed per token)
checkpoints are written in the test with ``transformers``
(``save_pretrained``, safetensors), at widths that make ``pick_format``
tile some projections and fall back to int8 on others (dim 256, 4 heads
of 64, MLP 512, vocab 128), and loaded on the CPU by both packages:

- Every leaf of the port's tree equals ``params_from_jax`` of the JAX
  tree exactly: float32 and bfloat16, and the int8/int4 payloads and
  scales bit for bit (per-row int8 embedding included).
- The port's forward over the loaded float32 params matches the
  ``transformers`` model's logits within the JAX test's tolerance
  (``rtol=1e-3, atol=2e-3``), with the same argmax everywhere.
- Mixtral's router stays in full precision and its expert stacks load
  int8 under int8 and int4 alike, as in JAX.
- A shape mismatch is refused with the JAX message, and so is an MoE
  checkpoint read with more experts than it holds; the streamed
  quantizing load equals quantizing the full load afterwards; the
  ``model.`` prefix is optional and a missing ``lm_head`` ties to the
  embedding, as in JAX; the reader returns what ``safetensors`` reads,
  over one file or shards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.models.config import ModelConfig as JaxModelConfig
from ai_agent_kubectl_tpu.models.convert import \
    convert_hf_checkpoint as jax_convert
from ai_agent_kubectl_tpu_torch.models.config import ModelConfig
from ai_agent_kubectl_tpu_torch.models.convert import (
    _open_checkpoint, convert_hf_checkpoint, params_from_jax)
from ai_agent_kubectl_tpu_torch.models.transformer import KVCache, forward
from ai_agent_kubectl_tpu_torch.ops.quant import (QuantInt8,
                                                  quantize_params_int8)
from ai_agent_kubectl_tpu_torch.ops.quant4 import (QuantInt4,
                                                   quantize_params_int4)

transformers = pytest.importorskip("transformers")
safetensors_numpy = pytest.importorskip("safetensors.numpy")

TINY = dict(vocab_size=128, dim=256, n_layers=2, n_heads=4, head_dim=64,
            mlp_hidden=512)
ARCHS = {
    "llama": dict(n_kv_heads=2, rope_theta=10000.0, rms_eps=1e-5),
    "gemma": dict(n_kv_heads=1, rms_offset=1.0, activation="gelu",
                  tie_embeddings=True, embed_scale=True),
    "mixtral": dict(n_kv_heads=2, rope_theta=10000.0, rms_eps=1e-5,
                    n_experts=4, experts_per_token=2),
}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (dtype, quant): quantized loads keep float32 for the non-quantized
# leaves and store the embedding per-row int8.
MODES = [(torch.float32, ""), (torch.bfloat16, ""),
         (torch.float32, "int8"), (torch.float32, "int4")]


def _configs(arch: str):
    kw = dict(TINY, **ARCHS[arch])
    return (ModelConfig(name=f"tiny-{arch}", **kw),
            JaxModelConfig(name=f"tiny-{arch}", **kw))


def _save_hf(path, arch: str, seed: int = 0):
    """A random-init tiny HF model saved as safetensors; returns it."""
    common = dict(vocab_size=TINY["vocab_size"], hidden_size=TINY["dim"],
                  intermediate_size=TINY["mlp_hidden"],
                  num_hidden_layers=TINY["n_layers"],
                  num_attention_heads=TINY["n_heads"],
                  head_dim=TINY["head_dim"], rope_theta=10000.0)
    if arch == "llama":
        hf_cfg = transformers.LlamaConfig(
            num_key_value_heads=2, rms_norm_eps=1e-5,
            tie_word_embeddings=False, attention_bias=False,
            mlp_bias=False, **common)
        cls = transformers.LlamaForCausalLM
    elif arch == "mixtral":
        hf_cfg = transformers.MixtralConfig(
            num_key_value_heads=2, rms_norm_eps=1e-5,
            tie_word_embeddings=False, num_local_experts=4,
            num_experts_per_tok=2, **common)
        cls = transformers.MixtralForCausalLM
    else:
        hf_cfg = transformers.GemmaConfig(
            num_key_value_heads=1, rms_norm_eps=1e-6,
            hidden_act="gelu_pytorch_tanh", **common)
        cls = transformers.GemmaForCausalLM
    torch.manual_seed(seed)
    model = cls(hf_cfg).eval().to(torch.float32)
    model.save_pretrained(path, safe_serialization=True)
    return model


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (QuantInt8, QuantInt4)):
        yield prefix + "q", tree.q
        yield prefix + "scale", tree.scale
    else:
        yield prefix.rstrip("/"), tree


def _assert_same_tree(ours, want):
    a, b = dict(_leaves(ours)), dict(_leaves(want))
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert a[key].shape == b[key].shape, key
        assert torch.equal(a[key], b[key]), key
    for key in ("wq", "w_gate", "w_down"):
        assert type(ours["layers"][key]) is type(want["layers"][key]), key


@pytest.mark.parametrize("dtype,quant", MODES,
                         ids=["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_convert_matches_jax_leaf_for_leaf(tmp_path, arch, dtype, quant):
    _save_hf(tmp_path, arch)
    cfg, jcfg = _configs(arch)
    ours = convert_hf_checkpoint(cfg, tmp_path, dtype=dtype, quant=quant,
                                 quantize_embed=bool(quant), device="cpu")
    jtree = jax_convert(jcfg, tmp_path, dtype=JAX_DTYPES[dtype],
                        quant=quant, quantize_embed=bool(quant))
    want = params_from_jax(jax.tree.map(np.asarray, jtree), cfg)
    _assert_same_tree(ours, want)
    if quant == "int4":
        # the format tiles some projections and not others
        assert isinstance(ours["layers"]["wq"], QuantInt4)
        assert isinstance(ours["layers"]["wk"], QuantInt8)
        assert isinstance(ours["embed"], QuantInt8)
    moe = arch == "mixtral"
    if quant:
        # MoE expert stacks stay int8 under int4, per (layer, expert)
        assert isinstance(ours["layers"]["w_gate"],
                          QuantInt8 if moe or quant == "int8" else QuantInt4)
    if moe:
        assert ours["layers"]["router"].dtype == dtype
        assert ours["layers"]["router"].shape == (2, 256, 4)
        assert ours["layers"]["w_down"].shape == (2, 4, 512, 256)


def _hf_logits(model, ids):
    with torch.no_grad():
        return model(torch.tensor([ids])).logits[0].numpy()


def _port_logits(cfg, params, ids):
    S = len(ids)
    tokens = torch.tensor([ids], dtype=torch.int32)
    positions = torch.arange(S, dtype=torch.int32)[None]
    cache = KVCache.zeros(cfg, 1, S, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        logits, _ = forward(params, cfg, tokens, positions, cache,
                            kv_limit=S)
    return logits[0].numpy()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_on_loaded_params_matches_transformers(tmp_path, arch):
    model = _save_hf(tmp_path, arch, seed=3)
    cfg, _ = _configs(arch)
    params = convert_hf_checkpoint(cfg, tmp_path, dtype=torch.float32,
                                   device="cpu")
    ids = [1, 17, 89, 5, 42, 77, 3]
    ours, hf = _port_logits(cfg, params, ids), _hf_logits(model, ids)
    np.testing.assert_allclose(ours, hf, rtol=1e-3, atol=2e-3)
    assert np.array_equal(ours.argmax(-1), hf.argmax(-1))


def test_shape_mismatch_refused_with_the_jax_message(tmp_path):
    _save_hf(tmp_path, "llama")
    bad = dict(TINY, **ARCHS["llama"], n_heads=8)       # wrong heads
    with pytest.raises(ValueError, match="mismatch") as ours:
        convert_hf_checkpoint(ModelConfig(name="bad", **bad), tmp_path,
                              dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError) as want:
        jax_convert(JaxModelConfig(name="bad", **bad), tmp_path,
                    dtype=jnp.float32)
    assert str(ours.value) == str(want.value)


@pytest.mark.parametrize("quant,posthoc", [("int8", quantize_params_int8),
                                           ("int4", quantize_params_int4)])
def test_streaming_quantized_load_equals_posthoc(tmp_path, quant, posthoc):
    _save_hf(tmp_path, "llama")
    cfg, _ = _configs("llama")
    full = convert_hf_checkpoint(cfg, tmp_path, dtype=torch.float32,
                                 device="cpu")
    streamed = convert_hf_checkpoint(cfg, tmp_path, dtype=torch.float32,
                                     quant=quant, quantize_embed=True,
                                     device="cpu")
    _assert_same_tree(streamed, posthoc(full, quantize_embed=True))


def test_moe_checkpoint_refused(tmp_path):
    """A Mixtral checkpoint read under a config with more experts than
    it holds is refused, by both loaders, at the first missing expert."""
    _save_hf(tmp_path, "mixtral")
    kw = dict(TINY, **dict(ARCHS["mixtral"], n_experts=8))
    with pytest.raises(KeyError, match="experts.4.w1") as ours:
        convert_hf_checkpoint(ModelConfig(name="bad", **kw), tmp_path,
                              dtype=torch.float32, device="cpu")
    with pytest.raises(KeyError) as want:
        jax_convert(JaxModelConfig(name="bad", **kw), tmp_path,
                    dtype=jnp.float32)
    assert str(ours.value) == str(want.value)


def _rewrite(src, dst, keep):
    """Copy a checkpoint's tensors into ``dst`` as shards of a few
    tensors each, keys renamed by ``keep`` (None drops a tensor)."""
    tensors = {}
    for key, arr in safetensors_numpy.load_file(
            str(src / "model.safetensors")).items():
        new = keep(key)
        if new is not None:
            tensors[new] = arr
    dst.mkdir()
    names = sorted(tensors)
    for i in range(0, len(names), 5):
        safetensors_numpy.save_file(
            {k: tensors[k] for k in names[i:i + 5]},
            str(dst / f"shard-{i // 5:03d}.safetensors"))
    return tensors


def test_reader_agrees_with_safetensors_over_shards(tmp_path):
    _save_hf(tmp_path / "hf", "llama")
    written = _rewrite(tmp_path / "hf", tmp_path / "shards",
                       lambda k: k)
    get, keys = _open_checkpoint(tmp_path / "shards")
    assert sorted(keys) == sorted(written)
    for key, arr in written.items():
        got = get(key)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), arr)
    # One file, read the same way.
    get1, keys1 = _open_checkpoint(tmp_path / "hf" / "model.safetensors")
    assert sorted(keys1) == sorted(written)
    with pytest.raises(FileNotFoundError):
        _open_checkpoint(tmp_path / "empty-dir-does-not-exist")


def test_prefix_optional_and_missing_head_ties_like_jax(tmp_path):
    """Keys without ``model.`` and no ``lm_head.weight`` on an untied
    model: both packages tie the head to the embedding (with a
    warning), the port's tree equals the JAX one in float32 and int4,
    and the plain head is the transposed embedding."""
    _save_hf(tmp_path / "hf", "llama")
    _rewrite(tmp_path / "hf", tmp_path / "bare",
             lambda k: None if k == "lm_head.weight"
             else k.removeprefix("model."))
    cfg, jcfg = _configs("llama")
    for quant in ("", "int4"):
        ours = convert_hf_checkpoint(cfg, tmp_path / "bare",
                                     dtype=torch.float32, quant=quant,
                                     quantize_embed=bool(quant),
                                     device="cpu")
        jtree = jax_convert(jcfg, tmp_path / "bare", dtype=jnp.float32,
                            quant=quant, quantize_embed=bool(quant))
        _assert_same_tree(ours, params_from_jax(
            jax.tree.map(np.asarray, jtree), cfg))
        if not quant:
            assert torch.equal(ours["lm_head"], ours["embed"].T)
            bare = ours
    prefixed = convert_hf_checkpoint(cfg, tmp_path / "hf",
                                     dtype=torch.float32, device="cpu")
    for key in ("wq", "w_down", "attn_norm"):
        assert torch.equal(prefixed["layers"][key], bare["layers"][key])
