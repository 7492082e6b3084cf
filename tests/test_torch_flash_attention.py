"""The port's flash attention against the JAX package's Pallas kernel,
which runs here in interpret mode (as ``tests/test_flash_attention.py``
runs it), at that suite's cases: MHA, GQA, MQA, a short sequence, offset
positions from a prefix splice, softcap and bf16 I/O — plus rows with no
visible key (exact zeros), positions past KVLEN (a padded bucket tail)
and a strided ``cache[:, :kv_limit]`` view.

On the CPU the wrapper takes the plain version, because the tensors lie
on the CPU. Tolerances: float32 within 2e-5 (round-off over a softmax,
the JAX suite's own bound); bf16 within 2e-2 (both round the
probabilities to bf16 before P.V, at running maxima that differ between
the tiled and the one-pass softmax). The CUDA kernel is held against the
plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.ops import flash_attention as jfa
from ai_agent_kubectl_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=2e-5)


def _case(B, S, KVLEN, H, KV, hd, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, hd)) * scale).astype(np.float32)
    k = (rng.standard_normal((B, KVLEN, KV, hd)) * scale).astype(np.float32)
    v = rng.standard_normal((B, KVLEN, KV, hd)).astype(np.float32)
    return q, k, v


def _both(q, k, v, positions, **kw):
    want = np.asarray(jfa.flash_attention_cached(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(positions), **kw))
    got = tfa.flash_attention_cached(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(positions), **kw).numpy()
    return got, want


def _arange(B, S, offset=0):
    return np.ascontiguousarray(
        np.broadcast_to(np.arange(S) + offset, (B, S)), dtype=np.int32)


@pytest.mark.parametrize("B,S,KVLEN,H,KV,hd", [
    (1, 128, 128, 4, 4, 64),     # MHA
    (2, 128, 256, 4, 2, 64),     # GQA, kv longer than q block
    (1, 256, 256, 8, 1, 64),     # MQA
    (2, 64, 64, 4, 2, 128),      # small seq < block_q
])
def test_plain_matches_jax_kernel(B, S, KVLEN, H, KV, hd):
    q, k, v = _case(B, S, KVLEN, H, KV, hd, seed=0)
    got, want = _both(q, k, v, _arange(B, S))
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("S,KVLEN,H,KV,offset", [
    (72, 128, 8, 2, 0),      # 288 rows per KV head: four full 64-row
                             # tiles and a part one, G = 4
    (200, 256, 4, 4, 13),    # three full tiles and a part one, MHA
    (136, 136, 8, 2, 0),     # keys end 8 past a 128-key (two-split) edge
    (56, 64, 4, 1, 30),      # the tail runs past KVLEN; MQA
    (24, 128, 8, 2, -3),     # G = 4; the first three columns see no key
], ids=["s72_gqa4", "s200_mha", "kv136_gqa4", "s56_tail_mqa",
        "s24_no_key_gqa4"])
def test_plain_matches_jax_kernel_at_tile_edges(S, KVLEN, H, KV, offset):
    """The Hopper kernel's tile and split edges (64-row tiles over the
    G query heads of a KV head, keys split in multiples of 64): row
    counts that are no multiple of 64, keys that end just past a split
    edge, positions past KVLEN and before slot 0."""
    q, k, v = _case(1, S, KVLEN, H, KV, 64, seed=S + KVLEN)
    got, want = _both(q, k, v, _arange(1, S, offset))
    np.testing.assert_allclose(got, want, **F32)
    if offset < 0:
        assert np.all(got[:, :-offset] == 0.0)


@pytest.mark.parametrize("offset", [37, 85], ids=["prefix37", "tail85"])
def test_offset_positions(offset):
    """Queries at absolute positions offset.. over a cache whose first
    slots hold a spliced prefix; at 85 the bucket's padded tail runs past
    KVLEN (the kernel must clamp, never read past the cache)."""
    q, k, v = _case(1, 128, 128 if offset == 85 else 256, 4, 2, 64, seed=1)
    got, want = _both(q, k, v, _arange(1, 128, offset))
    np.testing.assert_allclose(got, want, **F32)


def test_logit_softcap():
    q, k, v = _case(1, 128, 128, 2, 2, 64, seed=2, scale=3.0)
    got, want = _both(q, k, v, _arange(1, 128), logit_softcap=30.0)
    np.testing.assert_allclose(got, want, **F32)


def test_bf16_io():
    q, k, v = _case(1, 128, 128, 4, 2, 64, seed=3)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    pos = _arange(1, 128)
    want = jfa.flash_attention_cached(*bf, jnp.asarray(pos))
    assert want.dtype == jnp.bfloat16
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = tfa.flash_attention_cached(*tb, torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_rows_with_no_visible_key_are_zeros():
    q, k, v = _case(2, 64, 128, 4, 2, 128, seed=4)
    pos = _arange(2, 64, -3)           # rows 0..2 sit before slot 0
    got, want = _both(q, k, v, pos)
    np.testing.assert_allclose(got, want, **F32)
    assert np.all(got[:, :3] == 0.0) and np.all(want[:, :3] == 0.0)
    assert np.all(np.abs(got[:, 3:]).sum(-1) > 0)


def test_strided_cache_view():
    """The engine hands the kernel ``cache[:, :kv_limit]``: a view with
    the cache's batch stride, read in place."""
    q, _, _ = _case(2, 64, 128, 4, 2, 128, seed=5)
    cache_k = torch.from_numpy(_case(2, 1, 257, 1, 2, 128, seed=6)[1])
    cache_v = torch.from_numpy(_case(2, 1, 257, 1, 2, 128, seed=7)[1])
    k_view, v_view = cache_k[:, :128], cache_v[:, :128]
    assert not k_view.is_contiguous()
    pos = _arange(2, 64, 30)
    got = tfa.flash_attention_cached(torch.from_numpy(q), k_view, v_view,
                                     torch.from_numpy(pos)).numpy()
    want = np.asarray(jfa.flash_attention_cached(
        jnp.asarray(q), jnp.asarray(k_view.numpy()),
        jnp.asarray(v_view.numpy()), jnp.asarray(pos)))
    np.testing.assert_allclose(got, want, **F32)
    bf = [t.to(torch.bfloat16) for t in (torch.from_numpy(q),)]
    ck, cv = cache_k.to(torch.bfloat16), cache_v.to(torch.bfloat16)
    tfa._check_cuda_args(bf[0], ck[:, :128], cv[:, :128],
                         torch.from_numpy(pos))           # accepted
    heads_major = torch.zeros((2, 2, 128, 128),
                              dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="inner"):
        tfa._check_cuda_args(bf[0], heads_major, heads_major,
                             torch.from_numpy(pos))
    with pytest.raises(TypeError, match="int32"):
        tfa._check_cuda_args(bf[0], ck[:, :128], cv[:, :128],
                             torch.from_numpy(pos).long())
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_cached(bf[0].to("meta"), ck.to("meta"),
                                   cv.to("meta"),
                                   torch.from_numpy(pos).to("meta"))


def test_flash_supported_is_the_jax_gate():
    for s in (8, 32, 64, 85, 100, 128, 192, 256, 512, 600, 1024):
        for kv in (64, 128, 256, 384, 1024):
            for hd in (64, 128, 256):
                assert (tfa.flash_supported(s, kv, hd)
                        == jfa.flash_supported(s, kv, hd)), (s, kv, hd)


def test_cpu_path_counts_no_launch():
    q, k, v = _case(1, 64, 64, 4, 2, 64, seed=8)
    before = tfa.flash_attention_cached.launches
    tfa.flash_attention_cached(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               torch.from_numpy(_arange(1, 64)))
    assert tfa.flash_attention_cached.launches == before
