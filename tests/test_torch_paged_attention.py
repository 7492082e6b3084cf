"""The port's paged decode attention against the JAX package's Pallas
kernels, which run here in interpret mode (as
``tests/test_paged_attention.py`` runs them).

On the CPU both wrappers take their plain PyTorch versions — because the
tensors lie on the CPU — so these tests hold those versions to the
reference: tolerance 2e-5 in float32 (round-off over a softmax, as the
JAX kernels' own tests use) and 2e-2 in bfloat16 (the two round the
probabilities at different places). The CUDA kernel is held against the
plain versions on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``, which skips without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged,
    paged_decode_attention_pool as jax_paged_pool)
from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
    _check_cuda_args, paged_decode_attention, paged_decode_attention_pool,
    paged_supported)

# Tiny shapes: one intra-op thread is as fast, and spares the suite's
# other workers the cores that idle OpenMP threads spin on.
torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
# MQA (Gemma-2B's grouping), GQA (Llama's), MHA (Gemma-7B's).
GROUPINGS = {"mqa": 1, "gqa": 2, "mha": 4}


def _dense_case(kv_heads, *, N=4, S=128, H=4, hd=64, page=16, seed=0,
                positions=(0, 15, 16, 77)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((N, H, hd)).astype(np.float32)
    k = rng.standard_normal((N, S, kv_heads, hd)).astype(np.float32)
    v = rng.standard_normal((N, S, kv_heads, hd)).astype(np.float32)
    return q, k, v, np.asarray(positions, np.int32), page


def _pool_case(kv_heads, *, seed=7):
    """The JAX suite's pool case: slots 0 and 1 share block 7 as their
    first page; dead pages carry the sentinel (10 = n_blocks), which
    clamps onto block 9 — filled with NaN, so only a clamp that reaches a
    live page could leak it."""
    rng = np.random.default_rng(seed)
    N, n_blocks, page, H, hd = 3, 10, 16, 4, 64
    q = rng.standard_normal((N, H, hd)).astype(np.float32)
    k = rng.standard_normal((n_blocks, page, kv_heads, hd)).astype(np.float32)
    v = rng.standard_normal((n_blocks, page, kv_heads, hd)).astype(np.float32)
    k[9] = np.nan
    v[9] = np.nan
    tables = np.array([[7, 2, 8, 10], [7, 5, 10, 10], [0, 1, 3, 4]],
                      np.int32)
    positions = np.array([40, 17, 63], np.int32)
    return q, k, v, positions, tables, page


def _t(*arrays, dtype=None):
    out = [torch.from_numpy(a) for a in arrays]
    if dtype is not None:
        out = [t.to(dtype) if t.is_floating_point() else t for t in out]
    return out


@pytest.mark.parametrize("kv_heads", list(GROUPINGS.values()),
                         ids=list(GROUPINGS))
def test_dense_plain_matches_jax_kernel(kv_heads):
    """Positions at 0 (one live key), page-1, page and mid-cache."""
    q, k, v, positions, page = _dense_case(kv_heads)
    want = np.asarray(jax_paged(q, k, v, positions, page_size=page,
                                interpret=True))
    got = paged_decode_attention(*_t(q, k, v, positions), page_size=page)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("positions", [(63, 64, 127, 128), (0, 191, 65, 62)],
                         ids=["on_and_past_split_edges", "span_ends"])
def test_gqa4_plain_matches_jax_kernels_at_split_edges(positions):
    """G = 4 (8 query heads over 2 KV heads) with live spans that end
    exactly on and just past a 64-key split edge, on the first key and on
    the span's last slot: the dense cache and the pool (each slot's pages
    on permuted blocks, the sentinel past them clamping onto a NaN
    block)."""
    q, k, v, pos, page = _dense_case(2, N=4, S=192, H=8, hd=64, seed=11,
                                     positions=positions)
    want = np.asarray(jax_paged(q, k, v, pos, page_size=page,
                                interpret=True))
    got = paged_decode_attention(*_t(q, k, v, pos), page_size=page)
    np.testing.assert_allclose(got.numpy(), want, **F32)

    n_pages = 192 // page
    n_blocks = 4 * n_pages + 1
    rng = np.random.default_rng(12)
    kp = rng.standard_normal((n_blocks, page, 2, 64)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, page, 2, 64)).astype(np.float32)
    kp[-1] = vp[-1] = np.nan
    perm = rng.permutation(n_blocks - 1).astype(np.int32)
    tables = np.full((4, n_pages), n_blocks + 2, np.int32)
    for n, p in enumerate(positions):
        live = p // page + 1
        tables[n, :live] = perm[n * n_pages:n * n_pages + live]
    want = np.asarray(jax_paged_pool(q, kp, vp, pos, tables, page_size=page,
                                     interpret=True))
    got = paged_decode_attention_pool(*_t(q, kp, vp, pos, tables),
                                      page_size=page).numpy()
    assert not np.isnan(got).any(), "a dead or NaN page leaked"
    np.testing.assert_allclose(got, want, **F32)


def test_dense_plain_full_cache_and_last_page():
    """Positions S-1 and S-page over a GQA cache."""
    q, k, v, positions, page = _dense_case(2, N=2, S=64, seed=1,
                                           positions=(63, 48))
    want = np.asarray(jax_paged(q, k, v, positions, page_size=page,
                                interpret=True))
    got = paged_decode_attention(*_t(q, k, v, positions), page_size=page)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("kv_heads", list(GROUPINGS.values()),
                         ids=list(GROUPINGS))
def test_pool_plain_matches_jax_kernel(kv_heads):
    q, k, v, positions, tables, page = _pool_case(kv_heads)
    want = np.asarray(jax_paged_pool(q, k, v, positions, tables,
                                     page_size=page, interpret=True))
    got = paged_decode_attention_pool(*_t(q, k, v, positions, tables),
                                      page_size=page).numpy()
    assert not np.isnan(got).any(), "a dead or NaN page leaked"
    np.testing.assert_allclose(got, want, **F32)


def test_bf16_inputs_match_jax_kernel():
    """bfloat16 q/k/v through both versions of each function, at
    Gemma-2B's head_dim 256 over one KV head (dense) and the GQA pool."""
    q, k, v, positions, page = _dense_case(1, N=2, S=64, H=4, hd=256,
                                           seed=2, positions=(33, 5))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_paged(*jb, positions, page_size=page,
                                interpret=True)).astype(np.float32)
    qt, kt, vt = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in jb]
    got = paged_decode_attention(qt, kt, vt, torch.from_numpy(positions),
                                 page_size=page)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)

    q, k, v, positions, tables, page = _pool_case(2, seed=3)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_paged_pool(*jb, positions, tables, page_size=page,
                                     interpret=True)).astype(np.float32)
    qt, kt, vt = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in jb]
    got = paged_decode_attention_pool(qt, kt, vt,
                                      *_t(positions, tables),
                                      page_size=page)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def test_rows_past_the_position_never_reach_the_output():
    """NaN right after each slot's position (inside its last live page)
    and in a strided view's trash row: the output equals the same call on
    a clean cache. The CUDA kernel reads no such row at all; the plain
    version selects them away."""
    q, k, v, positions, page = _dense_case(2)
    cache = np.zeros((2, 4, 129, 2, 64), np.float32)
    cache[0, :, :128], cache[1, :, :128] = k, v
    clean = paged_decode_attention(*_t(q, k, v, positions), page_size=page)
    for n, p in enumerate(positions):
        cache[:, n, p + 1:] = np.nan
    kt, vt = [t[:, :128] for t in _t(cache[0], cache[1])]
    assert not kt.is_contiguous()
    got = paged_decode_attention(*_t(q), kt, vt, *_t(positions),
                                 page_size=page)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), clean.numpy(), **F32)


def test_negative_position_writes_zeros():
    q, k, v, _, page = _dense_case(2, N=2)
    got = paged_decode_attention(*_t(q, k, v),
                                 torch.tensor([-1, 3], dtype=torch.int32),
                                 page_size=page)
    assert (got[0] == 0).all() and (got[1] != 0).any()


def test_rejects_unaligned_cache():
    q, k, v, positions, _ = _dense_case(2, S=60)
    with pytest.raises(ValueError, match="divisible"):
        paged_decode_attention(*_t(q, k, v, positions), page_size=16)
    q, k, v, positions, tables, page = _pool_case(2)
    with pytest.raises(ValueError, match="page"):
        paged_decode_attention_pool(*_t(q, k, v, positions, tables),
                                    page_size=32)


def test_cpu_path_counts_no_launch():
    q, k, v, positions, page = _dense_case(2)
    before = paged_decode_attention.launches
    paged_decode_attention(*_t(q, k, v, positions), page_size=page)
    assert paged_decode_attention.launches == before
    q, k, v, positions, tables, page = _pool_case(2)
    before = paged_decode_attention_pool.launches
    paged_decode_attention_pool(*_t(q, k, v, positions, tables),
                                page_size=page)
    assert paged_decode_attention_pool.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """The CUDA path's argument checks run before any build or launch;
    on a non-CPU, non-CUDA device the wrappers raise outright."""
    q, k, v, positions, page = _dense_case(2)
    with pytest.raises(TypeError, match="bfloat16"):
        _check_cuda_args(*_t(q, k, v, positions), page)
    bq, bk, bv, bpos = _t(q, k, v, positions, dtype=torch.bfloat16)
    _check_cuda_args(bq, bk, bv, bpos, page)                # accepted
    cache = torch.zeros((4, 129, 2, 64), dtype=torch.bfloat16)
    _check_cuda_args(bq, cache[:, :128], cache[:, :128], bpos, page)
    wide = torch.zeros((4, 128, 2, 128), dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="dense"):
        _check_cuda_args(bq, wide, wide, bpos, page)
    with pytest.raises(ValueError, match="head_dim"):
        _check_cuda_args(bq[..., :32].contiguous(),
                         bk[..., :32].contiguous(),
                         bv[..., :32].contiguous(), bpos, page)
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_decode_attention(*[t.to("meta") for t in (bq, bk, bv, bpos)],
                               page_size=page)
    q, k, v, positions, tables, page = _pool_case(2)
    bq, bk, bv, bpos, btab = _t(q, k, v, positions, tables,
                                dtype=torch.bfloat16)
    _check_cuda_args(bq, bk, bv, bpos, page, btab)           # accepted
    with pytest.raises(TypeError, match="int32"):
        _check_cuda_args(bq, bk, bv, bpos, page, btab.long())
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_decode_attention_pool(
            *[t.to("meta") for t in (bq, bk, bv, bpos, btab)],
            page_size=page)


def test_paged_supported_states_the_kernel_limits():
    assert paged_supported(64, 128, 1)
    assert paged_supported(16, 256, 8)
    assert not paged_supported(24, 128, 1)          # does not divide 128
    assert not paged_supported(64, 96, 1)           # no such head_dim
    assert not paged_supported(64, 128, 0)
    assert not paged_supported(64, 128, 1, torch.float32)
