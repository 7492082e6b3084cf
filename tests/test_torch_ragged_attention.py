"""The port's ragged paged attention against the JAX package's Pallas
kernel, which runs here in interpret mode (as
``tests/test_ragged_attention.py`` runs it).

On the CPU the wrapper takes the plain PyTorch version — because the
tensors lie on the CPU — so these tests hold that version to the
reference in float32 (tolerance 2e-5, float32 round-off over a
softmax, as the JAX kernel's own tests use). The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``, which skips without a card.
"""

import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.ops.ragged_attention import (
    ragged_attention_pool as jax_ragged)
from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
    ragged_attention_pool, ragged_attention_pool_plain)

# Tiny shapes: one intra-op thread is as fast, and spares the suite's
# other workers the cores that idle OpenMP threads spin on.
torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _mixed_case():
    """The JAX suite's mixed case: decode, a 5-wide verify window, a
    prefill span and a frozen slot over a pool with a shared page, the
    unmapped-page sentinel (99) and a NaN block (11) that the clamp of a
    sentinel entry reaches."""
    rng = np.random.default_rng(0)
    page, n_blocks, KV, H, hd, W = 8, 12, 2, 4, 16, 8
    k = rng.standard_normal((n_blocks, page, KV, hd)).astype(np.float32)
    v = rng.standard_normal((n_blocks, page, KV, hd)).astype(np.float32)
    k[11] = np.nan
    v[11] = np.nan
    q = rng.standard_normal((4, W, H, hd)).astype(np.float32)
    q_lens = np.array([1, 5, 8, 0], np.int32)
    positions = np.array([19, 11, 0, 19], np.int32)
    tables = np.array([[7, 2, 9, 99], [7, 5, 99, 99], [0, 99, 99, 99],
                       [7, 2, 9, 99]], np.int32)
    return q, k, v, q_lens, positions, tables, page


def _mqa_case():
    """Gemma-2B's grouping at a small pool: 8 query heads over one KV
    head, head_dim 256, page 16, mixed decode/verify/prefill rows."""
    rng = np.random.default_rng(1)
    page, n_blocks, KV, H, hd, W = 16, 10, 1, 8, 256, 6
    k = rng.standard_normal((n_blocks, page, KV, hd)).astype(np.float32)
    v = rng.standard_normal((n_blocks, page, KV, hd)).astype(np.float32)
    k[9] = np.nan
    v[9] = np.nan
    q = rng.standard_normal((3, W, H, hd)).astype(np.float32)
    q_lens = np.array([1, 6, 4], np.int32)
    positions = np.array([40, 2, 20], np.int32)
    tables = np.array([[3, 1, 4, 50], [0, 50, 50, 50], [5, 6, 50, 50]],
                      np.int32)
    return q, k, v, q_lens, positions, tables, page


def _torch_args(case):
    q, k, v, q_lens, positions, tables, page = case
    return [torch.from_numpy(a) for a in (q, k, v, q_lens, positions,
                                          tables)], page


@pytest.mark.parametrize("make", [_mixed_case, _mqa_case],
                         ids=["mixed", "mqa_g8_hd256"])
def test_plain_matches_jax_kernel(make):
    case = make()
    q, k, v, q_lens, positions, tables, page = case
    want = np.asarray(jax_ragged(q, k, v, q_lens, positions, tables,
                                 page_size=page))
    args, page = _torch_args(case)
    got = ragged_attention_pool(*args, page_size=page).numpy()
    assert not np.isnan(got).any(), "a dead or NaN page leaked"
    np.testing.assert_allclose(got, want, **TOL)
    for n, ql in enumerate(q_lens):
        assert np.all(got[n, ql:] == 0.0), "padded columns must be zeros"


def _split_shape_case(W, positions, q_lens, seed):
    """The shapes the kernel splits keys at, small: one KV head under 4
    query heads, pages of 16, a NaN block behind the sentinel, and rows
    of 1e3 past each slot's last live key in its last page (the Pallas
    kernel reads whole pages and masks them, so they are finite)."""
    rng = np.random.default_rng(seed)
    page, max_pages, KV, H, hd = 16, 9, 1, 4, 16
    N = len(positions)
    n_blocks = N * max_pages + 1
    k = rng.standard_normal((n_blocks, page, KV, hd)).astype(np.float32)
    v = rng.standard_normal((n_blocks, page, KV, hd)).astype(np.float32)
    k[-1] = v[-1] = np.nan
    tables = np.full((N, max_pages), n_blocks + 5, np.int32)
    for n, (p, ql) in enumerate(zip(positions, q_lens)):
        last = p + max(ql, 1) - 1
        live = last // page + 1
        tables[n, :live] = n * max_pages + np.arange(live)
        k[tables[n, live - 1], last % page + 1:] = 1e3
        v[tables[n, live - 1], last % page + 1:] = 1e3
    q = rng.standard_normal((N, W, H, hd)).astype(np.float32)
    return (q, k, v, np.array(q_lens, np.int32),
            np.array(positions, np.int32), tables, page)


@pytest.mark.parametrize("W,positions,q_lens", [
    (1, [63, 64, 127, 128, 0, 143], [1, 1, 1, 1, 0, 1]),
    (16, [5, 21, 40, 100, 64, 130], [16, 11, 1, 1, 1, 1]),
    (5, [59, 60, 123, 0, 139], [5, 5, 1, 3, 5]),
], ids=["decode_on_split_edges", "prologue", "verify_across_edges"])
def test_plain_matches_jax_kernel_at_split_shapes(W, positions, q_lens):
    """Decode rows whose last keys fall on and beside 64-key boundaries
    (where the kernel's key ranges meet) and at the table's end, the
    mixed prologue (two admissions while the rest decode) and verify
    windows across a boundary: the plain version matches the reference,
    so the rows past each slot's last live key stay out of it."""
    case = _split_shape_case(W, positions, q_lens, seed=W)
    q, k, v, ql, pos, tables, page = case
    want = np.asarray(jax_ragged(q, k, v, ql, pos, tables, page_size=page))
    args, page = _torch_args(case)
    got = ragged_attention_pool(*args, page_size=page).numpy()
    assert not np.isnan(got).any(), "the NaN block leaked"
    np.testing.assert_allclose(got, want, **TOL)


def test_window_invariance():
    """The last column of a 5-wide window at positions p..p+4 equals a
    1-wide decode call at p+4: verify and decode share one function."""
    q, k, v, _ql, _pos, tables, page = _mixed_case()
    args, _ = _torch_args((q, k, v, np.full(4, 5, np.int32),
                           np.full(4, 11, np.int32), tables, page))
    wide = ragged_attention_pool(*args, page_size=page).numpy()
    narrow_q = np.zeros_like(q)
    narrow_q[:, 0] = q[:, 4]
    args, _ = _torch_args((narrow_q, k, v, np.ones(4, np.int32),
                           np.full(4, 15, np.int32), tables, page))
    narrow = ragged_attention_pool(*args, page_size=page).numpy()
    np.testing.assert_allclose(wide[:, 4], narrow[:, 0], **TOL)


def test_cpu_path_counts_no_launch():
    args, page = _torch_args(_mixed_case())
    before = ragged_attention_pool.launches
    ragged_attention_pool(*args, page_size=page)
    assert ragged_attention_pool.launches == before


def test_cuda_request_without_a_card_raises(monkeypatch):
    """A CUDA request never falls back to the plain version: with no
    card, the device resolution raises before anything runs."""
    from ai_agent_kubectl_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """The CUDA path's argument checks run before any build or launch;
    on a non-CPU, non-CUDA device the wrapper raises outright."""
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        _check_cuda_args)

    args, page = _torch_args(_mqa_case())
    with pytest.raises(TypeError, match="bfloat16"):
        _check_cuda_args(*args, page)
    bf = [a.to(torch.bfloat16) if a.is_floating_point() else a
          for a in args]
    _check_cuda_args(*bf, page)                       # accepted
    bad_hd = [bf[0][..., :96].contiguous(), bf[1][..., :96].contiguous(),
              bf[2][..., :96].contiguous()] + bf[3:]
    with pytest.raises(ValueError, match="head_dim"):
        _check_cuda_args(*bad_hd, page)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ragged_attention_pool(*[a.to("meta") for a in bf], page_size=page)
