"""The port's Hopper kernels against their plain versions on the card.

Every test here carries the ``cuda`` marker and skips without a card
(the kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so it also runs on a machine with the card and no JAX, where the
suite's ``conftest.py`` (which imports JAX) cannot load:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance, bf16 on the card: ``|kernel - plain| <= 1e-2 + 2e-2 |plain|``
(``chip_smoke.py``'s bound; the two round at different places).
"""

import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu_torch.ops import flash_attention as tfa
from ai_agent_kubectl_tpu_torch.ops import paged_attention as tpa
from ai_agent_kubectl_tpu_torch.ops import quant4 as tq4
from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
    ragged_attention_pool, ragged_attention_pool_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(out, ref):
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert ((out.float() - ref.float()).abs()
            <= 1e-2 + 2e-2 * ref.float().abs()).all()


def test_ragged_kernel_matches_plain(card):
    """Gemma-2B's grouping at a small pool: 8 query heads over one KV
    head, head_dim 256, page 16, mixed decode/verify/prefill rows and a
    NaN block that only a clamped sentinel entry reaches."""
    rng = np.random.default_rng(1)
    page, n_blocks, KV, H, hd, W = 16, 10, 1, 8, 256, 6
    k = rng.standard_normal((n_blocks, page, KV, hd)).astype(np.float32)
    v = rng.standard_normal((n_blocks, page, KV, hd)).astype(np.float32)
    k[9] = np.nan
    v[9] = np.nan
    q = rng.standard_normal((3, W, H, hd)).astype(np.float32)
    ints = [np.array([1, 6, 4], np.int32), np.array([40, 2, 20], np.int32),
            np.array([[3, 1, 4, 50], [0, 50, 50, 50], [5, 6, 50, 50]],
                     np.int32)]
    args = ([torch.from_numpy(a).to(card, torch.bfloat16) for a in (q, k, v)]
            + [torch.from_numpy(a).to(card) for a in ints])
    _close(ragged_attention_pool(*args, page_size=page),
           ragged_attention_pool_plain(*args, page_size=page))


@pytest.mark.parametrize("offset", [0, 85])
def test_flash_kernel_matches_plain(card, offset):
    """Llama-shaped GQA (32 heads over 8, head_dim 128) over a strided
    two-row cache view; at 85 the tail runs past the 256-slot span."""
    gen = torch.Generator(device=card).manual_seed(9)
    q = torch.randn((2, 128, 32, 128), generator=gen, device=card)
    cache = torch.randn((2, 2, 320, 8, 128), generator=gen, device=card)
    q, cache = q.to(torch.bfloat16), cache.to(torch.bfloat16)
    k, v = cache[0][:, :256], cache[1][:, :256]
    pos = (torch.arange(128, dtype=torch.int32, device=card)[None]
           + torch.tensor([[offset], [offset + 7]], dtype=torch.int32,
                          device=card)).contiguous()
    before = tfa.flash_attention_cached.launches
    _close(tfa.flash_attention_cached(q, k, v, pos),
           tfa.flash_attention_cached_plain(q, k, v, pos))
    assert tfa.flash_attention_cached.launches == before + 1


@pytest.mark.parametrize("T", [1, 5, 85])
@pytest.mark.parametrize("fmt", [(512, 512), (256, 256), (128, 256)])
def test_int4_kernel_matches_plain(card, T, fmt):
    """Both paths of the kernel (T <= 8 and above) at every format, with
    weights quantized on the card from a float draw."""
    gen = torch.Generator(device=card).manual_seed(T)
    w = torch.randn((1024, 1024), generator=gen, device=card) * 0.05
    qw = tq4.quantize_int4(w, *fmt)
    x = torch.randn((T, 1024), generator=gen, device=card).to(torch.bfloat16)
    _close(tq4.qmatmul4(x, qw), tq4.qmatmul4_plain(x, qw))


@pytest.mark.parametrize("geometry",
                         [(32, 8, 128), (8, 1, 256), (16, 16, 256)],
                         ids=["llama_gqa", "gemma2b_mqa", "gemma7b_mha"])
def test_paged_kernels_match_plain(card, geometry):
    """Both paged entry points: 4 slots at positions 0, page-1, page and
    the last slot, the dense cache read through its strided [:, :S] view
    (the model's trash row past S is NaN), the pool through tables with
    a shared first block and sentinels whose clamp lands on a NaN
    block."""
    H, KV, hd = geometry
    page, S = 64, 256
    gen = torch.Generator(device=card).manual_seed(H + KV)
    q = torch.randn((4, H, hd), generator=gen, device=card).to(torch.bfloat16)
    cache = torch.randn((2, 4, S + 1, KV, hd), generator=gen,
                        device=card).to(torch.bfloat16)
    cache[:, :, S] = float("nan")
    pos = torch.tensor([0, page - 1, page, S - 1], dtype=torch.int32,
                       device=card)
    k, v = cache[0][:, :S], cache[1][:, :S]
    before = tpa.paged_decode_attention.launches
    _close(tpa.paged_decode_attention(q, k, v, pos, page_size=page),
           tpa.paged_decode_attention_plain(q, k, v, pos, page_size=page))
    assert tpa.paged_decode_attention.launches == before + 1

    n_blocks = 12
    pool = torch.randn((2, n_blocks, page, KV, hd), generator=gen,
                       device=card).to(torch.bfloat16)
    pool[:, n_blocks - 1] = float("nan")
    tables = torch.tensor([[0, 20, 20, 20], [0, 20, 20, 20], [1, 2, 20, 20],
                           [3, 4, 5, 6]], dtype=torch.int32, device=card)
    before = tpa.paged_decode_attention_pool.launches
    _close(tpa.paged_decode_attention_pool(q, pool[0], pool[1], pos, tables,
                                           page_size=page),
           tpa.paged_decode_attention_pool_plain(q, pool[0], pool[1], pos,
                                                 tables, page_size=page))
    assert tpa.paged_decode_attention_pool.launches == before + 1


@pytest.mark.parametrize("T,OUT", [(1, 4096), (8, 4096), (9, 4096),
                                   (64, 4096), (64, 24576), (600, 4096)],
                         ids=["gemv_T1", "gemv_T8", "tiled_T9_split",
                              "tiled_T64_split", "tiled_T64_whole",
                              "tiled_T600_whole"])
def test_int4_kernel_paths_match_plain(card, T, OUT):
    """The GEMV and the tiled path at Gemma-7B widths, with and without
    the contraction split (wq's 32 output tiles split at T <= 128,
    w_gate's 192 do not), random packed bytes (every nibble, -8 too);
    a repeat is byte-identical (the slices sum in a fixed order)."""
    IN = 3072
    gen = torch.Generator(device=card).manual_seed(T + OUT)
    q = torch.randint(-128, 128, (IN, OUT // 2), generator=gen,
                      device=card, dtype=torch.int8)
    scale = (torch.rand((IN // 512, OUT), generator=gen, device=card)
             + 0.5) * (IN ** -0.5 / 7.0)
    w = tq4.QuantInt4(q=q, scale=scale)
    x = torch.randn((T, IN), generator=gen, device=card).to(torch.bfloat16)
    splits = tq4.split_plan(T, IN, OUT, 512)
    assert (splits > 1) == (OUT == 4096 and T <= 128)
    before = tq4.qmatmul4.launches
    out = tq4.qmatmul4(x, w)
    _close(out, tq4.qmatmul4_plain(x, w))
    assert torch.equal(out, tq4.qmatmul4(x, w))
    assert tq4.qmatmul4.launches == before + 2


def _serve_pool(card, positions, q_lens, W, seed):
    """Gemma-2B's grouping over serve's pool shape (8 slots, 64 pages of
    16, head_dim 256): distinct blocks per slot, the sentinel past them,
    NaN in the block a clamped sentinel reaches and in every row past a
    slot's last live key."""
    rng = np.random.default_rng(seed)
    N, page, max_pages, KV, H, hd = 8, 16, 64, 1, 8, 256
    n_blocks = N * max_pages + 1
    k = rng.standard_normal((n_blocks, page, KV, hd)).astype(np.float32)
    v = rng.standard_normal((n_blocks, page, KV, hd)).astype(np.float32)
    k[-1] = v[-1] = np.nan
    tables = np.full((N, max_pages), n_blocks + 3, np.int32)
    for n, (p, ql) in enumerate(zip(positions, q_lens)):
        last = p + max(ql, 1) - 1
        live = last // page + 1
        tables[n, :live] = n * max_pages + np.arange(live)
        k[tables[n, live - 1], last % page + 1:] = np.nan
        v[tables[n, live - 1], last % page + 1:] = np.nan
    q = rng.standard_normal((N, W, H, hd)).astype(np.float32)
    ints = [np.array(q_lens, np.int32), np.array(positions, np.int32),
            tables]
    return ([torch.from_numpy(a).to(card, torch.bfloat16) for a in (q, k, v)]
            + [torch.from_numpy(a).to(card) for a in ints]), page


@pytest.mark.parametrize("W,positions,q_lens", [
    (1, [63, 64, 127, 128, 0, 1023, 500, 191], [1, 1, 1, 1, 1, 1, 0, 1]),
    (64, [21, 45, 100, 150, 200, 260, 512, 1000],
     [64, 40, 1, 1, 1, 1, 1, 1]),
], ids=["decode_key_split", "mixed_prologue_w64"])
def test_ragged_key_split_matches_plain(card, W, positions, q_lens):
    """Serve's decode step (keys split 16 ways, last keys on split
    boundaries and at the table's end) and the mixed ragged prologue
    (two admissions, six decode rows; 4 splits of 256): within
    tolerance of the plain version, byte-identical on a repeat, and a
    slot's rows do not change when a neighbour moves 300 positions on
    (its K/V rebuilt for the new span)."""
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import split_plan

    args, page = _serve_pool(card, positions, q_lens, W, seed=W)
    assert split_plan(8, W, 8, 1, 64, page)[0] > 1
    out = ragged_attention_pool(*args, page_size=page)
    _close(out, ragged_attention_pool_plain(*args, page_size=page))
    assert torch.equal(out, ragged_attention_pool(*args, page_size=page))
    assert (out[torch.tensor(q_lens, device=card) == 0] == 0).all()
    moved = list(positions)
    moved[3] += 300                       # another slot, further along
    # The same draws: only slot 3's table and its own blocks' NaN rows
    # differ, so every other slot reads the same bytes.
    args2, _ = _serve_pool(card, moved, q_lens, W, seed=W)
    assert torch.equal(args2[0], args[0])
    out2 = ragged_attention_pool(*args2, page_size=page)
    _close(out2, ragged_attention_pool_plain(*args2, page_size=page))
    for n in range(8):
        if n != 3:
            assert torch.equal(out2[n], out[n]), f"slot {n} moved"
    assert not torch.equal(out2[3], out[3])


# The Gemma-7B projections serve1 runs through the kernel, and the token
# counts it gives them: decode, the GEMV's edge, its prefill buckets and
# the chunked long query (512 + 91).
_SERVE1_PROJ = [(3072, 4096), (4096, 3072), (3072, 24576), (24576, 3072)]
_SERVE1_TS = [1, 8, 9, 64, 65, 91, 128, 256, 512, 600]


def test_int4_split_plan(card):
    """The kernel's contraction split: whole groups a slice and none
    empty, only grids under one block per SM (132) split, and the f32
    workspace [splits, T, OUT] under the bound its source states (12.9
    MB for T > 8, 3.2 MB below) at every shape serve1 runs and beyond."""
    worst = 0
    for IN, OUT in _SERVE1_PROJ + [(512, 512), (8192, 1024)]:
        for T in _SERVE1_TS + [2, 17, 127, 129]:
            for group_in in (128, 256, 512):
                if IN % group_in:
                    continue
                G = IN // group_in
                splits = tq4.split_plan(T, IN, OUT, group_in)
                per = -(-G // splits)
                assert 1 <= splits <= G and (splits - 1) * per < G
                tiles = (OUT // 256 if T <= tq4.SKINNY_MAX_T
                         else OUT // 128 * -(-T // 64))
                assert splits == 1 or tiles < 132
                ws = 4 * splits * T * OUT if splits > 1 else 0
                assert ws < (4 * 396 * 256 * 8 if T <= tq4.SKINNY_MAX_T
                             else 4 * 396 * 128 * 64)
                if ((IN, OUT) in _SERVE1_PROJ and group_in == 512
                        and T in _SERVE1_TS):
                    worst = max(worst, ws)
    # Decode cuts w_gate's contraction in 3 and w_down's in 16; serve1's
    # prefix-hit bucket splits wq (32 output tiles) in 6, w_down in 10,
    # and leaves w_gate (192 tiles) whole; its largest workspace is wq's
    # at T=256, 3 slices of [256, 4096].
    assert [tq4.split_plan(*a, 512) for a in (
        (1, 3072, 24576), (1, 24576, 3072), (64, 3072, 4096),
        (64, 24576, 3072), (64, 3072, 24576), (512, 3072, 4096))] == [
            3, 16, 6, 10, 1, 1]
    assert worst == 3 * 256 * 4096 * 4
    with pytest.raises(ValueError, match="no plan"):
        tq4.split_plan(1, 3000, 4096, 512)


@pytest.mark.parametrize("T,IN,OUT,splits", [
    (1, 24576, 3072, 8), (1, 3072, 4096, 4), (64, 3072, 4096, 1),
    (64, 3072, 24576, 2)],
    ids=["gemv_fewer", "gemv_empty_slice", "tiled_unsplit", "tiled_split"])
def test_int4_launch_refuses_another_plan(card, T, IN, OUT, splits):
    """The C entry point refuses any split but its plan's (6 groups in 4
    slices would leave one empty) with cudaErrorInvalidValue, before it
    launches anything."""
    import ctypes

    from ai_agent_kubectl_tpu_torch.ops._cuda import load

    assert splits != tq4.split_plan(T, IN, OUT, 512)
    x = torch.zeros((T, IN), dtype=torch.bfloat16, device=card)
    q = torch.zeros((IN, OUT // 2), dtype=torch.int8, device=card)
    scale = torch.zeros((IN // 512, OUT), device=card)
    out = torch.empty((T, OUT), dtype=torch.bfloat16, device=card)
    work = torch.empty((max(splits, 1), T, OUT), device=card)
    fn = load("int4_matmul").int4_matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
             work.data_ptr(), T, IN, OUT, 512, 512, splits,
             torch.cuda.current_stream().cuda_stream)
    assert err == 1                       # cudaErrorInvalidValue


def test_ragged_split_plan(card):
    """The kernel's key split at serve's pool (8 slots, 1 KV head, 8
    query heads, 64 pages of 16) and other groupings: ranges of a
    multiple of 64 keys covering the table, none empty, only grids
    under one block per SM split, and the workspaces under the bound
    its source states (26.2 MB at head_dim 256)."""
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import split_plan

    worst = 0
    for W in (1, 2, 5, 16, 32, 64, 128, 256, 512):
        for N, KV, G, hd in ((8, 1, 8, 256), (8, 8, 4, 128), (1, 1, 8, 256),
                             (4, 2, 1, 64), (16, 1, 8, 256), (3, 1, 8, 256)):
            splits, kps, rows = split_plan(N, W, KV * G, KV, 64, 16)
            tiles = -(-W * G // 64)
            assert rows == N * KV * tiles * 64
            assert kps % 64 == 0 and (splits - 1) * kps < 1024 <= splits * kps
            assert (splits > 1) == (N * KV * tiles < 132)
            ws = 4 * splits * rows * (hd + 2) if splits > 1 else 0
            assert ws < 4 * 396 * 64 * (256 + 2)
            if (N, KV, G, hd) == (8, 1, 8, 256):
                worst = max(worst, ws)
    # serve's decode step: 8 row tiles split 16 ways, 64 keys each; its
    # largest workspaces: a 128-wide window, 3 splits of 8 x 1024 rows.
    assert split_plan(8, 1, 8, 1, 64, 16)[:2] == (16, 64)
    assert split_plan(8, 64, 8, 1, 64, 16)[:2] == (4, 256)
    assert split_plan(8, 512, 8, 1, 64, 16)[:2] == (1, 1024)
    assert worst == 3 * 8 * 1024 * (256 + 2) * 4


@pytest.mark.parametrize("W,splits,kps", [
    (1, 8, 128), (1, 16, 128), (512, 2, 512)],
    ids=["decode_halved", "decode_wider", "prefill_split"])
def test_ragged_launch_refuses_another_plan(card, W, splits, kps):
    """The C entry point refuses any key split but its plan's with
    cudaErrorInvalidValue, before it launches anything."""
    import ctypes

    from ai_agent_kubectl_tpu_torch.ops._cuda import load
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import split_plan

    N, H, KV, hd, page, max_pages = 8, 8, 1, 256, 16, 64
    plan = split_plan(N, W, H, KV, max_pages, page)
    assert (splits, kps) != plan[:2]
    args, _ = _serve_pool(card, [0] * N, [1] * N, W, seed=0)
    out = torch.empty_like(args[0])
    ws_o = torch.empty((splits, plan[2], hd), device=card)
    ws_ml = torch.empty((splits, plan[2], 2), device=card)
    fn = load("ragged_attention").ragged_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*[a.data_ptr() for a in args], out.data_ptr(), ws_o.data_ptr(),
             ws_ml.data_ptr(), N, W, H, KV, hd, page, args[1].shape[0],
             max_pages, hd ** -0.5, kps, splits,
             torch.cuda.current_stream().cuda_stream)
    assert err == 1                       # cudaErrorInvalidValue
