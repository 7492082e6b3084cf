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
                                   (64, 4096), (64, 24576), (600, 4096),
                                   (40, 4096), (129, 4096)],
                         ids=["gemv_T1", "gemv_T8", "tiled_T9_split",
                              "tiled_T64_split", "tiled_T64_whole",
                              "tiled_T600_whole", "tiled_T40_split",
                              "tiled_T129_split"])
def test_int4_kernel_paths_match_plain(card, T, OUT):
    """The GEMV and the tiled path at Gemma-7B widths (token tiles of 40
    and of 128 with a second, partly empty one at 129), with and without
    the contraction split across a cluster (wq's output tiles split up to
    T = 256, w_gate's 192 do not), random packed bytes (every nibble, -8
    too); a repeat is byte-identical (the slices sum in rank order)."""
    IN = 3072
    gen = torch.Generator(device=card).manual_seed(T + OUT)
    q = torch.randint(-128, 128, (IN, OUT // 2), generator=gen,
                      device=card, dtype=torch.int8)
    scale = (torch.rand((IN // 512, OUT), generator=gen, device=card)
             + 0.5) * (IN ** -0.5 / 7.0)
    w = tq4.QuantInt4(q=q, scale=scale)
    x = torch.randn((T, IN), generator=gen, device=card).to(torch.bfloat16)
    splits = tq4.split_plan(T, IN, OUT, 512)
    assert (splits > 1) == (OUT == 4096 and T <= 256)
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
    """The kernel's contraction split, the size of the cluster that sums
    it: whole groups a slice and none empty, at most 16 slices (the
    cluster limit; 12 for the GEMV, 8 at token tiles of 128), only grids
    under half a wave of resident blocks split (three blocks an SM for the
    GEMV, two below token tiles of 128, one at 128), and into at most one
    wave. No workspace: the cluster's partial rows stay in shared
    memory."""
    for IN, OUT in _SERVE1_PROJ + [(512, 512), (8192, 1024)]:
        for T in _SERVE1_TS + [2, 17, 40, 127, 129]:
            for group_in in (128, 256, 512):
                if IN % group_in:
                    continue
                G = IN // group_in
                splits = tq4.split_plan(T, IN, OUT, group_in)
                bn, got, (gx, gy) = tq4.kernel_geometry(T, IN, OUT, group_in)
                assert got == splits
                per = -(-G // splits)
                assert 1 <= splits <= G and (splits - 1) * per < G
                wide = T > 64
                assert splits <= (8 if wide else 12 if T <= tq4.SKINNY_MAX_T
                                  else 16)
                assert bn == (128 if wide else max(8, -(-T // 8) * 8))
                tiles = OUT // 128 * -(-T // bn)
                assert gx * gy == tiles * splits
                slots = 132 * (1 if wide else 3 if T <= tq4.SKINNY_MAX_T
                               else 2)
                assert splits == 1 or (2 * tiles <= slots and
                                       gx * gy <= slots)
    # On an H100 SXM: decode cuts w_gate's contraction in 2 and w_down's
    # in 12 (the GEMV's cluster limit); serve1's prefill bucket of 64
    # splits wq (32 output tiles) in 6 and w_down in 8 (its 24 clusters of
    # 10 would not all fit at once), and leaves w_gate (192 tiles) whole,
    # as it leaves wq at 512 (128 tiles of 128 x 128); Llama's wk at T = 40
    # and 128/256 takes the limit of 16.
    assert [tq4.split_plan(*a, 512) for a in (
        (1, 3072, 24576), (1, 24576, 3072), (64, 3072, 4096),
        (64, 24576, 3072), (64, 3072, 24576), (512, 3072, 4096))] == [
            2, 12, 6, 8, 1, 1]
    assert tq4.split_plan(40, 4096, 1024, 128) == 16
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
    fn = load("int4_matmul").int4_matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
             T, IN, OUT, 512, 512, splits,
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


async def _until(cond, what: str, limit: float = 60.0) -> None:
    """Poll ``cond`` until it holds, failing the test with ``what`` when
    it has not within ``limit`` seconds (a lost race must fail, not hang
    the run)."""
    import asyncio
    import time

    deadline = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < deadline, f"{what} within {limit:.0f} s"
        await asyncio.sleep(0.005)


def _flash_args(card, *, B, S, KVLEN, H, KV, hd, offsets, seed):
    """Flash inputs through a strided [:, :KVLEN] view of a cache one slot
    longer, with row b's queries at offsets[b] + 0 .. S-1. Each batch
    row's q and cache come from their own draws, so moving one row's
    offsets leaves the others' bytes as they were."""
    q = torch.empty((B, S, H, hd), dtype=torch.bfloat16, device=card)
    cache = torch.empty((2, B, KVLEN + 1, KV, hd), dtype=torch.bfloat16,
                        device=card)
    for b in range(B):
        rng = np.random.default_rng((seed, b))
        q[b] = torch.from_numpy(rng.standard_normal((S, H, hd)).astype(
            np.float32)).to(card, torch.bfloat16)
        cache[:, b] = torch.from_numpy(rng.standard_normal(
            (2, KVLEN + 1, KV, hd)).astype(np.float32)).to(card,
                                                           torch.bfloat16)
    pos = torch.stack([torch.arange(S, dtype=torch.int32) + o
                       for o in offsets]).to(card).contiguous()
    return q, cache[0][:, :KVLEN], cache[1][:, :KVLEN], pos


@pytest.mark.parametrize("S,KVLEN,H,KV,hd,split", [
    (85, 128, 16, 16, 256, True),
    (128, 128, 32, 8, 128, True),
    (72, 200, 8, 2, 64, True),
    (600, 1024, 16, 16, 256, False),
    (512, 512, 32, 8, 128, False),
], ids=["g7_s85_split", "llama_s128_split", "hd64_gqa4_split",
        "g7_s600_whole", "llama_s512_whole"])
def test_flash_key_split_matches_plain(card, S, KVLEN, H, KV, hd, split):
    """Both sides of the flash kernel's key split (serve1's prefix-hit
    shape and serve_paged's prefill window split; long prefills do not),
    two batch rows read through a strided view, row 1's first three
    columns before slot 0 (exact zeros): within tolerance of the plain
    version, byte-identical on a repeat, and row 0 unchanged when row 1's
    positions move on."""
    args = _flash_args(card, B=2, S=S, KVLEN=KVLEN, H=H, KV=KV, hd=hd,
                       offsets=[0, -3], seed=S)
    assert (tfa.split_plan(2, S, H, KV, KVLEN)[0] > 1) == split
    before = tfa.flash_attention_cached.launches
    out = tfa.flash_attention_cached(*args)
    _close(out, tfa.flash_attention_cached_plain(*args))
    assert torch.equal(out, tfa.flash_attention_cached(*args))
    assert tfa.flash_attention_cached.launches == before + 2
    assert (out[1, :3] == 0).all()
    moved = _flash_args(card, B=2, S=S, KVLEN=KVLEN, H=H, KV=KV, hd=hd,
                        offsets=[0, 40], seed=S)
    out2 = tfa.flash_attention_cached(*moved)
    _close(out2, tfa.flash_attention_cached_plain(*moved))
    assert torch.equal(out2[0], out[0])
    assert not torch.equal(out2[1], out[1])


def _paged_args(card, *, H, KV, hd, positions, page, S, seed):
    """Both paged layouts holding the same K/V: the dense cache [N, S + 1,
    KV, hd] read through its [:, :S] view, NaN from each slot's position
    + 1 on; and a pool whose block n * (S // page) + j is slot n's page j
    (live pages only; every other block NaN) through tables with the
    sentinel past the live pages. Each slot's rows come from its own
    draw, so moving one slot's position leaves the others' bytes as they
    were."""
    N = len(positions)
    max_pages = S // page
    n_blocks = N * max_pages + 1
    q = torch.empty((N, H, hd), dtype=torch.bfloat16, device=card)
    cache = torch.full((2, N, S + 1, KV, hd), float("nan"),
                       dtype=torch.bfloat16, device=card)
    pool = torch.full((2, n_blocks, page, KV, hd), float("nan"),
                      dtype=torch.bfloat16, device=card)
    tables = torch.full((N, max_pages), n_blocks + 5, dtype=torch.int32)
    for n, p in enumerate(positions):
        rng = np.random.default_rng((seed, n))
        q[n] = torch.from_numpy(rng.standard_normal((H, hd)).astype(
            np.float32)).to(card, torch.bfloat16)
        rows = torch.from_numpy(rng.standard_normal((2, S, KV, hd)).astype(
            np.float32)).to(card, torch.bfloat16)
        cache[:, n, :p + 1] = rows[:, :p + 1]
        for j in range(p // page + 1):
            blk = n * max_pages + j
            tables[n, j] = blk
            live = min(page, p + 1 - j * page)
            pool[:, blk, :live] = rows[:, j * page:j * page + live]
    pos = torch.tensor(positions, dtype=torch.int32, device=card)
    return ((q, cache[0][:, :S], cache[1][:, :S], pos),
            (q, pool[0], pool[1], pos, tables.to(card)))


@pytest.mark.parametrize("geometry,N,split", [
    ((32, 8, 128), 8, True), ((8, 1, 256), 8, True),
    ((16, 16, 256), 8, True), ((32, 8, 128), 32, False)],
    ids=["llama_8slots_split", "gemma2b_split", "gemma7b_split",
         "llama_32slots_whole"])
def test_paged_key_split_matches_plain(card, geometry, N, split):
    """Both paged entry points on both sides of the first and the last
    chunk edge, 8 slots at positions 0, page - 1, page, the first edge
    - 1 and + 0, the last edge - 1 and + 0, and the span's last slot
    (the rest of 32 slots spread over the span): within tolerance of the
    plain versions, one launch a call, byte-identical on a repeat, and
    every other slot byte-identical when slot 3 moves 300 positions
    (modulo the span; its K/V rebuilt for the new span)."""
    H, KV, hd = geometry
    page, S = 64, 1088
    max_chunks, chunk, _ = tpa.split_plan(N, H, KV, hd, S)
    assert (max_chunks > 1) == split
    first = min(chunk, S - 1)         # the span is one chunk when whole
    last = max((max_chunks - 1) * chunk, 1)
    positions = [0, page - 1, page, first - 1, first, last - 1, last, S - 1]
    positions += [(37 * i) % S for i in range(N - len(positions))]
    moved = list(positions)
    moved[3] = (moved[3] + 300) % S
    dense, pool = _paged_args(card, H=H, KV=KV, hd=hd, positions=positions,
                              page=page, S=S, seed=H)
    dense2, pool2 = _paged_args(card, H=H, KV=KV, hd=hd, positions=moved,
                                page=page, S=S, seed=H)
    for fn, plain, a, a2 in (
            (tpa.paged_decode_attention, tpa.paged_decode_attention_plain,
             dense, dense2),
            (tpa.paged_decode_attention_pool,
             tpa.paged_decode_attention_pool_plain, pool, pool2)):
        before = fn.launches
        out = fn(*a, page_size=page)
        _close(out, plain(*a, page_size=page))
        assert torch.equal(out, fn(*a, page_size=page))
        out2 = fn(*a2, page_size=page)
        _close(out2, plain(*a2, page_size=page))
        assert fn.launches == before + 3
        for n in range(N):
            if n != 3:
                assert torch.equal(out2[n], out[n]), f"slot {n} moved"
        assert not torch.equal(out2[3], out[3])


def test_paged_ring_decode_shape_matches_plain(card):
    """The decode after a ring prefill: one Llama-3-8B tp=2 shard (16
    over 4 heads of 128), a cache of 8,256 positions (page 64), 8 slots
    on and beside the chunk edges nearest 3,000 and 6,000, in both
    layouts: within tolerance, and byte-identical on a repeat."""
    page, S, H, KV, hd = 64, 8256, 16, 4, 128
    _, chunk, _ = tpa.split_plan(8, H, KV, hd, S)
    positions = []
    for near in (3000, 6000):
        edge = max(1, round(near / chunk)) * chunk
        positions += [edge - 1, edge, edge + 1, near]
    dense, pool = _paged_args(card, H=H, KV=KV, hd=hd, positions=positions,
                              page=page, S=S, seed=5)
    for fn, plain, a in (
            (tpa.paged_decode_attention, tpa.paged_decode_attention_plain,
             dense),
            (tpa.paged_decode_attention_pool,
             tpa.paged_decode_attention_pool_plain, pool)):
        out = fn(*a, page_size=page)
        _close(out, plain(*a, page_size=page))
        assert torch.equal(out, fn(*a, page_size=page))


#: (H, KV) of a grouping at each head_dim: a GQA model's at 64 and 128,
#: Gemma-2B's MQA at 256
NAN_GROUPINGS = {64: (16, 4), 128: (32, 8), 256: (8, 1)}


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_paged_nan_past_the_last_key_never_reaches_the_output(card, hd,
                                                              page):
    """NaN in every row past each slot's last live key, inside the page
    that holds it (the TMA box copies those rows), in both layouts: the
    output is finite and within tolerance of the plain versions, which
    select those rows away."""
    H, KV = NAN_GROUPINGS[hd]
    S = 320
    positions = [5, 17, 70, 100, 129, 200, 250, 300]
    assert all((p + 1) % page for p in positions)   # inside a page
    dense, pool = _paged_args(card, H=H, KV=KV, hd=hd, positions=positions,
                              page=page, S=S, seed=hd + page)
    assert torch.isnan(dense[1][0, positions[0] + 1]).all()
    for fn, plain, a in (
            (tpa.paged_decode_attention, tpa.paged_decode_attention_plain,
             dense),
            (tpa.paged_decode_attention_pool,
             tpa.paged_decode_attention_pool_plain, pool)):
        _close(fn(*a, page_size=page), plain(*a, page_size=page))


def test_paged_calls_on_two_streams_match_plain(card):
    """One split call on each of two streams, issued back to back: each
    equals the plain version, and each stream has buffers of its own."""
    page, S = 64, 1088
    calls = [_paged_args(card, H=32, KV=8, hd=128, positions=pos, page=page,
                         S=S, seed=i)
             for i, pos in enumerate(([700, 5, 384, 383, 1000, 64, 0, 900],
                                      [1087, 768, 767, 3, 212, 212, 212,
                                       727]))]
    assert tpa.split_plan(8, 32, 8, 128, S)[0] > 1
    streams = [torch.cuda.Stream(card) for _ in calls]
    torch.cuda.synchronize()
    outs = []
    for stream, (dense, pool) in zip(streams, calls):
        with torch.cuda.stream(stream):
            outs.append((tpa.paged_decode_attention(*dense, page_size=page),
                         tpa.paged_decode_attention_pool(*pool,
                                                         page_size=page)))
    torch.cuda.synchronize()
    for (dense, pool), (o_dense, o_pool) in zip(calls, outs):
        _close(o_dense, tpa.paged_decode_attention_plain(*dense,
                                                         page_size=page))
        _close(o_pool, tpa.paged_decode_attention_pool_plain(
            *pool, page_size=page))
    assert {(card.index or 0, s.cuda_stream) for s in streams} <= {
        (d or 0, s) for d, s in tpa._SCRATCH}


def test_paged_fifty_calls_are_bit_identical(card):
    """50 split calls in a row on one stream: every output equals the
    first bit for bit, and the merge's counters are back at 0 after
    each call (each resets its own)."""
    page, S = 64, 1088
    positions = [700, 5, 384, 383, 1000, 64, 0, 900]
    dense, pool = _paged_args(card, H=32, KV=8, hd=128, positions=positions,
                              page=page, S=S, seed=3)
    assert tpa.split_plan(8, 32, 8, 128, S)[0] > 1
    for fn, a in ((tpa.paged_decode_attention, dense),
                  (tpa.paged_decode_attention_pool, pool)):
        outs = [fn(*a, page_size=page) for _ in range(50)]
        torch.cuda.synchronize()
        assert all(torch.equal(o, outs[0]) for o in outs[1:])
        stream = torch.cuda.current_stream(card).cuda_stream
        counters = tpa._SCRATCH[(card.index or 0, stream)][0]
        assert int(counters.abs().sum()) == 0


def test_flash_split_plan(card):
    """The flash kernel's key split: ranges of a multiple of 64 keys
    covering KVLEN, none empty, only grids under one block per SM (132)
    split (and only more than 64 keys), and the workspaces under the
    bound its source states (26.2 MB at head_dim 256; 25.4 MB at the
    largest prefill served)."""
    for B in (1, 2):
        for S in (1, 16, 64, 85, 128, 256, 512, 600):
            for H, KV, hd in ((16, 16, 256), (32, 8, 128), (8, 1, 256),
                              (4, 2, 64)):
                for KVLEN in (S, 128, 512, 1024, 1025):
                    if KVLEN < S:
                        continue
                    splits, kps, rows = tfa.split_plan(B, S, H, KV, KVLEN)
                    blocks = B * KV * -(-S * (H // KV) // 64)
                    assert rows == blocks * 64
                    assert kps % 64 == 0
                    assert (splits - 1) * kps < KVLEN <= splits * kps
                    assert (splits > 1) == (blocks < 132 and KVLEN > 64)
                    ws = 4 * splits * rows * (hd + 2) if splits > 1 else 0
                    assert ws < 4 * 396 * 64 * (256 + 2)
    # serve1's prefix hit and serve_paged's prefill window split in 2;
    # serve1's 512 prefill in 3 of 192 keys (its workspaces: 25.4 MB);
    # 160 row tiles do not split.
    assert tfa.split_plan(1, 85, 16, 16, 128)[:2] == (2, 64)
    assert tfa.split_plan(1, 128, 32, 8, 128)[:2] == (2, 64)
    splits, kps, rows = tfa.split_plan(1, 512, 16, 16, 512)
    assert (splits, kps) == (3, 192)
    assert 4 * splits * rows * (256 + 2) == 25362432
    assert tfa.split_plan(1, 600, 16, 16, 1024)[:2] == (1, 1024)
    with pytest.raises(ValueError):
        tfa.split_plan(1, 64, 6, 4, 128)


def test_paged_split_plan(card):
    """The paged kernel's chunk rule: the wrapper's rule equals the
    kernel's own (``paged_decode_plan``) over a grid of shapes; chunks
    are a multiple of 64 keys covering the span, at least 128 KB of K/V
    an item, one chunk when the row tiles alone reach the rule's 198
    items; and the source note's values at the served shapes."""
    from ai_agent_kubectl_tpu_torch.ops._cuda import split_plan as read_plan

    for N in (1, 4, 8, 16, 32):
        for H, KV in ((32, 8), (8, 1), (16, 16), (64, 2), (16, 4)):
            for hd in (64, 128, 256):
                for span in (64, 128, 1024, 1040, 1088, 4096, 8256):
                    plan = tpa.split_plan(N, H, KV, hd, span)
                    assert plan == read_plan("paged_attention",
                                             "paged_decode_plan", N, H, KV,
                                             hd, span)
                    max_chunks, chunk, tiles = plan
                    assert tiles == N * KV * -(-(H // KV) // 16)
                    assert chunk % 64 == 0
                    assert (max_chunks - 1) * chunk < span <= (
                        max_chunks * chunk)
                    assert chunk * 4 * hd >= 131072 or max_chunks == 1
                    if tiles >= 198:
                        assert max_chunks == 1
    # serve_paged's decode (a slot at 212 is one item), the ring decode's
    # shard, Gemma-2B's grouping, 32 Llama slots.
    assert tpa.split_plan(8, 32, 8, 128, 1088) == (3, 384, 64)
    assert tpa.split_plan(8, 32, 8, 128, 1024) == (3, 384, 64)
    assert tpa.split_plan(8, 16, 4, 128, 8256) == (7, 1344, 32)
    assert tpa.split_plan(8, 8, 1, 256, 1040) == (9, 128, 8)
    assert tpa.split_plan(32, 32, 8, 128, 1088) == (1, 1088, 256)
    with pytest.raises(ValueError):
        tpa.split_plan(8, 30, 8, 128, 1088)


def _c_entry(lib, symbol, n_ptrs, middle):
    import ctypes

    from ai_agent_kubectl_tpu_torch.ops._cuda import load

    fn = getattr(load(lib), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + middle + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("shift", [(1, 0), (-1, 0), (0, 64)],
                         ids=["more_splits", "fewer_splits", "wider"])
def test_flash_launch_refuses_another_plan(card, shift):
    """flash_attention_bf16 refuses any key split but its plan's with
    cudaErrorInvalidValue, before it launches anything."""
    import ctypes

    q, k, v, pos = _flash_args(card, B=1, S=85, KVLEN=128, H=16, KV=16,
                               hd=256, offsets=[0], seed=0)
    splits, kps, rows = tfa.split_plan(1, 85, 16, 16, 128)
    splits, kps = splits + shift[0], kps + shift[1]
    out = torch.empty_like(q)
    ws_o = torch.empty((max(splits, 1), rows, 256), device=card)
    ws_ml = torch.empty((max(splits, 1), rows, 2), device=card)
    fn = _c_entry("flash_attention", "flash_attention_bf16", 7,
                  [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2
                  + [ctypes.c_float] * 2)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
             out.data_ptr(), ws_o.data_ptr(), ws_ml.data_ptr(), 1, 85, 16,
             16, 256, 128, k.stride(0), v.stride(0), 256 ** -0.5, 0.0, kps,
             splits, torch.cuda.current_stream().cuda_stream)
    assert err == 1                       # cudaErrorInvalidValue


@pytest.mark.parametrize("pool", [False, True], ids=["dense", "pool"])
@pytest.mark.parametrize("shift", [-64, 64, 1],
                         ids=["more_splits", "fewer_splits", "wider"])
def test_paged_launch_refuses_another_plan(card, pool, shift):
    """Both paged C entry points refuse any chunk but their rule's with
    cudaErrorInvalidValue, before they launch anything."""
    page, S = 64, 1088
    dense_args, pool_args = _paged_args(card, H=32, KV=8, hd=128,
                                        positions=[5] * 8, page=page, S=S,
                                        seed=0)
    max_chunks, chunk, tiles = tpa.split_plan(8, 32, 8, 128, S)
    lib = tpa._library()
    q = dense_args[0]
    out = torch.empty_like(q)
    counters = torch.zeros(tiles, dtype=torch.int32, device=card)
    ws = torch.empty(tiles * max_chunks * 16 * 130, device=card)
    stream = torch.cuda.current_stream().cuda_stream
    if pool:
        _, k, v, pos, tables = pool_args
        maps = [tpa._tensor_map(lib, x, page) for x in (k, v)]
        err = lib.paged_decode_pool_bf16(
            q.data_ptr(), *maps, pos.data_ptr(), tables.data_ptr(),
            out.data_ptr(), ws.data_ptr(), counters.data_ptr(), 8, 32, 8,
            128, page, k.shape[0], tables.shape[1], 128 ** -0.5,
            chunk + shift, stream)
    else:
        _, k, v, pos = dense_args
        maps = [tpa._tensor_map(lib, x) for x in (k, v)]
        err = lib.paged_decode_bf16(
            q.data_ptr(), *maps, pos.data_ptr(), out.data_ptr(),
            ws.data_ptr(), counters.data_ptr(), 8, 32, 8, 128, S,
            128 ** -0.5, chunk + shift, stream)
    assert err == 1                       # cudaErrorInvalidValue


def _tiny_hf_checkpoint(path, n_experts: int = 0):
    """A tiny HF-layout Llama checkpoint (untied head, ``model.`` keys)
    of random bf16 tensors from a seeded generator, or with
    ``n_experts`` a Mixtral one (``block_sparse_moe`` router and
    experts, 2 routed per token); returns its cfg."""
    from safetensors.torch import save_file

    from ai_agent_kubectl_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(name="tiny-llama-cuda", vocab_size=512, dim=256,
                      n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
                      mlp_hidden=512, n_experts=n_experts,
                      experts_per_token=2 if n_experts else 0)
    gen = torch.Generator().manual_seed(0)
    d, f, kvd = cfg.dim, cfg.mlp_hidden, cfg.n_kv_heads * cfg.head_dim
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, d),
              "model.norm.weight": (d,), "lm_head.weight": (cfg.vocab_size, d)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (d,),
            p + "post_attention_layernorm.weight": (d,),
            p + "self_attn.q_proj.weight": (d, d),
            p + "self_attn.k_proj.weight": (kvd, d),
            p + "self_attn.v_proj.weight": (kvd, d),
            p + "self_attn.o_proj.weight": (d, d)})
        if n_experts:
            m = p + "block_sparse_moe."
            shapes[m + "gate.weight"] = (n_experts, d)
            for e in range(n_experts):
                shapes.update({m + f"experts.{e}.w1.weight": (f, d),
                               m + f"experts.{e}.w3.weight": (f, d),
                               m + f"experts.{e}.w2.weight": (d, f)})
        else:
            shapes.update({p + "mlp.gate_proj.weight": (f, d),
                           p + "mlp.up_proj.weight": (f, d),
                           p + "mlp.down_proj.weight": (d, f)})
    save_file({k: (torch.randn(s, generator=gen) * 0.05).to(torch.bfloat16)
               for k, s in shapes.items()},
              str(path / "model.safetensors"))
    return cfg


@pytest.mark.parametrize("n_experts", [0, 4], ids=["llama", "mixtral"])
@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_checkpoint_loads_to_the_card_as_on_the_cpu(card, tmp_path, quant,
                                                    n_experts):
    """The streamed load onto the card (quantized there under int8 and
    int4; a Mixtral's expert stacks int8 under both) gives the CPU
    load's tree, byte for byte."""
    from ai_agent_kubectl_tpu_torch.models.convert import \
        convert_hf_checkpoint

    cfg = _tiny_hf_checkpoint(tmp_path, n_experts)
    kw = dict(dtype=torch.bfloat16, quant=quant, quantize_embed=bool(quant))
    on_card = convert_hf_checkpoint(cfg, tmp_path, device=card, **kw)
    on_cpu = convert_hf_checkpoint(cfg, tmp_path, device="cpu", **kw)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for key in sorted(tree):
                yield from leaves(tree[key], f"{prefix}{key}/")
        elif hasattr(tree, "q"):
            yield prefix + "q", tree.q
            yield prefix + "scale", tree.scale
        else:
            yield prefix, tree

    a, b = dict(leaves(on_card)), dict(leaves(on_cpu))
    assert sorted(a) == sorted(b)
    for key, t in a.items():
        assert t.device.type == "cuda", key
        assert t.dtype == b[key].dtype and t.shape == b[key].shape, key
        assert torch.equal(t.cpu(), b[key]), key


#: (prompt, temperature, seed) of the background requests, greedy pair
#: first or sampled pair first: the first two seated hold the slots when
#: the interactive probe arrives, so the victim is of that kind
CARD_BG = {"greedy_victim": [("bulk a ", 0.0, 101), ("bulk d ", 0.0, 404),
                             ("bulk b ", 0.9, 202), ("bulk c ", 0.9, 303)],
           "sampled_victim": [("bulk b ", 0.9, 202), ("bulk c ", 0.9, 303),
                              ("bulk a ", 0.0, 101), ("bulk d ", 0.0, 404)]}


@pytest.mark.parametrize("order", list(CARD_BG))
def test_preempted_request_resumes_on_the_card(card, order):
    """toy-8m in bf16 on the card, the pool with the paged decode kernel
    (RAGGED_ATTENTION=off: every decode step has the same shapes, so the
    card's rounding does not depend on the batch): an interactive probe
    preempts a background request, which resumes by re-mapping its cached
    chain (no prefill) at its seed stream's index. Every transcript,
    greedy and sampled, equals an uncontended engine's."""
    import asyncio

    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.qos import QoSContext, use_qos
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
    from ai_agent_kubectl_tpu_torch.models.config import get_config

    bg, probe_req = CARD_BG[order], ("quick q ", 0.0, 505)

    def engine(wait_ms):
        return BatchedTorchEngine(
            get_config("toy-8m"), tokenizer=ByteTokenizer(), device="cuda",
            dtype="bfloat16", max_seq_len=128, prefill_buckets=(16, 32),
            batch_size=2, chunk_len=4, prefix_cache=False,
            ragged_attention="off", decode_attn="paged", kv_pool_page=16,
            preempt_wait_ms=wait_ms)

    async def uncontended():
        eng = engine(0.0)
        await eng.start()
        try:
            return {p: (await eng.generate(p, max_tokens=40, temperature=t,
                                           seed=s)).token_ids
                    for p, t, s in bg}
        finally:
            await eng.stop()

    async def contended():
        eng = engine(15.0)
        await eng.start()
        remaps = []
        map_prefix = eng._pool_map_prefix

        def recording(ids, match_all=False):
            blocks, m = map_prefix(ids, match_all=match_all)
            if match_all:
                remaps.append((len(ids), m))
            return blocks, m

        eng._pool_map_prefix = recording
        try:
            async def run_bg(p, t, s):
                with use_qos(QoSContext(tenant="bulk", lane="background")):
                    return await eng.generate(p, max_tokens=40,
                                              temperature=t, seed=s)

            tasks = [asyncio.ensure_future(run_bg(*r)) for r in bg]
            for _ in range(4000):
                await asyncio.sleep(0.005)
                if all(s is not None and len(s.detok.ids) > 0
                       for s in eng._slots):
                    break
            p, t, s = probe_req
            with use_qos(QoSContext(tenant="quiet", lane="interactive")):
                await eng.generate(p, max_tokens=8, temperature=t, seed=s)
            out = dict(zip([r[0] for r in bg],
                           [r.token_ids for r in await asyncio.gather(*tasks)]))
            return out, eng.stats()["qos"]["preemptions"], remaps
        finally:
            await eng.stop()

    want = asyncio.run(uncontended())
    got, preemptions, remaps = asyncio.run(contended())
    assert preemptions >= 1 and remaps
    assert all(m == n for n, m in remaps), remaps      # nothing prefilled
    assert got == want


@pytest.mark.parametrize("quant", ["", "int8"], ids=["f32", "int8"])
def test_dense_moe_on_the_card_matches_the_cpu(card, quant):
    """toy-moe's MoE MLP (4 experts, 2 routed) on one layer, float32, on
    the card and on the CPU from the same weights (int8 experts: the
    same bytes): the same routed experts, outputs within 1e-4 (float32
    GEMMs of another summation order)."""
    from ai_agent_kubectl_tpu_torch.models import transformer as tt
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.ops.quant import quantize_params_int8
    from ai_agent_kubectl_tpu_torch.parallel import moe

    cfg = get_config("toy-moe")
    params = tt.init_params(torch.Generator().manual_seed(0), cfg,
                            dtype=torch.float32)
    if quant:
        params = quantize_params_int8(params)
    lp = {k: v[1] for k, v in params["layers"].items()}
    x = torch.randn((3, 7, cfg.dim), generator=torch.Generator().manual_seed(1))

    def to_card(leaf):
        if hasattr(leaf, "q"):
            return type(leaf)(q=leaf.q.to(card), scale=leaf.scale.to(card))
        return leaf.to(card)

    card_lp = {k: to_card(v) for k, v in lp.items()}
    want = moe.dense_moe(cfg, lp, x)
    got = moe.dense_moe(cfg, card_lp, x.to(card))
    torch.cuda.synchronize()
    _, want_idx = moe.router_weights(cfg, (x @ lp["router"]).float())
    _, got_idx = moe.router_weights(
        cfg, (x.to(card) @ card_lp["router"]).float())
    assert torch.equal(got_idx.cpu(), want_idx)
    assert torch.allclose(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_sampled_transcript_on_the_card_equals_the_cpus(card):
    """TorchEngine at temperature 0.9 (toy-8m, float32, top-k 20): the
    split-chained threefry keys hash in int64 on the card as on the CPU,
    so the same seed gives the same transcript on both."""
    import asyncio

    from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
    from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
    from ai_agent_kubectl_tpu_torch.models import transformer as tt
    from ai_agent_kubectl_tpu_torch.models.config import get_config

    cfg = get_config("toy-8m")
    params = tt.init_params(torch.Generator().manual_seed(0), cfg,
                            dtype=torch.float32)

    async def transcript(device):
        eng = TorchEngine(
            cfg, tokenizer=ByteTokenizer(), device=device, dtype="float32",
            max_seq_len=128, prefill_buckets=(32, 64), attn_impl="dense",
            top_k=20, prefix_cache=False,
            params={k: ({n: w.to(device) for n, w in v.items()}
                        if isinstance(v, dict) else v.to(device))
                    for k, v in params.items()})
        await eng.start()
        try:
            return [(await eng.generate(p, max_tokens=24, temperature=0.9,
                                        seed=s)).token_ids
                    for p, s in (("get pods", 7), ("list nodes", 8))]
        finally:
            await eng.stop()

    want = asyncio.run(transcript("cpu"))
    got = asyncio.run(transcript("cuda"))
    assert got == want and all(len(t) > 0 for t in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kv_quantize_on_the_card_gives_the_cpus_bytes(card, dtype):
    """int8 KV written on the card equals the CPU's: the same payload
    bytes and bit-equal scales (``absmax / 127`` through ``true_div``,
    a correctly rounded division on both)."""
    from ai_agent_kubectl_tpu_torch.ops.quant import kv_quantize

    x = (torch.randn((4, 37, 8, 128),
                     generator=torch.Generator().manual_seed(3)) * 4)
    x[1, 2, 0] = 0.0
    x = x.to(dtype)
    want, got = kv_quantize(x), kv_quantize(x.to(card))
    torch.cuda.synchronize()
    assert torch.equal(got.q.cpu(), want.q)
    assert torch.equal(got.s.cpu().view(torch.int32),
                       want.s.view(torch.int32))


@pytest.mark.parametrize("T", [1, 8, 17])
def test_w8a8_int32_product_on_the_card_equals_the_cpus(card, T):
    """``int8_matmul`` on the card (``torch._int_mm``, fewer than 17 rows
    padded) against the CPU's int32 product, bit for bit, at K = 4096
    (past the 1041 where a float32 product would round)."""
    from ai_agent_kubectl_tpu_torch.ops.quant import int8_matmul

    gen = torch.Generator().manual_seed(T)
    a = torch.randint(-127, 128, (T, 4096), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (4096, 1024), generator=gen,
                      dtype=torch.int8)
    got = int8_matmul(a.to(card), b.to(card))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (T, 1024)
    assert torch.equal(got.cpu(), int8_matmul(a, b))


@pytest.mark.parametrize("layout", ["pool", "dense"])
def test_int8_kv_forward_on_the_card_matches_the_cpu(card, layout):
    """toy-8m in float32 over an int8 pool (the gather path) and an int8
    dense cache: a 12-token prefill and three decode steps (fixed
    tokens) on the card and on the CPU from the same weights. The
    float32 GEMMs sum in another order, so a K/V value on a rounding
    boundary of the int8 grid may land one step apart. The first layer
    reads the same embeddings: its payloads agree to one step in at
    least 99.9 % of the bytes, its scales within 1e-5. A flipped step
    moves every later layer's K/V as it moves the logits, which agree
    within 1e-2 (an H100 read differences up to 1.2e-3 from the
    CPU's)."""
    from ai_agent_kubectl_tpu_torch.models import transformer as tt
    from ai_agent_kubectl_tpu_torch.models.config import get_config

    cfg = get_config("toy-8m")
    params = tt.init_params(torch.Generator().manual_seed(0), cfg,
                            dtype=torch.float32)

    def run(device):
        p = {k: ({n: w.to(device) for n, w in v.items()}
                 if isinstance(v, dict) else v.to(device))
             for k, v in params.items()}
        kw = {}
        if layout == "pool":
            cache = tt.KVCache.pool(cfg, 8, 8, dtype=torch.float32,
                                    device=device, kv_quant="int8")
            kw["block_tables"] = torch.tensor(
                [[5, 2, 7, 0]], dtype=torch.int32, device=device)
        else:
            cache = tt.KVCache.zeros(cfg, 1, 32, dtype=torch.float32,
                                     device=device, kv_quant="int8")
        tokens = torch.arange(3, 15, device=device)[None]
        out = [tt.forward(p, cfg, tokens,
                          torch.arange(12, device=device)[None], cache,
                          kv_limit=32, attn_impl="dense", **kw)[0]]
        for pos in range(12, 15):
            logits, _ = tt.forward(
                p, cfg, torch.tensor([[pos + 8]], device=device),
                torch.tensor([[pos]], device=device), cache, kv_limit=32,
                attn_impl="dense", **kw)
            out.append(logits)
        return [o.cpu() for o in out], [
            (kv.q.cpu(), kv.s.cpu()) for kv in (cache.k, cache.v)]

    (want, want_kv), (got, got_kv) = run("cpu"), run(card)
    for (wq, ws), (gq, gs) in zip(want_kv, got_kv):
        steps = (gq[0].int() - wq[0].int()).abs()
        assert steps.max() <= 1 and (steps == 0).float().mean() >= 0.999
        assert torch.allclose(gs[0], ws[0], rtol=1e-5, atol=0)
    for w, g in zip(want, got):
        assert torch.allclose(g, w, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("scoped", [True, False], ids=["in_scope", "bare"])
def test_ragged_kernel_spans_bill_to_attention(card, tmp_path, scoped):
    """A profiler capture of serve's decode step (the ragged kernel and
    its split combine, launched through ctypes): attribution finds both
    among the card's spans and bills them to ``attention`` — by the
    enclosing ``attention`` scope, or by their symbols when no scope
    covers them — never to ``other_device``."""
    from ai_agent_kubectl_tpu_torch.obs import attribution as attr
    from ai_agent_kubectl_tpu_torch.obs.profiler import (ProfilerSession,
                                                         scope)

    args, page = _serve_pool(card, [63, 64, 127, 128, 0, 1023, 500, 191],
                             [1, 1, 1, 1, 1, 1, 0, 1], 1, seed=1)
    ragged_attention_pool(*args, page_size=page)
    torch.cuda.synchronize()
    session = ProfilerSession(card)
    session.start()
    for _ in range(3):
        if scoped:
            with scope("attention"):
                ragged_attention_pool(*args, page_size=page)
        else:
            ragged_attention_pool(*args, page_size=page)
    torch.cuda.synchronize()
    session.stop(str(tmp_path))
    spans, source = attr._select_spans(
        attr._load_trace_events(str(tmp_path)))
    assert source == "cuda_device"
    names = {op: attr.categorize(text) for _, _, text, op in spans
             if "ragged_" in op}
    assert any("ragged_mma_kernel" in n for n in names)
    assert any("ragged_combine_kernel" in n for n in names)
    assert set(names.values()) == {"attention"}
    art = attr.attribute_trace(str(tmp_path), 3)
    attr.validate_attribution(art)
    cats = {c["name"]: c["ms_per_step"] for c in art["categories"]}
    assert cats["attention"] > 0


def test_one_shot_nan_replays_on_the_card(card):
    """toy-8m in bf16 on the card, the pool and ragged regime, 4 slots:
    a one-shot decode:nan on one request in its third chunk trips the
    card's own health check; at QUARANTINE_RETRY_BUDGET=1 the engine
    resets and replays every slot. All four complete, and each
    transcript equals the fault-free one or leaves it first at a near
    tie: the replay builds the generated tokens' KV by prefill where the
    first run built it in decode, and bf16 can flip a pick whose top-2
    gap is within 5 % of the logits' rms (chip_smoke.py's gate)."""
    import asyncio

    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
    from ai_agent_kubectl_tpu_torch.models import transformer
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.testing.faults import FaultInjector

    prompts = [f"pod q{i} " for i in range(4)]
    inj = FaultInjector()
    eng = BatchedTorchEngine(
        get_config("toy-8m"), tokenizer=ByteTokenizer(), device="cuda",
        dtype="bfloat16", max_seq_len=128, prefill_buckets=(16, 32),
        batch_size=4, chunk_len=4, prefix_cache=False, faults=inj)

    async def burst():
        res = await asyncio.gather(*[eng.generate(p, max_tokens=24,
                                                  seed=100 + i)
                                     for i, p in enumerate(prompts)])
        return {p: list(r.token_ids) for p, r in zip(prompts, res)}

    async def drill():
        await eng.start()
        try:
            want = await burst()
            seen = {"n": 0}
            orig = inj.decode_nan_slots

            def once(slot_prompts, replica=None):
                hits = orig(slot_prompts, replica)
                if hits:
                    seen["n"] += 1
                    if seen["n"] <= 2:
                        return []
                    inj.release("decode")
                return hits

            inj.decode_nan_slots = once
            inj.target_substr = "pod q2 "
            inj.set("decode", "nan")
            return want, await burst(), eng.stats()["containment"]
        finally:
            await eng.stop()

    want, got, c = asyncio.run(drill())
    assert c["resets"] == {"slot_health": 1} and c["quarantined"] == {}
    assert c["health_trips"] == 1 and c["replayed_tokens"] > 0
    for p in prompts:
        a, b = want[p], got[p]
        if a == b:
            continue
        k = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        ids = eng.tokenizer.encode(p) + a[:k]
        P, pages = len(ids), -(-len(ids) // 16)
        with torch.no_grad():
            cache = transformer.KVCache.pool(eng.model_cfg, pages, 16,
                                             dtype=eng.dtype, device=card)
            logits, _ = transformer.forward(
                eng.params, eng.model_cfg, torch.tensor([ids], device=card),
                torch.arange(P, dtype=torch.int32, device=card)[None], cache,
                block_tables=torch.arange(pages, dtype=torch.int32,
                                          device=card)[None],
                logits_at=torch.tensor([P - 1], device=card))
        row = logits[0, 0].float()
        top2 = torch.topk(row, 2).values
        assert float(top2[0] - top2[1]) <= 0.05 * float(
            row.pow(2).mean().sqrt()), (p, k)


def test_masked_step_fold_on_the_card_equals_the_cpus(card):
    """The grammar's per-step fold (``batcher.step_fold``: the legality
    mask gathered through the stacked tables, a dead end frozen before it
    samples, the masked draw, the FSM advance by the sampled token's
    class, EOS and budget) run for eight steps on the card and on the
    CPU over the same toy inputs: ByteTokenizer's default and readonly
    profiles at vocabulary 512, greedy and seeded 0.9 rows, one row in
    the DEAD state and one a token short of its budget. Every step's
    tokens, live flags, counts, health words and states are equal."""
    from ai_agent_kubectl_tpu_torch.constrain import GrammarRuntime
    from ai_agent_kubectl_tpu_torch.engine.batcher import step_fold
    from ai_agent_kubectl_tpu_torch.engine.protocol import (
        HEALTH_GRAMMAR_DEAD)
    from ai_agent_kubectl_tpu_torch.engine.sampling import (
        sample_tokens_seeded)
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer

    tok, V = ByteTokenizer(), 512
    rt = GrammarRuntime(tok, V, tok.eos_ids)
    _, tc, ok, nxt = rt.snapshot_tables()

    def enc(s):
        return tok.encode(s, add_bos=False)

    gs0 = np.array([rt.start_state(0), rt.run(0, enc("kubectl get p")),
                    rt.run(0, enc("not kubectl")), rt.start_state(1),
                    rt.run(0, enc("kubectl ver")),
                    rt.run(1, enc("kubectl logs web-")), ], np.int64)
    N = len(gs0)
    assert rt.is_dead(int(gs0[2])) and not rt.is_dead(int(gs0[5]))
    rng = np.random.default_rng(3)
    steps = (rng.standard_normal((8, N, V)) * 3.0).astype(np.float32)
    temps = np.array([0.0, 0.9, 0.9, 0.0, 0.9, 0.0], np.float32)
    seeds = np.array([7, 8, 9, 10, 11, 12], np.int64)
    budget = np.array([40, 40, 40, 40, 40, 3], np.int32)

    def run(dev):
        tc_d = torch.from_numpy(tc).to(dev, torch.int64)
        ok_d = torch.from_numpy(ok).to(dev)
        nx_d = torch.from_numpy(nxt).to(dev, torch.int64)
        gs = torch.from_numpy(gs0).to(dev)
        rows = tc_d[torch.div(gs, rt.S_max, rounding_mode="floor")]
        seeds_d, temps_d = (torch.from_numpy(seeds).to(dev),
                            torch.from_numpy(temps).to(dev))

        def sample(lg, ngen, live, mask):
            return sample_tokens_seeded(lg, seeds_d, ngen, temps_d,
                                        active=live, mask=mask)

        tok_d = torch.zeros((N,), dtype=torch.int32, device=dev)
        live = torch.ones((N,), dtype=torch.bool, device=dev)
        ngen = torch.full((N,), 2, dtype=torch.int32, device=dev)
        budget_d = torch.from_numpy(budget).to(dev)
        health = torch.zeros_like(ngen)
        eos = torch.tensor(tok.eos_ids, dtype=torch.int32, device=dev)
        trail = []
        for logits in steps:
            tok_d, live, ngen, health, counted, gs = step_fold(
                torch.from_numpy(logits).to(dev), tok_d, live, ngen,
                budget_d, health, (gs, rows, ok_d, nx_d), sample, eos, V,
                True)
            trail.append([x.cpu() for x in (tok_d, live, ngen, health,
                                            counted, gs)])
        return trail

    want, got = run("cpu"), run(card)
    for a, b in zip(want, got):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    last = want[-1]
    assert int(last[3][2]) & HEALTH_GRAMMAR_DEAD and not bool(last[1][2])
    assert int(last[2][5]) == 3 and not bool(last[1][5])
    assert int(last[2][0]) > 2 and not rt.is_dead(int(last[5][0]))


def test_spec_chunk_on_the_card_equals_spec_off(card):
    """Speculative decoding on the card: toy-8m in bf16, the pool and
    ragged regime, 4 slots, greedy, k=2 with an identical draft (the
    target's seed, so the accept path fires). The verify windows run through the
    ragged kernel at q_len 3 (at least a launch a layer a verify
    forward), proposals are accepted, the books balance, and each
    transcript equals spec off's or leaves it first at a near tie (top-2
    gap within 5 % of the logits' rms, as in the replay test above): the
    verify window computes a position's logits in a 3-column window
    where plain decode computes them alone, and bf16 rounds the two
    apart."""
    import asyncio

    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
    from ai_agent_kubectl_tpu_torch.models import transformer
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool)

    prompts = [f"pod q{i} " for i in range(4)]
    kw = dict(tokenizer=ByteTokenizer(), device="cuda", dtype="bfloat16",
              max_seq_len=128, prefill_buckets=(16, 32), batch_size=4,
              chunk_len=4, prefix_cache=False)

    async def run(**spec):
        eng = BatchedTorchEngine(get_config("toy-8m"), **kw, **spec)
        await eng.start()
        try:
            # The warm-up's chunks still in flight run out first: the
            # counts below are this burst's alone.
            await _until(lambda: not eng._inflight,
                         "the warm-up's chunks never ran out")
            ragged_attention_pool.launches = 0
            v0 = eng.verify_steps
            res = await asyncio.gather(*[
                eng.generate(p, max_tokens=24, seed=100 + i)
                for i, p in enumerate(prompts)])
            await _until(lambda: not eng._inflight,
                         "the burst's chunks never ran out")
            return eng, ragged_attention_pool.launches, \
                eng.verify_steps - v0, [list(r.token_ids) for r in res]
        finally:
            await eng.stop()

    on, launches, verify, got = asyncio.run(run(
        spec_decode=True, spec_draft_k=2, spec_draft_model="toy-8m",
        spec_draft_seed=0))
    off, _, _, want = asyncio.run(run())
    h = on.spec_health()
    assert h["drafted_tokens_total"] > 0 and h["accepted_tokens_total"] > 0
    assert verify > 0
    assert launches >= on.model_cfg.n_layers * verify
    assert on.ledger_snapshot()["conservation"]["balanced"]
    for p, a, b in zip(prompts, want, got):
        if a == b:
            continue
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        ids = off.tokenizer.encode(p) + a[:k]
        P, pages = len(ids), -(-len(ids) // 16)
        with torch.no_grad():
            cache = transformer.KVCache.pool(off.model_cfg, pages, 16,
                                             dtype=off.dtype, device=card)
            logits, _ = transformer.forward(
                off.params, off.model_cfg, torch.tensor([ids], device=card),
                torch.arange(P, dtype=torch.int32, device=card)[None], cache,
                block_tables=torch.arange(pages, dtype=torch.int32,
                                          device=card)[None],
                logits_at=torch.tensor([P - 1], device=card))
        row = logits[0, 0].float()
        top2 = torch.topk(row, 2).values
        assert float(top2[0] - top2[1]) <= 0.05 * float(
            row.pow(2).mean().sqrt()), (p, k)


def test_onloaded_blocks_are_bit_identical_on_the_card(card):
    """The two-tier host KV on the card: toy-8m in bf16, the pool and
    ragged regime, 4 slots (DECODE_ATTN=auto raises the page of this GQA
    model to 64 on the card). Every full page of a session's prompt is
    read on the card before radix eviction demotes it to host RAM; the
    returning turn onloads each into a fresh block, which must hold the
    same bytes (K and V, every layer); the books balance across both
    tiers."""
    import asyncio

    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
    from ai_agent_kubectl_tpu_torch.models.config import get_config

    prompt = ("inspect deployment rollout status verbose 3 across the "
              "staging cluster now, then list every pod of the deployment "
              "with its node and restarts")

    async def run():
        eng = BatchedTorchEngine(
            get_config("toy-8m"), tokenizer=ByteTokenizer(), device="cuda",
            dtype="bfloat16", max_seq_len=320, prefill_buckets=(32, 64, 128),
            batch_size=4, chunk_len=4, prefix_cache=False,
            host_kv_blocks=16)
        await eng.start()
        try:
            page = eng.kv_pool_page
            r1 = await eng.generate(prompt, max_tokens=12)
            ids = eng.tokenizer.encode(prompt)
            node, snaps = eng._radix._root, []
            for i in range(len(ids) // page):
                node = node.children[tuple(ids[i * page:(i + 1) * page])]
                snaps.append((node, [leaf[:, node.block].clone()
                                     for leaf in eng._kv_leaves()]))
            assert eng._radix.evict_for(eng._pool.n_blocks)
            assert all(n.block is None for n, _ in snaps)
            await eng.generate(prompt + r1.text + " and then?",
                               max_tokens=12)
            assert eng._host_store.onloaded_total >= len(snaps) > 0
            for n, want in snaps:
                for leaf, w in zip(eng._kv_leaves(), want):
                    assert torch.equal(leaf[:, n.block].view(torch.uint8),
                                       w.view(torch.uint8))
            holders: dict = {}
            for slot in eng._slots:
                for b in (slot.blocks or []) if slot is not None else []:
                    holders[b] = holders.get(b, 0) + 1
            for b, k in eng._radix._held.items():
                holders[b] = holders.get(b, 0) + k
            eng._pool.check(holders, host=eng._host_store,
                            host_holders=eng._radix.host_holders())
        finally:
            await eng.stop()

    asyncio.run(run())


def test_fleet_migrates_a_request_between_two_replicas_on_the_card(card):
    """Two toy-8m replicas (bf16, the pool and ragged regime) on one card
    behind the fleet: replica 0 is drained while its scheduler is held
    with the request in flight, and the request finishes on replica 1
    from its exported ids. One migration carrying the ids generated so
    far; both replicas ran ragged forwards; the transcript equals the
    undisturbed one or leaves it first at a near tie (top-2 gap within
    5 % of the logits' rms: the replay builds the carried ids' KV by
    prefill where the first run built it in decode, and bf16 rounds the
    two apart); the merged books balance."""
    import asyncio
    import threading

    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.fleet import EngineFleet
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
    from ai_agent_kubectl_tpu_torch.models import transformer
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool)

    prompt = "pod migrate "
    kw = dict(tokenizer=ByteTokenizer(), device="cuda", dtype="bfloat16",
              max_seq_len=128, prefill_buckets=(16, 32), batch_size=4,
              chunk_len=4, prefix_cache=False)

    async def run():
        fleet = EngineFleet([BatchedTorchEngine(get_config("toy-8m"), **kw)
                             for _ in range(2)], affinity=False)
        await fleet.start()
        try:
            want = await fleet.generate(prompt, max_tokens=48, seed=7)
            eng0 = fleet.replicas[0].engine
            real = type(eng0)._dispatch_chunk.__get__(eng0)
            base = eng0._chunks_consumed
            reached, opened = threading.Event(), threading.Event()

            def held():
                # Held once three chunks were read: tokens delivered,
                # chunks still in the pipe.
                if (eng0._chunks_consumed - base >= 3
                        and not opened.is_set()):
                    reached.set()
                    opened.wait(60)
                real()

            eng0._dispatch_chunk = held
            steps = [r.engine.forward_steps for r in fleet.replicas]
            ragged_attention_pool.launches = 0
            task = asyncio.create_task(
                fleet.generate(prompt, max_tokens=48, seed=7))
            await _until(reached.is_set,
                         "replica 0 never read three chunks")
            drain = asyncio.create_task(fleet.drain(0))
            await _until(lambda: fleet._migrations > 0,
                         "the drain never migrated the request")
            opened.set()
            got = await task
            await drain
            grew = [r.engine.forward_steps - s
                    for r, s in zip(fleet.replicas, steps)]
            return (fleet, want, got, grew, ragged_attention_pool.launches,
                    fleet.ledger_snapshot())
        finally:
            await fleet.stop()

    fleet, want, got, grew, launches, books = asyncio.run(run())
    assert fleet._migrations == 1 and fleet._migrated_tokens > 0
    assert all(g > 0 for g in grew)
    assert launches >= fleet.replicas[0].engine.model_cfg.n_layers * sum(grew)
    assert books["conservation"]["balanced"]
    a, b = list(want.token_ids), list(got.token_ids)
    if a != b:
        eng = fleet.replicas[1].engine
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        assert k >= fleet._migrated_tokens
        ids = eng.tokenizer.encode(prompt) + a[:k]
        P, pages = len(ids), -(-len(ids) // 16)
        with torch.no_grad():
            cache = transformer.KVCache.pool(eng.model_cfg, pages, 16,
                                             dtype=eng.dtype, device=card)
            logits, _ = transformer.forward(
                eng.params, eng.model_cfg, torch.tensor([ids], device=card),
                torch.arange(P, dtype=torch.int32, device=card)[None], cache,
                block_tables=torch.arange(pages, dtype=torch.int32,
                                          device=card)[None],
                logits_at=torch.tensor([P - 1], device=card))
        row = logits[0, 0].float()
        top2 = torch.topk(row, 2).values
        assert float(top2[0] - top2[1]) <= 0.05 * float(
            row.pow(2).mean().sqrt())


def test_pipe_of_three_overlaps_the_card_and_serves_depth_ones_transcripts(
        card):
    """The batched engine at CHUNK_PIPE_DEPTH=3 against depth 1 on the
    same toy weights, requests one at a time (greedy and seeded 0.9):
    byte-identical transcripts. Each forward also queues a device-side
    spin (``torch.cuda._sleep``) so that the card, not the host, sets
    the pace: then at depth 3 a dispatch begins while an earlier chunk
    still runs on the card (its event not yet complete), and at depth 1
    never. Every dispatch runs under
    ``torch.cuda.set_sync_debug_mode("error")``: no upload or read
    between dispatches waits for the stream."""
    import asyncio

    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
    from ai_agent_kubectl_tpu_torch.models.config import get_config

    reqs = [("pod alpha ", 0.0, 1), ("list things ", 0.9, 7),
            ("get nodes ", 0.9, 8)]
    kw = dict(tokenizer=ByteTokenizer(), device="cuda", dtype="bfloat16",
              max_seq_len=128, prefill_buckets=(16, 32), batch_size=2,
              chunk_len=4, prefix_cache=False)

    def slowed(eng):
        forward = eng._forward

        def call(*args, **kwargs):
            out = forward(*args, **kwargs)
            torch.cuda._sleep(50_000_000)      # tens of ms of device work
            return out
        eng._forward = call

    async def run(depth):
        eng = BatchedTorchEngine(get_config("toy-8m"), chunk_pipe_depth=depth,
                                 **kw)
        await eng.start()
        slowed(eng)
        dispatch, overlapped = eng._dispatch_chunk, []

        def watched():
            earlier = [e[1][1] for e in eng._inflight if e[0] == "chunk"]
            overlapped.append(any(not ev.query() for ev in earlier))
            torch.cuda.set_sync_debug_mode("error")
            try:
                dispatch()
            finally:
                torch.cuda.set_sync_debug_mode("default")

        eng._dispatch_chunk = watched
        try:
            out = [list((await eng.generate(p, max_tokens=24, temperature=t,
                                            seed=s)).token_ids)
                   for p, t, s in reqs]
        finally:
            await eng.stop()
        return out, overlapped, eng.stats()["containment"]["resets"]

    deep, deep_overlap, deep_resets = asyncio.run(run(3))
    shallow, shallow_overlap, shallow_resets = asyncio.run(run(1))
    assert deep == shallow
    assert deep_resets == shallow_resets == {}
    assert any(deep_overlap) and not any(shallow_overlap)


#: the tensor-parallel slice's per-shard geometries (H, KV, hd): Llama-3-8B
#: at tp=2 and tp=8, Gemma-7B at tp=2
TP_SHARDS = {"llama_tp2": (2, 32, 8, 128), "llama_tp8": (8, 32, 8, 128),
             "gemma7b_tp2": (2, 16, 16, 256)}


@pytest.mark.parametrize("geometry", sorted(TP_SHARDS))
def test_sharded_pool_kernels_launch_per_shard(card, geometry):
    """``ragged_attention_pool_sharded`` and
    ``paged_decode_attention_pool_sharded`` on two or eight shards of one
    card: one kernel launch per shard, each shard's output against its
    plain version, and the assembled output against the unsharded
    kernel on the same pool (decode, a verify window and a prefill span
    over 16-token pages)."""
    from ai_agent_kubectl_tpu_torch.ops import ragged_attention as tra
    from ai_agent_kubectl_tpu_torch.parallel.mesh import (MeshConfig,
                                                          build_mesh)

    tp, H, KV, hd = TP_SHARDS[geometry]
    mesh = build_mesh(MeshConfig(model=tp), [card] * tp)
    gen = torch.Generator(device=card).manual_seed(tp)
    page, n_blocks, W, N = 16, 24, 8, 3
    k = torch.randn((n_blocks, page, KV, hd), generator=gen,
                    device=card).to(torch.bfloat16)
    v = torch.randn((n_blocks, page, KV, hd), generator=gen,
                    device=card).to(torch.bfloat16)
    q = torch.randn((N, W, H, hd), generator=gen,
                    device=card).to(torch.bfloat16)
    q_lens = torch.tensor([1, 5, 8], dtype=torch.int32, device=card)
    pos = torch.tensor([70, 33, 0], dtype=torch.int32, device=card)
    tables = torch.arange(N * 8, dtype=torch.int32,
                          device=card).view(N, 8).contiguous()
    before = tra.ragged_attention_pool_sharded.launches
    shards = tra.ragged_attention_pool_sharded(q, k, v, q_lens, pos, tables,
                                               mesh, page_size=page)
    assert tra.ragged_attention_pool_sharded.launches == before + tp
    plain = tra.ragged_attention_pool_sharded(q.float(), k.float(),
                                              v.float(), q_lens, pos,
                                              tables, mesh, page_size=page,
                                              plain=True)
    for s, p in zip(shards, plain):
        _close(s, p)
    _close(torch.cat(shards, dim=2),
           ragged_attention_pool(q, k, v, q_lens, pos, tables,
                                 page_size=page))
    q1 = q[:, 0].contiguous()
    before = tpa.paged_decode_attention_pool_sharded.launches
    shards = tpa.paged_decode_attention_pool_sharded(q1, k, v, pos, tables,
                                                     mesh, page_size=page)
    assert tpa.paged_decode_attention_pool_sharded.launches == before + tp
    for s, p in zip(shards, tpa.paged_decode_attention_pool_sharded(
            q1.float(), k.float(), v.float(), pos, tables, mesh,
            page_size=page, plain=True)):
        _close(s, p)
    _close(torch.cat(shards, dim=1),
           tpa.paged_decode_attention_pool(q1, k, v, pos, tables,
                                           page_size=page))


@pytest.mark.parametrize("axes", [dict(expert=2), dict(expert=2, model=2)],
                         ids=["ep2", "ep2_tp2"])
def test_expert_parallel_moe_on_the_card_matches_the_cpu(card, axes):
    """toy-moe's dispatch, float32, over shards of one card and of the
    CPU from the same weights: each shard's output within 1e-4 (float32
    GEMMs of another summation order), and every token kept (decode's
    capacity of every local token)."""
    from ai_agent_kubectl_tpu_torch.models import transformer as tt
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.parallel import moe
    from ai_agent_kubectl_tpu_torch.parallel.mesh import (MeshConfig,
                                                          build_mesh)
    from ai_agent_kubectl_tpu_torch.parallel.sharding import shard_params

    cfg = get_config("toy-moe")
    params = tt.init_params(torch.Generator().manual_seed(0), cfg,
                            dtype=torch.float32)
    x = torch.randn((4, 1, cfg.dim), generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", card):
        mesh = build_mesh(MeshConfig(**axes),
                          [dev] * MeshConfig(**axes).n_devices)
        lps = [{k: t["layers"][k][0] for k in ("router", "w_gate", "w_up",
                                                "w_down")}
               for t in shard_params(params, mesh, cfg)]
        out[str(dev)] = moe.expert_parallel_moe(
            cfg, lps, [x.to(dev)] * mesh.size, mesh, capacity=2)
    torch.cuda.synchronize()
    for got, want in zip(out[str(card)], out["cpu"]):
        assert torch.allclose(got.cpu(), want, atol=1e-4, rtol=1e-4)
    lp = {k: v[0] for k, v in params["layers"].items()}
    assert torch.allclose(out["cpu"][0], moe.dense_moe(cfg, lp, x),
                          atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("spec,n", [("dp=2,ep=2,tp=2", 8), ("ep=2", 2)])
def test_toy_moe_mesh_engine_on_the_card_equals_the_cpus(card, spec, n):
    """toy-moe through ``BatchedTorchEngine`` on a mesh of shards of one
    card (float32, so the pool serves its gather path: the ragged kernel
    reads bf16): the dense ladder under the data axis (the pool's
    fallback), or the pool on an expert mesh; greedy transcripts equal
    to the same mesh's on the CPU, the fallback flagged."""
    import asyncio

    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
    from ai_agent_kubectl_tpu_torch.models import transformer as tt
    from ai_agent_kubectl_tpu_torch.models.config import get_config

    cfg = get_config("toy-moe")
    params = tt.init_params(torch.Generator().manual_seed(0), cfg,
                            dtype=torch.float32)
    prompts = ["list pods", "get nodes -o wide", "describe deployment web"]

    async def run(dev):
        eng = BatchedTorchEngine(
            cfg, tokenizer=ByteTokenizer(), params=params, device=dev,
            dtype="float32", max_seq_len=128, prefill_buckets=(32, 64),
            batch_size=4, chunk_len=4, prefix_cache=False,
            ragged_attention="off", mesh_shape=spec, devices=[dev] * n)
        await eng.start()
        try:
            res = await asyncio.gather(*[
                eng.generate(p, max_tokens=12, temperature=0.0)
                for p in prompts])
            return [r.text for r in res], eng.sharding_health()
        finally:
            await eng.stop()

    got, health = asyncio.run(run("cuda"))
    want, _ = asyncio.run(run("cpu"))
    assert got == want
    assert health["kv_pool_mesh_fallback"] is spec.startswith("dp")


def test_spec_on_tp2_on_the_card_equals_spec_off(card):
    """Speculative decoding on a tp=2 mesh of one card (toy-8m, float32,
    the draft toy-8m from the target's seed, k=2; float32 serves the
    pool's gather path, the ragged kernel reading bf16): the draft
    sharded, proposals accepted, and the greedy transcripts equal to
    spec off on one device. serve_spec_tp in ``chip_smoke.py`` drives
    the sharded ragged kernel in bf16."""
    import asyncio

    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
    from ai_agent_kubectl_tpu_torch.models.config import get_config

    prompts = [f"pod q{i} " for i in range(4)]
    kw = dict(tokenizer=ByteTokenizer(), device="cuda", dtype="float32",
              max_seq_len=128, prefill_buckets=(16, 32), batch_size=4,
              chunk_len=4, prefix_cache=False, ragged_attention="off")

    async def run(**extra):
        eng = BatchedTorchEngine(get_config("toy-8m"), **kw, **extra)
        await eng.start()
        try:
            res = await asyncio.gather(*[
                eng.generate(p, max_tokens=24, temperature=0.0)
                for p in prompts])
            return eng, [r.text for r in res]
        finally:
            await eng.stop()

    on, got = asyncio.run(run(
        spec_decode=True, spec_draft_k=2, spec_draft_model="toy-8m",
        spec_draft_seed=0, mesh_shape="tp=2", devices=[card] * 2))
    _, want = asyncio.run(run())
    h = on.spec_health()
    assert h["draft_sharded"] is True and h["draft_kv_fallback"] is False
    assert h["accepted_tokens_total"] > 0
    assert len(on._draft_cache.k.shards) == 2
    assert got == want
