"""The paged decode kernel's work plan, mirrored in Python and checked on
the CPU: the chunk rule (``ops/paged_attention.py::split_plan``, which
the kernel holds every launch to) and the list of work items each block
of ``csrc/paged_attention.cu`` derives on the device from the positions.

An item is one chunk of one row tile (slot, KV head, 16 query heads); a
slot at position p has ``min(p, span - 1) // chunk + 1`` chunks. These
tests hold the list to what the kernel's note promises: every live key
in exactly one item, no item past a slot's last key, a slot's chunk
edges moved by its own position only; and a chunked merge in chunk order
over the plain version's numerics (a helper here) to the JAX Pallas
kernels in interpret mode, within the float32 tolerance that
``tests/test_torch_paged_attention.py`` states (2e-5). The kernel itself
runs only on the card (``tests/test_torch_cuda.py``).
"""

import math

import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged,
    paged_decode_attention_pool as jax_paged_pool)
from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
    ROW_TILE, TARGET_ITEMS, slot_chunks, split_plan)

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=2e-5)
LOG2E = 1.4426950408889634
SMS = 132                      # an H100 SXM's SMs

#: (N, H, KV, head_dim, span): the served shapes (serve_paged's dense
#: cache and pool, the ring decode's tp=2 shard, serve_host's Gemma-2B
#: pool, Gemma-7B's MHA, Mixtral's (data, model) shard, 32 Llama slots)
#: and a toy one
SHAPES = {"llama_dense": (8, 32, 8, 128, 1088),
          "llama_pool": (8, 32, 8, 128, 1024),
          "ring_tp2": (8, 16, 4, 128, 8256),
          "gemma2b": (8, 8, 1, 256, 1024),
          "gemma7b": (8, 16, 16, 256, 1040),
          "mixtral_shard": (4, 16, 4, 128, 1088),
          "llama_32slots": (32, 32, 8, 128, 1088),
          "toy": (4, 8, 2, 64, 192)}


def items(positions, H, KV, span, chunk):
    """The kernel's item list, in its order: slot, then KV head, then row
    tile, then chunk; each (n, kvh, rt, c, first key, last key), the
    keys (-1, -1) for a slot with no visible key."""
    rtiles = -(-(H // KV) // ROW_TILE)
    out = []
    for n, pos in enumerate(positions):
        cn = slot_chunks(pos, span, chunk)
        last = -1 if pos < 0 else min(pos, span - 1)
        for t in range(KV * rtiles):
            for c in range(cn):
                keys = ((-1, -1) if last < 0 else
                        (c * chunk, min(c * chunk + chunk - 1, last)))
                out.append((n, t // rtiles, t % rtiles, c) + keys)
    return out


def _positions(rng, N, span):
    """Positions over the whole range a slot can hold, and past it."""
    pos = rng.integers(-2, span + 40, size=N)
    pos[0] = 0
    return [int(p) for p in pos]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_every_live_key_is_in_exactly_one_item(shape):
    N, H, KV, hd, span = SHAPES[shape]
    _, chunk, tiles = split_plan(N, H, KV, hd, span)
    rng = np.random.default_rng(len(shape))
    for _ in range(20):
        positions = _positions(rng, N, span)
        got = items(positions, H, KV, span, chunk)
        seen = {}
        for n, kvh, rt, _c, k0, k1 in got:
            if k0 < 0:
                continue
            for key in range(k0, k1 + 1):
                seen[(n, kvh, rt, key)] = seen.get((n, kvh, rt, key), 0) + 1
        want = {(n, kvh, rt, key)
                for n, p in enumerate(positions) if p >= 0
                for kvh in range(KV) for rt in range(tiles // (N * KV))
                for key in range(min(p, span - 1) + 1)}
        assert set(seen) == want
        assert set(seen.values()) <= {1}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_no_item_reaches_past_its_slots_last_key(shape):
    """Every item holds keys, a whole chunk but for the slot's last, and
    none past the slot's last key; a negative position is one item of
    no keys (its rows are zeros)."""
    N, H, KV, hd, span = SHAPES[shape]
    _, chunk, _ = split_plan(N, H, KV, hd, span)
    rng = np.random.default_rng(7 + len(shape))
    for _ in range(20):
        positions = _positions(rng, N, span)
        for n, _kvh, _rt, c, k0, k1 in items(positions, H, KV, span, chunk):
            p = positions[n]
            if p < 0:
                assert (c, k0, k1) == (0, -1, -1)
                continue
            last = min(p, span - 1)
            assert k0 <= k1 <= last
            assert k0 == c * chunk
            assert k1 - k0 + 1 == chunk or k1 == last


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_a_slots_chunk_edges_move_with_its_own_position_only(shape):
    """Slot 0's items stay as they are while every other slot moves."""
    N, H, KV, hd, span = SHAPES[shape]
    _, chunk, _ = split_plan(N, H, KV, hd, span)
    rng = np.random.default_rng(11)
    positions = _positions(rng, N, span)
    positions[0] = span // 2

    def own(pos):
        return [it for it in items(pos, H, KV, span, chunk) if it[0] == 0]

    before = own(positions)
    for _ in range(10):
        moved = [positions[0]] + _positions(rng, N, span)[1:]
        assert own(moved) == before


def test_chunk_rule_is_a_function_of_the_shapes():
    """Chunks are whole multiples of 64 keys covering the span, carry at
    least 128 KB of K/V rows unless the span is shorter, aim at 198 items
    with every slot at the span's end, and give one chunk when the row
    tiles alone reach that."""
    for N in (1, 2, 4, 8, 16, 32, 64):
        for H, KV in ((32, 8), (8, 1), (16, 16), (16, 4), (64, 2)):
            for hd in (64, 128, 256):
                for span in (16, 64, 100, 1024, 1040, 1088, 4096, 8256):
                    max_chunks, chunk, tiles = split_plan(N, H, KV, hd, span)
                    assert tiles == N * KV * math.ceil(H / KV / 16)
                    assert chunk % 64 == 0
                    assert (max_chunks - 1) * chunk < span <= (
                        max_chunks * chunk)
                    assert chunk * 4 * hd >= 131072 or max_chunks == 1
                    if max_chunks > 1:
                        assert tiles * max_chunks <= TARGET_ITEMS + tiles
                    if tiles >= TARGET_ITEMS:
                        assert max_chunks == 1


def test_chunk_rule_at_the_served_shapes():
    """serve_paged's decode: a slot at 212 is one item, at 727 two, for
    both layouts. The ring decode's shard: its slots near 3,000 and
    6,000 fill the 132 SMs once, at the timing phase's positions (on and
    beside 960-key boundaries) and on and beside the chunk edges nearest
    them."""
    for span in (1088, 1024):
        _, chunk, _ = split_plan(8, 32, 8, 128, span)
        assert slot_chunks(212, span, chunk) == 1
        assert slot_chunks(727, span, chunk) == 2
    _, chunk, _ = split_plan(8, 16, 4, 128, 8256)
    assert chunk == 1344
    edges = []
    for near in (3000, 6000):
        edge = max(1, round(near / chunk)) * chunk
        edges += [edge - 1, edge, edge + 1, near]
    for positions in ([2879, 2880, 2881, 3000, 5759, 5760, 5761, 6000],
                      edges):
        n_items = len(items(positions, 16, 4, 8256, chunk))
        assert 96 < n_items <= SMS


def test_plan_refuses_what_the_kernel_does_not_take():
    for bad in ((0, 32, 8, 128, 1088), (8, 30, 8, 128, 1088),
                (8, 32, 8, 96, 1088), (8, 32, 8, 128, 0),
                (2049, 32, 8, 128, 1088)):
        with pytest.raises(ValueError):
            split_plan(*bad)


def test_blocks_take_every_item_once():
    """The persistent grid's runs: block b takes items b * I // B up to
    (b + 1) * I // B, for any count of items and of blocks."""
    for total in (0, 1, 7, 128, 131, 132, 133, 1000):
        for blocks in (1, 8, 132):
            runs = [range(b * total // blocks, (b + 1) * total // blocks)
                    for b in range(blocks)]
            assert [i for r in runs for i in r] == list(range(total))
            assert max(map(len, runs)) <= -(-total // blocks)


def chunked_decode(q, k_ctx, v_ctx, positions, chunk, scale):
    """Decode attention the kernel's way, float32: over per-slot views
    [N, S, KV, hd], each row tile's chunks attended alone (the plain
    version's numerics: scores scaled into the log2 domain, keys past the
    slot's last one selected away), then merged in chunk order as
    ``combine_row`` merges them; a slot with no visible key gets
    zeros."""
    N, H, hd = q.shape
    S, KV = k_ctx.shape[1], k_ctx.shape[2]
    G = H // KV
    out = torch.zeros((N, H, hd), dtype=torch.float32)
    for n, pos in enumerate(positions):
        if pos < 0:
            continue
        last = min(pos, S - 1)
        for kvh in range(KV):
            qh = q[n, kvh * G:(kvh + 1) * G].float()            # [G, hd]
            m = torch.full((G,), -math.inf)
            den = torch.zeros(G)
            num = torch.zeros((G, hd))
            for c in range(slot_chunks(pos, S, chunk)):
                k0, k1 = c * chunk, min(c * chunk + chunk - 1, last)
                kc = k_ctx[n, k0:k1 + 1, kvh].float()
                vc = v_ctx[n, k0:k1 + 1, kvh].float()
                s = (qh @ kc.T) * (scale * LOG2E)
                cm = s.max(dim=1).values
                p = torch.exp2(s - cm[:, None])
                cl, co = p.sum(dim=1), p @ vc
                mn = torch.maximum(m, cm)
                a = torch.where(m == -math.inf, 0.0, torch.exp2(m - mn))
                w = torch.exp2(cm - mn)
                den = den * a + w * cl
                num = num * a[:, None] + w[:, None] * co
                m = mn
            out[n, kvh * G:(kvh + 1) * G] = num / den[:, None]
    return out


def _dense_case(seed, N=4, S=192, H=8, KV=2, hd=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((N, H, hd)).astype(np.float32)
    k = rng.standard_normal((N, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((N, S, KV, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("chunk", [64, None], ids=["chunk64", "rule"])
@pytest.mark.parametrize("positions", [(63, 64, 127, 128), (0, 191, 65, 130)],
                         ids=["on_and_past_edges", "span_ends"])
def test_chunked_merge_matches_the_jax_kernel_dense(positions, chunk):
    """G = 4 (8 query heads over 2 KV heads), page 16, live spans ending
    on and just past a 64-key chunk edge, on the first key and on the
    span's last slot; chunks of 64 keys (three a slot at most) and the
    rule's own chunk (one at this toy shape)."""
    q, k, v = _dense_case(3)
    pos = np.asarray(positions, np.int32)
    if chunk is None:
        chunk = split_plan(4, 8, 2, 64, 192)[1]
    want = np.asarray(jax_paged(q, k, v, pos, page_size=16, interpret=True))
    got = chunked_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                         positions, chunk, 64 ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("chunk", [64, 128])
def test_chunked_merge_matches_the_jax_kernel_pool(chunk):
    """The pool through permuted tables (each slot's live pages on their
    own blocks, the sentinel past them clamping onto a NaN block),
    gathered per slot and merged chunk by chunk: the JAX pool kernel's
    output, NaN-free."""
    q, _, _ = _dense_case(5)
    positions = (40, 191, 64, 127)
    page, n_pages = 16, 12
    n_blocks = 4 * n_pages + 1
    rng = np.random.default_rng(6)
    kp = rng.standard_normal((n_blocks, page, 2, 64)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, page, 2, 64)).astype(np.float32)
    kp[-1] = vp[-1] = np.nan
    perm = rng.permutation(n_blocks - 1).astype(np.int32)
    tables = np.full((4, n_pages), n_blocks + 2, np.int32)
    for n, p in enumerate(positions):
        live = p // page + 1
        tables[n, :live] = perm[n * n_pages:n * n_pages + live]
    want = np.asarray(jax_paged_pool(q, kp, vp, np.asarray(positions,
                                                            np.int32),
                                     tables, page_size=page, interpret=True))
    idx = np.clip(tables, 0, n_blocks - 1)
    k_ctx = torch.from_numpy(kp[idx].reshape(4, n_pages * page, 2, 64))
    v_ctx = torch.from_numpy(vp[idx].reshape(4, n_pages * page, 2, 64))
    got = chunked_decode(torch.from_numpy(q), k_ctx, v_ctx, positions,
                         chunk, 64 ** -0.5)
    assert torch.isfinite(got).all(), "a dead or NaN page leaked"
    np.testing.assert_allclose(got.numpy(), want, **F32)
