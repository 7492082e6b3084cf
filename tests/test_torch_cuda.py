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
