"""The port's model against the JAX package's, on the CPU in float32.

``params_from_jax`` carries one random init over, so both compute the
same function; then one mixed ragged window (a prefill from 0, a prefill
continuing at 5, a frozen slot) and 8 decode steps go through the JAX
``forward(attn_impl="ragged")`` — its Pallas kernel in interpret mode —
and the port's pool-mode ``forward``, comparing the logits and the
pool's contents after every call. Tolerance: 1e-4 absolute and relative
on logits and 1e-5 on the pool (float32, different summation orders
through a few layers).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.models import transformer as jt
from ai_agent_kubectl_tpu_torch.models import config as tconfig
from ai_agent_kubectl_tpu_torch.models import transformer as tt
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from ai_agent_kubectl_tpu_torch.parallel.sharding import shard_params

# Tiny shapes: one intra-op thread is as fast, and spares the suite's
# other workers the cores that idle OpenMP threads spin on.
torch.set_num_threads(1)

PAGE, N_BLOCKS, MAX_PAGES = 8, 16, 4

# Gemma-2B's features at a narrow width: (1+w) norm, GeGLU, a tied head,
# the sqrt(dim) embedding scale, MQA with 8 query heads over one KV head
# of head_dim 256; 2 layers, vocab 512.
GEMMA_NARROW = dict(name="gemma-narrow", vocab_size=512, dim=128,
                    n_layers=2, n_heads=8, n_kv_heads=1, head_dim=256,
                    mlp_hidden=256, rms_offset=1.0, activation="gelu",
                    tie_embeddings=True, embed_scale=True, bos_id=2,
                    eos_ids=(1, 107), pad_id=0, max_seq_len=8192)


def _configs(name):
    if name == "toy-8m":
        return jconfig.get_config(name), tconfig.get_config(name)
    return (jconfig.ModelConfig(**GEMMA_NARROW),
            tconfig.ModelConfig(**GEMMA_NARROW))


def _jax_params(jcfg):
    return jt.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_model_configs_are_the_jax_registry():
    for name in jconfig.list_configs():
        assert (dataclasses.asdict(jconfig.get_config(name))
                == dataclasses.asdict(tconfig.get_config(name)))


def test_params_from_jax_toy():
    jcfg, tcfg = _configs("toy-8m")
    tree = _np_tree(_jax_params(jcfg))
    params = params_from_jax(tree, tcfg)
    assert set(params) == set(tree)
    assert set(params["layers"]) == set(tree["layers"])
    for key, val in tree["layers"].items():
        np.testing.assert_array_equal(params["layers"][key].numpy(), val)
    np.testing.assert_array_equal(params["embed"].numpy(), tree["embed"])
    np.testing.assert_array_equal(params["lm_head"].numpy(),
                                  tree["lm_head"])
    # The port's own init has the same keys and shapes.
    own = tt.init_params(torch.Generator().manual_seed(0), tcfg,
                         dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in own["layers"].items()} == {
        k: v.shape for k, v in tree["layers"].items()}
    bad = dict(tree, final_norm=tree["final_norm"][:-1])
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(bad, tcfg)


def test_params_from_jax_keeps_bfloat16():
    jcfg, tcfg = _configs("toy-8m")
    tree = _np_tree(jt.init_params(jax.random.PRNGKey(1), jcfg))
    params = params_from_jax(tree, tcfg)
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["embed"].float().numpy(),
        np.asarray(tree["embed"]).astype(np.float32))


@pytest.mark.parametrize("name", ["toy-8m", "gemma-narrow"])
def test_pool_forward_matches_jax(name):
    jcfg, tcfg = _configs(name)
    jparams = _jax_params(jcfg)
    tparams = params_from_jax(_np_tree(jparams), tcfg)
    L, KV, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    jcache = jt.KVCache(
        k=jnp.zeros((L, N_BLOCKS, PAGE, KV, hd), jnp.float32),
        v=jnp.zeros((L, N_BLOCKS, PAGE, KV, hd), jnp.float32),
        lengths=jnp.zeros((N_BLOCKS,), jnp.int32))
    tcache = tt.KVCache.pool(tcfg, N_BLOCKS, PAGE, dtype=torch.float32,
                             device="cpu")
    sentinel = N_BLOCKS + 3
    tables = np.array([[3, 1, 5, sentinel], [0, 2, 7, sentinel],
                       [4, sentinel, sentinel, sentinel]], np.int32)
    jfwd = jax.jit(partial(jt.forward, cfg=jcfg, kv_limit=MAX_PAGES * PAGE,
                           attn_impl="ragged", page_size=PAGE))

    def step(tokens, positions, write_mask, q_lens, logits_at):
        nonlocal jcache, tcache
        jl, jcache = jfwd(jparams, tokens=jnp.asarray(tokens),
                          positions=jnp.asarray(positions), cache=jcache,
                          write_mask=jnp.asarray(write_mask),
                          block_tables=jnp.asarray(tables),
                          q_lens=jnp.asarray(q_lens),
                          logits_at=jnp.asarray(logits_at))
        tl, tcache = tt.forward(tparams, tcfg, torch.from_numpy(tokens),
                                torch.from_numpy(positions), tcache,
                                write_mask=torch.from_numpy(write_mask),
                                block_tables=torch.from_numpy(tables),
                                q_lens=torch.from_numpy(q_lens),
                                logits_at=torch.from_numpy(logits_at))
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=1e-4)
        for jleaf, tleaf in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
            np.testing.assert_allclose(tleaf[:, :N_BLOCKS].numpy(),
                                       np.asarray(jleaf), atol=1e-5,
                                       rtol=1e-5)
        return jl

    # One mixed window: slot 0 prefills 8 tokens from 0, slot 1 continues
    # a prefill at position 5 with 3 tokens, slot 2 is frozen.
    rng = np.random.default_rng(0)
    W = 8
    tokens = rng.integers(0, jcfg.vocab_size, (3, W)).astype(np.int32)
    starts = np.array([0, 5, 9], np.int32)
    q_lens = np.array([8, 3, 0], np.int32)
    positions = starts[:, None] + np.arange(W, dtype=np.int32)[None]
    wmask = np.arange(W)[None] < q_lens[:, None]
    logits = step(tokens, positions, wmask, q_lens,
                  np.maximum(q_lens, 1) - 1)
    # Eight decode steps: live slots feed their greedy token back.
    live = q_lens > 0
    pos = starts + q_lens
    tok = logits[:, 0].argmax(-1).astype(np.int32)
    for _ in range(8):
        logits = step(tok[:, None], pos[:, None].astype(np.int32),
                      live[:, None], np.ones(3, np.int32),
                      np.zeros(3, np.int32))
        tok = np.where(live, logits[:, 0].argmax(-1), tok).astype(np.int32)
        pos = pos + live


@pytest.mark.parametrize("impl", ["paged", "dense"])
@pytest.mark.parametrize("layout", ["pool", "dense"])
def test_decode_regimes_match_jax(layout, impl):
    """The two paged-decode regimes of the batched engine on toy-8m (4
    query heads over 2 KV heads): a ragged prefill window, then 8 decode
    steps with a frozen slot, through the JAX ``forward`` (its Pallas
    paged kernels in interpret mode) and the port's, with ``attn_impl``
    "paged" (the paged decode kernel) or "dense" (the pool's gather path,
    the dense cache's bucket read). The window itself takes the gather
    path or the dense cache read in every case. Tolerances as above:
    1e-4 on logits, 1e-5 on the cache."""
    jcfg, tcfg = _configs("toy-8m")
    jparams = _jax_params(jcfg)
    tparams = params_from_jax(_np_tree(jparams), tcfg)
    L, KV, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    span = MAX_PAGES * PAGE
    if layout == "pool":
        shape = (L, N_BLOCKS, PAGE, KV, hd)
        jcache = jt.KVCache(k=jnp.zeros(shape, jnp.float32),
                            v=jnp.zeros(shape, jnp.float32),
                            lengths=jnp.zeros((N_BLOCKS,), jnp.int32))
        tcache = tt.KVCache.pool(tcfg, N_BLOCKS, PAGE, dtype=torch.float32,
                                 device="cpu")
        sentinel = N_BLOCKS + 3
        tables = np.array([[3, 1, 5, sentinel], [0, 2, 7, sentinel],
                           [4, sentinel, sentinel, sentinel]], np.int32)
        extra = dict(block_tables=tables)
    else:
        jcache = jt.KVCache.zeros(jcfg, 3, span, dtype=jnp.float32)
        tcache = tt.KVCache.zeros(tcfg, 3, span, dtype=torch.float32,
                                  device="cpu")
        extra = {}
    jfwd = jax.jit(partial(jt.forward, cfg=jcfg, kv_limit=span,
                           page_size=PAGE), static_argnames=("attn_impl",))

    def step(tokens, positions, write_mask, logits_at, attn_impl):
        nonlocal jcache, tcache
        kw = {name: jnp.asarray(val) for name, val in extra.items()}
        jl, jcache = jfwd(jparams, tokens=jnp.asarray(tokens),
                          positions=jnp.asarray(positions), cache=jcache,
                          write_mask=(None if write_mask is None
                                      else jnp.asarray(write_mask)),
                          logits_at=jnp.asarray(logits_at),
                          attn_impl=attn_impl, **kw)
        tl, tcache = tt.forward(
            tparams, tcfg, torch.from_numpy(tokens),
            torch.from_numpy(positions), tcache, kv_limit=span,
            page_size=PAGE, attn_impl=attn_impl,
            write_mask=(None if write_mask is None
                        else torch.from_numpy(write_mask)),
            logits_at=torch.from_numpy(logits_at),
            **{name: torch.from_numpy(val) for name, val in extra.items()})
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=1e-4)
        for jleaf, tleaf in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
            t = (tleaf[:, :N_BLOCKS] if layout == "pool"
                 else tleaf[:, :, :span])
            np.testing.assert_allclose(t.numpy(), np.asarray(jleaf),
                                       atol=1e-5, rtol=1e-5)
        return jl

    # The window: slot 0 prefills 8 tokens from 0, slot 1 continues at 5
    # with 3, slot 2 is frozen (pool) or prefills 2 (dense, whose JAX
    # write mask is per row). Padding columns of the dense cache write
    # past the prompt, where decode overwrites them before any read.
    rng = np.random.default_rng(0)
    W = 8
    tokens = rng.integers(0, jcfg.vocab_size, (3, W)).astype(np.int32)
    starts = np.array([0, 5, 9], np.int32)
    q_lens = np.array([8, 3, 0 if layout == "pool" else 2], np.int32)
    positions = starts[:, None] + np.arange(W, dtype=np.int32)[None]
    wmask = (np.arange(W)[None] < q_lens[:, None] if layout == "pool"
             else None)
    logits = step(tokens, positions, wmask, np.maximum(q_lens, 1) - 1,
                  "dense")
    live = q_lens > 0
    pos = starts + q_lens
    tok = logits[:, 0].argmax(-1).astype(np.int32)
    for _ in range(8):
        logits = step(tok[:, None], pos[:, None].astype(np.int32), live,
                      np.zeros(3, np.int32), impl)
        tok = np.where(live, logits[:, 0].argmax(-1), tok).astype(np.int32)
        pos = pos + live


def test_forward_refuses_later_slices():
    """The ring path over the pool is not served (the JAX package has
    none: a ring prefill runs on the dense cache, where a one-column
    window reads dense, as in JAX: ``tests/test_torch_ring.py`` serves
    the ring); paged decode, the pool's gather path, an MoE model
    (toy-moe from the port's own init, through both layouts, and on a
    ``model`` mesh, where it equals the unsharded forward) and a dense
    model on a ``model`` mesh are served."""
    _, tcfg = _configs("toy-8m")
    params = tt.init_params(torch.Generator().manual_seed(0), tcfg,
                            dtype=torch.float32)
    cache = tt.KVCache.pool(tcfg, 4, PAGE, dtype=torch.float32,
                            device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    tables = torch.zeros((1, 2), dtype=torch.int32)
    dense = tt.KVCache.zeros(tcfg, 1, 16, dtype=torch.float32, device="cpu")
    ring, _ = tt.forward(params, tcfg, tok, tok, dense, attn_impl="ring")
    want, _ = tt.forward(params, tcfg, tok, tok, tt.KVCache.zeros(
        tcfg, 1, 16, dtype=torch.float32, device="cpu"))
    torch.testing.assert_close(ring, want, atol=0, rtol=0)
    with pytest.raises(NotImplementedError, match="ring"):
        tt.forward(params, tcfg, tok, tok, cache, attn_impl="ring",
                   block_tables=tables)
    mesh = build_mesh(MeshConfig(model=2), ["cpu"] * 2)
    logits, _ = tt.forward(
        shard_params(params, mesh, tcfg), tcfg, tok, tok,
        tt.KVCache.zeros(tcfg, 1, 16, dtype=torch.float32, mesh=mesh),
        mesh=mesh)
    assert logits.shape == (1, 1, tcfg.vocab_size)
    moe_cfg = tconfig.get_config("toy-moe")
    moe = tt.init_params(torch.Generator().manual_seed(0), moe_cfg,
                         dtype=torch.float32)
    whole, _ = tt.forward(moe, moe_cfg, tok, tok, tt.KVCache.zeros(
        moe_cfg, 1, 16, dtype=torch.float32), mesh=None)
    split, _ = tt.forward(
        shard_params(moe, mesh, moe_cfg), moe_cfg, tok, tok,
        tt.KVCache.zeros(moe_cfg, 1, 16, dtype=torch.float32, mesh=mesh),
        mesh=mesh)
    torch.testing.assert_close(split, whole, atol=1e-5, rtol=1e-5)
    E, D, F_ = moe_cfg.n_experts, moe_cfg.dim, moe_cfg.mlp_hidden
    assert moe["layers"]["router"].shape == (2, D, E)
    assert moe["layers"]["w_gate"].shape == (2, E, D, F_)
    assert moe["layers"]["w_down"].shape == (2, E, F_, D)
    for moe_cache, kw in (
            (tt.KVCache.pool(moe_cfg, 4, PAGE, dtype=torch.float32,
                             device="cpu"), dict(block_tables=tables)),
            (tt.KVCache.zeros(moe_cfg, 1, 16, dtype=torch.float32,
                              device="cpu"), {})):
        logits, _ = tt.forward(moe, moe_cfg, tok, tok, moe_cache, **kw)
        assert logits.shape == (1, 1, moe_cfg.vocab_size)
        assert torch.isfinite(logits).all()
    for impl in ("paged", "flash", "dense"):
        logits, _ = tt.forward(params, tcfg, tok, tok, cache,
                               attn_impl=impl, block_tables=tables)
        assert logits.shape == (1, 1, tcfg.vocab_size)
    logits, _ = tt.forward(params, tcfg, tok, tok, dense, attn_impl="paged",
                           page_size=8)
    assert torch.isfinite(logits).all()
