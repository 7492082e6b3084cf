"""The port's plain ops against the JAX package's, on the CPU in float32.

The same inputs, drawn from a numpy seed, go through both; the
tolerance is float32 round-off (the two frameworks sum in different
orders): 1e-5 absolute and relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_agent_kubectl_tpu.ops import attention as jattn
from ai_agent_kubectl_tpu.ops.norms import rms_norm as j_rms_norm
from ai_agent_kubectl_tpu.ops.rope import apply_rope as j_apply_rope
from ai_agent_kubectl_tpu_torch.ops import attention as tattn
from ai_agent_kubectl_tpu_torch.ops.norms import rms_norm as t_rms_norm
from ai_agent_kubectl_tpu_torch.ops.rope import apply_rope as t_apply_rope

# Tiny shapes: one intra-op thread is as fast, and spares the suite's
# other workers the cores that idle OpenMP threads spin on.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_matches_jax(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal((64,)).astype(np.float32)
    want = np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                 offset))
    got = t_rms_norm(_t(x), _t(w), 1e-6, offset).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    want = np.asarray(j_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = t_apply_rope(_t(x), _t(pos), theta).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2), (8, 1)])
def test_dense_attention_matches_jax(heads, kv_heads):
    rng = np.random.default_rng(2)
    B, Q, S, D = 2, 5, 11, 16
    q = rng.standard_normal((B, Q, heads, D)).astype(np.float32)
    k = rng.standard_normal((B, S, kv_heads, D)).astype(np.float32)
    v = rng.standard_normal((B, S, kv_heads, D)).astype(np.float32)
    offsets = np.array([3, 6])
    mask = (np.arange(S)[None, None, :]
            <= offsets[:, None, None] + np.arange(Q)[None, :, None])
    want = np.asarray(jattn.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    got = tattn.dense_attention(_t(q), _t(k), _t(v), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_masks_and_repeat_kv_match_jax():
    np.testing.assert_array_equal(
        tattn.causal_mask(5, 9, q_offset=3).numpy(),
        np.asarray(jattn.causal_mask(5, 9, q_offset=3)))
    lens = np.array([0, 4, 9], np.int32)
    np.testing.assert_array_equal(
        tattn.length_mask(_t(lens), 9).numpy(),
        np.asarray(jattn.length_mask(jnp.asarray(lens), 9)))
    kv = np.random.default_rng(3).standard_normal((2, 3, 2, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tattn.repeat_kv(_t(kv), 3).numpy(),
        np.asarray(jattn.repeat_kv(jnp.asarray(kv), 3)))
