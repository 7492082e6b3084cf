"""The port's expert-parallel MoE dispatch and its all-to-all against the
JAX package's, on the CPU in float32 at ``toy-moe`` (4 experts of 448,
2 routed per token, dim 256).

The JAX side runs on the suite's virtual CPU devices (``conftest.py``
forces eight); the port's mesh is ``[cpu] * N``, its weights one JAX
init carried over with ``params_from_jax`` and split by ``shard_params``
(the same bytes, quantized too). Inputs are drawn with numpy from fixed
seeds.

- ``collectives.all_to_all`` against ``jax.lax.all_to_all(...,
  tiled=True)`` inside a ``shard_map``, both directions the dispatch
  uses, over an expert axis alone and beside a model axis (exact: a
  copy).
- ``expert_parallel_moe`` against the JAX function at ep in {1, 2, 4}
  and ep=2 x tp=2, float32 and int8 experts, every shard's output
  (within ``2e-5``, the JAX suite's EP tolerance: the expert products
  and the F-split partial sums reassociate); a ``token_mask`` with dead
  rows; an explicit capacity small enough to drop, the same tokens
  dropped (dropped rows included, and the drops checked to happen); the
  JAX ``ValueError`` text where the tokens do not divide the axis.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ai_agent_kubectl_tpu.models import config as jconfig
from ai_agent_kubectl_tpu.models import transformer as jt
from ai_agent_kubectl_tpu.ops import quant as jq
from ai_agent_kubectl_tpu.parallel import mesh as jmesh
from ai_agent_kubectl_tpu.parallel import moe as jmoe
from ai_agent_kubectl_tpu.parallel.compat import shard_map
from ai_agent_kubectl_tpu_torch.models import config as tconfig
from ai_agent_kubectl_tpu_torch.models.convert import params_from_jax
from ai_agent_kubectl_tpu_torch.ops import quant as tq
from ai_agent_kubectl_tpu_torch.parallel import collectives
from ai_agent_kubectl_tpu_torch.parallel import mesh as pmesh
from ai_agent_kubectl_tpu_torch.parallel import moe as tmoe
from ai_agent_kubectl_tpu_torch.parallel.sharding import shard_params

torch.set_num_threads(1)

JCFG, TCFG = jconfig.get_config("toy-moe"), tconfig.get_config("toy-moe")
#: the JAX suite's EP parity tolerance (tests/test_moe_ep.py)
TOL = dict(rtol=2e-5, atol=2e-5)
MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def _meshes(**axes):
    cfg = jmesh.MeshConfig(**axes)
    n = cfg.n_devices
    return (jmesh.build_mesh(cfg, jax.devices()[:n]),
            pmesh.build_mesh(pmesh.MeshConfig(**axes), ["cpu"] * n))


@functools.lru_cache(maxsize=None)
def _params(quant: str):
    """toy-moe from seed 0 (int8 experts under ``quant``): the JAX
    layer-0 MoE leaves and the port's whole tree."""
    jparams = jt.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    if quant:
        jparams = jq.quantize_params_int8(jparams)
    jlp = {k: (jq.QuantInt8(q=v.q[0], scale=v.scale[0])
               if isinstance(v, jq.QuantInt8) else v[0])
           for k, v in jparams["layers"].items() if k in MOE_KEYS}
    return jlp, params_from_jax(jax.tree.map(np.asarray, jparams), TCFG)


def _port_layers(tparams, mesh):
    """Each shard's layer-0 MoE leaves."""
    trees = shard_params(tparams, mesh, TCFG) if mesh.size > 1 \
        else [tparams]
    return [{k: t["layers"][k][0] for k in MOE_KEYS} for t in trees]


def _x(B, S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, TCFG.dim)).astype(np.float32)


def _both(axes, x, quant="", **kw):
    """The JAX and the port dispatch on the same weights and input; the
    port's per-shard outputs."""
    jmesh_, pmesh_ = _meshes(**axes)
    jlp, tparams = _params(quant)
    mask = kw.pop("token_mask", None)
    want = jmoe.expert_parallel_moe(
        JCFG, jlp, jnp.asarray(x), jmesh_,
        token_mask=None if mask is None else jnp.asarray(mask), **kw)
    got = tmoe.expert_parallel_moe(
        TCFG, _port_layers(tparams, pmesh_),
        [torch.from_numpy(x)] * pmesh_.size, pmesh_,
        token_mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert len(got) == pmesh_.size
    return np.asarray(want), [g.numpy() for g in got]


# ---------------------------------------------------------- all_to_all

@pytest.mark.parametrize("axes", [dict(expert=4), dict(expert=2, model=2)],
                         ids=["ep4", "ep2_tp2"])
@pytest.mark.parametrize("dims", [(0, 1), (1, 0)], ids=["0to1", "1to0"])
def test_all_to_all_matches_jax(axes, dims):
    split, concat = dims
    jm, pm = _meshes(**axes)
    n = pm.size
    rng = np.random.default_rng(3)
    blocks = rng.standard_normal((n, 4, 8, 5)).astype(np.float32)

    def body(b):
        return jax.lax.all_to_all(b[0], "expert", split, concat,
                                  tiled=True)[None]

    spec = JP(tuple(a for a in ("expert", "model") if a in axes))
    want = np.asarray(shard_map(body, mesh=jm, in_specs=spec,
                                out_specs=spec)(jnp.asarray(blocks)))
    got = collectives.all_to_all([torch.from_numpy(b) for b in blocks],
                                 split, concat, pm.groups("expert"))
    for i in range(n):
        np.testing.assert_array_equal(got[i].numpy(), want[i])


# --------------------------------------------------- the EP dispatch

#: (axes, quant): every mesh in float32, the expert- and F-split int8
#: stacks on the widest two
EP_CASES = {"ep1-f32": (dict(expert=1), ""), "ep2-f32": (dict(expert=2), ""),
            "ep4-f32": (dict(expert=4), ""),
            "ep2_tp2-f32": (dict(expert=2, model=2), ""),
            "ep4-int8": (dict(expert=4), "int8"),
            "ep2_tp2-int8": (dict(expert=2, model=2), "int8")}


@pytest.mark.parametrize("case", list(EP_CASES))
def test_expert_parallel_moe_matches_jax(case):
    axes, quant = EP_CASES[case]
    want, got = _both(axes, _x(2, 8), quant)
    for g in got:
        np.testing.assert_allclose(g, want, **TOL)


def test_token_mask_keeps_dead_rows_out_of_capacity_as_jax():
    """The JAX suite's case: two live tokens per shard at capacity 2,
    which the two dead tokens per shard would overflow were they
    routed. Every row equals JAX's, the dead ones zero."""
    mask = np.array([[0, 0, 1, 1, 0, 0, 1, 1]], np.float32)
    want, got = _both(dict(expert=2), _x(1, 8), capacity=2,
                      token_mask=mask)
    for g in got:
        np.testing.assert_allclose(g, want, **TOL)
        assert not g[0, mask[0] == 0].any()


@pytest.mark.parametrize("capacity", [1, 2])
def test_small_capacity_drops_the_jax_tokens(capacity):
    """Capacity below the routed load: the same tokens drop in both
    packages (each row equal, dropped rows included), and some do drop
    (rows apart from the dense evaluation)."""
    x = _x(2, 8, seed=5)
    want, got = _both(dict(expert=2), x, capacity=capacity)
    for g in got:
        np.testing.assert_allclose(g, want, **TOL)
    _, tparams = _params("")
    lp = {k: tparams["layers"][k][0] for k in MOE_KEYS}
    dense = tmoe.dense_moe(TCFG, lp, torch.from_numpy(x)).numpy()
    apart = ~np.isclose(got[0], dense, **TOL).all(axis=-1)
    assert apart.any()


def test_indivisible_tokens_raise_the_jax_error():
    jm, pm = _meshes(expert=8)
    jlp, tparams = _params("")
    x = _x(1, 3)
    with pytest.raises(ValueError, match="divide") as theirs:
        jmoe.expert_parallel_moe(JCFG, jlp, jnp.asarray(x), jm)
    lps = _port_layers(tparams, pm)
    with pytest.raises(ValueError, match="divide") as ours:
        tmoe.expert_parallel_moe(TCFG, lps, [torch.from_numpy(x)] * 8, pm)
    assert str(ours.value) == str(theirs.value)


def test_int8_experts_keep_their_scales_per_shard():
    """An int8 expert stack splits payload and scales on the expert axis
    and, column-parallel, on the out-channel axis; row-parallel
    ``w_down`` keeps its size-1 scale axis whole (the JAX ``_wspec``)."""
    _, pm = _meshes(expert=2, model=2)
    _, tparams = _params("int8")
    layers = _port_layers(tparams, pm)
    E, D, F = TCFG.n_experts, TCFG.dim, TCFG.mlp_hidden
    for lp in layers:
        assert isinstance(lp["w_gate"], tq.QuantInt8)
        assert lp["w_gate"].q.shape == (E // 2, D, F // 2)
        assert lp["w_gate"].scale.shape == (E // 2, 1, F // 2)
        assert lp["w_down"].q.shape == (E // 2, F // 2, D)
        assert lp["w_down"].scale.shape == (E // 2, 1, D)
        assert lp["router"].shape == (D, E)
