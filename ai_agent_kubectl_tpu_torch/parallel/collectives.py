"""Collectives over a list of per-shard tensors, one controller.

Serving on a mesh keeps each shard's tensors on its own device
(``parallel/mesh.py``); these functions join them the way the JAX
package's XLA collectives join mesh axes. Each takes the mesh's whole
list of per-shard tensors and ``groups``, the shard lists it runs among
(``Mesh.groups(axes)``: one per combination of the other axes; None =
every shard in one group), and runs within each group alone. A sum goes
in a fixed shard order (the group's first shard first) on that shard's
device, and the result is copied back to every shard's device of the
group, so a result never depends on the order the shards finished in.
Shards that share one device (the tests' ``[cpu] * N``, or shards on one
card) get the result itself, with no copy. (A replicated input reaches
the shards through ``parallel/sharding.py::replicate``.)

Every call runs under the profiler scope ``all_reduce``: the
attribution's ``all_reduce`` category bills it (``obs/attribution.py``),
as the JAX attribution bills XLA's all-to-all there too.
``all_reduce.calls`` counts the calls of the four together.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..obs.profiler import scope

Groups = Optional[Sequence[Sequence[int]]]


def _groups(shards: Sequence[torch.Tensor], groups: Groups) -> list:
    return [list(range(len(shards)))] if groups is None else \
        [list(g) for g in groups]


def _to(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t if t.device == like.device else t.to(like.device)


def _sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for t in parts[1:]:
        out = out + _to(t, parts[0])
    return out


def all_reduce(shards: Sequence[torch.Tensor], groups: Groups = None
               ) -> List[torch.Tensor]:
    """The sum of each group's partial tensors, on each of its shards."""
    all_reduce.calls += 1
    out = list(shards)
    with scope("all_reduce"):
        for g in _groups(shards, groups):
            if len(g) == 1:
                continue
            total = _sum([shards[i] for i in g])
            for i in g:
                out[i] = _to(total, shards[i])
    return out


def reduce_scatter(shards: Sequence[torch.Tensor], dim: int,
                   groups: Groups = None) -> List[torch.Tensor]:
    """The sum of each group's partial tensors, split along ``dim`` into
    equal contiguous blocks: the group's ``r``-th shard gets block
    ``r``."""
    all_reduce.calls += 1
    out = list(shards)
    with scope("all_reduce"):
        for g in _groups(shards, groups):
            if len(g) == 1:
                continue
            blocks = _sum([shards[i] for i in g]).chunk(len(g), dim=dim)
            for b, i in zip(blocks, g):
                out[i] = _to(b, shards[i]).contiguous()
    return out


def all_gather(shards: Sequence[torch.Tensor], dim: int,
               groups: Groups = None) -> List[torch.Tensor]:
    """Each group's blocks concatenated along ``dim`` in group order, on
    each of its shards."""
    all_reduce.calls += 1
    out = list(shards)
    with scope("all_reduce"):
        for g in _groups(shards, groups):
            if len(g) == 1:
                continue
            first = shards[g[0]]
            whole = torch.cat([_to(shards[i], first) for i in g], dim=dim)
            for i in g:
                out[i] = _to(whole, shards[i])
    return out


def all_to_all(shards: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int, groups: Groups = None
               ) -> List[torch.Tensor]:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``
    within each group: every shard cuts its tensor into the group's size
    of equal blocks along ``split_dim``, and the group's ``r``-th shard
    gets every shard's block ``r``, concatenated along ``concat_dim`` in
    group order."""
    all_reduce.calls += 1
    out = list(shards)
    with scope("all_reduce"):
        for g in _groups(shards, groups):
            if len(g) == 1:
                continue
            n = len(g)
            for i in g:
                if shards[i].shape[split_dim] % n:
                    raise ValueError(
                        f"all_to_all: dimension {split_dim} of size "
                        f"{shards[i].shape[split_dim]} does not split over "
                        f"a group of {n}")
            blocks = [shards[i].chunk(n, dim=split_dim) for i in g]
            for r, i in enumerate(g):
                out[i] = torch.cat([_to(b[r], shards[i]) for b in blocks],
                                   dim=concat_dim)
    return out


all_reduce.calls = 0
