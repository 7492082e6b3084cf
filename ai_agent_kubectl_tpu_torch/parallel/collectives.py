"""Collectives over a list of per-shard tensors, one controller.

Tensor-parallel serving keeps each shard's tensors on its own device
(``parallel/mesh.py``); these functions join them the way the JAX
package's XLA collectives join a ``model`` axis. Each sums in a fixed
shard order (shard 0 first) on the first shard's device and copies the
result back to every shard's device, so a result never depends on the
order the shards finished in. Shards that share one device (the tests'
``[cpu] * N``, or two shards on one card) get the result itself, with
no copy. (A replicated input reaches the shards through
``parallel/sharding.py::replicate``.)

Every call runs under the profiler scope ``all_reduce``: the
attribution's ``all_reduce`` category bills it (``obs/attribution.py``).
``all_reduce.calls`` counts the calls of the three together.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..obs.profiler import scope


def _fan_out(result: torch.Tensor, like: Sequence[torch.Tensor]
             ) -> List[torch.Tensor]:
    """``result`` on each shard's device (itself where it already is)."""
    return [result if t.device == result.device else result.to(t.device)
            for t in like]


def _sum(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    dev = shards[0].device
    out = shards[0]
    for t in shards[1:]:
        out = out + t.to(dev)
    return out


def all_reduce(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the shards' partial tensors, on every shard."""
    all_reduce.calls += 1
    if len(shards) == 1:
        return list(shards)
    with scope("all_reduce"):
        return _fan_out(_sum(shards), shards)


def reduce_scatter(shards: Sequence[torch.Tensor], dim: int
                   ) -> List[torch.Tensor]:
    """The sum of the shards' partial tensors, split along ``dim`` into
    equal contiguous blocks: shard ``i`` gets block ``i``."""
    all_reduce.calls += 1
    if len(shards) == 1:
        return list(shards)
    with scope("all_reduce"):
        total = _sum(shards)
        blocks = total.chunk(len(shards), dim=dim)
        return [b.contiguous() if b.device == t.device
                else b.to(t.device).contiguous()
                for b, t in zip(blocks, shards)]


def all_gather(shards: Sequence[torch.Tensor], dim: int
               ) -> List[torch.Tensor]:
    """The shards' blocks concatenated along ``dim``, on every shard."""
    all_reduce.calls += 1
    if len(shards) == 1:
        return list(shards)
    with scope("all_reduce"):
        dev = shards[0].device
        return _fan_out(torch.cat([t.to(dev) for t in shards], dim=dim),
                        shards)


all_reduce.calls = 0
