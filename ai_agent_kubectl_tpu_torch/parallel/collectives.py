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

On a mesh laid out over processes (``mesh=``, ``Mesh.hybrid``) a list holds
None in the place of every other process's shard. Each process then
gathers the partials of every group it holds a shard of over the group
of those processes (``parallel/distributed.py``: gloo moves the bytes
and does no arithmetic), and sums them in shard order on its first
device of the group, as above: the result is the same bits as on a mesh
in one process. ``gather_home`` and ``transfer`` move whole tensors
between processes: the logits to rank 0 alone, a pipeline stage's
hand-off, a ring hop.

Every call runs under the profiler scope ``all_reduce``: the
attribution's ``all_reduce`` category bills it (``obs/attribution.py``),
as the JAX attribution bills XLA's all-to-all there too.
``all_reduce.calls`` counts the calls of the four together, and every
``gather_home`` on a mesh over processes or ``transfer`` that crosses
them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..obs.profiler import scope

Groups = Optional[Sequence[Sequence[int]]]


def _groups(shards: Sequence[torch.Tensor], groups: Groups) -> list:
    return [list(range(len(shards)))] if groups is None else \
        [list(g) for g in groups]


def _parts(shards, g: list, mesh) -> Optional[list]:
    """Every partial of group ``g`` in shard order, on this process:
    its own as they are, another process's gathered onto its first
    device of the group. None when no shard of ``g`` is here."""
    if mesh is None or not mesh.hybrid:
        return [shards[i] for i in g]
    mine = [i for i in g if mesh.is_local(i)]
    if not mine:
        return None
    ranks = sorted({mesh.owner(i) for i in g})
    if len(ranks) == 1:
        return [shards[i] for i in g]
    from . import distributed

    members = {r: [i for i in g if mesh.owner(i) == r] for r in ranks}
    if len({len(m) for m in members.values()}) != 1:
        raise ValueError(f"group {g} is not spread evenly over processes "
                         f"{ranks}")
    dev = shards[mine[0]].device
    stacks = distributed.all_gather_stacks(
        torch.stack([_to(shards[i], shards[mine[0]]) for i in mine]), ranks)
    got = {}
    for r, st in zip(ranks, stacks):
        for k, i in enumerate(members[r]):
            got[i] = shards[i] if mesh.is_local(i) else st[k].to(dev)
    return [got[i] for i in g]


def _to(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t if t.device == like.device else t.to(like.device)


def _sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for t in parts[1:]:
        out = out + _to(t, parts[0])
    return out


def all_reduce(shards: Sequence[torch.Tensor], groups: Groups = None,
               mesh=None) -> List[torch.Tensor]:
    """The sum of each group's partial tensors, on each of its shards."""
    all_reduce.calls += 1
    out = list(shards)
    with scope("all_reduce"):
        for g in _groups(shards, groups):
            parts = _parts(shards, g, mesh) if len(g) > 1 else None
            if parts is None:
                continue
            total = _sum(parts)
            for i in g:
                if shards[i] is not None:
                    out[i] = _to(total, shards[i])
    return out


def reduce_scatter(shards: Sequence[torch.Tensor], dim: int,
                   groups: Groups = None, mesh=None) -> List[torch.Tensor]:
    """The sum of each group's partial tensors, split along ``dim`` into
    equal contiguous blocks: the group's ``r``-th shard gets block
    ``r``."""
    all_reduce.calls += 1
    out = list(shards)
    with scope("all_reduce"):
        for g in _groups(shards, groups):
            parts = _parts(shards, g, mesh) if len(g) > 1 else None
            if parts is None:
                continue
            blocks = _sum(parts).chunk(len(g), dim=dim)
            for b, i in zip(blocks, g):
                if shards[i] is not None:
                    out[i] = _to(b, shards[i]).contiguous()
    return out


def all_gather(shards: Sequence[torch.Tensor], dim: int,
               groups: Groups = None, mesh=None) -> List[torch.Tensor]:
    """Each group's blocks concatenated along ``dim`` in group order, on
    each of its shards."""
    all_reduce.calls += 1
    out = list(shards)
    with scope("all_reduce"):
        for g in _groups(shards, groups):
            parts = _parts(shards, g, mesh) if len(g) > 1 else None
            if parts is None:
                continue
            whole = torch.cat([_to(p, parts[0]) for p in parts], dim=dim)
            for i in g:
                if shards[i] is not None:
                    out[i] = _to(whole, shards[i])
    return out


def all_to_all(shards: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int, groups: Groups = None, mesh=None
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
            parts = _parts(shards, g, mesh) if len(g) > 1 else None
            if parts is None:
                continue
            n = len(g)
            for p in parts:
                if p.shape[split_dim] % n:
                    raise ValueError(
                        f"all_to_all: dimension {split_dim} of size "
                        f"{p.shape[split_dim]} does not split over "
                        f"a group of {n}")
            blocks = [p.chunk(n, dim=split_dim) for p in parts]
            for r, i in enumerate(g):
                if shards[i] is not None:
                    out[i] = torch.cat([_to(b[r], shards[i])
                                        for b in blocks], dim=concat_dim)
    return out


def gather_home(shards: Sequence[torch.Tensor], dim: int, g: list, mesh,
                device) -> Optional[torch.Tensor]:
    """Group ``g``'s tensors concatenated along ``dim`` in group order, on
    ``device`` in rank 0's process (the controller's, which samples the
    logits); None in every other process. Within one process a copy.
    Across processes the blocks join on ``g[0]``'s process, each other
    process of ``g`` sending it its own, then move whole to rank 0
    unless they are there: no other process receives them."""
    if mesh is None or not mesh.hybrid:
        whole = shards[g[0]]
        if len(g) > 1:
            all_reduce.calls += 1
            with scope("all_reduce"):
                whole = torch.cat([_to(shards[i], whole) for i in g],
                                  dim=dim)
        return whole if whole.device == torch.device(device) else \
            whole.to(device)
    from . import distributed

    me, first = distributed.rank(), mesh.owner(g[0])
    members: dict = {}
    for i in g:
        members.setdefault(mesh.owner(i), []).append(i)
    if me not in members and me != 0:
        return None
    all_reduce.calls += 1
    whole = None
    with scope("all_reduce"):
        if me in members and me != first:
            mine = members[me]
            distributed.exchange([(torch.stack(
                [_to(shards[i], shards[mine[0]]) for i in mine]), first, 0)],
                [])
        elif me == first:
            others = [r for r in members if r != me]
            got = distributed.exchange(
                [], [(r, 0, shards[g[0]].device) for r in others]) \
                if others else []
            blocks = {i: shards[i] for i in members[me]}
            for r, st in zip(others, got):
                blocks.update(zip(members[r], st))
            whole = torch.cat([_to(blocks[i], blocks[g[0]]) for i in g],
                              dim=dim) if len(g) > 1 else blocks[g[0]]
        if first != 0 and me == first:
            distributed.exchange([(whole, 0, 1)], [])
        elif first != 0 and me == 0:
            whole = distributed.exchange(
                [], [(first, 1, torch.device(device))])[0]
    return None if me else whole.to(device)


def transfer(moves: Sequence[tuple], mesh) -> list:
    """Point-to-point moves ``(tensor, src shard, dst shard, dst
    device)``, the tensor None where ``src`` is another process's:
    returns each move's tensor on its destination device where ``dst``
    is this process's, else None. Within one process a copy (none where
    it already lies there); across processes each move's bytes go from
    ``src``'s process to ``dst``'s (a pipeline hand-off, a ring hop)."""
    out: list = [None] * len(moves)
    sends, recvs, at = [], [], []
    for k, (t, src, dst, dev) in enumerate(moves):
        here_src = mesh is None or mesh.is_local(src)
        here_dst = mesh is None or mesh.is_local(dst)
        if here_src and here_dst:
            out[k] = t if t.device == torch.device(dev) else \
                t.to(dev, non_blocking=True)
        elif here_src:
            sends.append((t, mesh.owner(dst), k))
        elif here_dst:
            recvs.append((mesh.owner(src), k, torch.device(dev)))
            at.append(k)
    if sends or recvs:
        from . import distributed

        all_reduce.calls += 1
        with scope("all_reduce"):
            for k, t in zip(at, distributed.exchange(sends, recvs)):
                out[k] = t
    return out


all_reduce.calls = 0
