"""The serving mesh: one controller over a list of devices.

The counterpart of the JAX package's ``parallel/mesh.py``. The JAX
engine is one program over a ``jax.sharding.Mesh``; the port keeps that
shape: one process and one scheduler thread, each shard's tensors on
its own ``torch.device`` (``parallel/sharding.py`` places them, and
``parallel/collectives.py`` joins them). A mesh may name one device
more than once: ``[cuda:0] * 2`` runs two tensor-parallel shards on one
card, as ``[cpu] * 2`` does in the tests.

Axis conventions (the JAX package's, fixed order):

- ``data``   — batch / DP
- ``expert`` — MoE expert parallelism
- ``pipe``   — pipeline stages
- ``seq``    — sequence/context (ring attention)
- ``model``  — tensor parallelism

Every axis is served. A ``seq`` axis carries ring prefill
(``parallel/ring_attention.py``): every other forward runs on the seq-0
row of shards (``Mesh.select``), which alone holds the KV cache. A
``pipe`` axis splits the layer stack into stages
(``parallel/pipeline.py``), each stage a sub-mesh of its own. Shard
``i`` sits at the coordinates of the JAX device layout,
``np.asarray(devices).reshape(cfg.shape)`` over ``AXES``: the shard
index is the row-major ravel of (data, expert, pipe, seq, model), so
the model shards of one (data, expert) row are adjacent. ``Mesh.groups``
lists the shards a collective over some axes runs among. An ``expert``
mesh may have one device: ``MOE_IMPL=ep`` on one card serves the
dispatch over it, as the JAX engine does.

A mesh may span processes (``DCN_MESH_SHAPE``, ``build_mesh(...,
dcn=)``): each axis is then ``ici x dcn`` in size, laid out as the JAX
``mesh_utils.create_hybrid_device_mesh(ici, dcn,
process_is_granule=True)`` lays it out — each process's devices
reshaped to the ICI shape, the processes in rank order, the DCN index
the outer part of each axis's coordinate. ``Mesh.owners`` names each
shard's process; a process holds and runs its own shards only
(``Mesh.is_local``), and ``parallel/collectives.py`` joins the shards
across processes (``parallel/distributed.py`` starts the process
group).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

AXES = ("data", "expert", "pipe", "seq", "model")

@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. Product must equal the device count in use."""

    data: int = 1
    expert: int = 1
    pipe: int = 1
    seq: int = 1
    model: int = 1

    @classmethod
    def parse(cls, spec: str) -> "MeshConfig":
        """Parse ``"dp=2,tp=4"`` / ``"data:2,model:4"`` style strings —
        ``=`` and ``:`` separators both accepted (the MESH_SHAPE env knob;
        empty string = single device)."""
        alias = {"dp": "data", "ep": "expert", "pp": "pipe", "sp": "seq",
                 "tp": "model", "data": "data", "expert": "expert",
                 "pipe": "pipe", "seq": "seq", "model": "model"}
        kwargs = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            key, _, val = part.replace(":", "=").partition("=")
            key = key.strip().lower()
            if key not in alias:
                raise ValueError(
                    f"Unknown mesh axis {key!r} in {spec!r}; "
                    f"use dp/ep/pp/sp/tp or {'/'.join(AXES)}"
                )
            kwargs[alias[key]] = int(val)
        return cls(**kwargs)

    @property
    def shape(self) -> tuple:
        return (self.data, self.expert, self.pipe, self.seq, self.model)

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    def describe(self) -> str:
        return ",".join(f"{a}={s}" for a, s in zip(AXES, self.shape) if s > 1) \
            or "single-device"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out on the named axes. ``shape`` maps each axis to
    its size (the JAX ``Mesh.shape``); ``devices`` lists one device per
    shard, in shard order: on a pure ``model`` mesh shard ``i`` holds
    the ``i``-th slice of every tensor that splits."""

    config: MeshConfig
    devices: tuple
    #: each shard's process (its rank); empty: every shard is this
    #: process's own
    owners: tuple = ()
    #: this process's rank
    rank: int = 0

    def owner(self, i: int) -> int:
        return self.owners[i] if self.owners else self.rank

    def is_local(self, i: int) -> bool:
        """Whether shard ``i`` is this process's: only its own shards'
        tensors exist here."""
        return not self.owners or self.owners[i] == self.rank

    @property
    def local_shards(self) -> list:
        return [i for i in range(self.size) if self.is_local(i)]

    @property
    def hybrid(self) -> bool:
        """Whether this mesh is laid out over processes: a DCN mesh (its
        shards in more than one process), or a part of one (a pipeline
        stage may lie wholly in another process)."""
        return bool(self.owners)

    @property
    def home(self):
        """The device of this process's first shard: where rank 0's
        results (the logits) land. None on a sub-mesh (a pipeline stage)
        with no shard here."""
        local = self.local_shards
        return self.devices[local[0]] if local else None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.config.shape))

    @property
    def axis_names(self) -> tuple:
        return AXES

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return self.config.model

    @property
    def ep(self) -> int:
        return self.config.expert

    @property
    def dp(self) -> int:
        return self.config.data

    @property
    def pp(self) -> int:
        return self.config.pipe

    @property
    def sp(self) -> int:
        return self.config.seq

    def coords(self, i: int) -> Dict[str, int]:
        """Shard ``i``'s index on each axis."""
        return dict(zip(AXES, (int(c) for c in
                               np.unravel_index(i, self.config.shape))))

    def coord(self, i: int, axis: str) -> int:
        return self.coords(i)[axis]

    def groups(self, axes) -> list:
        """The shards a collective over ``axes`` (a name or a tuple of
        names) runs among: one list per combination of the other axes'
        coordinates, each in shard order (a JAX ``psum`` over those axes
        sums within each list)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = np.arange(self.size).reshape(self.config.shape)
        inner = [k for k, a in enumerate(AXES) if a in axes]
        outer = [k for k, a in enumerate(AXES) if a not in axes]
        width = math.prod(self.config.shape[k] for k in inner)
        return [[int(i) for i in g] for g in
                idx.transpose(outer + inner).reshape(-1, width)]

    def select(self, axis: str, coord: int) -> tuple:
        """The sub-mesh of the shards at ``coord`` on ``axis`` (that axis
        of size 1, the others as they are, shard order kept) and their
        indices in this mesh: a pipeline stage, or a row of the seq
        axis."""
        idx = [i for i in range(self.size) if self.coord(i, axis) == coord]
        cfg = dataclasses.replace(self.config, **{axis: 1})
        owners = tuple(self.owners[i] for i in idx) if self.owners else ()
        return Mesh(cfg, tuple(self.devices[i] for i in idx), owners,
                    self.rank), idx

    def cache_row(self) -> tuple:
        """The sub-mesh that holds the KV cache and runs every forward but
        a ring prefill, with its indices: the seq-0 row (the whole mesh
        without a seq axis). The JAX layout replicates params and cache
        over ``seq``; the replicas compute the same values, so the port
        keeps one. A seq row in another process than this row (a DCN seq
        axis) holds its weights and no cache."""
        if self.config.seq <= 1:
            return self, list(range(self.size))
        return self.select("seq", 0)


def build_mesh(cfg: MeshConfig, devices: Sequence,
               dcn: Optional[MeshConfig] = None) -> Mesh:
    """A mesh over ``devices`` (one per shard; a device may repeat).
    Raises when the spec wants another number of devices, as the JAX
    ``build_mesh`` does.

    ``dcn`` (``DCN_MESH_SHAPE``) with more than one device makes the
    hybrid mesh: ``devices`` is then every process's devices, each entry
    ``(rank, device)`` (``parallel/distributed.py::global_devices``; a
    bare device is this process's), and each axis ``ici x dcn`` in size,
    laid out as ``create_hybrid_device_mesh(cfg.shape, dcn.shape,
    process_is_granule=True)`` does. It raises as that function does
    when the processes are not ``dcn``'s device count (one process cannot
    host a two-granule mesh)."""
    from . import distributed

    rank = distributed.rank()
    total = cfg.n_devices * (dcn.n_devices if dcn is not None else 1)
    if total != len(devices):
        raise ValueError(
            f"Mesh {cfg.describe()}"
            + (f" x dcn {dcn.describe()}" if dcn is not None else "")
            + f" wants {total} devices, got {len(devices)}")
    if dcn is None or dcn.n_devices == 1:
        mesh = Mesh(cfg, tuple(_device(d)[1] for d in devices), (), rank)
    else:
        mesh = _hybrid_mesh(cfg, dcn, [_device(d) for d in devices], rank)
    logger.info("Mesh built: %s over %d %s device(s)%s",
                mesh.config.describe(), mesh.size, mesh.devices[0].type,
                f" in {len(set(mesh.owners))} processes" if mesh.hybrid
                else "")
    return mesh


def _device(d) -> tuple:
    """(rank, torch.device) of a ``build_mesh`` entry; a bare device is
    this process's."""
    from . import distributed

    if isinstance(d, tuple):
        return int(d[0]), torch.device(d[1])
    return distributed.rank(), torch.device(d)


def _hybrid_mesh(cfg: MeshConfig, dcn: MeshConfig, devices: list,
                 rank: int) -> Mesh:
    """The ``create_hybrid_device_mesh`` layout: the granules (one per
    process, in rank order) each reshaped to the ICI shape, placed as
    blocks of the DCN shape, so that coordinate ``c`` on an axis of ICI
    size ``n`` is granule block ``c // n``, device ``c % n``."""
    granules: Dict[int, list] = {}
    for p, d in devices:
        granules.setdefault(p, []).append(d)
    keys = sorted(granules)
    if len(keys) != dcn.n_devices:
        raise ValueError(f"Number of slices {len(keys)} must equal the "
                         f"product of dcn_mesh_shape {dcn.shape}")
    for k in keys:
        if len(granules[k]) != cfg.n_devices:
            raise ValueError(
                f"Number of devices {len(granules[k])} must equal the "
                f"product of mesh_shape {cfg.shape}")
    shape = tuple(i * d for i, d in zip(cfg.shape, dcn.shape))
    devs, owners = [], []
    for c in np.ndindex(*shape):
        g = np.ravel_multi_index(tuple(x // n for x, n in zip(c, cfg.shape)),
                                 dcn.shape)
        local = np.ravel_multi_index(
            tuple(x % n for x, n in zip(c, cfg.shape)), cfg.shape)
        devs.append(granules[keys[g]][local])
        owners.append(keys[g])
    return Mesh(MeshConfig(*shape), tuple(devs), tuple(owners), rank)


def single_device_mesh(device=None) -> Mesh:
    """A 1x1x1x1x1 mesh on one device (default: the CPU)."""
    return build_mesh(MeshConfig(), [device or torch.device("cpu")])


def mesh_axis_size(mesh: Optional[Mesh], axis: str) -> int:
    return mesh.shape[axis] if mesh is not None else 1


def distinct_devices(kind: str) -> list:
    """The distinct devices of one type the process sees: every CUDA
    card, or the one CPU. ``from_env`` builds its mesh over the first
    ``n`` of these, so ``MESH_SHAPE=tp=2`` on one card raises where the
    engine starts (an explicit ``devices=`` list may repeat a device)."""
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]
