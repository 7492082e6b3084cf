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
        return Mesh(cfg, tuple(self.devices[i] for i in idx)), idx

    def cache_row(self) -> tuple:
        """The sub-mesh that holds the KV cache and runs every forward but
        a ring prefill, with its indices: the seq-0 row (the whole mesh
        without a seq axis). The JAX layout replicates params and cache
        over ``seq``; the replicas compute the same values, so the port
        keeps one."""
        if self.config.seq <= 1:
            return self, list(range(self.size))
        return self.select("seq", 0)


def build_mesh(cfg: MeshConfig, devices: Sequence) -> Mesh:
    """A mesh over ``devices`` (one per shard; a device may repeat).
    Raises when the spec wants another number of devices, as the JAX
    ``build_mesh`` does."""
    devices = tuple(torch.device(d) for d in devices)
    if cfg.n_devices != len(devices):
        raise ValueError(f"Mesh {cfg.describe()} wants {cfg.n_devices} "
                         f"devices, got {len(devices)}")
    mesh = Mesh(cfg, devices)
    logger.info("Mesh built: %s over %d %s device(s)", cfg.describe(),
                len(devices), devices[0].type)
    return mesh


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
