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

``data``, ``expert`` and ``model`` are served; a mesh with a >1 pipe or
seq axis is refused where it is built (ROADMAP.md A8 holds them). Shard
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

#: the axes a later part of ROADMAP.md A8 serves
UNSERVED_AXES = ("pipe", "seq")


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


def build_mesh(cfg: MeshConfig, devices: Sequence) -> Mesh:
    """A mesh over ``devices`` (one per shard; a device may repeat).
    Raises when the spec wants another number of devices, as the JAX
    ``build_mesh`` does, and when it has a >1 pipe or seq axis
    (ROADMAP.md A8)."""
    devices = tuple(torch.device(d) for d in devices)
    if cfg.n_devices != len(devices):
        raise ValueError(f"Mesh {cfg.describe()} wants {cfg.n_devices} "
                         f"devices, got {len(devices)}")
    bad = [a for a in UNSERVED_AXES if getattr(cfg, a) > 1]
    if bad:
        raise ValueError(
            f"Mesh {cfg.describe()}: the {'/'.join(bad)} axis is not "
            f"served by the PyTorch port yet (ROADMAP.md A8); it serves "
            f"the data, expert and model axes (dp/ep/tp)")
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
