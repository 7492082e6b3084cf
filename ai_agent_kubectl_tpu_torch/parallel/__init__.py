"""Parallel layers of the port: the MoE MLP on one card (``moe.py``) and
tensor parallelism over a ``model`` mesh — the mesh (``mesh.py``), the
partition policy and the functions that place shards (``sharding.py``),
and the collectives that join them (``collectives.py``). The data,
expert, pipe and seq axes wait for later parts of ROADMAP.md A8; the
JAX package's ``parallel/compat.py`` (``shard_map``, ``pvary``) is JAX
plumbing with no counterpart here: one controller calls each shard's
kernel itself."""
