"""Parallel layers of the port: the MoE MLP (``moe.py``: the dense
evaluation and the expert-parallel dispatch) and serving over a mesh of
data, expert, pipe, seq and model axes — the mesh (``mesh.py``), the
partition policy and the functions that place shards (``sharding.py``),
the collectives that join them (``collectives.py``), ring attention over
the seq axis (``ring_attention.py``) and the pipeline stages over the
pipe axis (``pipeline.py``). DCN and distributed init wait for the last
part of ROADMAP.md A8; the JAX package's ``parallel/compat.py``
(``shard_map``, ``pvary``) is JAX plumbing with no counterpart here: one
controller calls each shard's kernel itself."""
