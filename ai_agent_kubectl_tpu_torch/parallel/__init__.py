"""Parallel layers of the port: the MoE MLP (``moe.py``: the dense
evaluation and the expert-parallel dispatch) and serving over a mesh of
data, expert, pipe, seq and model axes — the mesh (``mesh.py``), the
partition policy and the functions that place shards (``sharding.py``),
the collectives that join them (``collectives.py``), ring attention over
the seq axis (``ring_attention.py``), the pipeline stages over the
pipe axis (``pipeline.py``), and a mesh across processes
(``distributed.py``: the process group, the bytes that cross it and
the dispatch point that carries rank 0's calls to the other ranks). The
JAX package's ``parallel/compat.py`` (``shard_map``, ``pvary``) is JAX
plumbing with no counterpart here: one controller calls each shard's
kernel itself."""
