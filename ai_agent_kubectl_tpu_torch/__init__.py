"""ai_agent_kubectl_tpu_torch — the kubectl NLP service on PyTorch and CUDA.

The same HTTP service as ``ai_agent_kubectl_tpu`` (natural language in, a
validated single-line ``kubectl`` command out), served by a PyTorch engine
on an NVIDIA Hopper GPU. The JAX package is the reference this package is
held against; nothing here imports it or JAX.

Package layout (each module mirrors its counterpart in the JAX package):

- ``config``  — typed environment configuration (the knobs this port reads)
- ``device``  — device resolution: CUDA unless the caller asks for the CPU
- ``ops``     — numeric ops and the hand-written Hopper kernels (``csrc/``)
- ``models``  — the decoder-only transformer over the block-paged KV pool
  or a dense per-request cache, plain or quantized weights, and the HF
  safetensors checkpoint loader (``models/convert.py``)
- ``engine``  — tokenizer, KV pool, radix cache, prefix cache, sampling,
  the single-sequence and the batched engines, the rule-based fallback
- ``obs``     — request traces and the flight recorder
- ``server``  — the service layer and the aiohttp app: auth, rate limit,
  overload shedding, TTL cache, breaker, ``/execute``, ``/metrics``
"""

__version__ = "0.1.0"
