"""Ring attention: causal self-attention with the sequence split over the
``seq`` axis.

The counterpart of the JAX package's ``parallel/ring_attention.py``, in
plain tensor code as the JAX version is plain ``jnp`` (no Pallas kernel
there, so no CUDA source here). One controller holds every seq shard's
blocks (``parallel/mesh.py``):

- Each shard holds one contiguous block of the queries, keys, values and
  their absolute positions, on its own device.
- The K/V blocks travel the ring one hop a step (shard ``j`` hands its
  block to ``j + 1``, the JAX ``ppermute`` order), n - 1 hops in all:
  after ``i`` hops shard ``j`` holds the block that started on ``j - i``.
  Each hop's copies are issued before that step's block attention, so
  on distinct cards the copy overlaps the compute.
- Every shard accumulates its queries' attention over each block it
  meets with the online softmax (running max ``m``, normalizer ``l``,
  accumulator ``acc``) in float32; no S x S logits over the whole
  sequence exist anywhere.
- The mask is ``kv_pos <= q_pos`` on the absolute positions carried
  with the blocks, so a block's place in the ring never matters. A fully
  masked row outputs 0.
- GQA/MQA: KV heads are shared by their query-head groups by reshape.
- A ring never crosses processes: a seq axis across them
  (``DCN_MESH_SHAPE``) is refused at boot (ROADMAP.md A12 row 1), so
  every shard of a seq group is in one process.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def _block_attention(q, k, v, qpos, kpos, scale: float):
    """One K/V block's online-softmax partial, in float32.

    q: [B, Sq, H, hd]; k/v: [B, Sk, KV, hd]; qpos: [B, Sq]; kpos: [B, Sk].
    Returns (m [B, Sq, H, 1], l [B, Sq, H, 1], acc [B, Sq, H, hd]). The
    scores take the inputs' products in float32 (the JAX einsum's
    ``preferred_element_type``); the probabilities round to the values'
    dtype before they weight the values, as in JAX."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, k.float()) * scale
    mask = (kpos.long()[:, None, :] <= qpos.long()[:, :, None]
            )[:, :, None, None, :]
    s.masked_fill_(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    # In place: the scores become the probabilities (a fully masked row's
    # NaNs from -inf - -inf are masked to 0 with the rest of it).
    p = s.sub_(m).exp_().masked_fill_(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return (m.reshape(B, Sq, H, 1), l.reshape(B, Sq, H, 1),
            acc.reshape(B, Sq, H, hd))


def _merge(m1, l1, acc1, m2, l2, acc2):
    """Two online-softmax partial states combined (the flash merge); a
    state whose max is -inf weighs nothing."""
    m = torch.maximum(m1, m2)
    zero = torch.zeros((), device=m.device)
    a1 = torch.where(m1 == float("-inf"), zero, torch.exp(m1 - m))
    a2 = torch.where(m2 == float("-inf"), zero, torch.exp(m2 - m))
    return m, l1 * a1 + l2 * a2, acc1 * a1 + acc2 * a2


def _to(t: torch.Tensor, device) -> torch.Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


def ring_attention_shards(qs: Sequence[torch.Tensor],
                          ks: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor],
                          positions: Sequence[torch.Tensor], *,
                          scale: Optional[float] = None
                          ) -> List[torch.Tensor]:
    """The ring over one seq group: shard ``j``'s query block ``qs[j]``
    [B, S/n, H, hd] attends over every shard's K/V block [B, S/n, KV, hd]
    (``positions[j]`` [B, S/n] the absolute positions of shard ``j``'s
    block), each block on its shard's device. Returns each shard's
    output [B, S/n, H, hd] in the queries' dtype, on its device."""
    n = len(qs)
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5
    devs = [q.device for q in qs]
    state = []
    for q in qs:
        B, Sq, H, hd = q.shape
        state.append((torch.full((B, Sq, H, 1), float("-inf"),
                                 dtype=torch.float32, device=q.device),
                      torch.zeros((B, Sq, H, 1), dtype=torch.float32,
                                  device=q.device),
                      torch.zeros((B, Sq, H, hd), dtype=torch.float32,
                                  device=q.device)))
    blocks = list(zip(ks, vs, positions))
    for i in range(n):
        nxt = None
        if i < n - 1:
            # One hop j -> j + 1, issued before this step's compute; the
            # last step skips it (its blocks would be discarded).
            nxt = [tuple(_to(t, devs[j]) for t in blocks[(j - 1) % n])
                   for j in range(n)]
        for j in range(n):
            k, v, kpos = blocks[j]
            part = _block_attention(qs[j], k, v, positions[j], kpos, scale)
            state[j] = _merge(*state[j], *part)
        if nxt is not None:
            blocks = nxt
    out = []
    for q, (_, l, acc) in zip(qs, state):
        l = torch.where(l == 0.0, torch.ones((), device=l.device), l)
        out.append((acc / l).to(q.dtype))
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, mesh, *, axis: str = "seq",
                   scale: Optional[float] = None) -> torch.Tensor:
    """Causal self-attention with the sequence split over ``axis`` (the
    JAX ``ring_attention``): q [B, S, H, hd], k/v [B, S, KV, hd] and
    positions [B, S] cut into ``n`` contiguous blocks, block ``j`` placed
    on the ``j``-th shard of the mesh's first ``axis`` group, the ring
    run over them, and the outputs joined on ``q``'s device. Requires S
    divisible by the axis size."""
    n = mesh.shape[axis]
    if q.shape[1] % n:
        raise ValueError(
            f"seq len {q.shape[1]} not divisible by {axis} axis size {n}"
        )
    devs = [mesh.devices[i] for i in mesh.groups(axis)[0]]

    def cut(t):
        return [_to(b, d) for b, d in zip(t.chunk(n, dim=1), devs)]

    outs = ring_attention_shards(cut(q), cut(k), cut(v), cut(positions),
                                 scale=scale)
    return torch.cat([_to(o, q.device) for o in outs], dim=1)
