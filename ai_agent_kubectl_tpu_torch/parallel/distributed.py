"""Multi-process serving (DCN): the ``torch.distributed`` process group,
the bytes that cross it, and the dispatch point that carries rank 0's
work on shards to the other processes.

The counterpart of the JAX package's ``parallel/distributed.py``
(``init_distributed``, ``is_primary``). The JAX package is one SPMD
program on every host; the port keeps its one controller and gives it
remote hands:

- Rank 0 keeps the scheduler thread, the books (pool, radix tree, QoS,
  ledger), the tokenizer and HTTP. Every rank holds the parameter and
  cache shards the hybrid mesh gives its process (``parallel/mesh.py``,
  ``parallel/sharding.py``), and no other shards.
- A call that launches work on shards goes through one dispatch point,
  ``dispatch(mesh, fn, *args, **kwargs)``: on a mesh that spans
  processes rank 0 first posts the call (``fn`` by its name in
  ``CALLS``, its arguments pickled, tensors as bytes, the engine's shard
  holders — parameters, caches, the mesh — by handle), then runs its
  own shards. A follower runs only ``CALLS``' functions and unpickles
  only ``_DATA``'s types; still, the store has no authentication, so
  ``COORDINATOR_ADDRESS`` stays on a private network.
  Every other rank runs ``serve_follower``: it takes each call in order,
  runs it over its own shards and joins the collectives
  (``parallel/collectives.py``), and drops the result. Only rank 0's
  scheduler issues calls, so every rank sees the same calls in the same
  order.
- Calls travel through the group's key-value store, not a collective:
  an idle follower polls the store (backing off to ``POLL_MAX_S``), so a
  server that waits an hour for its next request never meets the process
  group's timeout, and a follower whose rank 0 has gone (the store lives
  in rank 0) fails its next poll and exits non-zero within
  ``POLL_MAX_S``; mid-call, its collective fails when rank 0's end of it
  closes, or at ``TIMEOUT_S``.

Knobs (the JAX package's): ``COORDINATOR_ADDRESS`` (host:port of rank 0,
the store's address; absent = one process), ``NUM_PROCESSES`` and
``PROCESS_ID``; ``DISTRIBUTED_INIT=true`` (``require``) without an
address takes torch's own ``env://`` variables (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), torch's counterpart of the
TPU runtime's auto-configuration.

Backend: gloo on the CPU, and on CUDA whenever two ranks share a card
(NCCL refuses two ranks on one GPU); NCCL only when every rank's shards
lie on cards of its own (``global_devices`` decides from every rank's
cards). Gloo moves bytes only: a CUDA tensor crosses through a pinned
host buffer. The init, every collective and every wait has a deadline
(``TIMEOUT_S``).
"""

from __future__ import annotations

import collections
import importlib
import io
import itertools
import logging
import math
import os
import pickle
import socket
import threading
import time
import weakref
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

#: seconds an init, a collective or a process wait may take
TIMEOUT_S = 300.0
#: seconds between a follower's polls of the store: the first wait after
#: a call, doubling while it waits up to the longest
POLL_S, POLL_MAX_S = 0.0002, 0.02
#: seconds rank 0 waits for the followers to take its last call
STOP_WAIT_S = 30.0

_state = {"nccl": False, "store": None, "launches_at_start": None,
          "rings_at_start": 0}
_groups: dict = {}
#: this process's traffic with the others: collectives and moves made,
#: seconds spent in them (the device syncs of the staging included) and
#: bytes sent
TRAFFIC = {"calls": 0, "s": 0.0, "bytes": 0}


def _counted(fn):
    """Count a traffic function's calls and seconds in ``TRAFFIC``."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            TRAFFIC["calls"] += 1
            TRAFFIC["s"] += time.perf_counter() - t0
    run.__name__, run.__doc__ = fn.__name__, fn.__doc__
    return run


# ------------------------------------------------------------ the group

def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     require: bool = False) -> bool:
    """Join the process group if configured. Returns True when running
    in more than one process's group, False for one process with neither
    a coordinator nor ``require``. Idempotent.

    With a coordinator the ranks are ``num_processes``/``process_id``,
    else ``NUM_PROCESSES``/``PROCESS_ID``; ``require`` without one reads
    ``env://``. Raises, naming what is missing, when the ranks or the
    address cannot be found."""
    if dist.is_initialized():
        return True
    coordinator_address = (coordinator_address
                           or os.getenv("COORDINATOR_ADDRESS"))
    if not coordinator_address and not require:
        return False
    if coordinator_address:
        host, _, port = coordinator_address.rpartition(":")
        world = num_processes or _int_env("NUM_PROCESSES")
        rank_ = process_id if process_id is not None else \
            _int_env("PROCESS_ID")
        missing = [n for n, v in (("NUM_PROCESSES", world),
                                  ("PROCESS_ID", rank_)) if v is None]
        if missing or not host or not port.isdigit():
            raise ValueError(
                f"COORDINATOR_ADDRESS={coordinator_address!r} needs "
                f"host:port and the ranks; missing: "
                f"{', '.join(missing) or 'host:port'}")
    else:
        missing = [n for n in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                               "WORLD_SIZE") if not os.getenv(n)]
        if missing:
            raise ValueError(
                f"DISTRIBUTED_INIT=true without COORDINATOR_ADDRESS reads "
                f"torch's env:// variables; missing: {', '.join(missing)}")
        host, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
        world, rank_ = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if not 0 <= rank_ < world:
        raise ValueError(f"PROCESS_ID {rank_} outside NUM_PROCESSES {world}")
    timeout = timedelta(seconds=TIMEOUT_S)
    store = dist.TCPStore(host, int(port), world, is_master=rank_ == 0,
                          timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=rank_,
                            world_size=world, timeout=timeout)
    _state["store"] = store
    logger.info("torch.distributed up: process %d/%d over gloo (store %s)",
                rank_, world, coordinator_address or f"{host}:{port}")
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that runs HTTP ingress (rank 0), or when no
    group is up."""
    return rank() == 0


def shutdown() -> None:
    """Leave the process group (idempotent)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _groups.clear()
    _state.update(nccl=False, store=None, launches_at_start=None,
                  rings_at_start=0)


def _int_env(name: str) -> Optional[int]:
    v = os.getenv(name)
    return int(v) if v else None


def _card(d: torch.device) -> Optional[str]:
    """A card's identity across hosts (host and UUID); None off CUDA."""
    if d.type != "cuda":
        return None
    uuid = torch.cuda.get_device_properties(d).uuid
    return f"{socket.gethostname()}/{uuid}"


def global_devices(local: Sequence) -> list:
    """Every process's devices, each ``(rank, device)`` in rank order:
    this process's ``local`` and the others' (one exchange over the
    group). Sets the transport: NCCL when every device is a card and no
    card serves two ranks, else gloo."""
    local = [torch.device(d) for d in local]
    if not dist.is_initialized():
        return [(0, d) for d in local]
    mine = [(str(d), _card(d)) for d in local]
    every: list = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    cards = [{c for _, c in e} for e in every]
    shared = any(cards[a] & cards[b] for a in range(len(cards))
                 for b in range(a + 1, len(cards)))
    _state["nccl"] = None not in set().union(*cards) and not shared
    if _state["nccl"]:
        torch.cuda.set_device(local[0])
    logger.info("cross-process collectives over %s (%s)",
                "nccl" if _state["nccl"] else "gloo",
                "every rank on cards of its own" if _state["nccl"]
                else "a rank on the CPU or two ranks on one card")
    return [(r, torch.device(d)) for r, e in enumerate(every)
            for d, _ in e]


def group(ranks: Sequence[int]):
    """The process group among ``ranks`` (made once and cached; None is
    the whole world)."""
    ranks = tuple(sorted(set(ranks)))
    backend = "nccl" if _state["nccl"] else "gloo"
    if ranks == tuple(range(world_size())) and backend == "gloo":
        return None
    if (ranks, backend) not in _groups:
        _groups[(ranks, backend)] = dist.new_group(
            list(ranks), backend=backend, timeout=timedelta(seconds=TIMEOUT_S),
            use_local_synchronization=True)
    return _groups[(ranks, backend)]


# --------------------------------------------------------------- bytes

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8,
           torch.int32, torch.int64, torch.bool, torch.uint8, torch.float64,
           torch.int16)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor where the transport reads
    them: on the card under NCCL, else in a pinned host buffer (a CUDA
    tensor) or on the CPU."""
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    TRAFFIC["bytes"] += flat.numel()
    if t.device.type == "cuda" and not _state["nccl"]:
        buf = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        return buf.copy_(flat)
    return flat


def _buffer(dtype, shape, device: torch.device) -> torch.Tensor:
    """A receive buffer for a tensor of ``dtype`` and ``shape`` that
    lands on ``device``: on the card under NCCL, else pinned (for a
    card) or on the CPU."""
    nbytes = torch.empty(0, dtype=dtype).element_size() * math.prod(shape)
    on_card = device.type == "cuda"
    if on_card and _state["nccl"]:
        return torch.empty(nbytes, dtype=torch.uint8, device=device)
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=on_card)


def _unwire(buf: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    return buf.view(dtype).reshape(shape).to(device)


def _wire_group():
    """The group tensor bytes cross: the world's gloo group, or its
    NCCL group when every rank has cards of its own."""
    return group(range(world_size())) if _state["nccl"] else None


@_counted
def all_gather_stacks(t: torch.Tensor, ranks: Sequence[int]) -> list:
    """Each of ``ranks``' tensor (every one ``t``'s shape and dtype), in
    rank order, on ``t``'s device: the group's gather of per-rank stacks
    of shard tensors."""
    bufs = [_buffer(t.dtype, t.shape, t.device) for _ in set(ranks)]
    dist.all_gather(bufs, _wire(t), group=group(ranks))
    return [_unwire(b, t.dtype, t.shape, t.device) for b in bufs]


def _header(t: torch.Tensor) -> torch.Tensor:
    h = torch.zeros(10, dtype=torch.int64)
    h[0], h[1] = _DTYPES.index(t.dtype), t.dim()
    h[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    return h


def _from_header(h: torch.Tensor) -> tuple:
    n = int(h[1])
    return _DTYPES[int(h[0])], tuple(int(x) for x in h[2:2 + n])


@_counted
def exchange(sends: Sequence[tuple], recvs: Sequence[tuple]) -> list:
    """Point-to-point moves: ``sends`` ``(tensor, dst rank, tag)`` leave
    this rank, ``recvs`` ``(src rank, tag, device)`` arrive. Each shape
    and dtype travels first, over gloo; then every payload of the call
    is posted in one batch (``batch_isend_irecv``), so two ranks may send
    to each other under either backend. Returns the received tensors in
    ``recvs``' order."""
    heads = [dist.isend(_header(t), dst, tag=tag) for t, dst, tag in sends]
    metas = []
    for src, tag, _ in recvs:
        h = torch.zeros(10, dtype=torch.int64)
        dist.recv(h, src, tag=tag)
        metas.append(_from_header(h))
    for w in heads:
        w.wait()
    g = _wire_group()
    wires = [_wire(t) for t, _, _ in sends]
    bufs = [_buffer(dtype, shape, dev) for (dtype, shape), (_, _, dev)
            in zip(metas, recvs)]
    ops = ([dist.P2POp(dist.isend, w, dst, group=g, tag=tag)
            for w, (_, dst, tag) in zip(wires, sends)]
           + [dist.P2POp(dist.irecv, b, src, group=g, tag=tag)
              for b, (src, tag, _) in zip(bufs, recvs)])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [_unwire(b, dtype, shape, dev) for b, (dtype, shape), (_, _, dev)
            in zip(bufs, metas, recvs)]


# ----------------------------------------------------- the dispatch point

_STOP = "stop"
_PKG = __name__.rsplit(".", 2)[0]
#: every function a call may run on the followers, by module and
#: qualified name: rank 0 posts no other, a follower runs no other
CALLS = frozenset({
    (f"{_PKG}.models.transformer", "forward"),
    (f"{_PKG}.models.transformer", "KVCache.zeros"),
    (f"{_PKG}.models.transformer", "KVCache.pool"),
    (f"{_PKG}.engine.batcher", "copy_pool_rows"),
    (f"{_PKG}.engine.batcher", "splice_slots"),
    (f"{_PKG}.engine.batcher", "splice_prefix_rows"),
    (f"{_PKG}.engine.batcher", "slot_view"),
    (f"{_PKG}.engine.torch_engine", "trim_prefix"),
    (f"{_PKG}.engine.torch_engine", "splice_prefix"),
    (__name__, "mark_served"),
})
#: the classes and constructors a call's arguments may name (beside
#: torch's dtypes, and Python's containers and numbers, which pickle
#: names no class for): a follower loads no other
_DATA = frozenset({
    (f"{_PKG}.models.config", "ModelConfig"), ("torch", "device"),
    ("numpy", "dtype"), ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),     # numpy 1 and 2's arrays
})


def _call_name(fn) -> tuple:
    """``fn``'s entry in ``CALLS``; raises for a function not there."""
    name = (getattr(fn, "__module__", None), getattr(fn, "__qualname__",
                                                     None))
    if name not in CALLS:
        raise ValueError(f"{name[0]}.{name[1]} is not a call the followers "
                         f"take (distributed.CALLS)")
    return name


def _call(name) -> object:
    """The function of a posted call's ``name``, which must be in
    ``CALLS``."""
    if not isinstance(name, tuple) or name not in CALLS:
        raise pickle.UnpicklingError(f"a call names {name!r}, which is not "
                                     f"in distributed.CALLS")
    obj = importlib.import_module(name[0])
    for part in name[1].split("."):
        obj = getattr(obj, part)
    return obj


class _Pickler(pickle.Pickler):
    """Pickles a call for the followers: a registered object as its
    handle, a tensor as its bytes (it lands on the follower's serving
    device when it lay on a card); a shard holder that is not registered
    raises, so no shard's bytes ever travel by accident."""

    def __init__(self, f, handles: dict):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.handles = handles

    def persistent_id(self, obj):
        h = self.handles.get(id(obj))
        if h is not None:
            return ("ref", h)
        if isinstance(obj, torch.Tensor):
            c = obj.detach().cpu().contiguous()
            return ("tensor", c.reshape(-1).view(torch.uint8).numpy()
                    .tobytes(), _DTYPES.index(c.dtype), tuple(c.shape),
                    obj.device.type)
        if _shard_holder(obj):
            raise ValueError(f"a {type(obj).__name__} crosses to the "
                             f"followers without a handle")
        return None


class _Unpickler(pickle.Unpickler):
    """Reads a posted call: a handle as the follower's own object, a
    tensor from its bytes; any class or function but ``_DATA``'s and
    torch's dtypes is refused (the store takes posts from anyone who
    reaches the coordinator's port)."""

    def __init__(self, f, objs: dict, home):
        super().__init__(f)
        self.objs, self.home = objs, home

    def find_class(self, module, name):
        if (module, name) in _DATA or (module == "torch" and isinstance(
                getattr(torch, name, None), torch.dtype)):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"a call names {module}.{name}, which followers do not load "
            f"(distributed._DATA)")

    def persistent_load(self, pid):
        if pid[0] == "ref":
            return self.objs[pid[1]]
        _, data, dt, shape, kind = pid
        t = (torch.frombuffer(bytearray(data), dtype=torch.uint8)
             .view(_DTYPES[dt]).reshape(shape) if data
             else torch.empty(shape, dtype=_DTYPES[dt]))
        return t.to(self.home) if kind == "cuda" else t


def _shard_holder(obj) -> bool:
    from ..models.transformer import KVCache
    from ..ops.quant import ShardedKV
    from .mesh import Mesh
    from .sharding import ShardedParams

    return isinstance(obj, (KVCache, ShardedKV, ShardedParams, Mesh))


class Hands:
    """The dispatch point's two ends: rank 0 posts calls (``run``), the
    other ranks take them (``follow``). Objects both ends hold — the
    mesh, the parameters — are ``adopt``-ed under one name on every
    rank; an object a call makes on every rank (a cache) is kept under a
    handle the call carries, and released on every rank once rank 0's
    copy is gone."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seq = 0
        self._handles: dict = {}        # rank 0: id(obj) -> handle
        self._objs: dict = {}           # followers: handle -> obj
        self._released = collections.deque()
        self._count = itertools.count()
        self.calls = 0
        self.post_s = 0.0

    def adopt(self, name: str, obj) -> None:
        """``obj`` known by ``name`` on every rank (each rank adopts its
        own under the same name)."""
        if rank() == 0:
            self._handles = {k: v for k, v in self._handles.items()
                             if v != name}
            self._handles[id(obj)] = name
        else:
            self._objs[name] = obj

    def _keep(self, obj, handle) -> None:
        self._handles[id(obj)] = handle
        weakref.finalize(obj, self._release, id(obj), handle)

    def _release(self, key, handle) -> None:
        self._handles.pop(key, None)
        self._released.append(handle)

    def run(self, fn, /, *args, keep: bool = False, **kwargs):
        """Rank 0: post ``fn(*args, **kwargs)`` to the followers, then run
        it here. ``keep``: the result is a shard holder every rank keeps
        (later calls may name it)."""
        with self._lock:
            t0 = time.perf_counter()
            handle = f"k{next(self._count)}" if keep else None
            released = [self._released.popleft()
                        for _ in range(len(self._released))]
            buf = io.BytesIO()
            _Pickler(buf, self._handles).dump(
                (handle, _call_name(fn), args, kwargs, released))
            self._post(buf.getvalue())
            self.post_s += time.perf_counter() - t0
            self.calls += 1
            out = fn(*args, **kwargs)
            if keep:
                self._keep(out, handle)
            return out

    def _post(self, payload: bytes) -> None:
        _state["store"].set(f"call/{self._seq}", payload)
        self._seq += 1

    def stop(self, deadline_s: float = STOP_WAIT_S) -> None:
        """Rank 0: the last call; returns once every follower took it
        (or raises after ``deadline_s``)."""
        with self._lock:
            seq = self._seq
            self._post(pickle.dumps(_STOP))
            store, want = _state["store"], world_size() - 1
            end = time.monotonic() + deadline_s
            while int(store.add(f"call/{seq}/taken", 0)) < want:
                if time.monotonic() > end:
                    raise TimeoutError(
                        f"followers did not take the stop within "
                        f"{deadline_s:.0f} s")
                time.sleep(0.01)

    def follow(self, home) -> None:
        """A follower: take and run rank 0's calls in order until its
        stop. A store that fails (rank 0 gone) raises."""
        store, n = _state["store"], world_size() - 1
        while True:
            key = f"call/{self._seq}"
            wait = POLL_S
            while not store.check([key]):
                time.sleep(wait)
                wait = min(2 * wait, POLL_MAX_S)
            payload = store.get(key)
            taken = store.add(f"{key}/taken", 1)
            self._seq += 1
            if payload == pickle.dumps(_STOP):
                return
            if taken == n:
                store.delete_key(key)
                store.delete_key(f"{key}/taken")
            handle, name, args, kwargs, released = _Unpickler(
                io.BytesIO(payload), self._objs, home).load()
            fn = _call(name)
            for h in released:
                self._objs.pop(h, None)
            self.calls += 1
            out = fn(*args, **kwargs)
            if handle is not None:
                self._objs[handle] = out


HANDS = Hands()


def dispatch(mesh, fn, /, *args, keep: bool = False, **kwargs):
    """The one dispatch point of work on shards: ``fn(*args,
    **kwargs)``, first posted to the other ranks when ``mesh`` lies in
    more than one process (``Hands.run``)."""
    if mesh is None or not mesh.hybrid:
        return fn(*args, **kwargs)
    return HANDS.run(fn, *args, keep=keep, **kwargs)


def serve_follower(engine) -> dict:
    """A follower rank's life: build the engine's shards
    (``build_shards``), then run rank 0's calls until its stop. Returns
    its ``report``."""
    engine.build_shards()
    logger.info("rank %d follows rank 0 over %d local shard(s)", rank(),
                len(engine.mesh.local_shards))
    HANDS.follow(engine.mesh.home)
    return report()


def mark_served() -> None:
    """Note this process's kernel launches and ring prefills so far: the
    engine's start (its warm-up, the system prompt's preload) posts this
    as its last call, so that ``report`` counts those of the serving
    that follows apart from those before it."""
    from ..models.transformer import _forward_ring
    from ..ops._cuda import launch_counts

    _state["launches_at_start"] = launch_counts()
    _state["rings_at_start"] = _forward_ring.calls


def report() -> dict:
    """This process's part of a run over processes: its rank, the calls
    it posted (rank 0) or took, the seconds rank 0 spent posting them,
    its traffic with the other processes (``TRAFFIC``), the ring
    prefills it took part in since the engine started serving
    (``ring_forwards``; ``mark_served``), and its own kernel launches:
    ``launches`` since then, ``launches_at_start`` before."""
    from ..models.transformer import _forward_ring
    from ..ops._cuda import launch_counts

    start = _state.get("launches_at_start") or {}
    return {"rank": rank(), "calls": HANDS.calls, "post_s": HANDS.post_s,
            "traffic": dict(TRAFFIC), "ring_forwards": _forward_ring.calls - _state["rings_at_start"],
            "launches": {k: v - start.get(k, 0)
                         for k, v in launch_counts().items()},
            "launches_at_start": start}

