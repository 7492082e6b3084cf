"""A mesh across processes on the card: two rank processes, each with
two shards, against the one-process mesh in the same shard order.

Every test here carries the ``cuda`` marker and skips without the cards
it needs. The file imports neither JAX nor the JAX package, so it runs
where the suite's ``conftest.py`` cannot load:

    python -m pytest --noconftest -q -m cuda tests/test_torch_dcn_cuda.py

- ``shared``: both ranks on card 0 (``[cuda:0] * 2`` each), so the
  transport is gloo through pinned host buffers (NCCL refuses two ranks
  on one card).
- ``own``: rank ``r`` on card ``r`` (``[cuda:r] * 2``), so every rank has
  cards of its own and the transport is NCCL; needs two cards.

Each runs toy-8m in bf16 (seed 0) over tp=2 x DCN dp=2 (the batch
crosses processes: rank 1's rows of the logits sent to rank 0), tp=2 x
DCN tp=2 (a join every layer) and tp=2 x DCN pp=2 (the stage hand-off
point to point): rank 0's logits and the one-process mesh's, on the same
cards in the same shard order, are ``torch.equal``; rank 1 gets none.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.transformer import (KVCache, forward,
                                                           init_params)
from ai_agent_kubectl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from ai_agent_kubectl_tpu_torch.parallel.sharding import shard_params

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent
#: seconds the two rank processes may take
WAIT_S = 240.0
B, S = 4, 16
#: DCN spec -> the one-process MESH_SHAPE with the same shard order
SPECS = {"dp=2": "dp=2,tp=2", "tp=2": "tp=4", "pp=2": "pp=2,tp=2"}

WORKER = r"""
import json, sys
import torch
from ai_agent_kubectl_tpu_torch.models.config import get_config
from ai_agent_kubectl_tpu_torch.models.transformer import (KVCache, forward,
                                                           init_params)
from ai_agent_kubectl_tpu_torch.parallel import distributed
from ai_agent_kubectl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from ai_agent_kubectl_tpu_torch.parallel.sharding import shard_params

rank, coord, card, out = (int(sys.argv[1]), sys.argv[2], int(sys.argv[3]),
                          sys.argv[4])
distributed.init_distributed(coord, 2, rank)
dev = torch.device("cuda", card)
cfg = get_config("toy-8m")
full = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                   dtype=torch.bfloat16, device=dev)
tokens = torch.arange(@S@, dtype=torch.int32, device=dev)[None].repeat(@B@, 1)
report = {}
for dcn in @SPECS@:
    mesh = build_mesh(MeshConfig.parse("tp=2"),
                      distributed.global_devices([dev] * 2),
                      dcn=MeshConfig.parse(dcn))
    cache = KVCache.zeros(cfg, @B@, @S@, dtype=torch.bfloat16, mesh=mesh,
                          split_rows=True)
    logits, _ = forward(shard_params(full, mesh, cfg), cfg, tokens,
                        tokens.clone(), cache, kv_limit=@S@, mesh=mesh)
    torch.save(None if logits is None else logits.cpu(),
               f"{out}/{dcn}-{rank}.pt")
    report[dcn] = {"nccl": distributed._state["nccl"],
                   "traffic": dict(distributed.TRAFFIC)}
distributed.shutdown()
print(json.dumps(report), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", params=["shared", "own"])
def placement(request, tmp_path_factory):
    """Both ranks' logits and reports under one placement, and the
    cards of its shards in shard order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mesh's shards run on cards")
    if request.param == "own" and torch.cuda.device_count() < 2:
        pytest.skip("a card for each rank needs two cards")
    cards = [0, 0] if request.param == "shared" else [0, 1]
    out = tmp_path_factory.mktemp(f"dcn_{request.param}")
    script = (WORKER.replace("@S@", str(S)).replace("@B@", str(B))
              .replace("@SPECS@", repr(list(SPECS))))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), coord, str(cards[r]),
         str(out)], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    for r, p in enumerate(procs):
        try:
            outs.append(p.communicate(timeout=WAIT_S) + (p.returncode,))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {r} did not finish its forwards within "
                        f"{WAIT_S:.0f} s: {p.communicate()[1][-1500:]}")
    for r, (_, err, rc) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{err[-3000:]}"
    reports = [json.loads(o.strip().splitlines()[-1]) for o, _, _ in outs]
    logits = {dcn: [torch.load(out / f"{dcn}-{r}.pt") for r in range(2)]
              for dcn in SPECS}
    return request.param, cards, reports, logits


@pytest.mark.parametrize("dcn", list(SPECS))
def test_two_processes_on_the_card_are_the_one_process_mesh(placement,
                                                           dcn):
    kind, cards, reports, logits = placement
    devices = [torch.device("cuda", c) for c in cards for _ in range(2)]
    cfg = get_config("toy-8m")
    full = init_params(torch.Generator(device=devices[0]).manual_seed(0),
                       cfg, dtype=torch.bfloat16, device=devices[0])
    mesh = build_mesh(MeshConfig.parse(SPECS[dcn]), devices)
    tokens = torch.arange(S, dtype=torch.int32,
                          device=devices[0])[None].repeat(B, 1)
    cache = KVCache.zeros(cfg, B, S, dtype=torch.bfloat16, mesh=mesh,
                          split_rows=True)
    one, _ = forward(shard_params(full, mesh, cfg), cfg, tokens,
                     tokens.clone(), cache, kv_limit=S, mesh=mesh)
    r0, r1 = logits[dcn]
    assert torch.isfinite(r0).all()
    assert r1 is None
    assert torch.equal(r0, one.cpu())
    for rep in reports:
        assert rep[dcn]["nccl"] is (kind == "own")
        assert rep[dcn]["traffic"]["calls"] > 0
