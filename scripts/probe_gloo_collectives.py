#!/usr/bin/env python3
"""Which collectives a process group's backend takes on CPU and CUDA tensors.

    python3 scripts/probe_gloo_collectives.py [--backend gloo] [--ranks 2]

Launches the ranks through ``tensor2robot_tpu_torch/parallel/launch.py``
(CPU ranks, then, where CUDA is present, ranks co-located on cuda:0) and
calls each collective the parallel tier uses once on a small tensor of
that device, checking the answer. Prints one JSON object: for each device
and op, "ok", "wrong", the error's first line, or how its process
died (each op runs in ranks of its own). ``parallel/collectives.py``
keeps its routing table from this script's output on the card (recorded in
``ROADMAP.md`` Facts); the table is never built by catching a failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tensor2robot_tpu_torch.parallel import launch  # noqa: E402


def _ops(rank: int, world: int, dev: torch.device):
  """(name, call) pairs; each call returns (answer, expected)."""
  x = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank
  rows = [torch.arange(8, dtype=torch.float32) + 10 * r for r in range(world)]
  total = sum(rows)

  def all_reduce(op, expected):
    y = x.clone()
    dist.all_reduce(y, op=op)
    return y, expected

  def all_gather_into_tensor():
    y = torch.empty(8 * world, device=dev)
    dist.all_gather_into_tensor(y, x)
    return y, torch.cat(rows)

  def all_gather():
    ys = [torch.empty(8, device=dev) for _ in range(world)]
    dist.all_gather(ys, x)
    return torch.cat(ys), torch.cat(rows)

  def reduce_scatter_tensor():
    y = torch.empty(8 // world, device=dev)
    dist.reduce_scatter_tensor(y, x)
    return y, total.chunk(world)[rank]

  def all_to_all_single():
    y = torch.empty(8, device=dev)
    dist.all_to_all_single(y, x)
    return y, torch.cat([r.chunk(world)[rank] for r in rows])

  def send_recv():
    y = torch.empty(8, device=dev)
    peer_to, peer_from = (rank + 1) % world, (rank - 1) % world
    for req in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, peer_to),
        dist.P2POp(dist.irecv, y, peer_from)]):
      req.wait()
    return y, rows[peer_from]

  def broadcast():
    y = x.clone()
    dist.broadcast(y, 0)
    return y, rows[0]

  return [
      ("all_reduce_sum", lambda: all_reduce(dist.ReduceOp.SUM, total)),
      ("all_reduce_avg", lambda: all_reduce(dist.ReduceOp.AVG,
                                            total / world)),
      ("all_reduce_max", lambda: all_reduce(dist.ReduceOp.MAX, rows[-1])),
      ("all_gather_into_tensor", all_gather_into_tensor),
      ("all_gather", all_gather),
      ("reduce_scatter_tensor", reduce_scatter_tensor),
      ("all_to_all_single", all_to_all_single),
      ("send_recv", send_recv),
      ("broadcast", broadcast),
  ]


def probe_rank(rank: int, device: str, only=None) -> dict:
  dev = torch.device(device)
  world = dist.get_world_size()
  out = {}
  for name, call in _ops(rank, world, dev):
    if only is not None and name != only:
      continue
    try:
      answer, expected = call()
      same = torch.equal(answer.cpu(), expected.cpu())
      out[name] = "ok" if same else "wrong"
    except Exception as e:  # noqa: BLE001 — the probe records it
      out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    dist.barrier()  # a failed op must not leave a peer waiting in the next
  return out


def probe_device(device: str, backend: str, ranks: int) -> dict:
  """Each op in ranks of its own: an op that aborts its process (gloo
  writing from a device pointer does) costs only its own entry."""
  where = "cuda:0" if device == "cuda" else "cpu"
  names = [name for name, _ in _ops(0, ranks, torch.device("cpu"))]
  out = {}
  for name in names:
    try:
      out.update(launch.launch(probe_rank, ranks, (where, name),
                               device=device, backend=backend,
                               timeout_s=120)[0])
    except (RuntimeError, TimeoutError) as e:
      lines = [line for line in str(e).splitlines() if line.strip()]
      out[name] = "process died: " + " | ".join(lines[-2:])[:200]
  return out


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--backend", default="gloo")
  parser.add_argument("--ranks", type=int, default=2)
  args = parser.parse_args(argv)
  result = {"torch": torch.__version__, "cuda_version": torch.version.cuda,
            "backend": args.backend, "ranks": args.ranks}
  for device in ("cpu", "cuda"):
    if device == "cuda" and not torch.cuda.is_available():
      continue
    result[device] = probe_device(device, args.backend, args.ranks)
  print(json.dumps(result, indent=1), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
