"""Process bootstrap: ranks, the process group, and a single-slice mesh.

Counterpart of ``tensor2robot_tpu/parallel/distributed.py``. JAX runs one
program over every device, and ``jax.distributed.initialize`` joins the
hosts to it; PyTorch runs one process a rank, and ``initialize`` here joins
this process to the others through ``torch.distributed``. After it, the
parallel tier (``mesh.py``, ``collectives.py``) sees every rank.

``initialize`` reads what ``python -m torch.distributed.run`` sets
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) or takes the same as arguments. With
neither it is a single-process no-op, as JAX's is, so single-process runs
may call it unconditionally. The backend is an argument: by default NCCL
when the ranks train on cards and every local rank owns one; gloo
otherwise, which serves CPU ranks and ranks that share one card (NCCL
refuses two ranks on one device). ``parallel/launch.py`` starts ranks on one machine and joins
them through a file store before this module sees them.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

_log = logging.getLogger(__name__)


def _env_int(name: str) -> Optional[int]:
  value = os.environ.get(name)
  return None if value in (None, "") else int(value)


def default_backend(local_world_size: int, device: str = "cuda") -> str:
  """NCCL when the ranks train on `device` "cuda" and every local rank can
  own a card, gloo otherwise."""
  if (device != "cpu" and torch.cuda.is_available()
      and torch.cuda.device_count() >= max(local_world_size, 1)):
    return "nccl"
  return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: str = "cuda") -> None:
  """Joins this process to the others (idempotent).

  Args:
    coordinator_address: "host:port" of rank 0's store; by default
      ``MASTER_ADDR``/``MASTER_PORT`` from the environment.
    num_processes: the world size; by default ``WORLD_SIZE``.
    process_id: this process's rank; by default ``RANK``.
    backend: "nccl" or "gloo"; by default ``default_backend`` of the local
      world (``LOCAL_WORLD_SIZE``) and `device`.
    device: where the ranks train, "cuda" or "cpu".

  With no world size from the arguments or the environment, or a world of
  one, nothing is joined: one process, rank 0.
  """
  if dist.is_available() and dist.is_initialized():
    return
  world = num_processes if num_processes is not None else _env_int(
      "WORLD_SIZE")
  rank = process_id if process_id is not None else _env_int("RANK")
  explicit = (coordinator_address is not None or num_processes is not None
              or process_id is not None)
  if world is None or world <= 1:
    if explicit and world not in (None, 1):
      raise ValueError(f"num_processes must be >= 1, got {world}")
    _log.info("No multi-process environment; single process.")
    return
  if rank is None:
    raise ValueError(f"A world of {world} processes needs this process's "
                     "rank (process_id or RANK).")
  local_world = _env_int("LOCAL_WORLD_SIZE") or world
  backend = backend or default_backend(local_world, device)
  if coordinator_address is not None:
    init_method = f"tcp://{coordinator_address}"
  else:
    for name in ("MASTER_ADDR", "MASTER_PORT"):
      if not os.environ.get(name):
        raise ValueError(f"{name} is not set; pass coordinator_address.")
    init_method = "env://"
  if backend == "nccl":
    torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
  dist.init_process_group(backend, init_method=init_method, rank=rank,
                          world_size=world)
  _log.info("Distributed runtime: rank %d of %d, backend %s.", rank, world,
            backend)


def shutdown() -> None:
  """Leaves the process group, if this process is in one."""
  if is_initialized():
    dist.destroy_process_group()


def is_initialized() -> bool:
  return dist.is_available() and dist.is_initialized()


def process_index() -> int:
  """This process's rank (0 without a process group)."""
  return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
  """The number of ranks (1 without a process group)."""
  return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
  """True on the process that owns logging, metric files and export writes
  (the reference's chief worker)."""
  return process_index() == 0


def sync_global_devices(name: str) -> None:
  """A barrier over every rank (a no-op for one process). `name` labels
  the log line."""
  if is_initialized() and process_count() > 1:
    _log.debug("barrier %s", name)
    dist.barrier()


def create_hybrid_mesh(ici_axes: Mapping[str, int],
                       dcn_axes: Optional[Mapping[str, int]] = None):
  """A mesh whose `dcn_axes` would span hosts and `ici_axes` stay within one.

  JAX's checks on the axes come over. On one host (every rank local, the
  single-slice case) the layout is irrelevant and this is ``create_mesh``
  over ``{**dcn_axes, **ici_axes}``. Ranks on several hosts wait for the
  multihost tier (ROADMAP.md item 15d).
  """
  from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
  dcn_axes = dict(dcn_axes or {})
  axes = {**dcn_axes, **dict(ici_axes)}
  if len(set(axes)) != len(dcn_axes) + len(ici_axes):
    raise ValueError(
        f"Axis names repeat across ici {list(ici_axes)} and dcn "
        f"{list(dcn_axes)}.")
  if dcn_axes and any(v == -1 for v in ici_axes.values()):
    raise ValueError(
        f"-1 (fill) is only allowed on dcn axes when dcn_axes is set; "
        f"got ici_axes={dict(ici_axes)}.")
  local_world = _env_int("LOCAL_WORLD_SIZE") or process_count()
  if dcn_axes and local_world < process_count():
    raise NotImplementedError(
        "create_hybrid_mesh over ranks on several hosts waits for "
        "ROADMAP.md item 15d (multihost).")
  return mesh_lib.create_mesh(axes)


def global_put(tree: Any, shardings, device=None) -> Any:
  """This rank's part of a host tree that every rank holds in full.

  Each leaf takes the block its sharding (``mesh.NamedSharding``: a mesh
  and a ``PartitionSpec``) gives this rank, as a tensor on `device` (by
  default the CPU). `shardings` is one sharding for every leaf or a tree
  of them. One process: the whole leaf, as ``jax.device_put`` gives it.
  """
  from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
  from tensor2robot_tpu_torch.utils.tree import tree_map

  def place(leaf, sharding):
    tensor = torch.as_tensor(np.asarray(leaf) if not torch.is_tensor(leaf)
                             else leaf)
    local = mesh_lib.local_block(tensor, sharding.mesh, sharding.spec)
    return local.to(device or "cpu", copy=True)

  if isinstance(shardings, mesh_lib.NamedSharding):
    return tree_map(lambda leaf: place(leaf, shardings), tree)
  return tree_map(place, tree, shardings)
