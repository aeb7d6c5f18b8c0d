"""Start N ranks on this machine and run one function in each.

The port's counterpart of the JAX package's chipless multi-process
bring-up (``tensor2robot_tpu/parallel/distributed.py``'s gloo branch and
``utils/cpu_mesh_env.py``): where JAX proves a mesh on virtual CPU
devices, the port proves it on real processes. ``launch(fn, n)`` spawns
`n` processes; each joins a gloo (or NCCL) process group through a
``FileStore`` in a fresh temporary directory, sets the environment that
``torch.distributed.run`` would (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), runs ``fn(rank, *args)`` and hands its return
value back through a file. `fn` must be a module-level function (the
processes are spawned, not forked).

A rank is a CPU rank (``device="cpu"``: gloo, one intra-op thread, so
that N ranks share the cores) or a rank co-located on ``cuda:0``
(``device="cuda"``: gloo, since NCCL refuses two ranks on one device;
the collectives stage what gloo does not take on the card, see
``collectives.py``). A rank that raises fails the launch with its
traceback; the others are stopped, and so is every rank when the launch's
time runs out. No process outlives the call.

    python -c "from tensor2robot_tpu_torch.parallel import launch; ..."
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

_RESULT = "result-{}.pkl"
_ERROR = "error-{}.txt"


def _entry(rank: int, world: int, workdir: str, backend: str, device: str,
           fn: Callable, args: Sequence[Any]) -> None:
  os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                     "LOCAL_RANK": str(rank),
                     "LOCAL_WORLD_SIZE": str(world)})
  try:
    import torch.distributed as dist
    if device == "cpu":
      torch.set_num_threads(1)
    else:
      torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    result = fn(rank, *args)
  except BaseException:  # noqa: BLE001 — the parent reports it
    with open(os.path.join(workdir, _ERROR.format(rank)), "w") as f:
      f.write(traceback.format_exc())
    # Out at once: leaving the group waits for peers that may be blocked
    # in a collective this rank never reaches.
    os._exit(1)
  from tensor2robot_tpu_torch.parallel import distributed
  distributed.shutdown()
  with open(os.path.join(workdir, _RESULT.format(rank)), "wb") as f:
    pickle.dump(result, f)


def launch(fn: Callable, nprocs: int, args: Sequence[Any] = (), *,
           device: str = "cpu", backend: Optional[str] = None,
           timeout_s: float = 600.0) -> List[Any]:
  """Runs ``fn(rank, *args)`` in `nprocs` spawned ranks; returns their
  results in rank order.

  Args:
    fn: a module-level function; what it returns must pickle.
    device: "cpu" for CPU ranks, "cuda" for ranks co-located on cuda:0.
    backend: the process group's backend; gloo by default.
    timeout_s: the whole launch's limit; past it every rank is stopped and
      the launch raises TimeoutError.

  Raises RuntimeError with the first failed rank's traceback.
  """
  if device not in ("cpu", "cuda"):
    raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
  if device == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("launch(device='cuda') needs CUDA.")
  backend = backend or "gloo"
  workdir = tempfile.mkdtemp(prefix="t2r-launch-")
  context = mp.get_context("spawn")
  procs = [context.Process(
      target=_entry, args=(rank, nprocs, workdir, backend, device, fn,
                           tuple(args)), daemon=True)
           for rank in range(nprocs)]
  try:
    for proc in procs:
      proc.start()
    deadline = time.monotonic() + timeout_s
    failed = None
    while any(proc.is_alive() for proc in procs):
      failed = next((rank for rank, proc in enumerate(procs)
                     if proc.exitcode not in (None, 0)), None)
      if failed is not None or time.monotonic() > deadline:
        break
      time.sleep(0.02)
    if failed is None:
      failed = next((rank for rank, proc in enumerate(procs)
                     if proc.exitcode not in (None, 0)), None)
    if failed is not None:
      path = os.path.join(workdir, _ERROR.format(failed))
      detail = (open(path).read() if os.path.exists(path)
                else f"exit code {procs[failed].exitcode}")
      raise RuntimeError(f"rank {failed} of {nprocs} failed:\n{detail}")
    if any(proc.is_alive() for proc in procs):
      raise TimeoutError(f"launch of {nprocs} ranks ran past {timeout_s} s")
    results = []
    for rank in range(nprocs):
      with open(os.path.join(workdir, _RESULT.format(rank)), "rb") as f:
        results.append(pickle.load(f))
    return results
  finally:
    for proc in procs:
      if proc.is_alive():
        proc.terminate()
    for proc in procs:
      proc.join(timeout=10)
      if proc.is_alive():
        proc.kill()
        proc.join()
    shutil.rmtree(workdir, ignore_errors=True)
