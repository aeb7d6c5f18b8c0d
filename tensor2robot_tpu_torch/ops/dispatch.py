"""Trace-time routing of the hand kernels for ``torch.export``.

Counterpart of ``tensor2robot_tpu/ops/dispatch.py``. A kernel wrapper
launches its kernel through ctypes, which an exported program cannot
hold. So an exporter traces under ``custom_ops()``, and within it each
wrapper calls its ``torch.library`` custom op instead (K1:
``torch.ops.t2r.spatial_softmax``): the program then holds the op, whose
CUDA implementation launches the kernel and whose CPU implementation is
the plain version. Where the JAX guard makes exporters trace the XLA
reference, this one keeps the kernel in the program.

Thread-local, so an export on a worker thread does not change the route
of the training step running on the main thread. Training, MAML's
second-order backward and the CUDA graphs keep the wrappers' own route.
"""

from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


def use_custom_ops() -> bool:
  return getattr(_STATE, "custom_ops", False)


@contextlib.contextmanager
def custom_ops():
  """Within this context, kernel wrappers call their custom ops."""
  previous = use_custom_ops()
  _STATE.custom_ops = True
  try:
    yield
  finally:
    _STATE.custom_ops = previous
