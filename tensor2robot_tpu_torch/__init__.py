"""tensor2robot_tpu_torch — the PyTorch/CUDA port of ``tensor2robot_tpu``.

The JAX package beside this one is the reference: this package mirrors its
module paths and class names so each counterpart is easy to find, and its
tests hold every ported module against the JAX one on the same inputs.
The port imports ``torch`` and ``numpy`` only — never JAX, and nothing of
``tensor2robot_tpu``.

Every entry point runs on the GPU unless the caller asks for the CPU:
``resolve_device`` below is the one place that rule lives. Importing the
package builds and loads no kernel; kernels build at their first launch
(``ops/_build.py``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
  """The device an entry point runs on: CUDA unless `device` says otherwise.

  ``None`` means the current CUDA device. It raises when CUDA is absent and
  the caller did not ask for the CPU: the port never carries on quietly on
  the CPU.
  """
  resolved = torch.device("cuda" if device is None else device)
  if resolved.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "CUDA is not available; pass device='cpu' to run on the CPU.")
  if resolved.type not in ("cuda", "cpu"):
    raise ValueError(f"Unsupported device {resolved}; use 'cuda' or 'cpu'.")
  return resolved
