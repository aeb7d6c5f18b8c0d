"""Hooks: train-loop observers (exports while training, profiling, custom).

Counterpart of ``tensor2robot_tpu/hooks/``.
"""

from tensor2robot_tpu_torch.hooks.async_export_hook import (
    AsyncExportHook,
    AsyncExportHookBuilder,
)
from tensor2robot_tpu_torch.hooks.hook_builder import Hook, HookBuilder

__all__ = [
    "Hook",
    "HookBuilder",
    "AsyncExportHook",
    "AsyncExportHookBuilder",
]
