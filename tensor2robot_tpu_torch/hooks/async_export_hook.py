"""Exports while training: a worker thread publishes each checkpoint.

Counterpart of ``tensor2robot_tpu/hooks/async_export_hook.py``. At a
checkpoint the hook copies the (EMA) variables to the host, because the
train step updates the device tensors in place, and hands the copy to one
worker thread, which writes the export and garbage-collects old versions.
An export still waiting when the next checkpoint lands is replaced by it.
``end`` exports the final state unless the final checkpoint already
submitted that step, then drains the worker within a deadline.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import List, Optional

from tensor2robot_tpu_torch.export import export_utils
from tensor2robot_tpu_torch.hooks.hook_builder import Hook, HookBuilder

_log = logging.getLogger(__name__)


class AsyncExportHook(Hook):
  """Exports on checkpoint saves through a worker thread."""

  def __init__(self, export_generator, keep: int = 5,
               shutdown_timeout_s: float = 180.0, on_export=None):
    """Args:
      export_generator: writes one export version.
      keep: versions kept after each export.
      shutdown_timeout_s: the bound on ``end``'s drain.
      on_export: optional ``(export_dir, step)`` callable run on the worker
        after each publish (a rollout controller's notify); its exceptions
        are logged and never fail the export.
    """
    self._generator = export_generator
    self._keep = keep
    self._shutdown_timeout_s = shutdown_timeout_s
    self._on_export = on_export
    # maxsize=1 with replace-on-full: at most one export waits.
    self._pending: "queue.Queue" = queue.Queue(maxsize=1)
    self._worker: Optional[threading.Thread] = None
    self._stop = object()
    self._last_submitted_step: Optional[int] = None

  def begin(self, trainer, state, model_dir: str) -> None:
    export_utils.resolve_export_root(self._generator, model_dir)
    self._generator.set_specification_from_model(trainer.model)
    self._worker = threading.Thread(
        target=self._run, name="t2r-async-export", daemon=True)
    self._worker.start()

  def _submit(self, item) -> None:
    """Put, replacing an export that has not started."""
    while True:
      try:
        self._pending.put_nowait(item)
        return
      except queue.Full:
        try:
          self._pending.get_nowait()
        except queue.Empty:
          pass

  @staticmethod
  def _fetch(state):
    """The (EMA) variables whole on the host, on every rank (a gather over
    a mesh), or None on a rank that will not export: every rank joins the
    gather, and only the primary's export writes (``export_and_gc``)."""
    from tensor2robot_tpu_torch.parallel import distributed
    variables = export_utils.fetch_variables_to_host(
        state.full_variables(use_ema=True))
    return variables if distributed.is_primary() else None

  def after_checkpoint(self, step: int, state) -> None:
    if self._worker is None:  # begin was not called
      return
    variables = self._fetch(state)
    if variables is not None:
      self._submit((variables, int(state.step)))
    self._last_submitted_step = int(state.step)

  def _run(self) -> None:
    while True:
      item = self._pending.get()
      if item is self._stop:
        return
      variables, step = item
      try:
        export_dir = export_utils.export_and_gc(
            self._generator, variables, keep=self._keep, global_step=step)
        _log.info("Async export published %s", export_dir)
        if self._on_export is not None:
          try:
            self._on_export(export_dir, step)
          except Exception:
            _log.exception("on_export callback failed; training continues.")
      except Exception:
        _log.exception("Async export failed; training continues.")

  def end(self, state) -> None:
    # Ordered, deadline-bounded puts: the stop signal never displaces a
    # queued final export, and a hung worker never blocks past the
    # deadline (it is a daemon thread).
    if self._worker is None:
      _log.warning("AsyncExportHook.end called without begin; nothing to "
                   "export.")
      return
    deadline = time.monotonic() + self._shutdown_timeout_s
    submitted = True
    if self._last_submitted_step != int(state.step):
      variables = self._fetch(state)
      if variables is not None:
        submitted = self._put_with_deadline((variables, int(state.step)),
                                            deadline)
    if submitted and self._put_with_deadline(self._stop, deadline):
      self._worker.join(timeout=max(0.0, deadline - time.monotonic()))
      if not self._worker.is_alive():
        return
    _log.error("Async export worker did not finish within %.0fs; "
               "abandoning it (the final export may be missing).",
               self._shutdown_timeout_s)

  def _put_with_deadline(self, item, deadline: float) -> bool:
    try:
      self._pending.put(item, timeout=max(0.0, deadline - time.monotonic()))
      return True
    except queue.Full:
      return False


class AsyncExportHookBuilder(HookBuilder):
  """Builds an AsyncExportHook (config-injectable)."""

  def __init__(self, export_generator, keep: int = 5,
               shutdown_timeout_s: float = 180.0, on_export=None):
    self._export_generator = export_generator
    self._keep = keep
    self._shutdown_timeout_s = shutdown_timeout_s
    self._on_export = on_export

  def create_hooks(self, trainer, model_dir: str) -> List[Hook]:
    return [AsyncExportHook(self._export_generator, keep=self._keep,
                            shutdown_timeout_s=self._shutdown_timeout_s,
                            on_export=self._on_export)]
