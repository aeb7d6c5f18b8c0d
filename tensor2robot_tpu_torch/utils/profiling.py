"""Profiling: a guarded ``torch.profiler`` window, and the hook that opens
one over a range of training steps.

Counterpart of ``tensor2robot_tpu/utils/profiling.py``'s ``trace_active``,
``start_trace``, ``stop_trace``, ``trace`` and ``ProfilerHook``. One lock
guards one ``torch.profiler.profile`` per process (PyTorch allows one
active profiler, as ``jax.profiler`` does): a second ``start_trace`` logs
and returns False, so the capture path that lost the race skips its window
instead of stopping the program. The profiler records CPU activity always
and CUDA activity when the device is CUDA; ``stop_trace`` writes the
window as one Chrome trace (``trace-<pid>-<n>.json``) into its
``log_dir``, viewable in Perfetto or ``chrome://tracing``. While a window
is open, every ``obs.trace`` span also opens a
``torch.profiler.record_function`` range of its name, so the loop's spans
show in the trace beside the card's kernels.

A CUDA window needs CUPTI. Where PyTorch cannot trace the card,
``start_trace`` raises rather than record a CPU-only trace, and
``stop_trace`` raises (writing nothing) when a CUDA window holds no device
event.

``ProfilerHook`` is a train-loop ``Hook``; ``ProfilerHookBuilder`` makes
one from a config for ``train_eval_model(hook_builders=...)``, and the
replay loop drives the hook's ``after_step`` and ``end`` itself.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
from typing import List, Optional

import torch

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.hooks.hook_builder import Hook, HookBuilder
from tensor2robot_tpu_torch.obs import trace as obs_trace

_log = logging.getLogger(__name__)

TRACE_PREFIX = "trace-"
# Chrome-trace categories of work that ran on the card.
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_TRACE_LOCK = threading.Lock()
_TRACE_DIR: Optional[str] = None
_PROFILER = None
_CUDA = False
_WINDOWS = 0


def trace_active() -> bool:
  """True while a guarded trace window is open."""
  with _TRACE_LOCK:
    return _TRACE_DIR is not None


def _all_threads_config():
  """The profiler option that records every thread's ops, so the spans of
  collector and actor threads show too (by default PyTorch's profiler
  records the thread that started it); None on a PyTorch without it."""
  try:
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
  except TypeError:
    return None


def start_trace(log_dir: str, device: Device = None) -> bool:
  """Opens a trace window into `log_dir` unless one is already open.

  Returns True when it started; False (logged) when another window holds
  the profiler, and the caller skips its window. `device` is where the
  traced work runs (the GPU unless 'cpu' is asked for); a CUDA window
  raises when PyTorch cannot trace the card (no CUPTI)."""
  global _TRACE_DIR, _PROFILER, _CUDA
  cuda = resolve_device(device).type == "cuda"
  activities = [torch.profiler.ProfilerActivity.CPU]
  if cuda:
    if (torch.profiler.ProfilerActivity.CUDA
        not in torch.profiler.supported_activities()):
      raise RuntimeError(
          "torch.profiler cannot trace CUDA activity here (CUPTI is "
          "missing); no CPU-only trace is recorded for a CUDA window.")
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  with _TRACE_LOCK:
    if _TRACE_DIR is not None:
      _log.warning(
          "profiler trace already active (-> %s); skipping a second "
          "start_trace into %s", _TRACE_DIR, log_dir)
      return False
    os.makedirs(log_dir, exist_ok=True)
    profiler = torch.profiler.profile(
        activities=activities, experimental_config=_all_threads_config())
    profiler.start()
    _TRACE_DIR, _PROFILER, _CUDA = log_dir, profiler, cuda
    # Inside the lock: the spans' record_function flag never disagrees
    # with the window's state under a racing start and stop.
    obs_trace.set_device_annotations(True)
  return True


def _device_events(path: str) -> int:
  with open(path) as f:
    events = json.load(f).get("traceEvents", [])
  return sum(1 for event in events
             if event.get("cat") in _DEVICE_CATEGORIES)


def stop_trace() -> Optional[str]:
  """Closes the guarded window and writes its Chrome trace; returns its
  log_dir (None when no window was open, so it is safe to call on every
  shutdown). A CUDA window that recorded no device event raises."""
  global _TRACE_DIR, _PROFILER, _WINDOWS
  with _TRACE_LOCK:
    if _TRACE_DIR is None:
      return None
    log_dir, profiler, cuda = _TRACE_DIR, _PROFILER, _CUDA
    _TRACE_DIR = _PROFILER = None
    obs_trace.set_device_annotations(False)
    profiler.stop()
    _WINDOWS += 1
    path = os.path.join(log_dir,
                        f"{TRACE_PREFIX}{os.getpid()}-{_WINDOWS}.json")
    tmp = path + ".tmp"
    profiler.export_chrome_trace(tmp)
    if cuda and not _device_events(tmp):
      os.remove(tmp)
      raise RuntimeError(
          "the CUDA trace window recorded no device event (is CUPTI "
          f"tracing the card?); nothing was written to {log_dir}")
    os.replace(tmp, path)
  return log_dir


@contextlib.contextmanager
def trace(log_dir: str, device: Device = None):
  """The body runs either way; it is traced unless another window is
  open."""
  started = start_trace(log_dir, device)
  try:
    yield
  finally:
    if started:
      stop_trace()


class ProfilerHook(Hook):
  """Captures a window of training steps into a trace directory.

  Steps are observed where the caller reports them (``after_step``), so
  the realized window snaps outward to those points: the trace starts at
  the first reported step >= start_step and stops at the first reported
  step >= end_step. A loop that reports every 100 steps turns (start=10,
  end=13) into one 100-step window from step 100; align the window to
  the reporting interval for precision.
  """

  def __init__(self, start_step: int = 10, end_step: int = 13,
               log_dir: Optional[str] = None, device: Device = None):
    if end_step <= start_step:
      raise ValueError(
          f"end_step ({end_step}) must be > start_step ({start_step}).")
    self._start_step = start_step
    self._end_step = end_step
    self._log_dir = log_dir
    self._device = device
    self._tracing = False
    self._done = False

  def begin(self, trainer, state, model_dir: str) -> None:
    del state
    if self._log_dir is None:
      self._log_dir = os.path.join(model_dir or ".", "profile")
    if self._device is None and trainer is not None:
      self._device = trainer.device

  def after_step(self, state, metrics: dict) -> None:
    del metrics
    if self._done:
      return
    step = int(state.step)
    if not self._tracing and step >= self._start_step:
      if not start_trace(self._log_dir, self._device):
        # Another capture path holds the profiler: skip this window.
        self._done = True
        return
      self._tracing = True
      _log.info("Profiler trace started at step %d -> %s", step,
                self._log_dir)
      # A single report at or past the whole window still captures one
      # reporting interval rather than none.
      return
    if self._tracing and step >= self._end_step:
      self._tracing = False
      self._done = True
      stop_trace()
      _log.info("Profiler trace stopped at step %d.", step)

  def end(self, state) -> None:
    if self._tracing:
      self._tracing = False
      self._done = True
      stop_trace()
      _log.info("Profiler trace stopped at end of training.")
    elif not self._done:
      _log.warning(
          "ProfilerHook never started: no reported step reached "
          "start_step=%d (training ran %d steps).", self._start_step,
          int(state.step))


class ProfilerHookBuilder(HookBuilder):
  """Makes a ProfilerHook from a config (its device is the trainer's)."""

  def __init__(self, start_step: int = 10, end_step: int = 13,
               log_dir: Optional[str] = None):
    self._start_step = start_step
    self._end_step = end_step
    self._log_dir = log_dir

  def create_hooks(self, trainer, model_dir: str) -> List[Hook]:
    return [ProfilerHook(start_step=self._start_step,
                         end_step=self._end_step, log_dir=self._log_dir)]
