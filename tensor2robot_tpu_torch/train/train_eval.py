"""train_eval_model: train, evaluate and export one model, on one device.

Counterpart of ``tensor2robot_tpu/train/train_eval.py::train_eval_model``,
single host: wire the input generators to the model's specs, train over
``prefetch_to_device`` with a bounded number of steps in flight, log the
metrics every ``log_every_steps``, evaluate every ``eval_interval_steps``
and at the end, and export the final variables. With
``iterations_per_loop`` K > 1 it feeds K-stacked batches to
``Trainer.train_steps`` (on the GPU one CUDA graph replay for K steps);
with ``gradient_accumulation_steps`` m > 1, m-stacked microbatches to
``Trainer.train_step_accum``. Under ``model_dir`` it
also checkpoints every ``save_checkpoints_steps`` (and at the end), resumes
from the latest checkpoint, writes ``metrics.jsonl`` and an event file
(with the model's eval image summaries), dumps the operative config, and
on SIGTERM or SIGINT leaves the loop through the final checkpoint. Hooks
(``hooks/``) see the loop where the JAX loop calls them: ``begin``,
``after_step`` at each log step, ``after_checkpoint`` after each save,
``end`` after the final export; eval exporters (``export/exporters.py``)
run after every evaluation. ``continuous_eval_model`` is the separate
evaluator job: it evaluates each checkpoint of a ``model_dir`` as it
lands.

Over a mesh of ranks (``mesh``, ``param_specs``, ``shard_optimizer_state``,
``fsdp``: the JAX loop's parallelism, ``train/trainer.py``) every rank
runs this loop: each rank's input generator yields the same global batch
and the trainer keeps the rank's block. Metric files, the event file and
the operative config are written by the primary rank only; checkpoints
and exports run on every rank (their gathers are collectives) and the
primary writes the files.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import os
import signal
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tensor2robot_tpu_torch import Device, modes
from tensor2robot_tpu_torch.config import configurable, operative_config_str
from tensor2robot_tpu_torch.data.prefetch import prefetch_to_device
from tensor2robot_tpu_torch.export import export_utils
from tensor2robot_tpu_torch.export.exporters import run_exporters
from tensor2robot_tpu_torch.hooks.hook_builder import Hook, HookBuilder
from tensor2robot_tpu_torch.parallel import distributed
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import tp_rules
from tensor2robot_tpu_torch.train.checkpoints import CheckpointManager
from tensor2robot_tpu_torch.train.train_state import TrainState
from tensor2robot_tpu_torch.train.trainer import Trainer
from tensor2robot_tpu_torch.utils.metric_writer import MetricWriter
from tensor2robot_tpu_torch.utils.tree import tree_map

_log = logging.getLogger(__name__)


def _default_mesh(mesh, param_specs, shard_optimizer_state: bool):
  """The JAX loop's default: a mesh of every rank ({"data": -1}) when a
  layout asks for one or the process group has more than one rank."""
  if mesh is None and (param_specs is not None or shard_optimizer_state
                       or distributed.process_count() > 1):
    return mesh_lib.create_mesh()
  return mesh


def _init_exporters(create_exporters_fn, model, model_dir: str):
  """Builds and binds the eval exporters; two may not share a root."""
  if create_exporters_fn is None:
    return []
  exporters = list(create_exporters_fn(model))
  roots = set()
  for exporter in exporters:
    exporter.begin(model, model_dir)
    root = os.path.abspath(exporter.export_root)
    if root in roots:
      raise ValueError(
          f"Two exporters publish to the same root {root!r}; give them "
          "distinct names.")
    roots.add(root)
  return exporters


def _run_exporters_after_eval(exporters, state: TrainState,
                              eval_metrics: Dict[str, float]) -> None:
  """Drives the exporters; the variables are copied to the host at most
  once, and only if a policy publishes."""
  if exporters:
    run_exporters(
        exporters,
        lambda: export_utils.fetch_variables_to_host(
            state.full_variables(use_ema=True)),
        state.step, eval_metrics)


class _PreemptionGuard:
  """SIGTERM/SIGINT -> finish the current step, checkpoint, exit cleanly.

  Installed only on the main thread and only while the train loop runs;
  the previous handlers come back on exit. A second signal goes to the
  previous handler, so a double Ctrl-C still kills.
  """

  def __init__(self, enabled: bool = True):
    self._enabled = enabled
    self.requested = False
    self._previous = {}

  def __enter__(self):
    if (not self._enabled
        or threading.current_thread() is not threading.main_thread()):
      return self  # signal.signal is main-thread-only; run unguarded

    def handler(signum, frame):
      if self.requested:  # second signal: defer to the original handler
        previous = self._previous.get(signum)
        if callable(previous):
          previous(signum, frame)
          return
        raise KeyboardInterrupt
      self.requested = True
      _log.warning(
          "Signal %d received: checkpointing at the next loop boundary "
          "and exiting.", signum)

    for signum in (signal.SIGTERM, signal.SIGINT):
      self._previous[signum] = signal.signal(signum, handler)
    return self

  def __exit__(self, *exc):
    for signum, previous in self._previous.items():
      signal.signal(signum, previous)
    self._previous = {}
    return False


@dataclasses.dataclass
class TrainEvalResult:
  state: TrainState
  train_metrics: Dict[str, float]
  eval_metrics: Dict[str, float]
  export_dir: Optional[str]
  loop_stats: Dict[str, float] = dataclasses.field(default_factory=dict)


@configurable
def train_eval_model(
    model,
    input_generator_train=None,
    input_generator_eval=None,
    max_train_steps: int = 1000,
    eval_steps: int = 10,
    eval_interval_steps: int = 0,
    model_dir: Optional[str] = None,
    save_checkpoints_steps: int = 0,
    keep_checkpoint_max: int = 5,
    export_generator=None,
    export_keep: int = 5,
    seed: int = 0,
    log_every_steps: int = 100,
    prefetch_depth: int = 2,
    handle_preemption: bool = True,
    device: Device = None,
    create_exporters_fn=None,
    hook_builders: Sequence[HookBuilder] = (),
    iterations_per_loop: int = 1,
    gradient_accumulation_steps: int = 1,
    mesh=None,
    param_specs=None,
    shard_optimizer_state: bool = False,
    fsdp: bool = False,
    fsdp_min_size: int = 4096,
) -> TrainEvalResult:
  """Trains (and optionally evaluates and exports) `model`.

  Args:
    max_train_steps: total steps, counted from the restored step when the
      run resumes (Estimator's max_steps).
    eval_steps: eval batches per evaluation.
    eval_interval_steps: evaluate every N train steps (0 = only the final
      evaluation, when an eval generator is given).
    model_dir: the run directory: ``checkpoints/``, ``metrics.jsonl``, the
      event file, ``operative_config.txt``, and the exports when
      `export_generator` has no root of its own. None writes none of it.
    save_checkpoints_steps: checkpoint cadence (0 = only the final one).
    keep_checkpoint_max: checkpoints kept.
    export_generator: exports the final variables (EMA when kept) under its
      export_root, keeping the newest `export_keep` versions.
    seed: the trainer's init seed.
    log_every_steps: metric cadence; the metrics of the last logged step
      come back in `train_metrics`.
    prefetch_depth: batches copied ahead of the step, and the bound on
      steps issued ahead of the device.
    handle_preemption: trap SIGTERM/SIGINT during the train loop and leave
      through the final checkpoint, so the run resumes where it stopped.
    device: where to train; the GPU unless 'cpu' is asked for.
    iterations_per_loop: K steps a dispatch over K-stacked batches; the
      step advances by K (a final stack covers what is left).
    gradient_accumulation_steps: m microbatches a step, their gradients
      averaged; each step consumes m generator batches. The two are
      mutually exclusive.
    create_exporters_fn: model -> [export.exporters.Exporter]; each runs
      after every evaluation (the latest and best export policies).
    hook_builders: HookBuilders whose hooks observe the loop (an
      AsyncExportHookBuilder exports each checkpoint while training).
    mesh: a ``parallel.mesh.Mesh`` of ranks; by default every rank
      (``{"data": -1}``) when the process group has several or a layout
      below asks for one.
    param_specs: the parameters' specs (``parallel.tp_rules``): tensor
      parallelism, FSDP; None replicates them (data parallelism).
    shard_optimizer_state: ZeRO-1 (see ``Trainer``).
    fsdp: derive FSDP specs from the model
      (``tp_rules.infer_fsdp_specs_from_model``); exclusive with
      param_specs and with shard_optimizer_state.
    fsdp_min_size: the smallest parameter (elements) fsdp shards.

  The loop logs its timing once, at the end of training, as the record's
  ``loop_stats`` (``extra``): the host-clock time of each step from
  asking for its batch to the next such ask, and the time blocked in
  ``next()`` on the prefetch iterator; with ``iterations_per_loop`` a
  "step" there is the dispatch of one stack (``steps_per_dispatch``). The
  result carries them as ``loop_stats`` too.
  """
  if fsdp:
    if param_specs is not None:
      raise ValueError("Pass either fsdp=True or explicit param_specs, "
                       "not both.")
    if shard_optimizer_state:
      raise ValueError(
          "fsdp=True already shards optimizer state with the params "
          "(ZeRO-3 subsumes ZeRO-1); drop shard_optimizer_state.")
    if mesh is None:
      mesh = mesh_lib.create_mesh()
    param_specs = tp_rules.infer_fsdp_specs_from_model(
        model, mesh, min_size=fsdp_min_size)
  mesh = _default_mesh(mesh, param_specs, shard_optimizer_state)
  if iterations_per_loop < 1:
    raise ValueError(f"iterations_per_loop must be >= 1, got "
                     f"{iterations_per_loop}")
  if gradient_accumulation_steps < 1:
    raise ValueError(f"gradient_accumulation_steps must be >= 1, got "
                     f"{gradient_accumulation_steps}")
  if gradient_accumulation_steps > 1 and iterations_per_loop > 1:
    raise ValueError(
        "gradient_accumulation_steps and iterations_per_loop are mutually "
        "exclusive: one trades memory for compute, the other fuses "
        "dispatches — accumulate inside a scanned loop is not supported.")
  if export_generator is not None:
    export_utils.resolve_export_root(export_generator, model_dir)

  trainer = Trainer(model, seed=seed, device=device, mesh=mesh,
                    param_specs=param_specs,
                    shard_optimizer_state=shard_optimizer_state)
  state = trainer.create_train_state()
  # The chief-worker rule: metric and event files and the operative
  # config belong to the primary; checkpoints and exports run everywhere.
  primary = distributed.is_primary()

  checkpoint_manager = None
  metric_writer = None
  if model_dir:
    os.makedirs(model_dir, exist_ok=True)
    checkpoint_manager = CheckpointManager(
        os.path.join(model_dir, "checkpoints"),
        max_to_keep=keep_checkpoint_max,
        save_interval_steps=save_checkpoints_steps)
    if checkpoint_manager.latest_step() is not None:
      state = checkpoint_manager.restore(state)
      _log.info("Resumed from step %d", state.step)
    if primary:
      metric_writer = MetricWriter(model_dir)
      with open(os.path.join(model_dir, "operative_config.txt"), "w") as f:
        f.write(operative_config_str())

  hooks: List[Hook] = []
  for builder in hook_builders:
    hooks.extend(builder.create_hooks(trainer, model_dir or ""))
  for hook in hooks:
    hook.begin(trainer, state, model_dir or "")
  exporters = _init_exporters(create_exporters_fn, model, model_dir or "")

  train_metrics: Dict[str, float] = {}
  eval_metrics: Dict[str, float] = {}
  loop_stats: Dict[str, float] = {}

  def run_eval(state: TrainState) -> Dict[str, float]:
    if input_generator_eval is None:
      return {}
    metrics, images = _evaluate(trainer, model, input_generator_eval, state,
                                eval_steps, prefetch_depth)
    if metric_writer and images:
      metric_writer.write_images(
          state.step, {f"eval/{k}": v for k, v in images.items()})
    _run_exporters_after_eval(exporters, state, metrics)
    return metrics

  def crossed(cadence: int, prev: int, now: int) -> bool:
    return cadence > 0 and now // cadence > prev // cadence

  # The guard stays armed through the final checkpoint: a signal landing
  # during the save must not kill the writer mid-file.
  with _PreemptionGuard(enabled=(handle_preemption
                                 and input_generator_train is not None
                                 and max_train_steps > 0)) as preemption:
    if input_generator_train is not None and state.step < max_train_steps:
      input_generator_train.set_specification_from_model(model, modes.TRAIN)
      host_iter = input_generator_train.create_dataset_fn(modes.TRAIN)()
      pipeline_stats = getattr(input_generator_train, "pipeline_stats",
                               None)
      if pipeline_stats:
        _log.info("train input pipeline: %s", pipeline_stats)
      rank_batches = map(trainer.shard_batch, host_iter)
      if iterations_per_loop > 1 or gradient_accumulation_steps > 1:
        # Both feed (K, batch, ...) stacks: a stack is K steps, or the
        # m microbatches of one step (so the stream holds steps x m
        # batches, every stack full).
        remaining = max_train_steps - state.step
        if iterations_per_loop > 1:
          stack, total = iterations_per_loop, remaining
        else:
          stack = gradient_accumulation_steps
          total = remaining * stack
        host_batches = _stack_batches(rank_batches, stack, total)
      else:
        host_batches = rank_batches
      train_iter = prefetch_to_device(host_batches, device=trainer.device,
                                      depth=prefetch_depth)
      # CUDA steps return before the device finishes them; waiting on the
      # step `prefetch_depth` back keeps the host from queueing stale work.
      inflight = collections.deque()
      wait_s, step_s = [], []
      while state.step < max_train_steps and not preemption.requested:
        begin = time.perf_counter()
        features, labels = next(train_iter)
        wait_s.append(time.perf_counter() - begin)
        prev_step = state.step
        if iterations_per_loop > 1:
          state, metrics = trainer.train_steps(state, features, labels)
        elif gradient_accumulation_steps > 1:
          state, metrics = trainer.train_step_accum(state, features, labels)
        else:
          state, metrics = trainer.train_step(state, features, labels)
        if trainer.device.type == "cuda":
          inflight.append(torch.cuda.Event())
          inflight[-1].record(torch.cuda.current_stream(trainer.device))
          if len(inflight) > max(2, prefetch_depth):
            inflight.popleft().synchronize()
        step = state.step
        if (crossed(log_every_steps, prev_step, step)
            or step == max_train_steps):
          train_metrics = {k: float(v) for k, v in metrics.items()}
          if metric_writer:
            metric_writer.write_scalars(step, train_metrics)
          for hook in hooks:
            hook.after_step(state, train_metrics)
          _log.info("step %d: %s", step, train_metrics)
        if checkpoint_manager and checkpoint_manager.should_save(
            step, last_step=prev_step):
          checkpoint_manager.save(step, state)
          for hook in hooks:
            hook.after_checkpoint(step, state)
        if (crossed(eval_interval_steps, prev_step, step)
            and step < max_train_steps):
          eval_metrics = run_eval(state)
          if metric_writer and eval_metrics:
            metric_writer.write_scalars(
                step, {f"eval/{k}": v for k, v in eval_metrics.items()})
        step_s.append(time.perf_counter() - begin)
      host_iter.close()  # stops a record generator's reader and parsers
      if preemption.requested:
        _log.warning("Preempted at step %d; the final checkpoint below is "
                     "the resume point.", state.step)
      loop_stats = {
          "steps": len(step_s),
          "steps_per_dispatch": iterations_per_loop,
          "step_ms_median": float(np.median(step_s)) * 1e3,
          "input_wait_ms_median": float(np.median(wait_s)) * 1e3,
          "input_wait_share": float(np.sum(wait_s) / np.sum(step_s)),
      } if step_s else {"steps": 0}
      _log.info("train loop: %s", loop_stats,
                extra={"loop_stats": loop_stats})

    # Final checkpoint (also the resume point for a follow-on run).
    if checkpoint_manager and (checkpoint_manager.latest_step()
                               != state.step):
      checkpoint_manager.save(state.step, state, force=True)
      for hook in hooks:
        hook.after_checkpoint(state.step, state)

  final_eval = run_eval(state)
  if final_eval:
    eval_metrics = final_eval
    if metric_writer:
      metric_writer.write_scalars(
          state.step, {f"eval/{k}": v for k, v in eval_metrics.items()})
  export_dir = None
  if export_generator is not None:
    if any(os.path.abspath(e.export_root)
           == os.path.abspath(export_generator.export_root)
           for e in exporters):
      raise ValueError(
          f"export_generator and an eval exporter both publish to "
          f"{export_generator.export_root!r}; their garbage collection "
          "would delete each other's versions. Give the exporter another "
          "name or drop one of the two.")
    export_generator.set_specification_from_model(model)
    export_dir = export_utils.export_and_gc(
        export_generator,
        export_utils.fetch_variables_to_host(
            state.full_variables(use_ema=True)),
        keep=export_keep, global_step=state.step)
    if export_dir is not None:
      _log.info("Exported the final model to %s", export_dir)
  for hook in hooks:
    hook.end(state)
  if checkpoint_manager:
    checkpoint_manager.close()
  if metric_writer:
    metric_writer.close()
  return TrainEvalResult(state=state, train_metrics=train_metrics,
                         eval_metrics=eval_metrics, export_dir=export_dir,
                         loop_stats=loop_stats)


def _stack_batches(host_iter, stack: int, total: int):
  """Groups the host batches into (K, batch, ...) stacks for `total`
  batches: full stacks of `stack` and, when `stack` does not divide
  `total`, one final smaller stack (which takes a graph of its own)."""
  remaining = total
  while remaining > 0:
    size = min(stack, remaining)
    batches = [next(host_iter) for _ in range(size)]
    remaining -= size
    yield tree_map(lambda *leaves: np.stack(leaves), *batches)


def _evaluate(trainer: Trainer, model, input_generator_eval,
              state: TrainState, eval_steps: int, prefetch_depth: int):
  """Eval metrics averaged over `eval_steps` batches, and the model's image
  summaries of the last batch ({} when it renders none)."""
  input_generator_eval.set_specification_from_model(model, modes.EVAL)
  eval_iter = prefetch_to_device(
      map(trainer.shard_batch,
          input_generator_eval.create_dataset_fn(modes.EVAL)()),
      device=trainer.device, depth=prefetch_depth)
  sums: Dict[str, float] = {}
  count = 0
  last_features = None
  for _, (features, labels) in zip(range(eval_steps), eval_iter):
    for key, value in trainer.eval_step(state, features, labels).items():
      sums[key] = sums.get(key, 0.0) + float(value)
    count += 1
    last_features = features
  metrics = {key: value / max(count, 1) for key, value in sums.items()}
  images = {}
  if last_features is not None:
    images = dict(model.model_image_summaries_fn(
        state.full_variables(use_ema=True), last_features) or {})
  return metrics, images


@configurable
def continuous_eval_model(
    model,
    input_generator_eval,
    model_dir: str,
    eval_steps: int = 10,
    poll_interval_s: float = 10.0,
    timeout_s: float = 3600.0,
    stop_after_step: int = 0,
    max_evaluations: int = 0,
    create_exporters_fn=None,
    seed: int = 0,
    prefetch_depth: int = 2,
    device: Device = None,
    mesh=None,
    param_specs=None,
    shard_optimizer_state: bool = False,
) -> Dict[int, Dict[str, float]]:
  """The evaluator job: evaluates every checkpoint of `model_dir` as it
  lands, oldest first, and writes ``eval/*`` metrics (and image
  summaries) under ``<model_dir>/eval``; exporters run after each.

  Stops when no new checkpoint appears within `timeout_s`, when a
  checkpoint at a step >= `stop_after_step` (if > 0) has been evaluated,
  or after `max_evaluations` (if > 0) evaluations. `mesh`, `param_specs`
  and `shard_optimizer_state` evaluate over a mesh of ranks as
  ``train_eval_model`` trains: every rank restores and evaluates each
  checkpoint (a restore refuses another geometry's stamp), the primary
  lists the directory and decides, the others follow its broadcast, and
  only the primary writes the metric files.

  Returns {checkpoint step: eval metrics} for every evaluated step.
  """
  mesh = _default_mesh(mesh, param_specs, shard_optimizer_state)
  trainer = Trainer(model, seed=seed, device=device, mesh=mesh,
                    param_specs=param_specs,
                    shard_optimizer_state=shard_optimizer_state)
  template = trainer.create_train_state()
  checkpoint_manager = CheckpointManager(
      os.path.join(model_dir, "checkpoints"))
  exporters = _init_exporters(create_exporters_fn, model, model_dir)
  results: Dict[int, Dict[str, float]] = {}
  last_new_checkpoint = time.monotonic()
  primary = distributed.is_primary()
  with contextlib.ExitStack() as stack:
    metric_writer = (stack.enter_context(
        MetricWriter(os.path.join(model_dir, "eval"))) if primary else None)
    while True:
      pending = _agree([step for step in checkpoint_manager.all_steps()
                        if step not in results], trainer)
      for step in pending:  # every checkpoint, oldest first
        last_new_checkpoint = time.monotonic()
        state = checkpoint_manager.restore(template, step=step)
        metrics, images = _evaluate(trainer, model, input_generator_eval,
                                    state, eval_steps, prefetch_depth)
        results[step] = metrics
        if metric_writer:
          metric_writer.write_scalars(
              step, {f"eval/{k}": v for k, v in metrics.items()})
          if images:
            metric_writer.write_images(
                step, {f"eval/{k}": v for k, v in images.items()})
        _log.info("continuous eval @ step %d: %s", step, metrics)
        _run_exporters_after_eval(exporters, state, metrics)
        if ((stop_after_step and step >= stop_after_step)
            or (max_evaluations and len(results) >= max_evaluations)):
          return results
      if not pending:
        if _agree(time.monotonic() - last_new_checkpoint > timeout_s,
                  trainer):
          _log.info("continuous eval: no new checkpoint for %.0fs; "
                    "stopping.", timeout_s)
          return results
        time.sleep(poll_interval_s)


def _agree(value, trainer: Trainer):
  """The primary rank's `value` on every rank of the trainer's mesh (each
  rank lists the directory and reads its clock apart; the collectives that
  follow need one decision)."""
  if trainer.layout is None:
    return value
  box = [value]
  torch.distributed.broadcast_object_list(box, src=0)
  return box[0]
