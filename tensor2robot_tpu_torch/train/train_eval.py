"""train_eval_model: train, evaluate and export one model, on one device.

Counterpart of ``tensor2robot_tpu/train/train_eval.py::train_eval_model``,
a subset: wire the input generators to the model's specs, train over
``prefetch_to_device`` with a bounded number of steps in flight, log the
metrics every ``log_every_steps``, evaluate every ``eval_interval_steps``
and at the end, and export the final variables. What the JAX loop also
does raises ``NotImplementedError`` when asked for, naming the
``ROADMAP.md`` item it waits for; nothing is skipped quietly.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Dict, Optional, Sequence

import torch

from tensor2robot_tpu_torch import Device, modes
from tensor2robot_tpu_torch.data.prefetch import prefetch_to_device
from tensor2robot_tpu_torch.export import export_utils
from tensor2robot_tpu_torch.train.train_state import TrainState
from tensor2robot_tpu_torch.train.trainer import Trainer

_log = logging.getLogger(__name__)

# What the JAX loop does and this one does not yet, by argument: the value
# that asks for nothing, and the ROADMAP.md item it waits for.
_WAITING = {
    "model_dir": (None, "Queue 1 item 3, train/checkpoints.py: checkpoints, "
                        "resume and the metric files under model_dir"),
    "create_exporters_fn": (None, "the flagship list's item 13, the "
                                  "training harness: eval exporters"),
    "hook_builders": ((), "the flagship list's item 13, the training "
                          "harness: hooks"),
    "iterations_per_loop": (1, "the flagship list's item 4, the train "
                               "step: several steps a dispatch"),
    "gradient_accumulation_steps": (1, "the flagship list's item 4, the "
                                       "train step: gradient accumulation"),
    "mesh": (None, "the flagship list's item 15, the parallel tier"),
    "param_specs": (None, "the flagship list's item 15, the parallel tier"),
    "shard_optimizer_state": (False, "the flagship list's item 15, the "
                                     "parallel tier"),
    "fsdp": (False, "the flagship list's item 15, the parallel tier"),
}


@dataclasses.dataclass
class TrainEvalResult:
  state: TrainState
  train_metrics: Dict[str, float]
  eval_metrics: Dict[str, float]
  export_dir: Optional[str]


def train_eval_model(
    model,
    input_generator_train=None,
    input_generator_eval=None,
    max_train_steps: int = 1000,
    eval_steps: int = 10,
    eval_interval_steps: int = 0,
    export_generator=None,
    export_keep: int = 5,
    seed: int = 0,
    log_every_steps: int = 100,
    prefetch_depth: int = 2,
    device: Device = None,
    model_dir: Optional[str] = None,
    create_exporters_fn=None,
    hook_builders: Sequence = (),
    iterations_per_loop: int = 1,
    gradient_accumulation_steps: int = 1,
    mesh=None,
    param_specs=None,
    shard_optimizer_state: bool = False,
    fsdp: bool = False,
) -> TrainEvalResult:
  """Trains (and optionally evaluates and exports) `model`.

  Args:
    max_train_steps: optimizer steps to take.
    eval_steps: eval batches per evaluation.
    eval_interval_steps: evaluate every N train steps (0 = only the final
      evaluation, when an eval generator is given).
    export_generator: exports the final variables (EMA when kept) under its
      export_root, keeping the newest `export_keep` versions.
    seed: the trainer's init seed.
    log_every_steps: metric cadence; the metrics of the last logged step
      come back in `train_metrics`.
    prefetch_depth: batches copied ahead of the step, and the bound on
      steps issued ahead of the device.
    device: where to train; the GPU unless 'cpu' is asked for.
    model_dir ... fsdp: the JAX loop's checkpoints, hooks, exporters,
      fused steps, accumulation and parallelism; any value but the default
      raises NotImplementedError naming the ROADMAP.md item it waits for.
  """
  asked = dict(model_dir=model_dir, create_exporters_fn=create_exporters_fn,
               hook_builders=tuple(hook_builders),
               iterations_per_loop=iterations_per_loop,
               gradient_accumulation_steps=gradient_accumulation_steps,
               mesh=mesh, param_specs=param_specs,
               shard_optimizer_state=shard_optimizer_state, fsdp=fsdp)
  for name, value in asked.items():
    default, item = _WAITING[name]
    if value != default:
      raise NotImplementedError(
          f"train_eval_model({name}={value!r}) waits for ROADMAP.md {item}.")
  if export_generator is not None:
    export_utils.resolve_export_root(export_generator, model_dir)

  trainer = Trainer(model, seed=seed, device=device)
  state = trainer.create_train_state()
  train_metrics: Dict[str, float] = {}
  eval_metrics: Dict[str, float] = {}

  def run_eval(state: TrainState) -> Dict[str, float]:
    if input_generator_eval is None:
      return {}
    return _evaluate(trainer, model, input_generator_eval, state, eval_steps,
                     prefetch_depth)

  if input_generator_train is not None and max_train_steps > 0:
    input_generator_train.set_specification_from_model(model, modes.TRAIN)
    train_iter = prefetch_to_device(
        input_generator_train.create_dataset_fn(modes.TRAIN)(),
        device=trainer.device, depth=prefetch_depth)
    # CUDA steps return before the device finishes them; waiting on the
    # step `prefetch_depth` back keeps the host from queueing stale work.
    inflight = collections.deque()
    while state.step < max_train_steps:
      features, labels = next(train_iter)
      state, metrics = trainer.train_step(state, features, labels)
      if trainer.device.type == "cuda":
        inflight.append(torch.cuda.Event())
        inflight[-1].record(torch.cuda.current_stream(trainer.device))
        if len(inflight) > max(2, prefetch_depth):
          inflight.popleft().synchronize()
      if (log_every_steps > 0 and state.step % log_every_steps == 0
          ) or state.step == max_train_steps:
        train_metrics = {k: float(v) for k, v in metrics.items()}
        _log.info("step %d: %s", state.step, train_metrics)
      if (eval_interval_steps > 0 and state.step % eval_interval_steps == 0
          and state.step < max_train_steps):
        eval_metrics = run_eval(state)
        _log.info("eval at step %d: %s", state.step, eval_metrics)

  eval_metrics = run_eval(state) or eval_metrics
  export_dir = None
  if export_generator is not None:
    export_generator.set_specification_from_model(model)
    export_dir = export_utils.export_and_gc(
        export_generator,
        export_utils.fetch_variables_to_host(state.variables(use_ema=True)),
        keep=export_keep, global_step=state.step)
    _log.info("Exported the final model to %s", export_dir)
  return TrainEvalResult(state=state, train_metrics=train_metrics,
                         eval_metrics=eval_metrics, export_dir=export_dir)


def _evaluate(trainer: Trainer, model, input_generator_eval,
              state: TrainState, eval_steps: int,
              prefetch_depth: int) -> Dict[str, float]:
  """Eval metrics averaged over `eval_steps` batches."""
  input_generator_eval.set_specification_from_model(model, modes.EVAL)
  eval_iter = prefetch_to_device(
      input_generator_eval.create_dataset_fn(modes.EVAL)(),
      device=trainer.device, depth=prefetch_depth)
  sums: Dict[str, float] = {}
  count = 0
  for _, (features, labels) in zip(range(eval_steps), eval_iter):
    for key, value in trainer.eval_step(state, features, labels).items():
      sums[key] = sums.get(key, 0.0) + float(value)
    count += 1
  return {key: value / max(count, 1) for key, value in sums.items()}
