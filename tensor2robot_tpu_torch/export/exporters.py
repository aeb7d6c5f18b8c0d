"""Eval-driven exporters: the latest and best-metric export policies.

Counterpart of ``tensor2robot_tpu/export/exporters.py`` (tf.estimator's
LatestExporter and BestExporter). The train loop and the continuous
evaluator drive each exporter after an evaluation with the evaluated
variables and the eval metrics; the exporter's policy decides whether
that state becomes a new export version under
``<model_dir>/export/<name>/<version>/``.
"""

from __future__ import annotations

import json
import logging
import math
import os
from typing import Callable, Dict, List, Optional, Sequence

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.export import export_utils

_log = logging.getLogger(__name__)


class Exporter:
  """Policy deciding when an eval result becomes a serving artifact."""

  def __init__(self, export_generator, name: str, keep: int = 5):
    self._generator = export_generator
    self.name = name
    self._keep = keep
    self._ready = False

  def begin(self, model, model_dir: str) -> None:
    """Binds the export root and the model's specs (idempotent)."""
    if self._ready:
      return
    try:
      self._generator.export_root
    except ValueError:
      if not model_dir:
        raise ValueError(
            f"Exporter {self.name!r} needs a model_dir to place its "
            "export root under.") from None
      self._generator.export_root = os.path.join(
          model_dir, "export", self.name)
    self._generator.set_specification_from_model(model)
    self._ready = True

  @property
  def export_root(self) -> str:
    return self._generator.export_root

  def after_eval(self, variables, global_step: int,
                 eval_metrics: Dict[str, float]) -> Optional[str]:
    """Maybe exports; returns the published directory or None.

    `variables` is the state_dict or a zero-argument callable returning
    it, so the device-to-host copy happens only when a policy publishes.
    """
    raise NotImplementedError

  def _export(self, variables, global_step: int) -> str:
    if callable(variables):
      variables = variables()
    export_dir = export_utils.export_and_gc(
        self._generator, variables, keep=self._keep,
        global_step=global_step)
    _log.info("Exporter %r published %s", self.name, export_dir)
    return export_dir


@configurable
class LatestExporter(Exporter):
  """Exports after every evaluation."""

  def __init__(self, export_generator, name: str = "latest",
               keep: int = 5):
    super().__init__(export_generator, name=name, keep=keep)

  def after_eval(self, variables, global_step: int,
                 eval_metrics: Dict[str, float]) -> Optional[str]:
    return self._export(variables, global_step)


@configurable
class BestExporter(Exporter):
  """Exports only when the tracked eval metric improves.

  The best value is kept in ``<export_root>/best_eval.json``, so a
  restarted job keeps comparing against the best of all its runs.
  """

  _STATE_FILE = "best_eval.json"

  def __init__(self, export_generator, name: str = "best",
               metric_key: str = "loss", higher_is_better: bool = False,
               keep: int = 5):
    super().__init__(export_generator, name=name, keep=keep)
    self._metric_key = metric_key
    self._higher_is_better = higher_is_better
    self._best: Optional[float] = None

  def begin(self, model, model_dir: str) -> None:
    first = not self._ready
    super().begin(model, model_dir)
    if first:
      path = os.path.join(self.export_root, self._STATE_FILE)
      if os.path.exists(path):
        try:
          with open(path) as f:
            self._best = float(json.load(f)["best"])
        except (ValueError, KeyError, TypeError):
          # A corrupt state file must not stop the job; compare afresh.
          _log.warning("Ignoring unreadable %s", path)

  def _improved(self, value: float) -> bool:
    if math.isnan(value):
      return False
    if self._best is None:
      return True
    return (value > self._best if self._higher_is_better
            else value < self._best)

  def after_eval(self, variables, global_step: int,
                 eval_metrics: Dict[str, float]) -> Optional[str]:
    if self._metric_key not in eval_metrics:
      raise KeyError(
          f"BestExporter {self.name!r} tracks {self._metric_key!r} but "
          f"eval produced {sorted(eval_metrics)}.")
    value = float(eval_metrics[self._metric_key])
    if not self._improved(value):
      return None
    export_dir = self._export(variables, global_step)
    self._best = value
    if export_dir is None:
      return None  # not the primary rank: the export and its state are its
    os.makedirs(self.export_root, exist_ok=True)
    # Written to a temporary file and renamed, as an export is published:
    # a crash never leaves a truncated state file.
    path = os.path.join(self.export_root, self._STATE_FILE)
    with open(path + ".tmp", "w") as f:
      json.dump({"best": value, "metric": self._metric_key,
                 "global_step": int(global_step)}, f)
    os.replace(path + ".tmp", path)
    return export_dir


@configurable
def create_default_exporters_fn(
    export_generator_factory: Callable[[], object],
    best_metric_key: str = "loss",
    higher_is_better: bool = False,
    keep: int = 5,
) -> Callable[[object], List[Exporter]]:
  """A create_exporters_fn making the default pair: a LatestExporter and a
  BestExporter on `best_metric_key`."""

  def create_exporters_fn(model) -> List[Exporter]:
    del model  # exporters bind the specs in begin()
    return [
        LatestExporter(export_generator_factory(), keep=keep),
        BestExporter(export_generator_factory(),
                     metric_key=best_metric_key,
                     higher_is_better=higher_is_better, keep=keep),
    ]

  return create_exporters_fn


def run_exporters(exporters: Sequence[Exporter], variables,
                  global_step: int,
                  eval_metrics: Dict[str, float]) -> Dict[str, str]:
  """Drives every exporter after one evaluation; returns {name: dir} of
  those that published. A callable `variables` is called at most once."""
  if callable(variables):
    provider, cache = variables, []

    def variables():  # noqa: F811 (the memoised provider)
      if not cache:
        cache.append(provider())
      return cache[0]

  published = {}
  for exporter in exporters:
    export_dir = exporter.after_eval(variables, global_step, eval_metrics)
    if export_dir is not None:
      published[exporter.name] = export_dir
  return published
