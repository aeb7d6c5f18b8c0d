"""Abstract input generator: builds host-side batch iterators from specs.

Counterpart of ``tensor2robot_tpu/data/abstract_input_generator.py``. An
input generator is a factory of numpy batch iterators: producing and
preprocessing run on the host, and ``data.prefetch.prefetch_to_device``
overlaps the host-to-device copy with compute. ``shard_index`` /
``num_shards`` partition the stream, so each host feeds its slice of the
global batch.
"""

from __future__ import annotations

import abc
from typing import Callable, Iterator, Optional, Tuple

from tensor2robot_tpu_torch import modes
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

# A batch is (features, labels): flat TensorSpecStructs of numpy arrays
# with a leading (per-host) batch dim.
Batch = Tuple[ts.TensorSpecStruct, ts.TensorSpecStruct]


class AbstractInputGenerator(abc.ABC):
  """Builds per-host batch iterators conforming to a model's specs."""

  def __init__(
      self,
      batch_size: int = 32,
      shard_index: int = 0,
      num_shards: int = 1,
  ):
    if batch_size <= 0:
      raise ValueError(f"batch_size must be positive, got {batch_size}")
    if not 0 <= shard_index < num_shards:
      raise ValueError(
          f"shard_index {shard_index} out of range for {num_shards} shards")
    self._batch_size = batch_size
    self._shard_index = shard_index
    self._num_shards = num_shards
    self._feature_spec: Optional[ts.TensorSpecStruct] = None
    self._label_spec: Optional[ts.TensorSpecStruct] = None
    self._preprocess_fn: Optional[Callable[..., Batch]] = None
    self._wired_mode: Optional[str] = None

  def set_specification_from_model(self, model, mode: str) -> None:
    """Takes the in/out specs and the preprocessor from a model.

    The pipeline produces what the model's *preprocessor* consumes (its
    in-specs) and emits what the model consumes (its out-specs).
    """
    preprocessor = model.preprocessor
    self.set_specification(
        feature_spec=preprocessor.get_in_feature_specification(mode),
        label_spec=preprocessor.get_in_label_specification(mode),
    )
    self._preprocess_fn = lambda features, labels: preprocessor.preprocess(
        features, labels, mode)
    self._wired_mode = mode

  def set_specification(
      self,
      feature_spec: ts.SpecStructure,
      label_spec: Optional[ts.SpecStructure] = None,
  ) -> None:
    ts.assert_valid_spec_structure(feature_spec)
    self._feature_spec = ts.flatten_spec_structure(feature_spec)
    if label_spec is not None:
      ts.assert_valid_spec_structure(label_spec)
      self._label_spec = ts.flatten_spec_structure(label_spec)
    else:
      self._label_spec = ts.TensorSpecStruct()

  @property
  def batch_size(self) -> int:
    """Per-host batch size."""
    return self._batch_size

  @property
  def feature_spec(self) -> ts.TensorSpecStruct:
    self._assert_specs_set()
    return self._feature_spec

  @property
  def label_spec(self) -> ts.TensorSpecStruct:
    self._assert_specs_set()
    return self._label_spec

  def _assert_specs_set(self) -> None:
    if self._feature_spec is None:
      raise ValueError(
          "Input generator has no specs; call set_specification_from_model "
          "or set_specification first.")

  def create_dataset_fn(self, mode: str) -> Callable[[], Iterator[Batch]]:
    """Returns a factory of fresh batch iterators for `mode`, so train and
    eval can each restart their streams."""
    modes.validate_mode(mode)
    self._assert_specs_set()
    if self._preprocess_fn is not None and mode != self._wired_mode:
      raise ValueError(
          f"Input generator was wired for mode {self._wired_mode!r} (its "
          f"preprocess closure is mode-bound) but asked to produce "
          f"{mode!r}; call set_specification_from_model(model, {mode!r}) "
          "first.")

    def factory() -> Iterator[Batch]:
      iterator = self._create_iterator(mode)
      if self._preprocess_fn is None:
        return iterator
      return (self._preprocess_fn(f, l) for f, l in iterator)

    return factory

  @abc.abstractmethod
  def _create_iterator(self, mode: str) -> Iterator[Batch]:
    """Yields raw (pre-preprocessor) spec-conformant batches."""
