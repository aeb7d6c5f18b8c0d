"""Typed tensor specs: the numpy subset that serving and training need.

Counterpart of ``tensor2robot_tpu/specs/tensorspec_utils.py``:
``ExtendedTensorSpec``, ``TensorSpecStruct``, ``flatten_spec_structure``,
``assert_valid_spec_structure``, ``validate_and_flatten``, the random
batches of the mock input stack (``make_random_batch``, the same draws as
the JAX package's from the same generator), the record parser's schema
(``tensorspec_to_feature_dict``, ``pad_or_clip_array``) and the JSON
serialisation of an export's spec assets (``to_serialized`` /
``from_serialized``). Plain
numpy: no pytree registration, and dtypes are numpy's own (an export's
spec that names ``bfloat16`` is refused).
"""

from __future__ import annotations

import dataclasses
import json
import re
from collections import OrderedDict
from collections.abc import Mapping, MutableMapping
from typing import Any, Iterator, Optional, Union

import numpy as np

_VALID_KEY_RE = re.compile(r"^[A-Za-z0-9_.\-]+$")

# data_format values that mean "this spec arrives as an encoded image string
# and must be decoded host-side before it can cross to device".
_ENCODED_IMAGE_FORMATS = frozenset({"jpeg", "jpg", "png"})


def _normalize_dtype(dtype: Any) -> np.dtype:
  """Normalizes numpy/str/python dtypes to a canonical np.dtype."""
  if isinstance(dtype, np.dtype):
    return dtype
  return np.dtype(dtype)


def _normalize_shape(shape: Any) -> tuple[int, ...]:
  if shape is None:
    return ()
  if isinstance(shape, (int, np.integer)):
    return (int(shape),)
  out = []
  for dim in shape:
    if dim is None:
      raise ValueError(
          "Dynamic (None) dimensions are not supported: every spec must be "
          f"statically shaped. Got shape={shape!r}.")
    out.append(int(dim))
  return tuple(out)


@dataclasses.dataclass(frozen=True)
class ExtendedTensorSpec:
  """A statically-shaped tensor spec with robot-data extras.

  Shapes never include the batch dimension.

  Attributes:
    shape: static per-example shape (no batch dim).
    dtype: canonical numpy dtype.
    name: optional tensor name (defaults to the struct key when packed).
    is_optional: packing tolerates this spec being absent from the data.
    is_sequence: variable-length (ragged over time) feature.
    data_format: None for raw numeric data; 'jpeg'/'png' marks an
      encoded-image feature.
    dataset_key: which dataset of a multi-dataset input this spec is read
      from ('' = default dataset).
    varlen_default_value: padding value for varlen parsing.
  """

  shape: tuple[int, ...]
  dtype: np.dtype
  name: Optional[str] = None
  is_optional: bool = False
  is_sequence: bool = False
  data_format: Optional[str] = None
  dataset_key: str = ""
  varlen_default_value: Optional[float] = None

  def __init__(
      self,
      shape: Any,
      dtype: Any,
      name: Optional[str] = None,
      is_optional: bool = False,
      is_sequence: bool = False,
      data_format: Optional[str] = None,
      dataset_key: str = "",
      varlen_default_value: Optional[float] = None,
  ):
    object.__setattr__(self, "shape", _normalize_shape(shape))
    object.__setattr__(self, "dtype", _normalize_dtype(dtype))
    object.__setattr__(self, "name", name)
    object.__setattr__(self, "is_optional", bool(is_optional))
    object.__setattr__(self, "is_sequence", bool(is_sequence))
    object.__setattr__(
        self, "data_format", data_format.lower() if data_format else None)
    object.__setattr__(self, "dataset_key", dataset_key or "")
    object.__setattr__(self, "varlen_default_value", varlen_default_value)

  def to_json_dict(self) -> dict[str, Any]:
    return {
        "shape": list(self.shape),
        "dtype": self.dtype.name,
        "name": self.name,
        "is_optional": self.is_optional,
        "is_sequence": self.is_sequence,
        "data_format": self.data_format,
        "dataset_key": self.dataset_key,
        "varlen_default_value": self.varlen_default_value,
    }

  @classmethod
  def from_json_dict(cls, d: Mapping[str, Any]) -> "ExtendedTensorSpec":
    return cls(**dict(d))

  @classmethod
  def from_spec(cls, spec: "ExtendedTensorSpec",
                **overrides: Any) -> "ExtendedTensorSpec":
    """A copy of `spec` with `overrides` applied."""
    fields = spec.to_json_dict()
    fields.update(overrides)
    return cls(**fields)

  def __repr__(self) -> str:
    extras = []
    if self.name:
      extras.append(f"name={self.name!r}")
    if self.is_optional:
      extras.append("is_optional=True")
    if self.is_sequence:
      extras.append("is_sequence=True")
    if self.data_format:
      extras.append(f"data_format={self.data_format!r}")
    if self.dataset_key:
      extras.append(f"dataset_key={self.dataset_key!r}")
    if self.varlen_default_value is not None:
      extras.append(f"varlen_default_value={self.varlen_default_value!r}")
    extra = (", " + ", ".join(extras)) if extras else ""
    return f"ExtendedTensorSpec({self.shape}, {self.dtype.name}{extra})"


def is_encoded_image_spec(spec: ExtendedTensorSpec) -> bool:
  """True if the spec arrives as an encoded image (jpeg/png) byte string."""
  return (spec.data_format or "") in _ENCODED_IMAGE_FORMATS


class TensorSpecStruct(MutableMapping):
  """Ordered, attribute-accessible, nestable container for specs or tensors.

  Internally a single flat ordered dict keyed by '/'-separated paths;
  attribute or item access on an intermediate path returns a live *view*
  onto the subtree. Iteration yields flat paths relative to the view's
  prefix, in insertion order.
  """

  __slots__ = ("_data", "_prefix")

  def __init__(self, *args: Any, **kwargs: Any):
    object.__setattr__(self, "_data", OrderedDict())
    object.__setattr__(self, "_prefix", "")
    init = OrderedDict()
    if args:
      if len(args) > 1:
        raise TypeError("TensorSpecStruct expects at most one positional arg")
      src = args[0]
      if isinstance(src, TensorSpecStruct):
        init.update(src.items())
      elif isinstance(src, Mapping):
        init.update(src)
      elif src is not None:
        init.update(OrderedDict(src))
    init.update(kwargs)
    for key, value in init.items():
      self[key] = value

  @classmethod
  def _view(cls, data: OrderedDict, prefix: str) -> "TensorSpecStruct":
    obj = cls.__new__(cls)
    object.__setattr__(obj, "_data", data)
    object.__setattr__(obj, "_prefix", prefix)
    return obj

  def _abs(self, key: str) -> str:
    if not isinstance(key, str):
      raise TypeError(f"TensorSpecStruct keys are strings, got {key!r}")
    return f"{self._prefix}{key}"

  def __getitem__(self, key: str) -> Any:
    abs_key = self._abs(key)
    if abs_key in self._data:
      return self._data[abs_key]
    sub_prefix = abs_key + "/"
    if any(k.startswith(sub_prefix) for k in self._data):
      return TensorSpecStruct._view(self._data, sub_prefix)
    raise KeyError(key)

  def __setitem__(self, key: str, value: Any) -> None:
    abs_key = self._abs(key)
    for part in key.split("/"):
      if not _VALID_KEY_RE.match(part):
        raise ValueError(
            f"Invalid key part {part!r} in {key!r}: keys must match "
            f"{_VALID_KEY_RE.pattern} (no empty segments).")
    if isinstance(value, (TensorSpecStruct, Mapping)):
      items = value.items()
      if not items and isinstance(value, Mapping):
        raise ValueError(f"Cannot assign an empty mapping to key {key!r}.")
      for sub_key, sub_value in list(items):
        self[f"{key}/{sub_key}"] = sub_value
      return
    if abs_key in self._data:
      self._data[abs_key] = value
      return
    sub_prefix = abs_key + "/"
    if any(k.startswith(sub_prefix) for k in self._data):
      raise ValueError(
          f"Key {key!r} already names a subtree; cannot overwrite it with a "
          "leaf value. Delete the subtree first.")
    self._data[abs_key] = value

  def __delitem__(self, key: str) -> None:
    abs_key = self._abs(key)
    if abs_key in self._data:
      del self._data[abs_key]
      return
    sub_prefix = abs_key + "/"
    doomed = [k for k in self._data if k.startswith(sub_prefix)]
    if not doomed:
      raise KeyError(key)
    for k in doomed:
      del self._data[k]

  def __iter__(self) -> Iterator[str]:
    plen = len(self._prefix)
    for k in list(self._data):
      if k.startswith(self._prefix):
        yield k[plen:]

  def __len__(self) -> int:
    return sum(1 for _ in self)

  def __contains__(self, key: object) -> bool:
    if not isinstance(key, str):
      return False
    abs_key = self._abs(key)
    if abs_key in self._data:
      return True
    sub_prefix = abs_key + "/"
    return any(k.startswith(sub_prefix) for k in self._data)

  def __getattr__(self, name: str) -> Any:
    if name.startswith("_"):
      raise AttributeError(name)
    try:
      return self[name]
    except KeyError:
      raise AttributeError(
          f"TensorSpecStruct has no key or subtree {name!r}; "
          f"available: {list(self)[:20]}") from None

  def __setattr__(self, name: str, value: Any) -> None:
    if name.startswith("_"):
      object.__setattr__(self, name, value)
    else:
      self[name] = value

  def __repr__(self) -> str:
    inner = ", ".join(f"{k}={v!r}" for k, v in self.items())
    return f"TensorSpecStruct({inner})"

  def __eq__(self, other: object) -> bool:
    if isinstance(other, (TensorSpecStruct, Mapping)):
      other_items = list(
          other.items() if isinstance(other, TensorSpecStruct)
          else flatten_spec_structure(other).items())
      return list(self.items()) == other_items
    return NotImplemented

  def __ne__(self, other: object) -> bool:
    result = self.__eq__(other)
    return result if result is NotImplemented else not result


SpecStructure = Union[TensorSpecStruct, Mapping, Any]


def flatten_spec_structure(spec_structure: SpecStructure) -> TensorSpecStruct:
  """Flattens nested mappings / namedtuples / dataclasses to a TensorSpecStruct.

  Leaves are anything that is not a mapping/namedtuple/dataclass (specs,
  arrays, tensors).
  """
  out = TensorSpecStruct()

  def _walk(prefix: str, node: Any) -> None:
    if isinstance(node, (TensorSpecStruct, Mapping)):
      items = node.items()
    elif hasattr(node, "_asdict"):  # namedtuple
      items = node._asdict().items()
    elif dataclasses.is_dataclass(node) and not isinstance(
        node, (ExtendedTensorSpec, type)):
      items = ((f.name, getattr(node, f.name)) for f in
               dataclasses.fields(node))
    else:
      if prefix == "":
        raise ValueError(
            "flatten_spec_structure expects a mapping-like structure at the "
            f"top level, got {type(node).__name__}.")
      out[prefix] = node
      return
    for key, value in items:
      sub = f"{prefix}/{key}" if prefix else str(key)
      _walk(sub, value)

  _walk("", spec_structure)
  return out


def assert_valid_spec_structure(spec_structure: SpecStructure) -> None:
  """Raises unless every leaf is an ExtendedTensorSpec with a valid key."""
  for key, spec in flatten_spec_structure(spec_structure).items():
    if not isinstance(spec, ExtendedTensorSpec):
      raise ValueError(
          f"Spec structure leaf {key!r} is {type(spec).__name__}, expected "
          "ExtendedTensorSpec.")


def _shapes_compatible(spec: ExtendedTensorSpec, value_shape: tuple[int, ...],
                       batched: bool) -> bool:
  expected = spec.shape
  if not batched:
    return tuple(value_shape) == expected
  return len(value_shape) == len(expected) + 1 and tuple(
      value_shape[1:]) == expected


def validate_and_flatten(
    spec_structure: SpecStructure,
    tensors: SpecStructure,
    batched: bool = True,
) -> TensorSpecStruct:
  """Flattens `tensors` and validates them against `spec_structure`.

  Args:
    spec_structure: nested structure of ExtendedTensorSpec.
    tensors: nested structure of numpy arrays with matching paths.
    batched: whether arrays carry a leading batch dimension.

  Returns:
    Flat TensorSpecStruct of validated arrays (required keys only plus any
    optional keys that were present).
  """
  flat_specs = flatten_spec_structure(spec_structure)
  flat_tensors = flatten_spec_structure(tensors)
  out = TensorSpecStruct()
  for key, spec in flat_specs.items():
    if not isinstance(spec, ExtendedTensorSpec):
      raise ValueError(f"Spec leaf {key!r} is not an ExtendedTensorSpec.")
    if key not in flat_tensors:
      if spec.is_optional:
        continue
      raise ValueError(
          f"Required spec {key!r} missing from tensors; available keys: "
          f"{list(flat_tensors)}")
    value = flat_tensors[key]
    value_shape = tuple(np.shape(value))
    value_dtype = (value.dtype if hasattr(value, "dtype")
                   else np.asarray(value).dtype)
    if is_encoded_image_spec(spec) and np.dtype(value_dtype).kind in "OSU":
      out[key] = value
      continue
    if not _shapes_compatible(spec, value_shape, batched):
      raise ValueError(
          f"Tensor {key!r} has shape {value_shape}, expected "
          f"{'batch + ' if batched else ''}{spec.shape}.")
    if np.dtype(value_dtype) != spec.dtype:
      raise ValueError(
          f"Tensor {key!r} has dtype {np.dtype(value_dtype).name}, expected "
          f"{spec.dtype.name}.")
    out[key] = value
  return out


# ---------------------------------------------------------------------------
# Record parsing schema
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FeatureSchema:
  """Parser schema for one feature inside a serialized tf.Example (the
  analogue of tf.FixedLenFeature / tf.VarLenFeature).

  Attributes:
    kind: 'fixed' | 'varlen' | 'image': image means a length-1 bytes
      feature holding an encoded jpeg/png that decodes to `shape`.
    shape: the per-example dense shape after parsing (and decode/pad).
    dtype: output dtype.
    default_value: pad value for varlen, or None.
    data_format: image encoding for kind='image'.
  """

  kind: str
  shape: tuple[int, ...]
  dtype: np.dtype
  default_value: Optional[float] = None
  data_format: Optional[str] = None


def tensorspec_to_feature_dict(
    spec_structure: SpecStructure, decode_images: bool = True
) -> "OrderedDict[str, FeatureSchema]":
  """Builds the per-key parsing schema for serialized tf.Example records.

  Keys in the returned dict are the *record* feature names: spec.name if
  set, else the flat path's last component.
  """
  flat = flatten_spec_structure(spec_structure)
  out: OrderedDict[str, FeatureSchema] = OrderedDict()
  for key, spec in flat.items():
    if not isinstance(spec, ExtendedTensorSpec):
      raise ValueError(f"Spec leaf {key!r} is not an ExtendedTensorSpec.")
    feature_name = spec.name or key.rsplit("/", 1)[-1]
    if is_encoded_image_spec(spec) and decode_images:
      schema = FeatureSchema(
          kind="image", shape=spec.shape, dtype=spec.dtype,
          data_format=spec.data_format)
    elif spec.is_sequence or spec.varlen_default_value is not None:
      default = spec.varlen_default_value
      schema = FeatureSchema(
          kind="varlen", shape=spec.shape, dtype=spec.dtype,
          default_value=0.0 if default is None else default)
    else:
      schema = FeatureSchema(kind="fixed", shape=spec.shape, dtype=spec.dtype)
    if feature_name in out:
      # Two spec paths may read one record feature (MAML's condition/ and
      # inference/ views of one episode), if they agree on the whole parse
      # rule (kind, shape, dtype, padding, encoding).
      if out[feature_name] != schema:
        raise ValueError(
            f"Feature name {feature_name!r} is produced by multiple specs "
            f"with conflicting parse schemas: {out[feature_name]!r} vs "
            f"{schema!r} (spec at {key!r}). Give the specs distinct names."
        )
      continue
    out[feature_name] = schema
  return out


def pad_or_clip_array(
    array: np.ndarray,
    target_length: int,
    axis: int = 0,
    pad_value: float = 0.0,
) -> np.ndarray:
  """Pads/clips `array` along `axis` to exactly `target_length` (host side,
  where the input pipeline's shapes may still be ragged)."""
  array = np.asarray(array)
  length = array.shape[axis]
  if length == target_length:
    return array
  if length > target_length:
    index = [slice(None)] * array.ndim
    index[axis] = slice(0, target_length)
    return array[tuple(index)]
  pad_widths = [(0, 0)] * array.ndim
  pad_widths[axis] = (0, target_length - length)
  return np.pad(array, pad_widths, mode="constant",
                constant_values=pad_value)


def make_random_array(
    spec: ExtendedTensorSpec,
    batch_size: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
  """Spec-conformant random numpy array (the mock-stack workhorse).

  Floats ~ U[0, 1); ints ~ U[0, 10); bools ~ Bernoulli(0.5): the JAX
  package's draws, in its order, from the same generator.
  """
  rng = rng or np.random.default_rng(0)
  shape = spec.shape if batch_size is None else (batch_size,) + spec.shape
  if np.issubdtype(spec.dtype, np.floating):
    return rng.random(shape, dtype=np.float64).astype(spec.dtype)
  if spec.dtype == np.dtype(bool):
    return rng.random(shape) < 0.5
  if np.issubdtype(spec.dtype, np.integer):
    high = min(10, np.iinfo(spec.dtype).max)
    return rng.integers(0, high, size=shape).astype(spec.dtype)
  raise ValueError(f"Cannot synthesize random data for dtype {spec.dtype}.")


def make_random_batch(
    spec_structure: SpecStructure,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    include_optional: bool = True,
) -> TensorSpecStruct:
  """Random batch conforming to a whole spec structure."""
  rng = rng or np.random.default_rng(0)
  out = TensorSpecStruct()
  for key, spec in flatten_spec_structure(spec_structure).items():
    if spec.is_optional and not include_optional:
      continue
    out[key] = make_random_array(spec, batch_size=batch_size, rng=rng)
  return out


def to_serialized(spec_structure: SpecStructure) -> str:
  """JSON-serialises a spec structure: the export's spec asset."""
  payload = OrderedDict(
      (key, spec.to_json_dict())
      for key, spec in flatten_spec_structure(spec_structure).items())
  return json.dumps({"version": 1, "specs": payload}, indent=2)


def from_serialized(serialized: str) -> TensorSpecStruct:
  """Inverse of `to_serialized`: reads an export's spec asset."""
  payload = json.loads(serialized)
  if payload.get("version") != 1:
    raise ValueError(f"Unknown spec serialization version: {payload!r}")
  out = TensorSpecStruct()
  for key, d in payload["specs"].items():
    out[key] = ExtendedTensorSpec.from_json_dict(d)
  return out
