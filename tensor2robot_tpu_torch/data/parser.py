"""Spec-driven parsing of serialized tf.Examples into dense numpy batches.

Counterpart of ``tensor2robot_tpu/data/parser.py``'s pure-Python path: the
same arrays from the same records, and the same errors. Parsing and
decoding happen on the host; by the time arrays reach the device they are
dense, statically shaped and numeric.

The JAX package can also parse a whole batch in its C++ library (proto
walk and libjpeg decode). The port has no such library: it decodes with
PIL, whose pixels equal libjpeg's for the records this repository writes
(``tests/test_torch_records.py``). ``set_native_enabled`` and
``calibrate_native`` are kept for the JAX package's callers and accept
only the Python choice.
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional

import numpy as np

from tensor2robot_tpu_torch.data import example_proto
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

_NO_NATIVE = "the port has no native parser; it parses in Python"


def decode_image(data: bytes, data_format: Optional[str] = None,
                 channels: Optional[int] = None) -> np.ndarray:
  """Decodes an encoded image to an HWC uint8 array, with PIL.

  `channels` (1 or 3) converts the colorspace as TF's
  decode_jpeg(channels=N) does; None keeps the image's own.
  """
  del data_format  # PIL reads the format from the bytes
  from PIL import Image  # host-side decode only; never on device

  with Image.open(io.BytesIO(data)) as img:
    if channels == 1 and img.mode != "L":
      img = img.convert("L")
    elif channels == 3 and img.mode != "RGB":
      img = img.convert("RGB")
    arr = np.asarray(img)
  if arr.ndim == 2:
    arr = arr[:, :, None]
  return arr


class ExampleParser:
  """Parses serialized tf.Example records per a spec structure.

  Built once per input pipeline from the model's (feature, label) specs;
  returns flat TensorSpecStructs mirroring the spec hierarchy.
  """

  def __init__(
      self,
      feature_spec: ts.SpecStructure,
      label_spec: Optional[ts.SpecStructure] = None,
  ):
    self._feature_spec = ts.flatten_spec_structure(feature_spec)
    self._label_spec = (
        ts.flatten_spec_structure(label_spec) if label_spec is not None
        else ts.TensorSpecStruct())
    # Record-level schema covering features and labels (they read different
    # keys of the same Example); building it also checks that no two specs
    # claim one record feature with conflicting parse rules.
    merged = ts.TensorSpecStruct()
    for key, spec in self._feature_spec.items():
      merged[f"features/{key}"] = spec
    for key, spec in self._label_spec.items():
      merged[f"labels/{key}"] = spec
    self.schema = ts.tensorspec_to_feature_dict(merged)
    # record feature name -> list of (dest struct name, flat key, spec)
    self._routes: Dict[str, List] = {}
    for key, spec in self._feature_spec.items():
      name = spec.name or key.rsplit("/", 1)[-1]
      self._routes.setdefault(name, []).append(("features", key, spec))
    for key, spec in self._label_spec.items():
      name = spec.name or key.rsplit("/", 1)[-1]
      self._routes.setdefault(name, []).append(("labels", key, spec))

  def set_native_enabled(self, enabled: Optional[bool]) -> None:
    """Accepts False or None (the Python parser); True raises."""
    if enabled:
      raise ValueError(f"set_native_enabled(True): {_NO_NATIVE}.")

  def calibrate_native(self, records: List[bytes], trials: int = 3) -> Dict:
    """Nothing to time: the stats dict records the Python decision."""
    del records, trials
    return {"trials": 0, "decision": "python", "reason": _NO_NATIVE}

  def parse_single(self, serialized: bytes):
    """Parses one record -> (features, labels) of unbatched numpy arrays."""
    raw = example_proto.decode_example(serialized)
    features = ts.TensorSpecStruct()
    labels = ts.TensorSpecStruct()
    for name, routes in self._routes.items():
      values = raw.get(name)
      for dest, key, spec in routes:
        out = features if dest == "features" else labels
        if values is None:
          if spec.is_optional:
            continue
          raise ValueError(
              f"Record is missing required feature {name!r} "
              f"(for spec {key!r}); present: {sorted(raw)}")
        out[key] = self._materialize(name, spec, values)
    return features, labels

  def _materialize(self, name: str, spec: ts.ExtendedTensorSpec,
                   values) -> np.ndarray:
    if ts.is_encoded_image_spec(spec):
      if not values or not isinstance(values[0], bytes):
        raise ValueError(f"Feature {name!r}: expected encoded image bytes")
      channels = (spec.shape[-1]
                  if len(spec.shape) == 3 and spec.shape[-1] in (1, 3)
                  else None)
      img = decode_image(values[0], spec.data_format, channels=channels)
      if img.shape != spec.shape:
        raise ValueError(
            f"Feature {name!r}: decoded image shape {img.shape} != spec "
            f"shape {spec.shape}")
      return img.astype(spec.dtype, copy=False)
    if values and isinstance(values[0], bytes):
      # Raw-bytes numeric feature: TF convention of tensors serialized as a
      # single bytes value via .tobytes().
      arr = np.frombuffer(values[0], dtype=spec.dtype)
      return arr.reshape(spec.shape)
    arr = np.asarray(values)
    if spec.is_sequence or spec.varlen_default_value is not None:
      # Varlen feature: flat value list -> (time, *inner) padded/clipped to
      # spec.shape along time.
      if not spec.shape:
        raise ValueError(
            f"Feature {name!r}: sequence specs need a (time, ...) shape")
      inner = spec.shape[1:]
      inner_size = int(np.prod(inner)) if inner else 1
      if arr.size % inner_size:
        raise ValueError(
            f"Feature {name!r}: {arr.size} values not divisible by inner "
            f"shape {inner}")
      arr = arr.reshape((-1,) + inner)
      pad = spec.varlen_default_value
      arr = ts.pad_or_clip_array(
          arr, spec.shape[0], axis=0,
          pad_value=0.0 if pad is None else pad)
      return arr.astype(spec.dtype, copy=False)
    expected = int(np.prod(spec.shape)) if spec.shape else 1
    if arr.size != expected:
      raise ValueError(
          f"Feature {name!r}: got {arr.size} values, spec {spec.shape} "
          f"needs {expected}")
    return arr.reshape(spec.shape).astype(spec.dtype, copy=False)

  def parse_batch(self, serialized_records: List[bytes]):
    """Parses and stacks records -> batched (features, labels)."""
    parsed = [self.parse_single(r) for r in serialized_records]
    features = _stack_structs([p[0] for p in parsed])
    labels = _stack_structs([p[1] for p in parsed])
    return features, labels


def _stack_structs(structs: List[ts.TensorSpecStruct]) -> ts.TensorSpecStruct:
  out = ts.TensorSpecStruct()
  if not structs:
    return out
  # Union of keys across records: optional features present in only part of
  # a batch cannot be stacked into a dense array, so fail with the remedy
  # rather than silently dropping (order-dependent) data.
  keys = list(structs[0])
  key_set = set(keys)
  for s in structs[1:]:
    for key in s:
      if key not in key_set:
        key_set.add(key)
        keys.append(key)
  for key in keys:
    missing = sum(1 for s in structs if key not in s)
    if missing:
      raise ValueError(
          f"Optional feature {key!r} is present in only "
          f"{len(structs) - missing}/{len(structs)} records of a batch; "
          "optional features must be consistently present or absent within "
          "a dataset (or parsed with batch_size=1).")
    out[key] = np.stack([s[key] for s in structs])
  return out
