"""Spec structure <-> ``T2RAssets`` protobuf, encoded by hand.

Counterpart of ``tensor2robot_tpu/proto/proto_utils.py``. The schema is
``proto/t2r.proto`` (a copy of the JAX package's). The JAX package builds
the messages with the protobuf runtime; the port writes the wire format
itself, as ``data/example_proto.py`` does for tf.Example, so it needs no
protobuf package. ``T2RAssets.serialize`` gives the bytes of protobuf's
``SerializeToString(deterministic=True)`` for the same message: fields in
number order, proto3 defaults left out, ``shape`` packed, the ``extra``
map sorted by key. ``T2RAssets.parse`` reads any conformant encoding
(packed or unpacked ``shape``, map entries in any order, unknown fields
skipped).

``varlen_default_value`` is a wrapped message in the schema, so "unset"
(None here) differs from 0.0 (present, its value field left out).
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Dict, List, Mapping, Optional, Tuple

from tensor2robot_tpu_torch.data.example_proto import (
    _WIRETYPE_64BIT,
    _WIRETYPE_LEN,
    _WIRETYPE_VARINT,
    _iter_fields,
    _read_varint,
    _signed64,
    _write_len_delimited,
    _write_tag,
    _write_varint,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts


def _write_string(out: bytearray, field: int, value: str) -> None:
  if value:
    _write_len_delimited(out, field, value.encode("utf-8"))


def _write_varint_field(out: bytearray, field: int, value: int) -> None:
  if value:
    _write_tag(out, field, _WIRETYPE_VARINT)
    _write_varint(out, int(value))


def _fields(buf: bytes):
  """Yields (field, wiretype, value): an int for a varint, 8 bytes for a
  64-bit field, the payload for a length-delimited one."""
  for field, wiretype, data, pos in _iter_fields(buf):
    if wiretype == _WIRETYPE_VARINT:
      yield field, wiretype, _read_varint(data, pos)[0]
    elif wiretype == _WIRETYPE_64BIT:
      yield field, wiretype, data[pos:pos + 8]
    elif wiretype == _WIRETYPE_LEN:
      size, pos = _read_varint(data, pos)
      yield field, wiretype, data[pos:pos + size]


@dataclasses.dataclass
class ExtendedTensorSpecProto:
  """``ExtendedTensorSpecProto``; ``varlen_default_value`` None is unset."""

  shape: List[int] = dataclasses.field(default_factory=list)
  dtype: str = ""
  name: str = ""
  is_optional: bool = False
  is_sequence: bool = False
  data_format: str = ""
  dataset_key: str = ""
  varlen_default_value: Optional[float] = None

  def serialize(self) -> bytes:
    out = bytearray()
    if self.shape:
      packed = bytearray()
      for dim in self.shape:
        _write_varint(packed, int(dim))
      _write_len_delimited(out, 1, bytes(packed))
    _write_string(out, 2, self.dtype)
    _write_string(out, 3, self.name)
    _write_varint_field(out, 4, self.is_optional)
    _write_varint_field(out, 5, self.is_sequence)
    _write_string(out, 6, self.data_format)
    _write_string(out, 7, self.dataset_key)
    if self.varlen_default_value is not None:
      wrapped = bytearray()
      bits = struct.pack("<d", float(self.varlen_default_value))
      if bits != bytes(8):  # +0.0 is the default; -0.0 is not
        _write_tag(wrapped, 1, _WIRETYPE_64BIT)
        wrapped += bits
      _write_len_delimited(out, 8, bytes(wrapped))
    return bytes(out)

  @classmethod
  def parse(cls, buf: bytes) -> "ExtendedTensorSpecProto":
    proto = cls()
    for field, wiretype, value in _fields(buf):
      if field == 1 and wiretype == _WIRETYPE_LEN:  # packed
        pos = 0
        while pos < len(value):
          dim, pos = _read_varint(value, pos)
          proto.shape.append(_signed64(dim))
      elif field == 1 and wiretype == _WIRETYPE_VARINT:  # unpacked
        proto.shape.append(_signed64(value))
      elif field in (2, 3, 6, 7) and wiretype == _WIRETYPE_LEN:
        setattr(proto, {2: "dtype", 3: "name", 6: "data_format",
                        7: "dataset_key"}[field], value.decode("utf-8"))
      elif field in (4, 5) and wiretype == _WIRETYPE_VARINT:
        setattr(proto, {4: "is_optional", 5: "is_sequence"}[field],
                bool(value))
      elif field == 8 and wiretype == _WIRETYPE_LEN:
        proto.varlen_default_value = 0.0
        for f2, w2, v2 in _fields(value):
          if f2 == 1 and w2 == _WIRETYPE_64BIT:
            proto.varlen_default_value = struct.unpack("<d", v2)[0]
    return proto


@dataclasses.dataclass
class TensorSpecStructProto:
  """``TensorSpecStructProto``: ordered (key, spec) entries."""

  entries: List[Tuple[str, ExtendedTensorSpecProto]] = dataclasses.field(
      default_factory=list)

  def serialize(self) -> bytes:
    out = bytearray()
    for key, spec in self.entries:
      entry = bytearray()
      _write_string(entry, 1, key)
      _write_len_delimited(entry, 2, spec.serialize())
      _write_len_delimited(out, 1, bytes(entry))
    return bytes(out)

  @classmethod
  def parse(cls, buf: bytes) -> "TensorSpecStructProto":
    proto = cls()
    for field, wiretype, value in _fields(buf):
      if field != 1 or wiretype != _WIRETYPE_LEN:
        continue
      key, spec = "", ExtendedTensorSpecProto()
      for f2, w2, v2 in _fields(value):
        if f2 == 1 and w2 == _WIRETYPE_LEN:
          key = v2.decode("utf-8")
        elif f2 == 2 and w2 == _WIRETYPE_LEN:
          spec = ExtendedTensorSpecProto.parse(v2)
      proto.entries.append((key, spec))
    return proto


@dataclasses.dataclass
class T2RAssets:
  """``T2RAssets``; a spec left None is an unset field."""

  feature_spec: Optional[TensorSpecStructProto] = None
  label_spec: Optional[TensorSpecStructProto] = None
  extra: Dict[str, str] = dataclasses.field(default_factory=dict)
  global_step: int = 0

  def serialize(self) -> bytes:
    """protobuf's deterministic serialization of this message."""
    out = bytearray()
    for field, spec in ((1, self.feature_spec), (2, self.label_spec)):
      if spec is not None:
        _write_len_delimited(out, field, spec.serialize())
    for key in sorted(self.extra):
      entry = bytearray()
      _write_string(entry, 1, key)
      _write_string(entry, 2, self.extra[key])
      _write_len_delimited(out, 3, bytes(entry))
    _write_varint_field(out, 4, self.global_step)
    return bytes(out)

  @classmethod
  def parse(cls, buf: bytes) -> "T2RAssets":
    assets = cls()
    for field, wiretype, value in _fields(buf):
      if field in (1, 2) and wiretype == _WIRETYPE_LEN:
        setattr(assets, "feature_spec" if field == 1 else "label_spec",
                TensorSpecStructProto.parse(value))
      elif field == 3 and wiretype == _WIRETYPE_LEN:
        key = item = ""
        for f2, w2, v2 in _fields(value):
          if f2 == 1 and w2 == _WIRETYPE_LEN:
            key = v2.decode("utf-8")
          elif f2 == 2 and w2 == _WIRETYPE_LEN:
            item = v2.decode("utf-8")
        assets.extra[key] = item
      elif field == 4 and wiretype == _WIRETYPE_VARINT:
        assets.global_step = _signed64(value)
    return assets


def spec_to_proto(spec: ts.ExtendedTensorSpec) -> ExtendedTensorSpecProto:
  """ExtendedTensorSpec -> ExtendedTensorSpecProto."""
  return ExtendedTensorSpecProto(
      shape=[int(d) for d in spec.shape],
      dtype=spec.dtype.name,
      name=spec.name or "",
      is_optional=spec.is_optional,
      is_sequence=spec.is_sequence,
      data_format=spec.data_format or "",
      dataset_key=spec.dataset_key,
      varlen_default_value=(None if spec.varlen_default_value is None
                            else float(spec.varlen_default_value)))


def proto_to_spec(proto: ExtendedTensorSpecProto) -> ts.ExtendedTensorSpec:
  """ExtendedTensorSpecProto -> ExtendedTensorSpec."""
  return ts.ExtendedTensorSpec(
      shape=tuple(proto.shape),
      dtype=proto.dtype,
      name=proto.name or None,
      is_optional=proto.is_optional,
      is_sequence=proto.is_sequence,
      data_format=proto.data_format or None,
      dataset_key=proto.dataset_key,
      varlen_default_value=proto.varlen_default_value)


def struct_to_proto(spec_structure: ts.SpecStructure
                    ) -> TensorSpecStructProto:
  """Any spec structure -> the flattened, order-preserving proto."""
  return TensorSpecStructProto([
      (key, spec_to_proto(spec)) for key, spec in
      ts.flatten_spec_structure(spec_structure).items()])


def proto_to_struct(proto: TensorSpecStructProto) -> ts.TensorSpecStruct:
  """Inverse of `struct_to_proto` (always the flattened view)."""
  return ts.TensorSpecStruct(
      (key, proto_to_spec(spec)) for key, spec in proto.entries)


def make_t2r_assets(
    feature_spec: ts.SpecStructure,
    label_spec: Optional[ts.SpecStructure] = None,
    extra: Optional[Mapping[str, Any]] = None,
    global_step: int = 0,
) -> T2RAssets:
  """The serving-metadata message written next to every export.

  `extra` values are JSON-encoded, so lists and dicts survive the
  string-map wire type. A spec structure with no entries is left unset,
  as protobuf leaves a submessage nothing was written into.
  """
  features = struct_to_proto(feature_spec)
  labels = struct_to_proto(label_spec) if label_spec is not None else None
  return T2RAssets(
      feature_spec=features if features.entries else None,
      label_spec=labels if labels is not None and labels.entries else None,
      extra={str(k): json.dumps(v) for k, v in (extra or {}).items()},
      global_step=int(global_step))


def parse_t2r_assets(
    assets: T2RAssets,
) -> Tuple[ts.TensorSpecStruct, Optional[ts.TensorSpecStruct], dict]:
  """T2RAssets -> (feature_spec, label_spec, extra dict)."""
  feature_spec = proto_to_struct(assets.feature_spec
                                 or TensorSpecStructProto())
  label_spec = (proto_to_struct(assets.label_spec)
                if assets.label_spec is not None else None)
  extra = {key: json.loads(value) for key, value in assets.extra.items()}
  return feature_spec, label_spec, extra
