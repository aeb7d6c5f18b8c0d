"""tf.Example wire-format codec with zero TensorFlow/protobuf dependency.

Counterpart of ``tensor2robot_tpu/data/example_proto.py``: the same bytes
out of ``encode_example`` and the same values out of ``decode_example``.
``tf.Example`` is a tiny, frozen proto schema, so the wire format is
written out here by hand.

Schema (proto3, from tensorflow/core/example/{example,feature}.proto):

    message BytesList { repeated bytes value = 1; }
    message FloatList { repeated float value = 1 [packed]; }
    message Int64List { repeated int64 value = 1 [packed]; }
    message Feature { oneof kind {
        BytesList bytes_list = 1; FloatList float_list = 2;
        Int64List int64_list = 3; } }
    message Features { map<string, Feature> feature = 1; }
    message Example { Features features = 1; }

The decoder accepts both packed and unpacked repeated scalars and unknown
fields (skipped), as any conformant proto parser must.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union

FeatureValue = Union[List[bytes], List[float], List[int]]

_WIRETYPE_VARINT = 0
_WIRETYPE_64BIT = 1
_WIRETYPE_LEN = 2
_WIRETYPE_32BIT = 5


# ---------------------------------------------------------------------------
# Low-level wire helpers
# ---------------------------------------------------------------------------


def _write_varint(out: bytearray, value: int) -> None:
  if value < 0:
    value &= (1 << 64) - 1  # two's-complement 64-bit, proto int64 style
  while True:
    byte = value & 0x7F
    value >>= 7
    if value:
      out.append(byte | 0x80)
    else:
      out.append(byte)
      return


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
  result = 0
  shift = 0
  while True:
    if pos >= len(buf):
      raise ValueError("Truncated varint")
    byte = buf[pos]
    pos += 1
    result |= (byte & 0x7F) << shift
    if not byte & 0x80:
      return result, pos
    shift += 7
    if shift >= 70:
      raise ValueError("Varint too long")


def _signed64(value: int) -> int:
  if value >= 1 << 63:
    value -= 1 << 64
  return value


def _write_tag(out: bytearray, field: int, wiretype: int) -> None:
  _write_varint(out, (field << 3) | wiretype)


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
  _write_tag(out, field, _WIRETYPE_LEN)
  _write_varint(out, len(payload))
  out += payload


def _skip_field(buf: bytes, pos: int, wiretype: int) -> int:
  if wiretype == _WIRETYPE_VARINT:
    _, pos = _read_varint(buf, pos)
    return pos
  if wiretype == _WIRETYPE_64BIT:
    return pos + 8
  if wiretype == _WIRETYPE_LEN:
    size, pos = _read_varint(buf, pos)
    return pos + size
  if wiretype == _WIRETYPE_32BIT:
    return pos + 4
  raise ValueError(f"Unsupported wire type {wiretype}")


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes, int]]:
  """Yields (field_number, wiretype, buf, value_pos); caller decodes value."""
  pos = 0
  while pos < len(buf):
    tag, pos = _read_varint(buf, pos)
    yield tag >> 3, tag & 7, buf, pos
    pos = _skip_field(buf, pos, tag & 7)


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _encode_bytes_list(values: List[bytes]) -> bytes:
  out = bytearray()
  for v in values:
    if isinstance(v, str):
      v = v.encode("utf-8")
    _write_len_delimited(out, 1, bytes(v))
  return bytes(out)


def _encode_float_list(values: List[float]) -> bytes:
  out = bytearray()
  payload = struct.pack(f"<{len(values)}f", *values)
  _write_len_delimited(out, 1, payload)  # packed
  return bytes(out)


def _encode_int64_list(values: List[int]) -> bytes:
  packed = bytearray()
  for v in values:
    _write_varint(packed, int(v))
  out = bytearray()
  _write_len_delimited(out, 1, bytes(packed))  # packed
  return bytes(out)


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
  """Serializes a {name: list-of-bytes|float|int} dict as a tf.Example.

  The kind of each feature is inferred from its first element — numpy
  scalars included (np.float32 is not a Python float; missing it would
  silently truncate floats to int64). Empty lists encode as empty
  Int64Lists, matching TF's convention of an empty feature.
  """
  import numpy as _np

  features_payload = bytearray()
  for name, values in features.items():
    values = list(values)
    first = values[0] if values else None
    if isinstance(first, (bytes, str)):
      kind_field, kind_payload = 1, _encode_bytes_list(values)
    elif isinstance(first, (float, _np.floating)):
      kind_field, kind_payload = 2, _encode_float_list(
          [float(v) for v in values])
    elif first is None or isinstance(first, (int, _np.integer)):
      kind_field, kind_payload = 3, _encode_int64_list(
          [int(v) for v in values])
    else:
      raise TypeError(
          f"Feature {name!r}: cannot infer kind from {type(first).__name__};"
          " expected bytes/str, float, or int values.")
    feature_msg = bytearray()
    _write_len_delimited(feature_msg, kind_field, kind_payload)
    entry = bytearray()
    _write_len_delimited(entry, 1, name.encode("utf-8"))  # map key
    _write_len_delimited(entry, 2, bytes(feature_msg))  # map value
    _write_len_delimited(features_payload, 1, bytes(entry))
  example = bytearray()
  _write_len_delimited(example, 1, bytes(features_payload))
  return bytes(example)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def _decode_bytes_list(buf: bytes) -> List[bytes]:
  out: List[bytes] = []
  for field, wiretype, data, pos in _iter_fields(buf):
    if field == 1 and wiretype == _WIRETYPE_LEN:
      size, pos = _read_varint(data, pos)
      out.append(data[pos:pos + size])
  return out


def _decode_float_list(buf: bytes) -> List[float]:
  out: List[float] = []
  for field, wiretype, data, pos in _iter_fields(buf):
    if field != 1:
      continue
    if wiretype == _WIRETYPE_LEN:  # packed
      size, pos = _read_varint(data, pos)
      count = size // 4
      out.extend(struct.unpack_from(f"<{count}f", data, pos))
    elif wiretype == _WIRETYPE_32BIT:  # unpacked
      out.append(struct.unpack_from("<f", data, pos)[0])
  return out


def _decode_int64_list(buf: bytes) -> List[int]:
  out: List[int] = []
  for field, wiretype, data, pos in _iter_fields(buf):
    if field != 1:
      continue
    if wiretype == _WIRETYPE_LEN:  # packed
      size, pos = _read_varint(data, pos)
      end = pos + size
      while pos < end:
        value, pos = _read_varint(data, pos)
        out.append(_signed64(value))
    elif wiretype == _WIRETYPE_VARINT:  # unpacked
      value, _ = _read_varint(data, pos)
      out.append(_signed64(value))
  return out


def _decode_feature(buf: bytes) -> FeatureValue:
  for field, wiretype, data, pos in _iter_fields(buf):
    if wiretype != _WIRETYPE_LEN:
      continue
    size, pos = _read_varint(data, pos)
    payload = data[pos:pos + size]
    if field == 1:
      return _decode_bytes_list(payload)
    if field == 2:
      return _decode_float_list(payload)
    if field == 3:
      return _decode_int64_list(payload)
  return []


def decode_example(serialized: bytes) -> Dict[str, FeatureValue]:
  """Parses a serialized tf.Example into {name: list of bytes|float|int}."""
  features: Dict[str, FeatureValue] = {}
  for field, wiretype, data, pos in _iter_fields(serialized):
    if field != 1 or wiretype != _WIRETYPE_LEN:
      continue  # unknown field — skip
    size, pos = _read_varint(data, pos)
    features_buf = data[pos:pos + size]
    for f2, w2, d2, p2 in _iter_fields(features_buf):
      if f2 != 1 or w2 != _WIRETYPE_LEN:
        continue
      entry_size, p2 = _read_varint(d2, p2)
      entry = d2[p2:p2 + entry_size]
      name = None
      value: FeatureValue = []
      for f3, w3, d3, p3 in _iter_fields(entry):
        if w3 != _WIRETYPE_LEN:
          continue
        s3, p3 = _read_varint(d3, p3)
        payload = d3[p3:p3 + s3]
        if f3 == 1:
          name = payload.decode("utf-8")
        elif f3 == 2:
          value = _decode_feature(payload)
      if name is not None:
        features[name] = value
  return features
