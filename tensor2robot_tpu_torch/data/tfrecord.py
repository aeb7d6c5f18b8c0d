"""TFRecord file framing (read and write) without TensorFlow.

Counterpart of ``tensor2robot_tpu/data/tfrecord.py``, writing and reading
the same bytes:

    each record:  uint64 length (LE)
                  uint32 masked-crc32c(length bytes) (LE)
                  byte   data[length]
                  uint32 masked-crc32c(data) (LE)

CRC32C is the Castagnoli polynomial (0x1EDC6F41, reflected 0x82F63B78), with
TF's mask: ``((crc >> 15) | (crc << 17)) + 0xa282ead8 (mod 2^32)``.

``crc32c`` and ``masked_crc32c`` run in the port's host library
(``csrc/crc32c.cc``, built with the host C++ compiler at first use). A
Python loop costs about 2 µs a byte, which at a few ms a jpeg record would
outweigh a training step, so the reader and the writer never fall back to
it: when the library does not build, they raise. ``crc32c_reference`` is
the plain Python version, the JAX package's loop; the tests hold the
library to it, and a caller may ask for it with ``python_crc=True``.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Callable, Iterable, Iterator, List

import numpy as np

_CRC_TABLE = None


def _crc_table() -> np.ndarray:
  global _CRC_TABLE
  if _CRC_TABLE is None:
    poly = np.uint32(0x82F63B78)
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
      table = np.where(table & 1, (table >> 1) ^ poly, table >> 1)
    _CRC_TABLE = table
  return _CRC_TABLE


def crc32c_reference(data: bytes) -> int:
  """CRC32C of `data`, one byte at a time in Python: the plain version."""
  table = _crc_table()
  crc = np.uint32(0xFFFFFFFF)
  for byte in np.frombuffer(data, dtype=np.uint8):
    crc = table[(crc ^ byte) & np.uint32(0xFF)] ^ (crc >> np.uint32(8))
  return int(crc ^ np.uint32(0xFFFFFFFF))


def _mask(crc: int) -> int:
  rotated = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
  return (rotated + 0xA282EAD8) & 0xFFFFFFFF


def masked_crc32c_reference(data: bytes) -> int:
  """TF's masked CRC of `data`, in Python."""
  return _mask(crc32c_reference(data))


def _library() -> ctypes.CDLL:
  from tensor2robot_tpu_torch.ops import _build
  library = _build.build_host("crc32c")
  for name in ("t2r_crc32c", "t2r_masked_crc32c"):
    function = getattr(library, name)
    function.restype = ctypes.c_uint32
    function.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
  return library


def crc32c(data: bytes) -> int:
  """CRC32C (Castagnoli) of `data`, in the host library."""
  data = bytes(data)
  return _library().t2r_crc32c(data, len(data))


def masked_crc32c(data: bytes) -> int:
  """TF's masked CRC (so CRCs of CRCs don't collide with data CRCs), in the
  host library."""
  data = bytes(data)
  return _library().t2r_masked_crc32c(data, len(data))


def _masked_crc_fn(python_crc: bool) -> Callable[[bytes], int]:
  if python_crc:
    return masked_crc32c_reference
  function = _library().t2r_masked_crc32c
  return lambda data: function(data, len(data))


class TFRecordWriter:
  """Writes TFRecord files (data collection, test fixtures, converters).

  Args:
    path: the file to write.
    python_crc: compute the CRCs in Python instead of the host library.
  """

  def __init__(self, path: str, python_crc: bool = False):
    self._crc = _masked_crc_fn(python_crc)
    self._file = open(path, "wb")

  def write(self, record: bytes) -> None:
    record = bytes(record)
    length_bytes = struct.pack("<Q", len(record))
    self._file.write(length_bytes)
    self._file.write(struct.pack("<I", self._crc(length_bytes)))
    self._file.write(record)
    self._file.write(struct.pack("<I", self._crc(record)))

  def flush(self) -> None:
    self._file.flush()

  def close(self) -> None:
    self._file.close()

  def __enter__(self) -> "TFRecordWriter":
    return self

  def __exit__(self, *exc) -> None:
    self.close()


def write_tfrecords(path: str, records: Iterable[bytes],
                    python_crc: bool = False) -> None:
  with TFRecordWriter(path, python_crc=python_crc) as writer:
    for record in records:
      writer.write(record)


def read_tfrecords(path: str, verify_crc: bool = True,
                   python_crc: bool = False) -> Iterator[bytes]:
  """Yields the records of one TFRecord file, streaming.

  CRC verification is on by default (corrupt robot-fleet data should fail
  loudly, not train silently), in the host library unless `python_crc`.
  """
  crc = _masked_crc_fn(python_crc) if verify_crc else None
  with open(path, "rb") as f:
    while True:
      header = f.read(12)
      if not header:
        return
      if len(header) < 12:
        raise ValueError(f"{path}: truncated record header")
      length, length_crc = struct.unpack("<QI", header)
      if crc is not None and crc(header[:8]) != length_crc:
        raise ValueError(f"{path}: corrupted record length (CRC mismatch)")
      data = f.read(length)
      if len(data) < length:
        raise ValueError(f"{path}: truncated record body")
      footer = f.read(4)
      if len(footer) < 4:
        raise ValueError(f"{path}: truncated record footer")
      (data_crc,) = struct.unpack("<I", footer)
      if crc is not None and crc(data) != data_crc:
        raise ValueError(f"{path}: corrupted record data (CRC mismatch)")
      yield data


def list_files(file_patterns: str | Iterable[str]) -> List[str]:
  """Expands comma-separated glob patterns to a sorted file list
  ('/data/train-*.tfrecord,/data/extra-*.tfrecord')."""
  import glob as globlib

  if isinstance(file_patterns, str):
    patterns = [p for p in file_patterns.split(",") if p]
  else:
    patterns = list(file_patterns)
  files: List[str] = []
  for pattern in patterns:
    matches = sorted(globlib.glob(os.path.expanduser(pattern)))
    if not matches and os.path.exists(pattern):
      matches = [pattern]
    files.extend(matches)
  if not files:
    raise FileNotFoundError(
        f"No files matched file_patterns={file_patterns!r}")
  return files
