"""Metric writing: metrics.jsonl and a TensorBoard event file, no TF.

Counterpart of ``tensor2robot_tpu/utils/metric_writer.py``: the same
``metrics.jsonl`` records (``step``, ``wall_time``, ``host``, ``pid`` and
the scalars) and an event file TensorBoard reads, with scalar and image
summaries. The JAX writer builds its events with tensorboard's protos;
this one encodes the few fields they need by hand, over the port's
``TFRecordWriter``, so no tensorboard install is needed:

    Event    { double wall_time = 1; int64 step = 2;
               string file_version = 3; Summary summary = 5; }
    Summary  { repeated Value value = 1; }
    Value    { string tag = 1; float simple_value = 2; Image image = 4; }
    Image    { int32 height = 1; int32 width = 2; int32 colorspace = 3;
               bytes encoded_image_string = 4; }

An image is PNG-encoded with ``utils/image.py`` (PIL).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch.data.example_proto import (
    _write_len_delimited,
    _write_tag,
    _write_varint,
)
from tensor2robot_tpu_torch.data.tfrecord import TFRecordWriter

_WIRETYPE_VARINT, _WIRETYPE_64BIT, _WIRETYPE_32BIT = 0, 1, 5


# (tag, height, width, colorspace, PNG bytes) of one image summary.
ImageValue = Tuple[str, int, int, int, bytes]


def _image_value(image: ImageValue) -> bytes:
  tag, height, width, colorspace, encoded = image
  proto = bytearray()
  for field, value in ((1, height), (2, width), (3, colorspace)):
    _write_tag(proto, field, _WIRETYPE_VARINT)
    _write_varint(proto, int(value))
  _write_len_delimited(proto, 4, encoded)
  entry = bytearray()
  _write_len_delimited(entry, 1, tag.encode("utf-8"))
  _write_len_delimited(entry, 4, bytes(proto))
  return bytes(entry)


def encode_event(wall_time: float, step: int = 0,
                 file_version: Optional[str] = None,
                 scalars: Optional[Mapping[str, float]] = None,
                 images: Sequence[ImageValue] = ()) -> bytes:
  """A serialized tensorboard ``Event`` with scalar and image summary
  values."""
  out = bytearray()
  _write_tag(out, 1, _WIRETYPE_64BIT)
  out += struct.pack("<d", wall_time)
  if step:
    _write_tag(out, 2, _WIRETYPE_VARINT)
    _write_varint(out, int(step))
  if file_version is not None:
    _write_len_delimited(out, 3, file_version.encode("utf-8"))
  if scalars or images:
    summary = bytearray()
    for tag, value in (scalars or {}).items():
      entry = bytearray()
      _write_len_delimited(entry, 1, tag.encode("utf-8"))
      _write_tag(entry, 2, _WIRETYPE_32BIT)
      entry += struct.pack("<f", float(value))
      _write_len_delimited(summary, 1, bytes(entry))
    for image in images:
      _write_len_delimited(summary, 1, _image_value(image))
    _write_len_delimited(out, 5, bytes(summary))
  return bytes(out)


class MetricWriter:
  """Writes scalar metrics to a TB event file and metrics.jsonl.

  Usable as a context manager; writing after ``close()`` raises. Every
  JSONL record carries ``host``/``pid``, so per-process streams can be
  merged.
  """

  def __init__(self, logdir: str):
    os.makedirs(logdir, exist_ok=True)
    self._logdir = logdir
    self._host = socket.gethostname()
    self._pid = os.getpid()
    self._closed = False
    self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
    fname = f"events.out.tfevents.{int(time.time())}.{self._host}"
    self._events = TFRecordWriter(os.path.join(logdir, fname))
    self._events.write(encode_event(time.time(),
                                    file_version="brain.Event:2"))

  def _check_open(self) -> None:
    if self._closed:
      raise RuntimeError(
          f"MetricWriter for {self._logdir!r} is closed; writes after "
          "close() indicate a lifecycle bug (a loop still logging "
          "after shutdown)")

  def __enter__(self) -> "MetricWriter":
    return self

  def __exit__(self, *exc_info) -> None:
    self.close()

  def write_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
    self._check_open()
    now = time.time()
    record: Dict[str, float] = {"step": int(step), "wall_time": now,
                                "host": self._host, "pid": self._pid}
    record.update({k: float(v) for k, v in scalars.items()})
    self._jsonl.write(json.dumps(record) + "\n")
    self._events.write(encode_event(now, step=int(step), scalars=scalars))
    # Writes are rate-limited by the log cadence; flushing here means a
    # crashed run keeps everything written so far.
    self.flush()

  def write_images(self, step: int, images: Mapping[str, "np.ndarray"]
                   ) -> None:
    """Writes (H, W[, C]) uint8 or [0, 1] float images (numpy arrays or
    tensors) as PNG image summaries in one event."""
    self._check_open()
    if not images:
      return
    from tensor2robot_tpu_torch.utils.image import encode_png
    values = []
    for tag, array in images.items():
      if hasattr(array, "detach"):  # a tensor, perhaps on the GPU
        array = array.detach().float().cpu().numpy()
      array = np.asarray(array)
      values.append((tag, array.shape[0], array.shape[1],
                     1 if array.ndim == 2 else array.shape[2],
                     encode_png(array)))
    self._events.write(encode_event(time.time(), step=int(step),
                                    images=values))
    self.flush()

  def flush(self) -> None:
    self._jsonl.flush()
    self._events.flush()

  def close(self) -> None:
    if self._closed:
      return  # idempotent: context-manager exit after an explicit close
    self.flush()
    self._closed = True
    self._jsonl.close()
    self._events.close()
