"""Image encode and decode helpers, on the host.

Counterpart of ``tensor2robot_tpu/utils/image.py``: the same bytes out of
``encode_jpeg`` and ``encode_png`` for the same PIL build, and the same
quantisation (``to_uint8``). Decoding goes through the record parser's
``decode_image`` (PIL), so tools see the pixels training saw. PIL is
imported at first use.
"""

from __future__ import annotations

import io

import numpy as np


def decode_jpeg(data: bytes) -> np.ndarray:
  """JPEG bytes -> (H, W, C) uint8 (C=1 grayscale or 3 RGB)."""
  from tensor2robot_tpu_torch.data.parser import decode_image as _decode
  return _decode(data, data_format="jpeg")


def decode_image(data: bytes) -> np.ndarray:
  """Any PIL-readable format (PNG, JPEG, ...) -> (H, W, C) uint8."""
  from tensor2robot_tpu_torch.data.parser import decode_image as _decode
  return _decode(data)


def to_uint8(array: np.ndarray) -> np.ndarray:
  """Canonical image quantization: uint8 passthrough, integer clip,
  [0,1]-float scale+round, as the preprocessor's uint8 wire format."""
  array = np.asarray(array)
  if array.dtype == np.uint8:
    return array
  if np.issubdtype(array.dtype, np.integer):
    # Integer pixels are already on the 0-255 scale; just clip + cast.
    return np.clip(array, 0, 255).astype(np.uint8)
  # Float images in [0, 1] (the pipeline's post-decode convention).
  return np.clip(np.asarray(array, np.float32) * 255.0 + 0.5,
                 0, 255).astype(np.uint8)


def _encode(array: np.ndarray, **save_kwargs) -> bytes:
  from PIL import Image
  array = to_uint8(array)
  if array.ndim == 3 and array.shape[-1] == 1:
    array = array[..., 0]
  buf = io.BytesIO()
  Image.fromarray(array).save(buf, **save_kwargs)
  return buf.getvalue()


def encode_jpeg(array: np.ndarray, quality: int = 95) -> bytes:
  """(H, W, C) uint8 (or [0,1] float) -> JPEG bytes."""
  return _encode(array, format="JPEG", quality=quality)


def encode_png(array: np.ndarray) -> bytes:
  """(H, W, C) uint8 (or [0,1] float) -> PNG bytes."""
  return _encode(array, format="PNG")
