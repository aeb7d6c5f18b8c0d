"""Image preprocessing: crops, photometric distortion, dtype conversion.

Numpy copy of ``tensor2robot_tpu/preprocessors/image_preprocessors.py``:
host-side, batched, and bit-identical to the JAX package's on the same
seeds, since both draw from the same ``np.random.Generator`` streams in
the same order. It runs in the input pipeline, so the device step stays
pure compute.
"""

from __future__ import annotations

import itertools
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch import modes
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts


def random_crop(
    images: np.ndarray,
    target_height: int,
    target_width: int,
    rng: np.random.Generator,
) -> np.ndarray:
  """Per-example random spatial crop of a BHWC batch."""
  b, h, w, _ = images.shape
  if target_height > h or target_width > w:
    raise ValueError(
        f"Crop {target_height}x{target_width} larger than image {h}x{w}")
  tops = rng.integers(0, h - target_height + 1, size=b)
  lefts = rng.integers(0, w - target_width + 1, size=b)
  out = np.empty((b, target_height, target_width, images.shape[3]),
                 dtype=images.dtype)
  for i in range(b):
    out[i] = images[i, tops[i]:tops[i] + target_height,
                    lefts[i]:lefts[i] + target_width]
  return out


def center_crop(images: np.ndarray, target_height: int,
                target_width: int) -> np.ndarray:
  """Deterministic center crop of a BHWC batch (eval counterpart)."""
  _, h, w, _ = images.shape
  if target_height > h or target_width > w:
    raise ValueError(
        f"Crop {target_height}x{target_width} larger than image {h}x{w}")
  top = (h - target_height) // 2
  left = (w - target_width) // 2
  return images[:, top:top + target_height, left:left + target_width]


def adjust_saturation(images: np.ndarray, factors: np.ndarray) -> np.ndarray:
  """Exact HSV saturation scaling on RGB, vectorized (no HSV round-trip).

  For fixed hue/value each channel is c_i = v·(1 − s·q_i), so scaling
  s→k·s is c_i' = v − k·(v − c_i), with k capped per-pixel where k·s would
  exceed 1.
  """
  v = images.max(axis=-1, keepdims=True)
  diff = v - images
  max_diff = diff.max(axis=-1, keepdims=True)
  with np.errstate(divide="ignore", invalid="ignore"):
    cap = np.where(max_diff > 0, v / max_diff, np.inf)
  k = np.minimum(factors, cap)
  return v - k * diff


def apply_photometric_distortions(
    images: np.ndarray,
    rng: np.random.Generator,
    max_brightness_delta: float = 0.125,
    contrast_range: Tuple[float, float] = (0.5, 1.5),
    saturation_range: Tuple[float, float] = (0.5, 1.5),
    noise_stddev: float = 0.0,
    copy: bool = True,
) -> np.ndarray:
  """Per-example saturation/brightness/contrast jitter on float images.

  Input must be float in [0, 1]; output is clipped back to [0, 1].
  `copy=False` mutates `images` in place (the input pipeline's hot path).
  """
  if not np.issubdtype(images.dtype, np.floating):
    raise ValueError(
        f"Photometric distortions expect float images in [0,1], got "
        f"{images.dtype}; convert first.")
  b = images.shape[0]
  out = images.astype(np.float32, copy=copy)
  # Saturation first (on the undistorted colors), as HSV math assumes
  # in-gamut RGB.
  if out.shape[-1] == 3:
    sat = rng.uniform(*saturation_range, size=(b, 1, 1, 1)).astype(np.float32)
    out = adjust_saturation(out, sat)
  deltas = rng.uniform(-max_brightness_delta, max_brightness_delta,
                       size=(b, 1, 1, 1)).astype(np.float32)
  out += deltas
  # Contrast: scale around the per-example, per-channel mean.
  factors = rng.uniform(*contrast_range, size=(b, 1, 1, 1)).astype(np.float32)
  means = out.mean(axis=(1, 2), keepdims=True)
  out -= means
  out *= factors
  out += means
  if noise_stddev > 0.0:
    out += rng.normal(0.0, noise_stddev, size=out.shape).astype(np.float32)
  return np.clip(out, 0.0, 1.0, out=out)


def to_uint8(array: np.ndarray) -> np.ndarray:
  """Image quantization: uint8 passes, integers clip, [0, 1] floats scale
  and round (the JAX package's ``utils.image.to_uint8``)."""
  array = np.asarray(array)
  if array.dtype == np.uint8:
    return array
  if np.issubdtype(array.dtype, np.integer):
    return np.clip(array, 0, 255).astype(np.uint8)
  return np.clip(np.asarray(array, np.float32) * 255.0 + 0.5,
                 0, 255).astype(np.uint8)


class ImagePreprocessor(AbstractPreprocessor):
  """Camera-image path: uint8 at the collection size in, model-size out.

  Train: random crop + photometric distortion. Eval/predict: center crop
  only. Non-image keys pass through unchanged; float outputs are in
  [0, 1].

  Args:
    feature_spec: model-facing (out) feature specs; the image key must be a
      float or uint8 spec with shape (H, W, C).
    label_spec: passthrough label specs.
    image_key: flat key of the image feature.
    in_image_shape: the pre-crop image shape; defaults to the out shape
      (no crop).
    data_format: the in-spec's encoding mark ('jpeg' as the record
      pipeline parses it; the arrays handed over are already decoded).
    distort: enable photometric distortion in train mode.
    seed: augmentation seed.
  """

  def __init__(
      self,
      feature_spec: ts.SpecStructure,
      label_spec: Optional[ts.SpecStructure] = None,
      image_key: str = "image",
      in_image_shape: Optional[Sequence[int]] = None,
      data_format: str = "jpeg",
      distort: bool = True,
      seed: int = 0,
  ):
    self._out_feature_spec = ts.flatten_spec_structure(feature_spec)
    if image_key not in self._out_feature_spec:
      raise ValueError(
          f"image_key {image_key!r} not in feature spec: "
          f"{list(self._out_feature_spec)}")
    self._image_key = image_key
    out_image = self._out_feature_spec[image_key]
    if not (np.issubdtype(out_image.dtype, np.floating)
            or out_image.dtype == np.uint8):
      raise ValueError(
          f"Out image spec must be float or uint8 (model-ready), got "
          f"{out_image.dtype}")
    in_shape = tuple(in_image_shape) if in_image_shape else out_image.shape
    self._in_feature_spec = ts.TensorSpecStruct(self._out_feature_spec)
    self._in_feature_spec[image_key] = ts.ExtendedTensorSpec(
        in_shape, np.uint8, name=out_image.name or image_key,
        data_format=data_format)
    self._label_spec = (
        ts.flatten_spec_structure(label_spec) if label_spec is not None
        else ts.TensorSpecStruct())
    self._distort = distort
    # np.random.Generator is not thread-safe, so each pipeline thread gets
    # its own stream, default_rng([seed, k]), with k handed out in the
    # order the threads first draw, as the JAX package does.
    self._seed = seed
    self._stream_counter = itertools.count()
    self._local = threading.local()

  @property
  def _rng(self) -> np.random.Generator:
    rng = getattr(self._local, "rng", None)
    if rng is None:
      rng = np.random.default_rng([self._seed, next(self._stream_counter)])
      self._local.rng = rng
    return rng

  def get_in_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    return self._in_feature_spec

  def get_in_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    return self._label_spec

  def get_out_feature_specification(self, mode: str) -> ts.TensorSpecStruct:
    return self._out_feature_spec

  def get_out_label_specification(self, mode: str) -> ts.TensorSpecStruct:
    return self._label_spec

  def _preprocess_fn(self, features, labels, mode):
    out = ts.TensorSpecStruct(features)
    images = np.asarray(features[self._image_key])
    out_spec = self._out_feature_spec[self._image_key]
    target_h, target_w = out_spec.shape[:2]
    uint8_out = out_spec.dtype == np.uint8
    # Crop on uint8 first: a float32 copy of the pre-crop batch would
    # waste host bandwidth.
    if mode == modes.TRAIN:
      if images.shape[1:3] != (target_h, target_w):
        images = random_crop(images, target_h, target_w, self._rng)
      if self._distort:
        images = apply_photometric_distortions(
            images.astype(np.float32) / 255.0, self._rng, copy=False)
      elif not uint8_out:
        images = images.astype(np.float32) / 255.0
    else:
      if images.shape[1:3] != (target_h, target_w):
        images = center_crop(images, target_h, target_w)
      if not uint8_out:
        images = images.astype(np.float32) / 255.0
    if uint8_out and images.dtype != np.uint8:
      images = to_uint8(images)
    out[self._image_key] = images.astype(out_spec.dtype, copy=False)
    return out, labels
