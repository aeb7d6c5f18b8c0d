"""Ambiguous two-object reaching tasks: a measurable MAML story.

Counterpart of ``tensor2robot_tpu/research/pose_env/meta_reaching.py``,
bit for bit on the same seeds. Every scene shows a red and a blue object;
a task's hidden rule is which colour to reach. Its labelled condition
scenes reveal the rule, and the adapted model must reach the right object
in fresh query scenes, which it cannot do unadapted (the meta-init can
only hedge between the two objects).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from tensor2robot_tpu_torch.meta_learning.meta_data import (
    meta_batch_from_arrays,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env import (
    ARM_COLOR,
    TABLE_COLOR,
    draw_disc,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

RED = (200, 40, 40)
BLUE = (40, 60, 200)
OBJECT_RADIUS = 0.22


def sample_two_object_scenes(
    num_scenes: int,
    image_size: int = 64,
    rng: np.random.Generator = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """(uint8 images, red positions [N, 2], blue positions [N, 2])."""
  rng = rng or np.random.default_rng(0)
  images = np.empty((num_scenes, image_size, image_size, 3), np.uint8)
  red = np.empty((num_scenes, 2), np.float32)
  blue = np.empty((num_scenes, 2), np.float32)
  for i in range(num_scenes):
    red[i] = rng.uniform(-0.7, 0.7, 2)
    while True:
      blue[i] = rng.uniform(-0.7, 0.7, 2)
      if np.linalg.norm(blue[i] - red[i]) > 2.2 * OBJECT_RADIUS:
        break
    image = np.empty((image_size, image_size, 3), np.uint8)
    image[:] = TABLE_COLOR
    draw_disc(image, (0.0, -0.95), 0.12, ARM_COLOR)  # arm base
    draw_disc(image, red[i], OBJECT_RADIUS, RED)
    draw_disc(image, blue[i], OBJECT_RADIUS, BLUE)
    images[i] = image
  return images, red, blue


def sample_meta_batch(
    num_tasks: int,
    num_condition_samples: int,
    num_inference_samples: int,
    image_size: int = 64,
    seed: int = 0,
    condition_label_noise: float = 0.0,
) -> Tuple[ts.TensorSpecStruct, Dict[str, np.ndarray]]:
  """MAML meta-features over two-object tasks, and the ground truth.

  Each task flips a coin for its target colour and labels its pool of
  scenes with that object's position. `condition_label_noise` > 0 jitters
  the condition labels only (noisy demonstrations; the query labels and
  the scoring truth stay exact).

  Returns:
    (meta features for MAMLModel, info): info holds "query_target" and
    "query_distractor" positions ([tasks, K_i, 2]) and "target_is_red"
    ([tasks] bool).
  """
  rng = np.random.default_rng(seed)
  pool = num_condition_samples + num_inference_samples
  images = np.empty(
      (num_tasks, pool, image_size, image_size, 3), np.float32)
  labels = np.empty((num_tasks, pool, 2), np.float32)
  distractor = np.empty((num_tasks, pool, 2), np.float32)
  target_is_red = rng.random(num_tasks) < 0.5
  for t in range(num_tasks):
    scene_images, red, blue = sample_two_object_scenes(
        pool, image_size=image_size, rng=rng)
    images[t] = scene_images.astype(np.float32) / 255.0
    labels[t] = red if target_is_red[t] else blue
    distractor[t] = blue if target_is_red[t] else red
  noisy_labels = labels
  if condition_label_noise > 0:
    noisy_labels = labels.copy()
    noisy_labels[:, :num_condition_samples] += rng.normal(
        0.0, condition_label_noise,
        (num_tasks, num_condition_samples, 2)).astype(np.float32)
  meta = meta_batch_from_arrays(
      ts.TensorSpecStruct({"image": images}),
      ts.TensorSpecStruct({"target_pose": noisy_labels}),
      num_condition_samples=num_condition_samples,
      num_inference_samples=num_inference_samples)
  info = {
      "query_target": labels[:, num_condition_samples:],
      "query_distractor": distractor[:, num_condition_samples:],
      "target_is_red": target_is_red,
  }
  return meta, info


def reach_success(
    predictions: np.ndarray,
    info: Dict[str, np.ndarray],
    radius: float = OBJECT_RADIUS,
) -> Dict[str, float]:
  """Scores query predictions ([tasks, K_i, 2]) against the task rule:
  {"success_rate", "wrong_object_rate", "mean_error"}, success being
  within `radius` of the task's object, wrong_object within `radius` of
  the other one."""
  predictions = np.asarray(predictions, np.float32)
  target_dist = np.linalg.norm(
      predictions - info["query_target"], axis=-1)
  distractor_dist = np.linalg.norm(
      predictions - info["query_distractor"], axis=-1)
  return {
      "success_rate": float(np.mean(target_dist < radius)),
      "wrong_object_rate": float(np.mean(distractor_dist < radius)),
      "mean_error": float(np.mean(target_dist)),
  }
