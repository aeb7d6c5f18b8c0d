"""Synthetic grasp2vec triplets: a measurable embedding-arithmetic task.

Numpy copy of ``tensor2robot_tpu/research/grasp2vec/synthetic_scenes.py``,
bit-identical on the same seeds. Grasp2vec trains phi(scene_pre) -
phi(scene_post) ~= phi(outcome) on grasping triplets; this module renders
them with pose_env's rasterizer:

  - pre   = table with the grasped object AND a distractor object
  - post  = the same table with only the distractor
  - goal  = the grasped object alone, centered ("outcome" camera)

Objects differ by color and position, so the n-pairs retrieval objective
is solvable only by an embedding of object identity that ignores
position: within-batch retrieval accuracy must climb from chance
(1/batch) toward 1.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from tensor2robot_tpu_torch.research.pose_env.pose_env import (
    TABLE_COLOR,
    draw_disc,
)

OBJECT_RADIUS = 0.28


def _table(image_size: int) -> np.ndarray:
  image = np.empty((image_size, image_size, 3), np.uint8)
  image[:] = TABLE_COLOR
  return image


def _random_color(rng: np.random.Generator) -> Tuple[int, int, int]:
  """Saturated random color, away from the table's brown."""
  channels = rng.permutation(3)
  color = np.zeros(3, np.int64)
  color[channels[0]] = rng.integers(180, 256)
  color[channels[1]] = rng.integers(0, 100)
  color[channels[2]] = rng.integers(0, 180)
  return tuple(int(c) for c in color)


def sample_triplets(num_triplets: int, image_size: int = 64,
                    seed: int = 0) -> Dict[str, np.ndarray]:
  """Renders (pre_image, post_image, goal_image) triplets, uint8.

  Positions are sampled at least one object diameter apart, so the two
  objects never merge into one blob.
  """
  rng = np.random.default_rng(seed)
  shape = (num_triplets, image_size, image_size, 3)
  pre = np.empty(shape, np.uint8)
  post = np.empty(shape, np.uint8)
  goal = np.empty(shape, np.uint8)
  for i in range(num_triplets):
    grasped_color = _random_color(rng)
    distractor_color = _random_color(rng)
    grasped_pos = rng.uniform(-0.6, 0.6, 2)
    while True:
      distractor_pos = rng.uniform(-0.6, 0.6, 2)
      if np.linalg.norm(distractor_pos - grasped_pos) > 2 * OBJECT_RADIUS:
        break
    scene = _table(image_size)
    draw_disc(scene, distractor_pos, OBJECT_RADIUS, distractor_color)
    post[i] = scene
    pre[i] = scene.copy()
    draw_disc(pre[i], grasped_pos, OBJECT_RADIUS, grasped_color)
    goal[i] = _table(image_size)
    draw_disc(goal[i], (0.0, 0.0), OBJECT_RADIUS, grasped_color)
  return {"pre_image": pre, "post_image": post, "goal_image": goal}


def as_model_batch(triplets: Dict[str, np.ndarray],
                   indices: np.ndarray) -> Dict[str, np.ndarray]:
  """uint8 triplets -> the model's float32 [0, 1] feature batch."""
  return {key: value[indices].astype(np.float32) / 255.0
          for key, value in triplets.items()}
