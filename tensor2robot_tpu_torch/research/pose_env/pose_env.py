"""PoseEnv: simulated planar reaching — predict target pose from camera.

Numpy copy of ``tensor2robot_tpu/research/pose_env/pose_env.py`` (the env
and its rasterizer): with the same seed it renders bit-identical images
and gives the same rewards. An RGB camera image of a table with a red
target disc, distractor objects (one near-red hard negative) and a
partial occluder bar; a 2D action in table coordinates; reward is the
negative distance to the target.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

IMAGE_SIZE = 64
TABLE_COLOR = (96, 72, 48)
TARGET_COLOR = (200, 40, 40)
ARM_COLOR = (60, 60, 180)
OCCLUDER_COLOR = (130, 130, 130)
# Distractor palette: distinct objects, one deliberately near-red so the
# net must discriminate hue, not just threshold the red channel.
DISTRACTOR_COLORS = (
    (40, 180, 60),    # green
    (210, 170, 40),   # yellow
    (150, 40, 200),   # purple
    (220, 110, 70),   # red-orange (the hard negative)
)


@dataclasses.dataclass
class PoseEnvStep:
  observation: Dict[str, np.ndarray]
  reward: float
  done: bool
  info: Dict


class PoseEnv:
  """Single-step reaching: observe image, act with a 2D pose."""

  def __init__(self, image_size: int = IMAGE_SIZE, seed: int = 0,
               success_threshold: float = 0.1,
               num_distractors: int = 4, occlusion: bool = True):
    """num_distractors / occlusion make the scene discriminative: a bare
    red disc on a table is separable by a color threshold. Distractors
    (one near-red) force hue discrimination and the occluder bar forces
    robustness to partially visible targets; both default ON."""
    self._image_size = image_size
    self._rng = np.random.default_rng(seed)
    self._success_threshold = success_threshold
    self._num_distractors = num_distractors
    self._occlusion = occlusion
    self._target: Optional[np.ndarray] = None
    self._distractors: list = []
    self._occluder: Optional[tuple] = None

  # --- gym-ish API ---------------------------------------------------------

  def reset(self) -> Dict[str, np.ndarray]:
    """New episode: target placed uniformly in [-1, 1]^2 table coords;
    scene clutter (distractors, occluder) resampled once per episode."""
    self._target = self._rng.uniform(-0.8, 0.8, size=2).astype(np.float32)
    self._distractors = []
    for i in range(self._num_distractors):
      # Keep distractor centers off the target so the task stays
      # unambiguous (the target is never fully hidden by an object).
      for _ in range(20):
        pos = self._rng.uniform(-0.9, 0.9, size=2).astype(np.float32)
        if np.linalg.norm(pos - self._target) >= 0.28:
          break
      self._distractors.append(
          (pos, float(self._rng.uniform(0.06, 0.12)),
           DISTRACTOR_COLORS[int(self._rng.integers(
               len(DISTRACTOR_COLORS)))]))
    self._occluder = None
    if self._occlusion:
      # A thin bar that only SOMETIMES crosses near the target (clipping
      # an edge of the disc, never hiding it) and otherwise sits at a
      # random scene position — an always-near-target bar would be a
      # deterministic positional beacon a policy could localize instead
      # of the red disc, defeating the clutter's purpose.
      angle = float(self._rng.uniform(0, np.pi))
      offset = float(self._rng.uniform(0.05, 0.09))
      if self._rng.random() < 0.5:
        anchor = self._target.copy()
      else:
        anchor = self._rng.uniform(-0.9, 0.9, size=2).astype(np.float32)
      self._occluder = (anchor, angle, offset)
    return self._observation()

  def step(self, action: np.ndarray) -> PoseEnvStep:
    """Act with a 2D pose; reward = −distance to target; episode ends."""
    if self._target is None:
      raise RuntimeError("Call reset() first.")
    action = np.asarray(action, np.float32)
    distance = float(np.linalg.norm(action - self._target))
    step = PoseEnvStep(
        observation=self._observation(),
        reward=-distance,
        done=True,
        info={"success": distance < self._success_threshold,
              "target_pose": self._target.copy()},
    )
    return step

  @property
  def target_pose(self) -> np.ndarray:
    if self._target is None:
      raise RuntimeError("Call reset() first.")
    return self._target

  # --- rendering -----------------------------------------------------------

  def _observation(self) -> Dict[str, np.ndarray]:
    return {"image": self.render(), "target_pose": self._target.copy()}

  def render(self) -> np.ndarray:
    """Rasterizes the table scene: uint8 (S, S, 3)."""
    if self._target is None:
      raise RuntimeError("Call reset() first.")
    s = self._image_size
    image = np.empty((s, s, 3), np.uint8)
    image[:] = TABLE_COLOR
    # Checker shading for texture so the conv net sees gradients.
    yy, xx = np.mgrid[0:s, 0:s]
    image[((yy // 8 + xx // 8) % 2).astype(bool)] = tuple(
        min(c + 12, 255) for c in TABLE_COLOR)
    # Arm base: fixed blue disc at the bottom center.
    self._draw_disc(image, (0.0, -0.95), radius=0.12, color=ARM_COLOR)
    # Distractor objects under the target in z-order.
    for pos, radius, color in self._distractors:
      self._draw_disc(image, tuple(pos), radius=radius, color=color)
    # Target: red disc at the target pose.
    self._draw_disc(image, tuple(self._target), radius=0.1,
                    color=TARGET_COLOR)
    if self._occluder is not None:
      center, angle, offset = self._occluder
      draw_bar(image, tuple(center), angle, offset, half_width=0.025,
               color=OCCLUDER_COLOR)
    return image

  def _draw_disc(self, image: np.ndarray, center_xy: Tuple[float, float],
                 radius: float, color) -> None:
    draw_disc(image, center_xy, radius, color)


def draw_disc(image: np.ndarray, center_xy, radius: float, color) -> None:
  """Rasterizes a filled disc at table coords [-1, 1]² into a (S, S, 3)
  uint8 image in place (shared by pose_env and the synthetic research
  scenes)."""
  s = image.shape[0]
  cx, cy = pose_to_pixel(center_xy, s)
  r = radius / 2.0 * (s - 1)
  yy, xx = np.mgrid[0:s, 0:s]
  mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r ** 2
  image[mask] = color


def draw_bar(image: np.ndarray, center_xy, angle: float, offset: float,
             half_width: float, color) -> None:
  """Rasterizes an infinite bar at distance `offset` from `center_xy`
  with direction `angle` (table-coord units) — the partial occluder:
  it clips the edge of a disc at center_xy without covering its
  center."""
  s = image.shape[0]
  cx, cy = pose_to_pixel(center_xy, s)
  # Signed distance from each pixel to the bar's center line. Pixel y
  # grows downward, so flip the normal's y component.
  nx, ny = np.cos(angle), -np.sin(angle)
  yy, xx = np.mgrid[0:s, 0:s]
  dist = (xx - cx) * nx + (yy - cy) * ny - offset / 2.0 * (s - 1)
  mask = np.abs(dist) <= half_width / 2.0 * (s - 1)
  image[mask] = color


def pose_to_pixel(pose_xy, image_size: int) -> Tuple[float, float]:
  """Table coords [-1, 1]² → pixel (x, y); the rasterization mapping."""
  px = (pose_xy[0] + 1.0) / 2.0 * (image_size - 1)
  py = (1.0 - (pose_xy[1] + 1.0) / 2.0) * (image_size - 1)
  return px, py


def pixel_to_pose(pixel_xy, image_size: int) -> Tuple[float, float]:
  """Pixel (x, y) → table coords; exact inverse of pose_to_pixel."""
  x = pixel_xy[0] / (image_size - 1) * 2.0 - 1.0
  y = 1.0 - pixel_xy[1] / (image_size - 1) * 2.0
  return x, y


# Reference alias.
PoseToyEnv = PoseEnv


def collect_episodes(
    num_episodes: int,
    seed: int = 0,
    image_size: int = IMAGE_SIZE,
    num_distractors: int = 4,
    occlusion: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
  """Random-policy data collection: (images, target_poses).

  uint8 (N, S, S, 3) images and float32 (N, 2) poses, bit-identical to the
  JAX package's ``collect_episodes`` on the same arguments. Clutter knobs
  default to the env defaults (the hard scene).
  """
  env = PoseEnv(image_size=image_size, seed=seed,
                num_distractors=num_distractors, occlusion=occlusion)
  images = np.empty((num_episodes, image_size, image_size, 3), np.uint8)
  poses = np.empty((num_episodes, 2), np.float32)
  for i in range(num_episodes):
    obs = env.reset()
    images[i] = obs["image"]
    poses[i] = obs["target_pose"]
  return images, poses


def write_tfrecords(path: str, num_episodes: int, seed: int = 0,
                    image_size: int = IMAGE_SIZE,
                    num_distractors: int = 4,
                    occlusion: bool = True) -> str:
  """Collects episodes and writes them as one TFRecord file of
  tf.Examples with a jpeg-encoded image and a float target pose: the JAX
  package's ``write_tfrecords`` file, byte for byte on the same PIL build.
  Clutter knobs pass through to `collect_episodes`."""
  from tensor2robot_tpu_torch.data import example_proto, tfrecord
  from tensor2robot_tpu_torch.utils.image import encode_jpeg

  images, poses = collect_episodes(num_episodes, seed=seed,
                                   image_size=image_size,
                                   num_distractors=num_distractors,
                                   occlusion=occlusion)

  def records():
    for image, pose in zip(images, poses):
      yield example_proto.encode_example({
          "image": [encode_jpeg(image)],
          "target_pose": pose.tolist(),
      })

  tfrecord.write_tfrecords(path, records())
  return path
