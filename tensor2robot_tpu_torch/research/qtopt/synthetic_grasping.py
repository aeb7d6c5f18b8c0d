"""Synthetic grasping task: a measurable grasp-success story for QT-Opt.

Numpy copy of ``tensor2robot_tpu/research/qtopt/synthetic_grasping.py``,
bit-identical to it on the same seeds (the JAX module's package imports
JAX, so the port keeps its own). A self-contained planar grasping task:

  - a scene image shows a graspable object (pose_env's renderer);
  - an action is a 4-vector; a grasp succeeds iff its (x, y) lands within
    `grasp_radius` of the object (the other dims are free, like the
    reference's gripper and height commands the Q-function must learn to
    ignore);
  - training data is off-policy: logged random grasps with their observed
    success labels, `positive_fraction` of them drawn near the object.

The capability claim: train the Q-function on logged grasps through the
record pipeline, serve it through the CEM policy, and closed-loop grasp
success must clearly beat random grasping
(``bin/run_capability_checks.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch.research.pose_env import pose_env

GRASP_RADIUS = 0.25
ACTION_SIZE = 4


def sample_scenes(
    num_scenes: int,
    image_size: int = 64,
    seed: int = 0,
    num_distractors: int = 4,
    occlusion: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
  """(uint8 images [N, S, S, 3], object positions [N, 2] in [-0.8, 0.8]).

  Clutter knobs default to the hard scene (capability checks); the
  miniature CI test disables them to verify machinery on a budget."""
  return pose_env.collect_episodes(num_scenes, seed=seed,
                                   image_size=image_size,
                                   num_distractors=num_distractors,
                                   occlusion=occlusion)


def grasp_success(
    targets: np.ndarray,
    actions: np.ndarray,
    radius: float = GRASP_RADIUS,
) -> np.ndarray:
  """Success = commanded (x, y) within `radius` of the object."""
  targets = np.asarray(targets, np.float32)
  actions = np.asarray(actions, np.float32)
  dist = np.linalg.norm(actions[..., :2] - targets, axis=-1)
  return dist < radius


def generate_grasps(
    num_examples: int,
    image_size: int = 64,
    seed: int = 0,
    action_size: int = ACTION_SIZE,
    positive_fraction: float = 0.5,
    radius: float = GRASP_RADIUS,
    num_distractors: int = 4,
    occlusion: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Logged random-grasp dataset: (images, actions, success labels).

  `positive_fraction` of the actions are drawn near the object
  (std 0.12 gaussian) so the success classes are roughly balanced; the
  rest are uniform in [-1, 1]^A. Labels are the observed outcomes.
  """
  images, targets = sample_scenes(num_examples, image_size, seed,
                                  num_distractors=num_distractors,
                                  occlusion=occlusion)
  rng = np.random.default_rng(seed + 1)
  actions = rng.uniform(-1.0, 1.0,
                        (num_examples, action_size)).astype(np.float32)
  near = rng.random(num_examples) < positive_fraction
  noise = rng.normal(0.0, 0.12, (num_examples, 2)).astype(np.float32)
  actions[near, :2] = np.clip(targets[near] + noise[near], -1.0, 1.0)
  labels = grasp_success(targets, actions, radius).astype(np.float32)
  return images, actions, labels


def write_tfrecords(
    path: str,
    num_examples: int,
    image_size: int = 64,
    seed: int = 0,
    action_size: int = ACTION_SIZE,
    positive_fraction: float = 0.5,
    radius: float = GRASP_RADIUS,
    num_distractors: int = 4,
    occlusion: bool = True,
) -> str:
  """Logged grasps → reference-format tf.Examples (jpeg image, float
  action, float `target_q` success label — QTOptGraspingModel's specs)."""
  from tensor2robot_tpu_torch.data import example_proto, tfrecord
  from tensor2robot_tpu_torch.utils.image import encode_jpeg

  images, actions, labels = generate_grasps(
      num_examples, image_size=image_size, seed=seed,
      action_size=action_size, positive_fraction=positive_fraction,
      radius=radius, num_distractors=num_distractors,
      occlusion=occlusion)

  def records():
    for image, action, label in zip(images, actions, labels):
      yield example_proto.encode_example({
          "image": [encode_jpeg(image)],
          "action": action.tolist(),
          "target_q": [float(label)],
      })

  tfrecord.write_tfrecords(path, records())
  return path


class GraspRetryEnv:
  """Multi-attempt grasping episode over one fixed scene.

  The replay/Bellman loop needs episodes where bootstrapping MATTERS —
  the logged-grasp dataset above is single-step (target == reward), so
  a Bellman updater degenerates to supervised labels on it. This env
  wraps the same scene/success machinery as a retry process: the robot
  keeps the scene, attempts a grasp per step, and the episode ends on
  success or after `max_attempts`. The state is static (the scene
  image), so the optimal Q is the fixed point

      Q*(s, a) = success(a) + gamma * (1 - success(a)) * max_a' Q*(s, a')

  — failed grasps bootstrap through the NEXT attempt's value, which is
  exactly the propagation path the updater must compute via CEM.
  Truncation at max_attempts is reported separately from success so the
  ingest layer can bootstrap through it (done=0) rather than treating
  "ran out of budget" as "the scene has no value".
  """

  def __init__(self, image_size: int = 64, max_attempts: int = 4,
               radius: float = GRASP_RADIUS, num_distractors: int = 0,
               occlusion: bool = False):
    self._image_size = image_size
    self._max_attempts = max_attempts
    self._radius = radius
    self._num_distractors = num_distractors
    self._occlusion = occlusion
    self._image: Optional[np.ndarray] = None
    self._target: Optional[np.ndarray] = None
    self._attempts = 0

  def reset(self, seed: int) -> np.ndarray:
    """New scene; returns its uint8 (S, S, 3) image."""
    images, targets = sample_scenes(
        1, image_size=self._image_size, seed=seed,
        num_distractors=self._num_distractors,
        occlusion=self._occlusion)
    self._image, self._target = images[0], targets[0]
    self._attempts = 0
    return self._image

  @property
  def image(self) -> np.ndarray:
    assert self._image is not None, "call reset() first"
    return self._image

  @property
  def target(self) -> np.ndarray:
    assert self._target is not None, "call reset() first"
    return self._target

  def step(self, action: np.ndarray):
    """One grasp attempt.

    Returns:
      (reward, done, truncated): reward 1.0 on success; done mirrors
      success (the scene is solved); truncated flags the attempt-budget
      exhaustion on a FAILED last attempt (bootstrap through it).
    """
    assert self._image is not None, "call reset() first"
    self._attempts += 1
    success = bool(grasp_success(self._target, np.asarray(action),
                                 self._radius))
    truncated = (not success) and self._attempts >= self._max_attempts
    return float(success), success, truncated


class VectorGraspEnv:
  """N GraspRetryEnvs stepped in lockstep as ONE vectorized call.

  This env holds all N scenes as stacked arrays and computes the whole
  fleet's grasp outcomes (`grasp_success`, attempt bookkeeping,
  truncation) in one numpy call per control step, where scalar
  collectors step one `GraspRetryEnv` transition at a time.

  Semantics contract: with the
  same per-env seed stream, every observable — scene images, targets,
  rewards, dones, truncations, episode/success counts, auto-reset
  boundaries — is BIT-IDENTICAL to N scalar `GraspRetryEnv`s driven in
  env order. Scene generation goes through the same
  `sample_scenes(1, seed)` call per reset, so images match byte for
  byte, not just statistically.

  Auto-reset: `step(actions, seed_fn=...)` resets every terminal env in
  env index order, drawing one seed per reset from `seed_fn` — the same
  order the scalar collector loop resets its fleet, so a shared
  monotonic scene counter produces the same scene assignment. The
  returned reward/done/truncated arrays always describe the PRE-reset
  attempt; callers snapshot `images` before stepping to build
  transitions (the scene is static within an episode, so a terminal
  transition's next_image is the OLD scene — bootstrap never leaks
  across the reset).
  """

  def __init__(self, num_envs: int, image_size: int = 64,
               max_attempts: int = 4, radius: float = GRASP_RADIUS,
               num_distractors: int = 0, occlusion: bool = False):
    if num_envs < 1:
      raise ValueError(f"num_envs must be >= 1, got {num_envs}")
    self.num_envs = num_envs
    self._image_size = image_size
    self._max_attempts = max_attempts
    self._radius = radius
    self._num_distractors = num_distractors
    self._occlusion = occlusion
    self._images: Optional[np.ndarray] = None
    self._targets: Optional[np.ndarray] = None
    self._attempts = np.zeros((num_envs,), np.int64)
    self.episodes = 0
    self.successes = 0

  def reset(self, seeds: Sequence[int]) -> np.ndarray:
    """Resets every env (env order); returns uint8 (N, S, S, 3) images."""
    seeds = list(seeds)
    if len(seeds) != self.num_envs:
      raise ValueError(
          f"need {self.num_envs} seeds, got {len(seeds)}")
    self._images = np.empty(
        (self.num_envs, self._image_size, self._image_size, 3), np.uint8)
    self._targets = np.empty((self.num_envs, 2), np.float32)
    for i, seed in enumerate(seeds):
      self.reset_env(i, seed)
    return self._images

  def reset_env(self, i: int, seed: int) -> None:
    """New scene for env `i` — the same sample_scenes(1, seed) call a
    scalar GraspRetryEnv.reset(seed) makes, so scenes are bit-identical
    given the same seed (the equivalence property the actor tests pin)."""
    assert self._images is not None, "call reset() first"
    images, targets = sample_scenes(
        1, image_size=self._image_size, seed=seed,
        num_distractors=self._num_distractors,
        occlusion=self._occlusion)
    self._images[i] = images[0]
    self._targets[i] = targets[0]
    self._attempts[i] = 0

  @property
  def images(self) -> np.ndarray:
    assert self._images is not None, "call reset() first"
    return self._images

  @property
  def targets(self) -> np.ndarray:
    assert self._targets is not None, "call reset() first"
    return self._targets

  @classmethod
  def from_scenes(cls, images: np.ndarray, targets: np.ndarray,
                  max_attempts: int = 4,
                  radius: float = GRASP_RADIUS) -> "VectorGraspEnv":
    """Env over PRE-SAMPLED scenes (no re-rendering).

    The vectorized `evaluate_grasp_policy` path needs the EXACT scene
    set `sample_scenes(num_scenes, seed)` produces (one sequential-RNG
    call) so vectorized and scalar evaluation see the same scenes for
    the same seed — per-env seeding would generate different scenes.
    """
    images = np.asarray(images, np.uint8)
    targets = np.asarray(targets, np.float32)
    env = cls(num_envs=images.shape[0], image_size=images.shape[1],
              max_attempts=max_attempts, radius=radius)
    env._images = images.copy()
    env._targets = targets.copy()
    return env

  def step(self, actions: np.ndarray,
           seed_fn: Optional[Callable[[], int]] = None
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One grasp attempt across the whole fleet (one vectorized call).

    Args:
      actions: (N, A) commanded grasps.
      seed_fn: when given, every terminal env auto-resets (env index
        order, one seed drawn per reset) and the episode/success
        counters advance — the scalar collector loop's bookkeeping.

    Returns:
      (rewards, dones, truncated): float32 (N,) rewards/dones (done
      mirrors success — only success terminates value; truncation
      bootstraps) and bool (N,) truncation flags, all describing the
      PRE-reset attempt.
    """
    assert self._images is not None, "call reset() first"
    actions = np.asarray(actions)
    if actions.shape[0] != self.num_envs:
      raise ValueError(
          f"need {self.num_envs} actions, got {actions.shape[0]}")
    success = grasp_success(self._targets, actions, self._radius)
    self._attempts += 1
    truncated = (~success) & (self._attempts >= self._max_attempts)
    rewards = success.astype(np.float32)
    if seed_fn is not None:
      terminal = success | truncated
      if terminal.any():
        self.episodes += int(terminal.sum())
        self.successes += int(success.sum())
        for i in np.nonzero(terminal)[0]:
          self.reset_env(int(i), seed_fn())
    return rewards, rewards.copy(), truncated.copy()


def evaluate_grasp_policy(
    policy: Callable[[np.ndarray], np.ndarray],
    num_scenes: int = 100,
    image_size: int = 64,
    seed: int = 1000,
    radius: float = GRASP_RADIUS,
    image_transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    num_distractors: int = 4,
    occlusion: bool = True,
    vectorized: bool = False,
) -> Dict[str, float]:
  """Closed-loop grasp evaluation: scene → policy(image) → success.

  Args:
    policy: image → action (e.g. research.qtopt.cem.CEMPolicy over an
      exported Q-function). With ``vectorized=True`` the policy instead
      maps the STACKED (N, S, S, 3) batch to (N, A) actions (e.g.
      serving.CEMFleetPolicy) and the scoring runs as one
      ``VectorGraspEnv`` step — no per-scene Python loop.
    image_transform: converts the rendered uint8 image to the policy's
      wire format. Default: float32 in [0, 1] (the float-image models'
      serving contract); pass identity for uint8_images models. Applied
      to the whole stack at once on the vectorized path (numpy
      elementwise transforms behave identically either way).
    vectorized: batch the whole evaluation through ``VectorGraspEnv``.
      Scenes come from the SAME ``sample_scenes(num_scenes, seed)``
      call on both paths, so for a per-image-deterministic policy the
      same seed yields the same success rate.

  Returns {"success_rate", "mean_distance", "num_scenes"}.
  """
  if image_transform is None:
    image_transform = lambda im: im.astype(np.float32) / 255.0
  images, targets = sample_scenes(num_scenes, image_size, seed,
                                  num_distractors=num_distractors,
                                  occlusion=occlusion)
  if vectorized:
    env = VectorGraspEnv.from_scenes(images, targets, max_attempts=1,
                                     radius=radius)
    actions = np.asarray(policy(image_transform(images)), np.float32)
    rewards, _, _ = env.step(actions)
    # float32 per-scene norms, float64 reduction: bit-identical to the
    # scalar loop's float(np.linalg.norm(...)) accumulation, so the two
    # paths return THE SAME numbers for the same seed, not just close.
    distances = np.linalg.norm(actions[:, :2] - targets,
                               axis=-1).astype(np.float64)
    return {
        "success_rate": float(rewards.sum()) / num_scenes,
        "mean_distance": float(np.mean(distances)),
        "num_scenes": float(num_scenes),
    }
  successes = 0
  distances = []
  for image, target in zip(images, targets):
    action = np.asarray(policy(image_transform(image)), np.float32)
    successes += bool(grasp_success(target, action, radius))
    distances.append(float(np.linalg.norm(action[:2] - target)))
  return {
      "success_rate": successes / num_scenes,
      "mean_distance": float(np.mean(distances)),
      "num_scenes": float(num_scenes),
  }
