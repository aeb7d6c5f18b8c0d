"""Policy evaluation in the pose environment: rollout success rate.

Numpy copy of ``tensor2robot_tpu/research/pose_env/eval_policy.py``: drives
any predictor, or a plain callable, through the real observation ->
predict -> act loop and counts reaches within the success threshold.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np

from tensor2robot_tpu_torch.research.pose_env.pose_env import (
    IMAGE_SIZE,
    TARGET_COLOR,
    PoseEnv,
    pixel_to_pose,
)

# Anything with .predict(features) -> outputs, or the bare callable.
Policy = Union[Callable[[Mapping[str, np.ndarray]], Mapping[str, Any]], Any]


def evaluate_policy(
    policy: Policy,
    num_episodes: int = 50,
    seed: int = 0,
    image_size: int = IMAGE_SIZE,
    success_threshold: float = 0.1,
    output_key: str = "inference_output",
    extra_thresholds: Optional[Sequence[float]] = None,
) -> Dict[str, float]:
  """Rolls a policy in PoseEnv; returns success rate + mean reward.

  Args:
    policy: a predictor (its ``predict`` is used) or a callable mapping a
      batched feature dict ``{"image": float32 [1, S, S, 3] in [0, 1]}``
      to an output mapping with ``output_key`` -> [1, 2] pose.
    num_episodes: episodes to roll (each is one reach).
    seed: env seed (targets are placed deterministically given it).
    image_size: rendered camera size; must match the policy's spec.
    success_threshold: reach distance counted as success.
    output_key: key of the predicted pose in the policy's outputs.
    extra_thresholds: additional reach thresholds scored from the same
      rollouts.

  Returns:
    {"success_rate", "mean_reward", "num_episodes"} plus one
    ``success_rate_at_<t>`` per extra threshold.
  """
  predict = policy.predict if hasattr(policy, "predict") else policy
  env = PoseEnv(image_size=image_size, seed=seed,
                success_threshold=success_threshold)
  successes = 0
  rewards = []
  for _ in range(num_episodes):
    obs = env.reset()
    features = {"image": obs["image"].astype(np.float32)[None] / 255.0}
    outputs = predict(features)
    action = np.asarray(outputs[output_key], np.float32)[0]
    if action.shape != (2,):
      raise ValueError(
          f"Policy output {output_key!r} must be a [1, 2] pose; got "
          f"shape {np.asarray(outputs[output_key]).shape}.")
    step = env.step(action)
    successes += bool(step.info["success"])
    rewards.append(step.reward)
  result = {
      "success_rate": successes / num_episodes,
      "mean_reward": float(np.mean(rewards)),
      "num_episodes": float(num_episodes),
  }
  distances = -np.asarray(rewards)
  for t in extra_thresholds or ():
    result[f"success_rate_at_{float(t):g}"] = float(np.mean(distances < t))
  return result


def oracle_policy(features: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
  """Perfect vision-based policy: reaches for the centroid of the
  target-colored pixels. Validates the evaluation harness end to end."""
  image = np.asarray(features["image"])[0]  # [S, S, 3] in [0, 1]
  s = image.shape[0]
  target = np.asarray(TARGET_COLOR, np.float32) / 255.0
  dist = np.linalg.norm(image - target, axis=-1)
  mask = dist < 0.05
  if not mask.any():
    return {"inference_output": np.zeros((1, 2), np.float32)}
  yy, xx = np.nonzero(mask)
  x, y = pixel_to_pose((float(xx.mean()), float(yy.mean())), s)
  return {"inference_output": np.asarray([[x, y]], np.float32)}
