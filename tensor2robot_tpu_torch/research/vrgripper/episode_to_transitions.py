"""Episode -> transition dataset conversion.

Counterpart of
``tensor2robot_tpu/research/vrgripper/episode_to_transitions.py``, the
same records from the same episodes: VR-teleop episodes (image,
proprioception and action sequences) flattened into per-timestep
tf.Examples for behavior cloning, written with the port's
``data/example_proto.py`` and ``data/tfrecord.py``.
"""

from __future__ import annotations

import io
from typing import Dict, Iterator, List

import numpy as np

from tensor2robot_tpu_torch.data import example_proto, tfrecord


def episode_to_examples(episode: Dict[str, np.ndarray]) -> Iterator[bytes]:
  """One episode dict -> serialized per-transition tf.Examples.

  Args:
    episode: {"images": (T, H, W, 3) uint8, "gripper_poses": (T, P),
      "actions": (T, A)}.

  Yields:
    Serialized examples with a jpeg `image`, float `gripper_pose` and
    float `action`.
  """
  from PIL import Image

  images = episode["images"]
  poses = episode["gripper_poses"]
  actions = episode["actions"]
  if not len(images) == len(poses) == len(actions):
    raise ValueError(
        f"Episode streams disagree on length: images={len(images)} "
        f"poses={len(poses)} actions={len(actions)}")
  for t in range(len(images)):
    buf = io.BytesIO()
    Image.fromarray(np.asarray(images[t], np.uint8)).save(
        buf, format="JPEG", quality=95)
    yield example_proto.encode_example({
        "image": [buf.getvalue()],
        "gripper_pose": np.asarray(poses[t], np.float32).tolist(),
        "action": np.asarray(actions[t], np.float32).tolist(),
    })


def write_episodes(path: str, episodes: List[Dict[str, np.ndarray]]) -> str:
  """Writes many episodes' transitions into one TFRecord file."""
  def records():
    for episode in episodes:
      yield from episode_to_examples(episode)

  tfrecord.write_tfrecords(path, records())
  return path
