"""Random-policy pose_env data collection into a TFRecord file.

    python -m tensor2robot_tpu_torch.research.pose_env.collect_data \
        --output /tmp/pose_env/train.tfrecord --episodes 2000

Counterpart of ``tensor2robot_tpu/research/pose_env/collect_data.py``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
  from tensor2robot_tpu_torch.research.pose_env import pose_env

  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--output", required=True)
  parser.add_argument("--episodes", type=int, default=1000)
  parser.add_argument("--seed", type=int, default=0)
  args = parser.parse_args(argv)

  os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
  path = pose_env.write_tfrecords(
      args.output, num_episodes=args.episodes, seed=args.seed)
  print(f"Wrote {args.episodes} episodes to {path}")
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
