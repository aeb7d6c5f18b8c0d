#!/usr/bin/env python3
"""Where the closed QT-Opt loop's learner loses its time on one CUDA GPU.

    python3 scripts/profile_qtopt_loop.py [--steps N] [--intervals A,B]
        [--modes fleet,uniform,vector,alone]

Runs the production loop (``run_qtopt_replay``'s non-smoke config: the
64x64 uint8 GroupNorm critic, batch 32, CEM 64/6/3, 4 collector threads
of 8 envs) for ``--steps`` learner steps in each of these setups, all in
one process on one card, so they compare:

- ``fleet``: the collectors act through ``CEMFleetPolicy``'s bucket-8
  CUDA graph, as the loop runs; once for each interpreter switch
  interval in ``--intervals`` (``sys.setswitchinterval``, seconds;
  Python's default is 0.005);
- ``uniform``: the collectors act through a seeded uniform policy on the
  host (no device work, the same env stepping);
- ``vector``: one ``VectorActor`` steps the same 32 envs in lockstep
  through one bucket-32 CUDA graph (``vector_actors=True``);
- ``alone``: the collectors stop as soon as the ring passes ``min_fill``.

Prints one JSON line a run: learner steps/s from the end of the fill to
the end of the run, each learner stage's host and CUDA-event ms a step
(``learner_bench.StageClock``), env steps/s over the run, the policy's
graph replays, and the card (``nvidia-smi`` name and power limit). Run
from the repository root.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


class _UniformPolicy:
  """Seeded uniform actions on the host, with the fleet policy's surface
  the loop touches (``ladder``, ``warm``, ``compile_counts``)."""

  def __init__(self, action_size: int, seed: int):
    from tensor2robot_tpu_torch.replay import learner_bench
    from tensor2robot_tpu_torch.serving import BucketLadder
    self._act = learner_bench.uniform_policy(action_size, seed)
    self.ladder = BucketLadder()
    self.compile_counts = {}

  def warm(self, make_image, sizes=None) -> None:
    del make_image, sizes

  def __call__(self, images):
    return self._act(images)


def run_loop(gl, steps: int, mode: str, interval: float, seed: int,
             logdir: str) -> dict:
  import torch

  import chip_smoke
  from tensor2robot_tpu_torch.bin import run_qtopt_replay
  from tensor2robot_tpu_torch.replay import learner_bench
  from tensor2robot_tpu_torch.replay.loop import ReplayTrainLoop
  config = run_qtopt_replay.build_config(False, seed,
                                         vector_actors=mode == "vector")
  replay = ReplayTrainLoop(config, logdir)
  if mode == "uniform":
    replay._make_policy = lambda predictor: _UniformPolicy(
        config.action_size, seed + 7)
  marks = {}
  wait_for_min_fill = replay._wait_for_min_fill
  clock = learner_bench.StageClock(torch.device("cuda"))

  def timed_fill():
    wait_for_min_fill()
    if mode == "alone":
      for collector in replay._collectors:
        collector.request_stop()
      for collector in replay._collectors:
        collector.join(30.0)
    marks["learn_start"] = time.perf_counter()

  replay._wait_for_min_fill = timed_fill
  step = learner_bench.host_learner_step

  def clocked_step(*args, **kwargs):
    return step(*args, clock=clock, **kwargs)

  previous = sys.getswitchinterval()
  sys.setswitchinterval(interval)
  learner_bench.host_learner_step = clocked_step
  start = time.perf_counter()
  try:
    with chip_smoke.CountReplays(gl) as replays:
      result = replay.run(steps)
  finally:
    learner_bench.host_learner_step = step
    sys.setswitchinterval(previous)
  end = time.perf_counter()
  return {
      "mode": mode, "switch_interval_s": interval, "steps": steps,
      "learner_steps_per_s": steps / (end - marks["learn_start"]),
      "stages": clock.summary(),
      "env_steps_per_s": result["env_steps_collected"] / (end - start),
      "policy_graph_replays": replays.replays,
      "compile_counts": result["compile_counts"],
      "breach_count": result["health"]["breach_count"]}


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--steps", type=int, default=100)
  parser.add_argument("--intervals", default="0.005")
  parser.add_argument("--modes", default="fleet,uniform,vector,alone",
                      help="the setups to run, in order (fleet once per "
                           "interval)")
  parser.add_argument("--seed", type=int, default=0)
  args = parser.parse_args(argv)

  import torch
  if not torch.cuda.is_available():
    print("profile_qtopt_loop: CUDA is not available.", file=sys.stderr)
    return 2
  import importlib

  import chip_smoke
  gl = importlib.import_module("tensor2robot_tpu_torch.ops.graph_launches")
  card = chip_smoke.nvidia_smi()
  default = sys.getswitchinterval()
  runs = []
  for mode in args.modes.split(","):
    if mode == "fleet":
      runs += [("fleet", float(i)) for i in args.intervals.split(",")]
    else:
      runs.append((mode, default))
  with tempfile.TemporaryDirectory() as tmp:
    for i, (mode, interval) in enumerate(runs):
      print(json.dumps({"card": card, **run_loop(
          gl, args.steps, mode, interval, args.seed,
          os.path.join(tmp, str(i)))}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
