"""Actor throughput: threaded scalar collectors against the vector fleet.

Counterpart of ``tensor2robot_tpu/replay/actor_bench.py``'s first two
phases. At the same policy (one shared hot-reload predictor, the same CEM
settings) and the same total env count, it times the threaded collectors
(``scalar_collectors`` threads, each stepping its share of scalar
``GraspRetryEnv``s through its own small bucket) against one
``VectorActor`` stepping every env in lockstep through one bucket pinned
to the fleet. No learner runs, so the numbers isolate acting.

The block, every timed field a {median, min, max, trials} spread:

  scalar_threads / vector_actor:
    env_steps_per_sec      env transitions attempted per second
    transitions_per_sec    transitions enqueued per second (the threaded
                           path enqueues at episode ends)
  speedup                  per-trial vector / scalar env steps
  overlap                  None: the JAX bench's third phase, the
                           ``MegastepLearner`` beside the fleet, is not
                           ported yet (``ROADMAP.md`` Queue 1)
  compile_counts           both policies' bucket builds (one each)
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.replay.actor import ActorFleet
from tensor2robot_tpu_torch.replay.ingest import TransitionQueue
from tensor2robot_tpu_torch.replay.learner_bench import _spread
from tensor2robot_tpu_torch.replay.loop import (
    CollectorWorker,
    _HotReloadPredictor,
)
from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
from tensor2robot_tpu_torch.serving.bucketing import BucketLadder
from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy


def measure_actor_throughput(
    num_envs: int = 32,
    scalar_collectors: int = 8,
    image_size: int = 16,
    action_size: int = 4,
    max_attempts: int = 3,
    grasp_radius: float = 0.4,
    exploration_epsilon: float = 0.25,
    scripted_fraction: float = 0.25,
    cem_num_samples: int = 16,
    cem_num_elites: int = 4,
    cem_iterations: int = 2,
    window_s: float = 1.0,
    trials: int = 3,
    seed: int = 0,
    device: Device = None,
) -> Dict:
  """Times both actor paths (TinyQ's policy on `device`, the GPU unless
  'cpu' is asked for); returns the block. Both buckets are built before
  any timing, on this thread."""
  if num_envs % scalar_collectors:
    raise ValueError(
        f"num_envs {num_envs} must split evenly over "
        f"scalar_collectors {scalar_collectors}")
  device = resolve_device(device)
  envs_per_collector = num_envs // scalar_collectors
  model = TinyQCriticModel(image_size=image_size, action_size=action_size)
  predictor = _HotReloadPredictor(model, model.init_variables(
      torch.Generator().manual_seed(seed), device=device))
  cem_kwargs = dict(action_size=action_size, num_samples=cem_num_samples,
                    num_elites=cem_num_elites, iterations=cem_iterations,
                    seed=seed + 7)
  # One bucket a path: the threads flush envs_per_collector requests a
  # call, the vector fleet num_envs.
  scalar_policy = CEMFleetPolicy(
      predictor, ladder=BucketLadder((envs_per_collector,)), **cem_kwargs)
  vector_policy = CEMFleetPolicy(
      predictor, ladder=BucketLadder((num_envs,)), **cem_kwargs)
  warm_image = np.zeros((image_size, image_size, 3), np.uint8)
  env_kwargs = dict(max_attempts=max_attempts, grasp_radius=grasp_radius,
                    exploration_epsilon=exploration_epsilon,
                    scripted_fraction=scripted_fraction)

  def timed_windows(steps_of, enqueued_of):
    """(env steps/s, transitions/s) a trial window over live threads."""
    sps, tps = [], []
    for _ in range(trials):
      steps0, enq0 = steps_of(), enqueued_of()
      start = time.perf_counter()
      time.sleep(window_s)
      elapsed = time.perf_counter() - start
      sps.append((steps_of() - steps0) / elapsed)
      tps.append((enqueued_of() - enq0) / elapsed)
    return sps, tps

  # --- the threaded scalar collectors ---------------------------------------
  scalar_queue = TransitionQueue(max(4096, 4 * num_envs))
  collectors = [
      CollectorWorker(scalar_policy, scalar_queue, image_size,
                      num_envs=envs_per_collector, seed=seed + i,
                      **env_kwargs)
      for i in range(scalar_collectors)
  ]
  scalar_policy([warm_image] * envs_per_collector)  # build, untimed
  for collector in collectors:
    collector.start()
  try:
    scalar_sps, scalar_tps = timed_windows(
        lambda: sum(c.env_steps for c in collectors),
        lambda: scalar_queue.enqueued)
  finally:
    for collector in collectors:
      collector.request_stop()
    for collector in collectors:
      collector.stop()

  # --- the vector actor: one bucket over the whole fleet --------------------
  vector_queue = TransitionQueue(max(4096, 4 * num_envs))
  fleet = ActorFleet(vector_policy, vector_queue, image_size,
                     total_envs=num_envs, seed=seed, **env_kwargs)
  vector_policy([warm_image] * num_envs)  # build, untimed
  fleet.start()
  try:
    vector_sps, vector_tps = timed_windows(
        lambda: fleet.env_steps, lambda: vector_queue.enqueued)
  finally:
    fleet.stop()

  return {
      "num_envs": num_envs,
      "scalar_collectors": scalar_collectors,
      "envs_per_collector": envs_per_collector,
      "window_s": window_s,
      "trials": trials,
      "scalar_threads": {
          "env_steps_per_sec": _spread(scalar_sps, 1),
          "transitions_per_sec": _spread(scalar_tps, 1),
      },
      "vector_actor": {
          "env_steps_per_sec": _spread(vector_sps, 1),
          "transitions_per_sec": _spread(vector_tps, 1),
      },
      "speedup": _spread(
          [v / max(s, 1e-9) for v, s in zip(vector_sps, scalar_sps)], 2),
      "overlap": None,
      "compile_counts": {
          **{f"scalar_cem_bucket_{k}": v
             for k, v in sorted(scalar_policy.compile_counts.items())},
          **{f"vector_cem_bucket_{k}": v
             for k, v in sorted(vector_policy.compile_counts.items())},
      },
      "note": (
          "same shared hot-reload predictor, same CEM settings, same total "
          f"env count on {device.type}: scalar path = {scalar_collectors} "
          f"threads x {envs_per_collector} GraspRetryEnvs each (one small "
          "bucket call a thread step); vector path = one VectorActor "
          f"stepping all {num_envs} envs through one bucket and one "
          "put_batch chunk a step. overlap is None: the megastep phase is "
          "not ported yet."),
  }
