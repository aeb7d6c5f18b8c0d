"""Actor throughput: threaded scalar collectors against the vector fleet,
and the learner beside the fleet.

Counterpart of ``tensor2robot_tpu/replay/actor_bench.py``. At the same
policy (one shared hot-reload predictor, the same CEM settings) and the
same total env count, it times the threaded collectors
(``scalar_collectors`` threads, each stepping its share of scalar
``GraspRetryEnv``s through its own small bucket) against one
``VectorActor`` stepping every env in lockstep through one bucket pinned
to the fleet; no learner runs in those two phases, so their numbers
isolate acting. The overlap phase then runs the megastep learner
(``device_buffer.MegastepLearner`` over a pre-filled device ring) while a
fresh fleet collects.

The block, every timed field a {median, min, max, trials} spread:

  scalar_threads / vector_actor:
    env_steps_per_sec      env transitions attempted per second
    transitions_per_sec    transitions enqueued per second (the threaded
                           path enqueues at episode ends)
  speedup                  per-trial vector / scalar env steps
  overlap:
    acting_learning_overlap_fraction   the fleet's busy seconds over the
                           learner's wall seconds (1.0: acting never
                           paused while the learner trained)
    learner_steps_per_sec_while_acting the megastep's optimizer steps/s
                           beside the fleet
  compile_counts           both policies' bucket builds and the
                           megastep's (one each)
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.replay.actor import ActorFleet
from tensor2robot_tpu_torch.replay.device_buffer import (
    DeviceReplayBuffer,
    MegastepLearner,
)
from tensor2robot_tpu_torch.replay.ingest import TransitionQueue
from tensor2robot_tpu_torch.replay.learner_bench import (
    _spread,
    _synthetic_transitions,
)
from tensor2robot_tpu_torch.replay.loop import (
    CollectorWorker,
    _HotReloadPredictor,
    transition_spec,
)
from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
from tensor2robot_tpu_torch.serving.bucketing import BucketLadder
from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy
from tensor2robot_tpu_torch.train.trainer import Trainer
from tensor2robot_tpu_torch.utils import optimizers


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
    batch_size: int = 32,
    learner_capacity: int = 256,
    learner_inner_steps: int = 5,
    gamma: float = 0.8,
    learning_rate: float = 3e-3,
    seed: int = 0,
    device: Device = None,
) -> Dict:
  """Times both actor paths, then the overlap phase (TinyQ on `device`,
  the GPU unless 'cpu' is asked for); returns the block. Both buckets and
  the megastep's graph are built before any timing, on this thread."""
  if num_envs % scalar_collectors:
    raise ValueError(
        f"num_envs {num_envs} must split evenly over "
        f"scalar_collectors {scalar_collectors}")
  device = resolve_device(device)
  envs_per_collector = num_envs // scalar_collectors
  model = TinyQCriticModel(
      image_size=image_size, action_size=action_size,
      optimizer_fn=optimizers.create_adam_optimizer(learning_rate))
  trainer = Trainer(model, seed=seed, device=device)
  state = trainer.create_train_state()
  host_variables = {key: value.detach().clone()
                    for key, value in state.variables(use_ema=True).items()}
  predictor = _HotReloadPredictor(model, host_variables)
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

  # --- the overlap phase: the megastep learner beside a fresh fleet ---------
  buffer = DeviceReplayBuffer(
      transition_spec(image_size, action_size), learner_capacity, batch_size,
      seed=seed, prioritized=True, ingest_chunk=min(64, learner_capacity),
      device=device)
  buffer.extend(_synthetic_transitions(learner_capacity, image_size,
                                       action_size, seed + 17))
  learner = MegastepLearner(
      model, trainer, buffer, action_size=action_size, gamma=gamma,
      num_samples=cem_num_samples, num_elites=cem_num_elites,
      iterations=cem_iterations, inner_steps=learner_inner_steps,
      seed=seed + 13)
  learner.refresh(host_variables, step=0)
  # Untimed: the eager first dispatch, then the capture (on the card).
  for _ in range(2):
    state, _ = learner.step(state)
  overlap_fleet = ActorFleet(
      vector_policy, TransitionQueue(max(4096, 4 * num_envs)), image_size,
      total_envs=num_envs, seed=seed + 99, **env_kwargs)
  overlap_fleet.start()
  overlap_fracs, learner_sps = [], []
  try:
    for _ in range(trials):
      busy0 = overlap_fleet.busy_seconds()
      steps = 0
      start = time.perf_counter()
      while time.perf_counter() - start < window_s:
        state, _ = learner.step(state)
        steps += learner_inner_steps
      elapsed = time.perf_counter() - start
      overlap_fracs.append(
          min(1.0, (overlap_fleet.busy_seconds() - busy0) / elapsed))
      learner_sps.append(steps / elapsed)
  finally:
    overlap_fleet.stop()

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
      "overlap": {
          "acting_learning_overlap_fraction": _spread(overlap_fracs, 3),
          "learner_steps_per_sec_while_acting": _spread(learner_sps, 2),
      },
      "compile_counts": {
          **{f"scalar_cem_bucket_{k}": v
             for k, v in sorted(scalar_policy.compile_counts.items())},
          **{f"vector_cem_bucket_{k}": v
             for k, v in sorted(vector_policy.compile_counts.items())},
          **learner.compile_counts,
      },
      "note": (
          "same shared hot-reload predictor, same CEM settings, same total "
          f"env count on {device.type}: scalar path = {scalar_collectors} "
          f"threads x {envs_per_collector} GraspRetryEnvs each (one small "
          "bucket call a thread step); vector path = one VectorActor "
          f"stepping all {num_envs} envs through one bucket and one "
          "put_batch chunk a step. The overlap phase runs the megastep "
          "learner while a fresh fleet collects: overlap fraction = actor "
          "busy seconds / learner wall seconds."),
  }
