"""The Anakin loop's bench: the vector fleet against the fused loop, and
its crash-resume bar.

Counterpart of ``tensor2robot_tpu/replay/anakin_bench.py``. At the same
env count and policy (the same CEM settings over the same TinyQ critic),
``measure_anakin_throughput`` times the vector side (one ``VectorActor``
stepping every env through one ``CEMFleetPolicy`` bucket, numpy envs and
the queue on the host) against ``anakin.AnakinLoop``, where acting, the
env step, the replay extend and the optimizer step all run on the card.

The vector fleet is timed beside the megastep learner (``inner_steps`` 5
over a pre-filled device ring, the co-scheduled production shape) and
then alone (its best case); the Anakin loop trains every
``train_every``-th control step inside the timed number. Every timed
field is a {median, min, max, trials} spread:

  vector_fleet:
    env_steps_per_sec              beside the megastep learner
    collect_only_env_steps_per_sec nothing else running
    learner_steps_per_sec          the megastep's rate beside the fleet
  anakin:
    env_steps_per_sec              the fused loop, training as it goes
    train_steps_per_sec            its optimizer steps
    host_blocked_fraction          1 - (launch-to-readback seconds) /
                                   wall: the host's own share
    dtype                          the CEM scoring dtype
  speedup                          per trial, anakin / co-scheduled fleet
  speedup_vs_collect_only          per trial, anakin / collect-only fleet
  compile_counts                   one acting bucket and one megastep for
                                   the vector side, one ``anakin_step``.

``anakin_resume_parity`` holds the Anakin path's checkpoints (the loop's
own ``_save_fused_checkpoint`` / ``_restore_fused_checkpoint``) to
resume bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.replay.actor import ActorFleet
from tensor2robot_tpu_torch.replay.anakin import AnakinLoop
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
    ReplayLoopConfig,
    ReplayTrainLoop,
    _HotReloadPredictor,
    transition_spec,
)
from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
from tensor2robot_tpu_torch.research.qtopt.device_grasping import (
    DeviceGraspEnv,
    make_scene_bank,
)
from tensor2robot_tpu_torch.serving.bucketing import BucketLadder
from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy
from tensor2robot_tpu_torch.train.trainer import Trainer
from tensor2robot_tpu_torch.utils import optimizers


def measure_anakin_throughput(
    num_envs: int = 32,
    image_size: int = 16,
    action_size: int = 4,
    max_attempts: int = 3,
    grasp_radius: float = 0.4,
    exploration_epsilon: float = 0.25,
    scripted_fraction: float = 0.25,
    cem_num_samples: int = 16,
    cem_num_elites: int = 4,
    cem_iterations: int = 2,
    inner_steps: int = 128,
    train_every: int = 8,
    bank_scenes: int = 512,
    window_s: float = 1.0,
    trials: int = 3,
    batch_size: int = 32,
    capacity: int = 512,
    gamma: float = 0.8,
    learning_rate: float = 3e-3,
    seed: int = 0,
    device: Device = None,
) -> Dict:
  """Times both loop shapes (TinyQ on `device`, the GPU unless 'cpu' is
  asked for); returns the ``anakin_throughput`` block. Every build (the
  acting bucket, the megastep's graph, the Anakin period's graph) happens
  before any timing, on this thread."""
  device = resolve_device(device)
  model = TinyQCriticModel(
      image_size=image_size, action_size=action_size,
      optimizer_fn=optimizers.create_adam_optimizer(learning_rate))
  trainer = Trainer(model, seed=seed, device=device)
  state = trainer.create_train_state()
  host_variables = {key: value.detach().clone()
                    for key, value in state.variables(use_ema=True).items()}
  spec = transition_spec(image_size, action_size)
  cem_kwargs = dict(action_size=action_size, num_samples=cem_num_samples,
                    num_elites=cem_num_elites, iterations=cem_iterations)

  # --- the vector side: the numpy fleet beside the megastep ------------------
  vector_policy = CEMFleetPolicy(
      _HotReloadPredictor(model, host_variables), seed=seed + 7,
      ladder=BucketLadder((num_envs,)), **cem_kwargs)
  fleet = ActorFleet(vector_policy, TransitionQueue(max(4096, 4 * num_envs)),
                     image_size, total_envs=num_envs,
                     max_attempts=max_attempts, seed=seed,
                     grasp_radius=grasp_radius,
                     exploration_epsilon=exploration_epsilon,
                     scripted_fraction=scripted_fraction)
  warm_image = np.zeros((image_size, image_size, 3), np.uint8)
  vector_policy([warm_image] * num_envs)  # build, untimed
  vbuffer = DeviceReplayBuffer(spec, capacity, batch_size, seed=seed,
                               prioritized=True,
                               ingest_chunk=min(64, capacity), device=device)
  vbuffer.extend(_synthetic_transitions(capacity, image_size, action_size,
                                        seed + 17))
  vlearner = MegastepLearner(model, trainer, vbuffer, gamma=gamma,
                             inner_steps=5, seed=seed + 13, **cem_kwargs)
  vlearner.refresh(host_variables, step=0)
  for _ in range(2):  # the eager first dispatch, then the capture: untimed
    state, _ = vlearner.step(state)
  fleet.start()
  vector_sps, vector_learner_sps, collect_sps = [], [], []
  try:
    for _ in range(trials):
      steps0, learner_steps = fleet.env_steps, 0
      start = time.perf_counter()
      while time.perf_counter() - start < window_s:
        state, _ = vlearner.step(state)
        learner_steps += vlearner.inner_steps
      elapsed = time.perf_counter() - start
      vector_sps.append((fleet.env_steps - steps0) / elapsed)
      vector_learner_sps.append(learner_steps / elapsed)
    for _ in range(trials):
      steps0 = fleet.env_steps
      start = time.perf_counter()
      time.sleep(window_s)
      collect_sps.append(
          (fleet.env_steps - steps0) / (time.perf_counter() - start))
  finally:
    fleet.stop()

  # --- the Anakin side: the fused loop, training as it goes ------------------
  buffer = DeviceReplayBuffer(spec, capacity, batch_size, seed=seed,
                              prioritized=True, ingest_chunk=num_envs,
                              device=device)
  env = DeviceGraspEnv(
      num_envs, image_size=image_size, max_attempts=max_attempts,
      radius=grasp_radius, device=device,
      bank=make_scene_bank(bank_scenes, image_size=image_size,
                           base_seed=seed, device=device))
  loop = AnakinLoop(
      model, trainer, buffer, env, gamma=gamma, inner_steps=inner_steps,
      train_every=train_every, min_fill=min(batch_size, capacity),
      exploration_epsilon=exploration_epsilon,
      scripted_fraction=scripted_fraction, seed=seed + 13, **cem_kwargs)
  loop.refresh(host_variables, step=0)
  # Untimed: the eager dispatch that fills past min_fill, then the capture.
  for _ in range(2):
    state, _ = loop.step(state)
  anakin_sps, anakin_tps, anakin_blocked = [], [], []
  for _ in range(trials):
    steps = trained = 0
    exec0 = loop.exec_seconds
    start = time.perf_counter()
    while time.perf_counter() - start < window_s:
      state, metrics = loop.step(state)
      steps += inner_steps * num_envs
      trained += metrics["trained_steps"]
    elapsed = time.perf_counter() - start
    anakin_sps.append(steps / elapsed)
    anakin_tps.append(trained / elapsed)
    anakin_blocked.append(
        max(0.0, 1.0 - (loop.exec_seconds - exec0) / elapsed))

  return {
      "num_envs": num_envs,
      "train_every": train_every,
      "inner_steps": inner_steps,
      "window_s": window_s,
      "trials": trials,
      "dtype": loop.dtype,
      "vector_fleet": {
          "env_steps_per_sec": _spread(vector_sps, 1),
          "collect_only_env_steps_per_sec": _spread(collect_sps, 1),
          "learner_steps_per_sec": _spread(vector_learner_sps, 2),
      },
      "anakin": {
          "env_steps_per_sec": _spread(anakin_sps, 1),
          "train_steps_per_sec": _spread(anakin_tps, 2),
          "host_blocked_fraction": _spread(anakin_blocked, 3),
          "dtype": loop.dtype,
      },
      "speedup": _spread(
          [a / max(v, 1e-9) for a, v in zip(anakin_sps, vector_sps)], 2),
      "speedup_vs_collect_only": _spread(
          [a / max(v, 1e-9) for a, v in zip(anakin_sps, collect_sps)], 2),
      "compile_counts": {
          **{f"vector_cem_bucket_{k}": v
             for k, v in sorted(vector_policy.compile_counts.items())},
          **vlearner.compile_counts,
          **loop.compile_counts,
      },
      "note": (
          f"same env count, CEM settings and TinyQ critic on {device.type}. "
          f"The vector side is one VectorActor stepping all {num_envs} numpy "
          "envs through one bucket while the megastep learner trains "
          "(collect_only: the fleet alone); the Anakin side runs "
          f"{inner_steps} control steps a dispatch, an optimizer step every "
          f"{train_every}th, on the card. host_blocked_fraction is the wall "
          "time outside the loop's launch-to-readback windows."),
  }


def anakin_resume_parity(k1: int, k2: int, seed: int = 0,
                         device: Device = None) -> Dict:
  """The Anakin path's crash-resume bar: k1 + k2 dispatches straight
  through against k1 dispatches, a checkpoint through the loop's own
  ``_save_fused_checkpoint``, a fresh loop's ``_restore_fused_checkpoint``
  and k2 more, a target refresh after the first dispatch. Metrics,
  parameters, the env fleet, the ring and the target net must agree bit
  for bit. TinyQ at the smoke's scale (4 envs, 16x16, CEM 16/4/2) with
  dispatches of 16 control steps; on the GPU with cuDNN deterministic."""
  device = resolve_device(device)
  # checkpoint_every gives the loops their checkpoint manager; only the
  # calls below save.
  config = ReplayLoopConfig(anakin=True, anakin_inner=16,
                            anakin_train_every=4, min_fill=32, seed=seed,
                            anakin_bank_scenes=64, checkpoint_every=1)

  def fresh(logdir, resume=False):
    replay = ReplayTrainLoop(
        dataclasses.replace(config, resume=resume), logdir,
        model=TinyQCriticModel(optimizer_fn=optimizers.create_adam_optimizer(
            config.learning_rate)), device=device)
    replay.writer.close()  # no run: nothing is written
    state = replay.trainer.create_train_state()
    loop = replay._anakin_loop()
    loop.refresh(state.variables(use_ema=True), step=0)
    return replay, state, loop

  def run(state, loop, first, dispatches):
    metrics = []
    for outer in range(first, first + dispatches):
      state, values = loop.step(state)
      metrics.append(values)
      if outer == 1:
        loop.refresh(state.variables(use_ema=True), loop.trained_steps)
    return state, metrics

  def carried(replay, loop):
    """Host copies of the env, the ring and the target net."""
    return {**{f"env/{k}": v for k, v in loop.env_state.arrays().items()},
            **{f"ring/{k}": v.copy()
               for k, v in replay.buffer.state.arrays().items()},
            **{f"target/{k}": v.cpu().numpy().copy()
               for k, v in loop.checkpoint_state()["target"].items()}}

  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    with tempfile.TemporaryDirectory(prefix="anakin_resume_") as root:
      oracle, state, loop = fresh(os.path.join(root, "oracle"))
      state, want = run(state, loop, 1, k1 + k2)
      want_carried = carried(oracle, loop)
      first, state1, loop1 = fresh(os.path.join(root, "run"))
      state1, got = run(state1, loop1, 1, k1)
      saved_step = loop1.trained_steps
      first._save_fused_checkpoint(saved_step, state1, loop1, {}, [])
      saved = carried(first, loop1)
      del first, state1, loop1
      resumed, state2, loop2 = fresh(os.path.join(root, "run"),
                                     resume=True)
      state2, restored_step, _ = resumed._restore_fused_checkpoint(
          state2, loop2)
      restored = carried(resumed, loop2)
      state2, rest = run(state2, loop2, k1 + 1, k2)
      got_carried = carried(resumed, loop2)
  finally:
    torch.backends.cudnn.deterministic = deterministic
  restored_equal = all(np.array_equal(value, restored[key])
                       for key, value in saved.items())
  carried_equal = all(np.array_equal(value, got_carried[key])
                      for key, value in want_carried.items())
  params_equal = all(torch.equal(param, state2.params[name])
                     for name, param in state.params.items())
  return {
      "k1": k1, "k2": k2, "inner_steps": config.anakin_inner,
      "model": "tinyq_16x16", "saved_step": saved_step,
      "restored_step": restored_step,
      "restored_bit_equal": bool(restored_equal),
      "pre_crash_metrics_equal": got == want[:k1],
      "post_resume_metrics_equal": rest == want[k1:],
      "params_bit_equal": bool(params_equal),
      "env_ring_target_bit_equal": bool(carried_equal),
      "parity_ok": bool(restored_step == saved_step and restored_equal
                        and got == want[:k1] and rest == want[k1:]
                        and params_equal and carried_equal),
  }
