"""The learner's crash-resume parity harness.

Counterpart of ``tensor2robot_tpu/serving/fault_bench.py``'s phase 5a:
``_fixed_stream``, ``_DeterministicLearner`` and ``_measure_resume_parity``.
The learner's host step (sample, label, train, TD errors, priority write)
runs on a fixed stream with no collector threads, so every source of
nondeterminism is a seeded generator or a checkpointed counter: training
k1 steps, checkpointing (``CheckpointManager`` and the loop's sidecar),
restoring into fresh objects and training k2 more must reproduce an
uninterrupted k1 + k2 run bit for bit, TD stream and ring alike.

The rest of the JAX file is the fault tier (router chaos, the degraded
fleet, dispatcher deaths, export-watcher damage and the live kill of a
loop through a fault plan), which waits for ``ROADMAP.md``'s flagship
items 9 and 15.
"""

from __future__ import annotations

import tempfile
from typing import Dict, List

import numpy as np
import torch

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.replay.bellman import BellmanUpdater
from tensor2robot_tpu_torch.replay.learner_bench import host_learner_step
from tensor2robot_tpu_torch.replay.loop import transition_spec
from tensor2robot_tpu_torch.replay.ring_buffer import ReplayBuffer
from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
from tensor2robot_tpu_torch.research.qtopt import synthetic_grasping as sg
from tensor2robot_tpu_torch.train import checkpoints as checkpoints_lib
from tensor2robot_tpu_torch.train.trainer import Trainer
from tensor2robot_tpu_torch.utils import optimizers


def _fixed_stream(n: int, image_size: int, action_size: int,
                  grasp_radius: float, gamma: float, seed: int) -> Dict:
  """A deterministic transition stream (the loop's eval recipe as ingest):
  class-balanced actions over sampled scenes, reward = grasp success."""
  del gamma
  images, targets = sg.sample_scenes(n, image_size=image_size,
                                     seed=seed + 101, num_distractors=0,
                                     occlusion=False)
  rng = np.random.default_rng(seed + 102)
  actions = rng.uniform(-1.0, 1.0, (n, action_size)).astype(np.float32)
  near = rng.random(n) < 0.5
  noise = rng.normal(0.0, 0.12, (n, 2)).astype(np.float32)
  actions[near, :2] = np.clip(targets[near] + noise[near], -1.0, 1.0)
  success = sg.grasp_success(targets, actions,
                             grasp_radius).astype(np.float32)
  return {
      "image": images,
      "action": actions,
      "reward": success,
      "done": success,
      "next_image": images,
  }


def _flagship_model(image_size: int, action_size: int):
  """The production loop's critic: the 64x64 uint8 GroupNorm flagship."""
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      QTOptGraspingModel,
  )
  return QTOptGraspingModel(
      image_size=image_size, action_size=action_size, uint8_images=True,
      norm="group", optimizer_fn=optimizers.create_adam_optimizer(1e-4))


class _DeterministicLearner:
  """The host learner step over a fixed prioritized ring, with no
  collector threads; ``save`` and ``restore`` are the loop's checkpoint
  (train state, then sidecar: target net, label seed, ring)."""

  def __init__(self, stream: Dict, image_size: int, action_size: int,
               batch_size: int, capacity: int, gamma: float,
               refresh_every: int, seed: int, flagship: bool = False,
               cem=(16, 4, 2), device: Device = None):
    self.refresh_every = refresh_every
    if flagship:
      self.model = _flagship_model(image_size, action_size)
    else:
      self.model = TinyQCriticModel(
          image_size=image_size, action_size=action_size,
          optimizer_fn=optimizers.create_adam_optimizer(3e-3))
    self.trainer = Trainer(self.model, seed=seed, device=device)
    self.state = self.trainer.create_train_state()
    self.buffer = ReplayBuffer(
        transition_spec(image_size, action_size), capacity, batch_size,
        seed=seed, prioritized=True)
    self.buffer.extend(stream)
    num_samples, num_elites, iterations = cem
    self.updater = BellmanUpdater(
        self.model, self._host_variables(), action_size=action_size,
        gamma=gamma, num_samples=num_samples, num_elites=num_elites,
        iterations=iterations, seed=seed + 13, device=self.trainer.device)
    self.step = 0

  def _host_variables(self) -> Dict[str, torch.Tensor]:
    return {key: value.detach().clone()
            for key, value in self.state.variables(use_ema=True).items()}

  def run_steps(self, n: int) -> List[np.ndarray]:
    """n optimizer steps; returns each step's TD errors (the stream the
    parity compares)."""
    tds = []
    for _ in range(n):
      self.state, _, td = host_learner_step(
          self.trainer, self.updater, self.buffer, self.state)[:3]
      self.step += 1
      if self.step % self.refresh_every == 0:
        self.updater.refresh(self._host_variables(), self.step)
      tds.append(np.asarray(td).copy())
    return tds

  def save(self, root: str) -> None:
    checkpoints_lib.CheckpointManager(root, max_to_keep=2).save(
        self.step, self.state)
    target_vars, target_meta = self.updater.target_state()
    buffer_arrays, buffer_meta = self.buffer.state_dict()
    checkpoints_lib.save_sidecar(
        root, self.step,
        trees={} if target_vars is None else {"target": target_vars},
        flats={"buffer": buffer_arrays},
        meta={"target": target_meta,
              "next_label_seed": self.updater.next_label_seed,
              "buffer_meta": buffer_meta})

  def restore(self, root: str) -> int:
    step = checkpoints_lib.latest_resumable_step(root)
    if step is None:
      raise FileNotFoundError(f"no resumable checkpoint under {root}")
    manager = checkpoints_lib.CheckpointManager(root, max_to_keep=2)
    self.state = manager.restore(self.state, step=step)
    trees, flats, meta = checkpoints_lib.load_sidecar(root, step)
    self.buffer.load_state_dict(flats["buffer"], meta["buffer_meta"])
    self.updater.restore_target_state(trees.get("target"), meta["target"])
    self.updater.restore_label_seed(meta["next_label_seed"])
    self.step = int(step)
    return self.step


def _measure_resume_parity(k1: int, k2: int, seed: int,
                           device: Device = None,
                           flagship: bool = False) -> Dict:
  """Crash at k1 and resume == uninterrupted, bit for bit, on the fixed
  stream: TinyQ at 16x16 (CEM 16/4/2), or with `flagship` the production
  loop's 64x64 critic (CEM 64/6/3); batch 32, a ring of 256, a target
  refresh every 10 steps. On the GPU it runs with cuDNN deterministic."""
  device = resolve_device(device)
  image_size = 64 if flagship else 16
  kwargs = dict(image_size=image_size, action_size=4, batch_size=32,
                capacity=256, gamma=0.8, refresh_every=10, seed=seed,
                flagship=flagship, cem=(64, 6, 3) if flagship else (16, 4, 2),
                device=device)
  stream = _fixed_stream(256, image_size, 4, 0.4, 0.8, seed)
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    # The uninterrupted oracle: k1 + k2 straight through.
    oracle_tds = _DeterministicLearner(stream, **kwargs).run_steps(k1 + k2)
    # Interrupted: k1 steps, checkpoint, "crash" (objects dropped), then a
    # FRESH learner restores and runs k2 more.
    with tempfile.TemporaryDirectory(prefix="resume_parity_") as root:
      first = _DeterministicLearner(stream, **kwargs)
      first_tds = first.run_steps(k1)
      first.save(root)
      saved_arrays, saved_meta = first.buffer.state_dict()
      del first
      resumed = _DeterministicLearner(stream, **kwargs)
      restored_step = resumed.restore(root)
    restored_arrays, restored_meta = resumed.buffer.state_dict()
    buffer_bit_equal = (
        all(np.array_equal(saved_arrays[key], restored_arrays[key])
            for key in saved_arrays)
        and saved_meta["next"] == restored_meta["next"]
        and saved_meta["append_count"] == restored_meta["append_count"]
        and saved_meta["rng_state"] == restored_meta["rng_state"])
    resumed_tds = resumed.run_steps(k2)
  finally:
    torch.backends.cudnn.deterministic = deterministic
  pre_crash_equal = all(
      np.array_equal(a, b) for a, b in zip(oracle_tds[:k1], first_tds))
  post_resume_equal = all(
      np.array_equal(a, b) for a, b in zip(oracle_tds[k1:], resumed_tds))
  max_post_delta = max(
      (float(np.max(np.abs(a - b)))
       for a, b in zip(oracle_tds[k1:], resumed_tds)), default=0.0)
  parity_ok = (restored_step == k1 and buffer_bit_equal
               and pre_crash_equal and post_resume_equal)
  return {
      "k1": k1, "k2": k2,
      "restored_step": restored_step,
      "buffer_bit_equal": bool(buffer_bit_equal),
      "pre_crash_stream_bit_equal": bool(pre_crash_equal),
      "post_resume_stream_bit_equal": bool(post_resume_equal),
      "max_post_resume_td_delta": max_post_delta,
      "parity_ok": bool(parity_ok),
  }
