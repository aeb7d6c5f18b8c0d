"""The QT-Opt learner's host path: its step, its throughput bench, and the
off-policy learning check.

Counterpart of ``tensor2robot_tpu/replay/learner_bench.py``'s host path:
each optimizer step samples the replay ring on the host, labels the batch
with CEM-maximized Bellman targets (``BellmanUpdater.compute_targets``),
trains (``Trainer.train_step``), computes the batch's TD errors and writes
them back as priorities — the learner half of the JAX
``ReplayTrainLoop._run_host``, with no collectors running, so the numbers
isolate the learner.

The JAX bench also times the device-resident megastep (its
``device_megastep`` and ``speedup`` blocks); that path waits for
``ROADMAP.md``'s flagship item 10 (``DeviceReplayBuffer``,
``MegastepLearner``), so this bench returns no such keys.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.replay.bellman import BellmanUpdater
from tensor2robot_tpu_torch.replay.ingest import ReplayFeeder, TransitionQueue
from tensor2robot_tpu_torch.replay.loop import (
    CollectorWorker,
    ReplayLoopConfig,
    eval_transitions,
    evaluate_td,
    transition_spec,
)
from tensor2robot_tpu_torch.replay.ring_buffer import (
    ReplayBuffer,
    ShardedReplayBuffer,
)
from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
from tensor2robot_tpu_torch.train.trainer import Trainer
from tensor2robot_tpu_torch.utils import optimizers

STAGES = ("sample", "label", "train", "td", "priority_write")


def _spread(values, digits=3):
  """{median,min,max,trials}: the JAX bench's field shape."""
  vals = [float(v) for v in values]
  return {
      "median": round(statistics.median(vals), digits),
      "min": round(min(vals), digits),
      "max": round(max(vals), digits),
      "trials": len(vals),
  }


def _synthetic_transitions(n, image_size, action_size, seed):
  rng = np.random.default_rng(seed)
  return {
      "image": rng.integers(0, 255, (n, image_size, image_size, 3),
                            np.uint8),
      "action": rng.uniform(-1, 1, (n, action_size)).astype(np.float32),
      "reward": (rng.random(n) < 0.3).astype(np.float32),
      "done": (rng.random(n) < 0.3).astype(np.float32),
      "next_image": rng.integers(0, 255, (n, image_size, image_size, 3),
                                 np.uint8),
  }


class StageClock:
  """Host time and device time per stage of the learner step.

  ``with clock("label"): ...`` adds the stage's host seconds (no
  synchronisation: what the host spends issuing it) and, on a GPU, CUDA
  events around it, read after one synchronise in ``summary``."""

  def __init__(self, device: torch.device):
    self._cuda = device.type == "cuda"
    self.host_s = {name: 0.0 for name in STAGES}
    self._events = {name: [] for name in STAGES}
    self.steps = 0

  @contextlib.contextmanager
  def __call__(self, name: str):
    self.steps += name == STAGES[0]
    if self._cuda:
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
    t0 = time.perf_counter()
    yield
    self.host_s[name] += time.perf_counter() - t0
    if self._cuda:
      end.record()
      self._events[name].append((start, end))

  def summary(self) -> Dict[str, Dict[str, Optional[float]]]:
    """{stage: {"host_ms", "device_ms"}} per step (device_ms None off the
    GPU)."""
    if self._cuda:
      torch.cuda.synchronize()
    steps = max(self.steps, 1)
    return {name: {
        "host_ms": self.host_s[name] * 1e3 / steps,
        "device_ms": (sum(s.elapsed_time(e) for s, e in self._events[name])
                      / steps if self._cuda else None),
    } for name in STAGES}


class LearnerStep(NamedTuple):
  """What one learner step leaves: the state after it, the train step's
  metrics, and the batch's TD errors, targets, bootstrap Q and sample
  info."""
  state: Any
  metrics: Dict[str, torch.Tensor]
  td: np.ndarray
  targets: np.ndarray
  q_next: np.ndarray
  info: Any


def host_learner_step(trainer: Trainer, updater: BellmanUpdater, buffer,
                      state, clock=None, with_health: bool = False
                      ) -> LearnerStep:
  """One learner step of the JAX ``ReplayTrainLoop._run_host``: sample,
  label, train, TD errors, priority write-back. `clock` (a StageClock)
  times each stage; `with_health` adds the gradients' norm and non-finite
  count to the metrics."""
  clock = clock or (lambda name: contextlib.nullcontext())
  device = trainer.device
  with clock("sample"):
    batch, info = buffer.sample()
  with clock("label"):
    targets, q_next = updater.compute_targets(batch)
  with clock("train"):
    features = {
        "image": torch.from_numpy(np.asarray(batch["image"])).to(device),
        "action": torch.from_numpy(np.asarray(batch["action"])).to(device)}
    labels = {"target_q": torch.from_numpy(targets).to(device)}
    state, metrics = trainer.train_step(state, features, labels,
                                        with_health=with_health)
  with clock("td"):
    td = updater.td_errors(state.variables(use_ema=True), batch, targets)
  with clock("priority_write"):
    buffer.update_priorities(info.indices, td)
  return LearnerStep(state, metrics, td, targets, q_next, info)


def measure_learner_throughput(
    batch_size: int = 32,
    image_size: int = 16,
    action_size: int = 4,
    capacity: int = 256,
    steps_per_trial: int = 30,
    trials: int = 3,
    gamma: float = 0.8,
    learning_rate: float = 3e-3,
    cem_num_samples: int = 16,
    cem_num_elites: int = 4,
    cem_iterations: int = 2,
    seed: int = 0,
    device: Device = None,
) -> Dict:
  """Times the host learner path on a pre-filled prioritized ring.

  Three warm-up steps first, outside all timing; then `trials` timed
  windows of `steps_per_trial` steps. host_blocked_fraction is the wall
  time OUTSIDE the label, train and TD calls (each synchronised on the
  GPU before its clock is read) over the window's wall time."""
  device = resolve_device(device)
  model = TinyQCriticModel(
      image_size=image_size, action_size=action_size,
      optimizer_fn=optimizers.create_adam_optimizer(learning_rate))
  trainer = Trainer(model, seed=seed, device=device)
  state = trainer.create_train_state()
  buffer = ReplayBuffer(transition_spec(image_size, action_size), capacity,
                        batch_size, seed=seed, prioritized=True)
  buffer.extend(_synthetic_transitions(capacity, image_size, action_size,
                                       seed + 17))
  updater = BellmanUpdater(
      model, state.variables(use_ema=True), action_size=action_size,
      gamma=gamma, num_samples=cem_num_samples, num_elites=cem_num_elites,
      iterations=cem_iterations, seed=seed + 13, device=device)
  exec_seconds = [0.0]

  def sync():
    if device.type == "cuda":
      torch.cuda.synchronize(device)

  @contextlib.contextmanager
  def timed(name):
    if name not in ("label", "train", "td"):
      yield
      return
    sync()
    start = time.perf_counter()
    yield
    sync()
    exec_seconds[0] += time.perf_counter() - start

  for _ in range(3):  # builds and warm caches, outside all timing
    state = host_learner_step(trainer, updater, buffer, state).state
  sync()
  host_sps, host_blocked = [], []
  for _ in range(trials):
    exec_seconds[0] = 0.0
    start = time.perf_counter()
    for _ in range(steps_per_trial):
      state, metrics = host_learner_step(trainer, updater, buffer, state,
                                         timed)[:2]
    float(metrics["loss"])  # sync
    elapsed = time.perf_counter() - start
    host_sps.append(steps_per_trial / elapsed)
    host_blocked.append(max(0.0, 1.0 - exec_seconds[0] / elapsed))
  return {
      "batch_size": batch_size,
      "steps_per_trial": steps_per_trial,
      "prioritized": True,
      "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu"),
      "host_path": {
          "train_steps_per_sec": _spread(host_sps, 2),
          "transitions_per_sec": _spread(
              [s * batch_size for s in host_sps], 1),
          "host_blocked_fraction": _spread(host_blocked, 3),
      },
      "compile_counts": dict(updater.compile_counts),
      "note": (
          "pre-filled ring, no collectors: sample/label/train/TD/"
          "reprioritize per optimizer step on the host path. "
          "host_blocked_fraction counts wall time OUTSIDE the label, train "
          "and TD calls."),
  }


def uniform_policy(action_size: int, seed: int):
  """A logged policy: seeded uniform actions in [-1, 1], one row an
  image."""
  rng = np.random.default_rng(seed)

  def policy(images):
    return rng.uniform(-1.0, 1.0,
                       (len(images), action_size)).astype(np.float32)

  return policy


def fill_ring(config: ReplayLoopConfig):
  """The config's sharded (or single) ring filled to capacity by one
  CollectorWorker stepped on this thread with a seeded uniform policy
  (plus the worker's own epsilon and scripted mix). Returns (buffer,
  worker, feeder)."""
  c = config
  spec = transition_spec(c.image_size, c.action_size)
  if c.num_buffer_shards > 1:
    buffer = ShardedReplayBuffer(spec, c.capacity, c.batch_size,
                                 num_shards=c.num_buffer_shards, seed=c.seed,
                                 prioritized=c.prioritized)
  else:
    buffer = ReplayBuffer(spec, c.capacity, c.batch_size, seed=c.seed,
                          prioritized=c.prioritized)
  queue = TransitionQueue(c.queue_capacity)
  feeder = ReplayFeeder(queue, buffer, c.min_fill)
  worker = CollectorWorker(
      uniform_policy(c.action_size, c.seed + 7), queue, c.image_size,
      num_envs=c.envs_per_collector, max_attempts=c.max_attempts,
      seed=c.seed, grasp_radius=c.grasp_radius,
      exploration_epsilon=c.exploration_epsilon,
      scripted_fraction=c.scripted_fraction)
  while buffer.size < c.capacity:
    worker.step_once()
    feeder.drain()
  return buffer, worker, feeder


def off_policy_td_reduction(seed: int = 0, steps: int = 300,
                            device: Device = None) -> Dict:
  """Purely off-policy learning through the CEM max, with no serving
  policy: TinyQ at ``ReplayLoopConfig()``'s defaults, a 2-shard
  prioritized ring filled from logged uniform and scripted episodes and
  then frozen, `steps` host learner steps with a target refresh every
  ``refresh_every``. Returns the eval TD error against the retry env's
  Q* before and after, and its relative reduction (the JAX smoke's bar
  is 0.30)."""
  device = resolve_device(device)
  config = ReplayLoopConfig(seed=seed)
  buffer, worker, _ = fill_ring(config)
  model = TinyQCriticModel(
      image_size=config.image_size, action_size=config.action_size,
      optimizer_fn=optimizers.create_adam_optimizer(config.learning_rate))
  trainer = Trainer(model, seed=seed, device=device)
  state = trainer.create_train_state()
  updater = BellmanUpdater(
      model, state.variables(use_ema=True), action_size=config.action_size,
      gamma=config.gamma, num_samples=config.cem_num_samples,
      num_elites=config.cem_num_elites, iterations=config.cem_iterations,
      seed=seed + 13, polyak_tau=config.polyak_tau, device=device)
  batches, q_stars = eval_transitions(config)
  initial = evaluate_td(updater, state.variables(use_ema=True), batches,
                        q_stars)
  start = time.perf_counter()
  losses = []
  for step in range(1, steps + 1):
    state, metrics = host_learner_step(trainer, updater, buffer, state)[:2]
    losses.append(metrics["loss"])
    if step % config.refresh_every == 0:
      updater.refresh(state.variables(use_ema=True), step)
  final = evaluate_td(updater, state.variables(use_ema=True), batches,
                      q_stars)
  seconds = time.perf_counter() - start
  return {
      "seed": seed,
      "steps": steps,
      "episodes": worker.episodes,
      "successes": worker.successes,
      "ring_size": buffer.size,
      "initial_eval": initial,
      "final_eval": final,
      "eval_td_reduction": 1.0 - (final["eval_td_error"]
                                  / max(initial["eval_td_error"], 1e-9)),
      "first_loss": float(losses[0]),
      "last_loss": float(losses[-1]),
      "refreshes": updater.refresh_count,
      "compile_counts": dict(updater.compile_counts),
      "learner_seconds": seconds,
  }
