"""The QT-Opt learner's host path, its throughput bench against the
megastep, and the off-policy learning check.

Counterpart of ``tensor2robot_tpu/replay/learner_bench.py``. The host
path's optimizer step samples the replay ring on the host, labels the
batch with CEM-maximized Bellman targets
(``BellmanUpdater.compute_targets``), trains (``Trainer.train_step``),
computes the batch's TD errors and writes them back as priorities: the
learner half of the JAX ``ReplayTrainLoop._run_host``.
``fused_resume_parity`` holds the device-resident path's checkpoints to
resume bit for bit. ``measure_learner_throughput`` times it against the device-resident
megastep (``device_buffer.MegastepLearner``, K steps a dispatch) on the
same pre-filled ring content at the same batch shape, with no collectors
running, so the numbers isolate the learner. Each block carries the JAX
bench's fields as {median, min, max, trials}:

  host_path / device_megastep:
    train_steps_per_sec    optimizer steps per wall second
    transitions_per_sec    steps/s x batch
    host_blocked_fraction  the wall time outside the learner's device
                           work (host path: its synchronised label, train
                           and TD calls; megastep: its ``step`` calls)
  speedup                  per trial, megastep over host steps/s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.obs import trace as trace_lib
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
  count to the metrics. Over a trainer's mesh every rank samples and
  labels the same batch from the same ring, trains on its block of it
  (``Trainer.shard_batch``) and takes the TD errors with the whole
  variables, so the priorities stay the same on every rank."""
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
    features, labels = trainer.shard_batch((features, labels))
    with trace_lib.span("learn/train_step"):
      state, metrics = trainer.train_step(state, features, labels,
                                          with_health=with_health)
  with clock("td"):
    td = updater.td_errors(state.full_variables(use_ema=True), batch,
                           targets)
  with clock("priority_write"):
    buffer.update_priorities(info.indices, td)
  return LearnerStep(state, metrics, td, targets, q_next, info)


def measure_learner_throughput(
    batch_size: int = 32,
    image_size: int = 16,
    action_size: int = 4,
    capacity: int = 256,
    steps_per_trial: int = 30,
    inner_steps: int = 10,
    trials: int = 3,
    gamma: float = 0.8,
    learning_rate: float = 3e-3,
    cem_num_samples: int = 16,
    cem_num_elites: int = 4,
    cem_iterations: int = 2,
    seed: int = 0,
    device: Device = None,
) -> Dict:
  """Times both learner paths on the same pre-filled prioritized ring.

  steps_per_trial must be a multiple of inner_steps (whole megasteps).
  The host path takes three warm-up steps and the megastep two dispatches
  (its eager warm-up and its capture on the card) outside all timing;
  then each takes `trials` timed windows of `steps_per_trial` steps."""
  if steps_per_trial % inner_steps:
    raise ValueError(f"steps_per_trial {steps_per_trial} must be a "
                     f"multiple of inner_steps {inner_steps}")
  device = resolve_device(device)
  spec = transition_spec(image_size, action_size)
  fill = _synthetic_transitions(capacity, image_size, action_size, seed + 17)
  cem_knobs = dict(action_size=action_size, gamma=gamma,
                   num_samples=cem_num_samples, num_elites=cem_num_elites,
                   iterations=cem_iterations, seed=seed + 13)

  def learner():
    model = TinyQCriticModel(
        image_size=image_size, action_size=action_size,
        optimizer_fn=optimizers.create_adam_optimizer(learning_rate))
    trainer = Trainer(model, seed=seed, device=device)
    return model, trainer, trainer.create_train_state()

  # --- the host path: sample, label, train, TD, write-back a step -------
  model, trainer, state = learner()
  buffer = ReplayBuffer(spec, capacity, batch_size, seed=seed,
                        prioritized=True)
  buffer.extend(fill)
  updater = BellmanUpdater(model, state.variables(use_ema=True),
                           device=device, **cem_knobs)
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

  # --- the megastep: the same content, K steps a dispatch ----------------
  from tensor2robot_tpu_torch.replay.device_buffer import (
      DeviceReplayBuffer,
      MegastepLearner,
  )
  model, trainer, state = learner()
  ring = DeviceReplayBuffer(spec, capacity, batch_size, seed=seed,
                            prioritized=True,
                            ingest_chunk=min(64, capacity), device=device)
  ring.extend(fill)
  megastep = MegastepLearner(model, trainer, ring, inner_steps=inner_steps,
                             **cem_knobs)
  megastep.refresh(state.variables(use_ema=True), step=0)
  for _ in range(2):  # the eager warm-up and the capture, outside timing
    state, _ = megastep.step(state)
  device_sps, device_blocked = [], []
  for _ in range(trials):
    in_step = 0.0
    start = time.perf_counter()
    for _ in range(steps_per_trial // inner_steps):
      begin = time.perf_counter()
      state, _ = megastep.step(state)
      in_step += time.perf_counter() - begin
    elapsed = time.perf_counter() - start
    device_sps.append(steps_per_trial / elapsed)
    device_blocked.append(max(0.0, 1.0 - in_step / elapsed))

  def block(sps, blocked):
    return {"train_steps_per_sec": _spread(sps, 2),
            "transitions_per_sec": _spread([s * batch_size for s in sps], 1),
            "host_blocked_fraction": _spread(blocked, 3)}

  return {
      "batch_size": batch_size,
      "inner_steps": inner_steps,
      "steps_per_trial": steps_per_trial,
      "prioritized": True,
      "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu"),
      "host_path": block(host_sps, host_blocked),
      "device_megastep": block(device_sps, device_blocked),
      "speedup": _spread([d / h for d, h in zip(device_sps, host_sps)], 2),
      "compile_counts": {**updater.compile_counts,
                         **megastep.compile_counts, **ring.compile_counts},
      "note": (
          "same batch shape and pre-filled ring content, no collectors: the "
          "host path samples, labels, trains, computes TD and writes "
          "priorities back each optimizer step; the megastep runs "
          "inner_steps of them a dispatch (CUDA graphs on the card). "
          "host_blocked_fraction counts the wall time outside the host "
          "path's synchronised label, train and TD calls, and outside the "
          "megastep's step calls."),
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


def fused_resume_parity(k1: int, k2: int, seed: int = 0,
                        device: Device = None, flagship: bool = False
                        ) -> Dict:
  """The device-resident path's crash-resume bar: k1 + k2 megastep
  dispatches straight through against k1 dispatches, a checkpoint through
  the loop's own ``_save_fused_checkpoint``, a fresh loop's
  ``_restore_fused_checkpoint`` and k2 more. Metrics, parameters and the
  ring must agree bit for bit.

  A frozen ring of 256 filled once, batch 32, K 5 and a target refresh
  after the first dispatch; TinyQ at 16x16 (CEM 16/4/2) or, with
  `flagship`, the production loop's 64x64 critic (CEM 64/6/3). On the GPU
  it runs with cuDNN deterministic."""
  import tempfile

  from tensor2robot_tpu_torch.replay.loop import ReplayTrainLoop
  device = resolve_device(device)
  config = ReplayLoopConfig(
      device_resident=True, image_size=64 if flagship else 16,
      batch_size=32, capacity=256, min_fill=32, megastep_inner=5,
      ingest_chunk=64, seed=seed, checkpoint_every=5 * k1,
      cem_num_samples=64 if flagship else 16,
      cem_num_elites=6 if flagship else 4,
      cem_iterations=3 if flagship else 2,
      learning_rate=1e-4 if flagship else 3e-3)
  fill = _synthetic_transitions(256, config.image_size, config.action_size,
                                seed + 17)

  def fresh(logdir, resume=False):
    model = None if flagship else TinyQCriticModel(
        image_size=config.image_size, action_size=config.action_size,
        optimizer_fn=optimizers.create_adam_optimizer(config.learning_rate))
    replay = ReplayTrainLoop(dataclasses.replace(config, resume=resume),
                             logdir, model=model, device=device)
    replay.writer.close()  # no run: nothing is written
    state = replay.trainer.create_train_state()
    learner = replay._megastep_learner()
    learner.refresh(state.variables(use_ema=True), step=0)
    return replay, state, learner

  def run(state, learner, first, dispatches):
    metrics = []
    for outer in range(first, first + dispatches):
      state, values = learner.step(state)
      metrics.append(values)
      if outer == 1:
        learner.refresh(state.variables(use_ema=True), 5)
    return state, metrics

  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    with tempfile.TemporaryDirectory(prefix="fused_resume_") as root:
      oracle, state, learner = fresh(os.path.join(root, "oracle"))
      oracle.buffer.extend(fill)
      state, want = run(state, learner, 1, k1 + k2)
      first, state1, learner1 = fresh(os.path.join(root, "run"))
      first.buffer.extend(fill)
      state1, got = run(state1, learner1, 1, k1)
      first._save_fused_checkpoint(5 * k1, state1, learner1, {}, [])
      saved = first.buffer.state.arrays()
      del first, state1, learner1
      resumed, state2, learner2 = fresh(os.path.join(root, "run"),
                                        resume=True)
      state2, restored_step, _ = resumed._restore_fused_checkpoint(
          state2, learner2)
      restored = resumed.buffer.state.arrays()
      ring_restored = all(np.array_equal(value, restored[key])
                          for key, value in saved.items())
      state2, rest = run(state2, learner2, k1 + 1, k2)
  finally:
    torch.backends.cudnn.deterministic = deterministic
  params_equal = all(torch.equal(param, state2.params[name])
                     for name, param in state.params.items())
  final_ring = resumed.buffer.state.arrays()
  ring_equal = all(np.array_equal(value, final_ring[key])
                   for key, value in oracle.buffer.state.arrays().items())
  deltas = [abs(a[key] - b[key]) for a, b in zip(want[k1:], rest)
            for key in a]
  return {
      "k1": k1, "k2": k2, "inner_steps": config.megastep_inner,
      "model": "flagship_64x64" if flagship else "tinyq_16x16",
      "restored_step": restored_step,
      "ring_restored_bit_equal": bool(ring_restored),
      "pre_crash_metrics_equal": got == want[:k1],
      "post_resume_metrics_equal": rest == want[k1:],
      "max_post_resume_metric_delta": max(deltas, default=0.0),
      "params_bit_equal": bool(params_equal),
      "ring_bit_equal": bool(ring_equal),
      "parity_ok": bool(restored_step == 5 * k1 and ring_restored
                        and got == want[:k1] and rest == want[k1:]
                        and params_equal and ring_equal),
  }
