"""The QT-Opt replay loop's pieces: transition schema, config, collector,
and the eval against the retry env's analytic Q*.

Counterpart of parts of ``tensor2robot_tpu/replay/loop.py``: the host
loop there collects -> replays -> Bellman-labels -> trains. This module
holds what that loop's learner and collectors need:
- ``transition_spec``: the loop's transition schema (uint8 wire images);
- ``ReplayLoopConfig``: the loop's knobs, field for field with the JAX
  defaults;
- ``CollectorWorker``: a fleet of ``GraspRetryEnv``s stepped in lockstep
  through one batched policy call, with the JAX exploration mix and
  scene-seed formula (numpy only: the same bits on the same seeds);
- ``eval_transitions`` / ``evaluate_td``: the held-out eval set with its
  analytic targets, and |Q - Q*| over it.

The learner's step itself is ``learner_bench.host_learner_step``. Not yet
ported, and named where asked for: ``ReplayTrainLoop`` with its
``_HotReloadPredictor`` (the next slice, with ``CEMFleetPolicy``, item 9,
and the health reductions, item 4), the device-resident, vector-actor and
Anakin paths (item 10), the mesh (item 15), loop checkpoints and the
profiler window (with ``ReplayTrainLoop``, item 8), and the collector's
trace span, flight recorder and watchdog (the obs tier, item 15).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch.replay.ingest import TransitionQueue
from tensor2robot_tpu_torch.research.qtopt import cem
from tensor2robot_tpu_torch.research.qtopt import synthetic_grasping as sg
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts


def transition_spec(image_size: int, action_size: int) -> ts.TensorSpecStruct:
  """The loop's transition schema (uint8 wire images, Bellman leaves)."""
  image_shape = (image_size, image_size, 3)
  return ts.TensorSpecStruct({
      "image": ts.ExtendedTensorSpec(image_shape, np.uint8, name="image"),
      "action": ts.ExtendedTensorSpec((action_size,), np.float32,
                                      name="action"),
      "reward": ts.ExtendedTensorSpec((), np.float32, name="reward"),
      "done": ts.ExtendedTensorSpec((), np.float32, name="done"),
      "next_image": ts.ExtendedTensorSpec(image_shape, np.uint8,
                                          name="next_image"),
  })


class CollectorWorker:
  """One thread driving a fleet of GraspRetryEnvs through a policy.

  All `num_envs` envs step in LOCKSTEP through one batched policy call
  (``policy(images) -> (num_envs, A)``); an env that finishes its episode
  flushes it to the queue and resets at once, keeping the batch shape
  constant. ``step_once`` steps the fleet on the caller's thread;
  ``start`` runs it on a thread of its own until ``stop``.
  """

  def __init__(self, policy, queue: TransitionQueue, image_size: int,
               num_envs: int = 4, max_attempts: int = 4,
               seed: int = 0, grasp_radius: float = 0.35,
               exploration_epsilon: float = 0.2,
               scripted_fraction: float = 0.25,
               flight_recorder=None, watchdog=None):
    if flight_recorder is not None or watchdog is not None:
      raise NotImplementedError(
          "CollectorWorker's flight_recorder= and watchdog= hooks wait for "
          "ROADMAP.md's flagship item 15 (the obs tier).")
    self._policy = policy
    self._queue = queue
    # Exploration mix, QT-Opt parity: the logs are seeded by SCRIPTED
    # grasps plus noisy on-policy actions. A cold random Q cannot be the
    # only success source: with rare positives the critic fits the base
    # rate and the CEM max never rises. epsilon draws uniform actions;
    # scripted_fraction draws near-object actions from the oracle pose.
    self._epsilon = exploration_epsilon
    self._scripted = scripted_fraction
    self._explore_rng = np.random.default_rng(seed + 555)
    self._envs = [
        sg.GraspRetryEnv(image_size=image_size, max_attempts=max_attempts,
                         radius=grasp_radius)
        for _ in range(num_envs)
    ]
    self._seed = seed
    self._next_scene = 0
    self._records: List[Dict[str, list]] = [
        {"actions": [], "rewards": [], "dones": []}
        for _ in range(num_envs)
    ]
    self.episodes = 0
    self.successes = 0
    self.env_steps = 0
    self.errors: List[BaseException] = []
    self._stop = threading.Event()
    self._thread = threading.Thread(target=self._run, daemon=True)
    self._reset_all()

  def _reset_all(self) -> None:
    for env in self._envs:
      env.reset(self._scene_seed())

  def start(self) -> None:
    self._thread.start()

  def request_stop(self) -> None:
    """Signals the thread; returns immediately (never raises)."""
    self._stop.set()

  def stop(self, timeout: float = 30.0) -> None:
    """Signal + join + surface any recorded error. A multi-collector
    owner should request_stop() on EVERY worker first, then join."""
    self.request_stop()
    self._thread.join(timeout)
    if self._thread.is_alive():
      raise RuntimeError(f"collector did not stop within {timeout} s")
    if self.errors:
      raise RuntimeError("collector died") from self.errors[0]

  def _scene_seed(self) -> int:
    seed = self._seed * 1_000_003 + self._next_scene
    self._next_scene += 1
    return seed

  def _run(self) -> None:
    try:
      while not self._stop.is_set():
        self.step_once()
    except Exception as e:  # noqa: BLE001 — surfaced through stop()
      self.errors.append(e)

  def step_once(self) -> None:
    """One lockstep control step across the whole env fleet."""
    images = [env.image for env in self._envs]
    actions = np.asarray(self._policy(images))
    draw = self._explore_rng.random(len(self._envs))
    uniform = self._explore_rng.uniform(
        -1.0, 1.0, actions.shape).astype(np.float32)
    scripted = uniform.copy()
    noise = self._explore_rng.normal(
        0.0, 0.12, (len(self._envs), 2)).astype(np.float32)
    scripted[:, :2] = np.clip(
        np.stack([env.target for env in self._envs]) + noise, -1.0, 1.0)
    actions = np.where((draw < self._epsilon)[:, None], uniform, actions)
    actions = np.where(
        (draw >= 1.0 - self._scripted)[:, None], scripted, actions)
    self.env_steps += len(self._envs)
    for env, record, action in zip(self._envs, self._records, actions):
      scene = env.image
      reward, done, truncated = env.step(np.asarray(action))
      record["actions"].append(np.asarray(action, np.float32))
      record["rewards"].append(reward)
      # Bootstrap through truncation: only SUCCESS terminates value.
      record["dones"].append(float(done))
      if done or truncated:
        t = len(record["actions"])
        self._queue.put_episode({
            # Static scene: every observation in the episode (the closing
            # next-state included) is the same rendered image.
            "images": np.stack([scene] * (t + 1)),
            "actions": np.stack(record["actions"]),
            "rewards": np.asarray(record["rewards"], np.float32),
            "dones": np.asarray(record["dones"], np.float32),
        })
        self.episodes += 1
        self.successes += int(done)
        record["actions"], record["rewards"], record["dones"] = [], [], []
        env.reset(self._scene_seed())


# Options whose paths wait for a later ROADMAP.md item, with their defaults:
# a config that asks for one raises by name.
_WAITING = {
    "device_resident": (False, "item 10 (the device-resident ring)"),
    "vector_actors": (False, "item 10 (the vector actor fleet)"),
    "anakin": (False, "item 10 (the Anakin loop)"),
    "mesh_dp": (0, "item 15 (the parallel tier)"),
    "mesh_tp": (1, "item 15 (the parallel tier)"),
    "zero1": (None, "item 15 (the parallel tier)"),
    "checkpoint_every": (0, "item 8 (ReplayTrainLoop's checkpoints)"),
    "resume": (False, "item 8 (ReplayTrainLoop's checkpoints)"),
    "checkpoint_dir": (None, "item 8 (ReplayTrainLoop's checkpoints)"),
    "health_halt": (False, "item 4 (the health reductions)"),
    "profile_window": (None, "item 8 (ReplayTrainLoop's profiler window)"),
}


@dataclass
class ReplayLoopConfig:
  """Knobs of the replay loop, field for field with the JAX defaults (the
  chipless smoke scale). The learner and collector read the first block;
  the rest belong to paths that wait for later items, and setting one off
  its default raises NotImplementedError naming the item."""
  image_size: int = 16
  action_size: int = 4
  batch_size: int = 32
  capacity: int = 512
  min_fill: int = 96
  num_buffer_shards: int = 2
  prioritized: bool = True
  gamma: float = 0.8
  learning_rate: float = 3e-3
  num_collectors: int = 1
  envs_per_collector: int = 4
  max_attempts: int = 3
  grasp_radius: float = 0.4
  queue_capacity: int = 512
  cem_num_samples: int = 16
  cem_num_elites: int = 4
  cem_iterations: int = 2
  exploration_epsilon: float = 0.25
  scripted_fraction: float = 0.25
  refresh_every: int = 15
  polyak_tau: Optional[float] = None  # None = hard target copy
  eval_every: int = 30
  eval_batches: int = 4
  log_every: int = 10
  seed: int = 0
  min_fill_timeout_s: float = 300.0
  model_kwargs: Dict = field(default_factory=dict)
  device_resident: bool = False
  megastep_inner: int = 10
  ingest_chunk: int = 64
  vector_actors: bool = False
  anakin: bool = False
  anakin_inner: int = 40
  anakin_train_every: int = 8
  anakin_bank_scenes: int = 512
  mesh_dp: int = 0
  mesh_tp: int = 1
  zero1: Optional[bool] = None
  precision: str = "f32"
  checkpoint_every: int = 0
  checkpoint_keep: int = 3
  resume: bool = False
  checkpoint_dir: Optional[str] = None
  health: bool = True
  health_halt: bool = False
  profile_window: Optional[Tuple[int, int]] = None

  def __post_init__(self):
    cem.validate_precision(self.precision)
    for name, (default, item) in _WAITING.items():
      if getattr(self, name) != default:
        raise NotImplementedError(
            f"ReplayLoopConfig.{name}={getattr(self, name)!r} waits for "
            f"ROADMAP.md's flagship {item}.")


def eval_transitions(config: ReplayLoopConfig):
  """Held-out random-action eval set WITH its analytic value targets.

  The retry env has a closed-form optimal Q: grasping at the object
  always succeeds, so V*(s) = 1 and Q*(s, a) = 1 if success(a) else gamma.
  Eval TD error is measured against THIS fixed point, not the moving
  target network: the Bellman residual of a random init is near zero by
  self-consistency, so it cannot witness learning; distance to Q* falls
  only if the updater propagates grasp reward through the CEM max.

  Returns (batches, q_star_per_batch).
  """
  c = config
  n = c.batch_size * c.eval_batches
  images, targets = sg.sample_scenes(
      n, image_size=c.image_size, seed=c.seed + 990_001,
      num_distractors=0, occlusion=False)
  rng = np.random.default_rng(c.seed + 990_002)
  # Class-balanced actions: half near-object, half uniform, so the metric
  # weighs the supervised arm (success -> 1) and the bootstrap arm (fail
  # -> gamma) comparably.
  actions = rng.uniform(-1.0, 1.0, (n, c.action_size)).astype(np.float32)
  near = rng.random(n) < 0.5
  noise = rng.normal(0.0, 0.12, (n, 2)).astype(np.float32)
  actions[near, :2] = np.clip(targets[near] + noise[near], -1.0, 1.0)
  success = sg.grasp_success(targets, actions,
                             c.grasp_radius).astype(np.float32)
  q_star = np.where(success > 0, 1.0, c.gamma).astype(np.float32)
  batches, stars = [], []
  for i in range(c.eval_batches):
    part = slice(i * c.batch_size, (i + 1) * c.batch_size)
    batches.append({
        "image": images[part],
        "action": actions[part],
        "reward": success[part],
        "done": success[part],
        "next_image": images[part],
    })
    stars.append(q_star[part])
  return batches, stars


def evaluate_td(updater, variables, eval_batches,
                eval_q_stars) -> Dict[str, float]:
  """|Q - Q*| and its square on the held-out set (the updater's TD
  closure; the targets are the analytic constants, so eval runs no CEM)."""
  tds = [updater.td_errors(variables, batch, q_star)
         for batch, q_star in zip(eval_batches, eval_q_stars)]
  td = np.concatenate(tds)
  return {
      "eval_td_error": float(np.mean(td)),
      "eval_q_loss": float(np.mean(np.square(td))),
  }
