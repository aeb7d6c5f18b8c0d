"""The vector actor fleet: one thread steps every env in lockstep.

Counterpart of ``tensor2robot_tpu/replay/actor.py``. The threaded
collectors (``loop.CollectorWorker``) step one ``GraspRetryEnv`` at a time
in Python; beside an eager learner their stepping holds the interpreter
that each of the learner's launches must take back. A ``VectorActor``
steps its whole fleet as one ``VectorGraspEnv.step`` numpy call, acts
through one ``CEMFleetPolicy`` bucket call (one CUDA graph replay, whose
wait releases the interpreter) and hands the fleet's transitions to
``TransitionQueue.put_batch`` as one fixed-size chunk, once a control
step:

- ``VectorActor``: one thread over a ``VectorGraspEnv``; ``step_once``
  owns its busy time, its env steps and the scene-seed counter;
- ``ActorFleet``: the actors (the envs split evenly), their threads, and
  the fleet's summed accounts. Its ``actors`` list has the surface of a
  ``CollectorWorker`` list, so ``ReplayTrainLoop`` stops either kind the
  same way.

Collection is the scalar collectors': the same retry budget, the same
epsilon-uniform and scripted near-object mix drawn in the same order from
``default_rng(seed + 555)``, the same scene-seed formula and the same
static-scene transitions (next_image is the scene; truncation bootstraps
with done 0), so the numpy draws and scenes are the JAX actor's bit for
bit.

Each actor thread beats an ``act/vector_actor`` heartbeat once a control
step (unregistered when the thread ends), wraps its policy call in an
``act/cem_policy`` span, and triggers the flight recorder when it dies.
``flight_recorder=`` and ``watchdog=`` default to the process singletons;
the replay loop passes its own.
"""

from __future__ import annotations

import threading
import time
from typing import List

import numpy as np

from tensor2robot_tpu_torch.obs import flight_recorder as flight_lib
from tensor2robot_tpu_torch.obs import trace as trace_lib
from tensor2robot_tpu_torch.obs import watchdog as watchdog_lib
from tensor2robot_tpu_torch.replay.ingest import TransitionQueue
from tensor2robot_tpu_torch.research.qtopt.synthetic_grasping import (
    VectorGraspEnv,
)


class VectorActor:
  """One thread stepping `num_envs` envs in lockstep through a batched
  policy: one ``policy(images)`` call, one ``VectorGraspEnv.step`` and one
  ``put_batch`` a control step."""

  def __init__(self, policy, queue: TransitionQueue, image_size: int,
               num_envs: int = 32, max_attempts: int = 4,
               seed: int = 0, grasp_radius: float = 0.35,
               exploration_epsilon: float = 0.2,
               scripted_fraction: float = 0.25,
               flight_recorder=None, watchdog=None):
    self._policy = policy
    self._queue = queue
    self._recorder = flight_recorder or flight_lib.get_recorder()
    self._watchdog = watchdog or watchdog_lib.get_watchdog()
    # The scalar collectors' exploration mix, draw order and stream.
    self._epsilon = exploration_epsilon
    self._scripted = scripted_fraction
    self._explore_rng = np.random.default_rng(seed + 555)
    self._env = VectorGraspEnv(
        num_envs, image_size=image_size, max_attempts=max_attempts,
        radius=grasp_radius)
    self._seed = seed
    self._next_scene = 0
    self.env_steps = 0
    self.busy_seconds = 0.0
    self.errors: List[BaseException] = []
    self._stop = threading.Event()
    self._thread = threading.Thread(target=self._run, daemon=True)

  @property
  def num_envs(self) -> int:
    return self._env.num_envs

  @property
  def episodes(self) -> int:
    return self._env.episodes

  @property
  def successes(self) -> int:
    return self._env.successes

  def reset(self) -> None:
    """Gives every env its first scene (``start`` does this)."""
    self._env.reset([self._scene_seed() for _ in range(self._env.num_envs)])

  def start(self) -> None:
    self.reset()
    self._thread.start()

  def request_stop(self) -> None:
    """Signals the thread; returns immediately (never raises)."""
    self._stop.set()

  def join(self, timeout: float = 30.0) -> bool:
    """Waits up to `timeout` s for the thread; True once it has ended."""
    self._thread.join(timeout)
    return not self._thread.is_alive()

  def stop(self, timeout: float = 30.0) -> None:
    """Signal + join + surface any recorded error. An owner of several
    actors should request_stop() on every one first, then join."""
    self.request_stop()
    if not self.join(timeout):
      raise RuntimeError(f"actor did not stop within {timeout} s")
    if self.errors:
      raise RuntimeError("actor died") from self.errors[0]

  def _scene_seed(self) -> int:
    # CollectorWorker's formula: one monotonic counter over the fleet.
    seed = self._seed * 1_000_003 + self._next_scene
    self._next_scene += 1
    return seed

  def _run(self) -> None:
    # One beat a control step; unregistered on exit, so a finished actor
    # never reads as a stalled one.
    heartbeat = self._watchdog.register("act/vector_actor")
    try:
      while not self._stop.is_set():
        self.step_once()
        heartbeat.beat()
    except Exception as e:  # noqa: BLE001 — surfaced through stop()
      self.errors.append(e)
      self._recorder.trigger(
          "actor_thread_exception", error=f"{type(e).__name__}: {e}")
    finally:
      self._watchdog.unregister(heartbeat)

  def step_once(self) -> None:
    """One batched control step: act, step, enqueue, fleet-wide.

    The scenes are copied BEFORE the env steps: auto-reset overwrites a
    finished env's row in place, and a terminal transition's observation
    and next_image must be the old scene."""
    begin = time.perf_counter()
    env = self._env
    n = env.num_envs
    scenes = env.images.copy()
    targets = env.targets.copy()
    with trace_lib.span("act/cem_policy", envs=n):
      actions = np.asarray(self._policy(scenes))
    draw = self._explore_rng.random(n)
    uniform = self._explore_rng.uniform(
        -1.0, 1.0, actions.shape).astype(np.float32)
    scripted = uniform.copy()
    noise = self._explore_rng.normal(0.0, 0.12, (n, 2)).astype(np.float32)
    scripted[:, :2] = np.clip(targets + noise, -1.0, 1.0)
    actions = np.where((draw < self._epsilon)[:, None], uniform, actions)
    actions = np.where(
        (draw >= 1.0 - self._scripted)[:, None], scripted, actions)
    rewards, dones, _ = env.step(actions, seed_fn=self._scene_seed)
    self.env_steps += n
    # One fixed-size chunk a step; image and next_image alias the same
    # snapshot (the scene is static; the ring copies at its door).
    self._queue.put_batch({
        "image": scenes,
        "action": actions.astype(np.float32, copy=False),
        "reward": rewards,
        "done": dones,
        "next_image": scenes,
    })
    self.busy_seconds += time.perf_counter() - begin


class ActorFleet:
  """Owns the vector actors: `num_actors` actors over `total_envs`
  split evenly (one actor, one bucket, is the default), their lifecycle
  and the fleet's accounts."""

  def __init__(self, policy, queue: TransitionQueue, image_size: int,
               total_envs: int, max_attempts: int = 4, seed: int = 0,
               grasp_radius: float = 0.35,
               exploration_epsilon: float = 0.2,
               scripted_fraction: float = 0.25,
               num_actors: int = 1,
               flight_recorder=None, watchdog=None):
    if num_actors < 1 or total_envs % num_actors:
      raise ValueError(
          f"total_envs {total_envs} must split evenly over "
          f"num_actors {num_actors}")
    self.actors = [
        VectorActor(policy, queue, image_size,
                    num_envs=total_envs // num_actors,
                    max_attempts=max_attempts, seed=seed + i,
                    grasp_radius=grasp_radius,
                    exploration_epsilon=exploration_epsilon,
                    scripted_fraction=scripted_fraction,
                    flight_recorder=flight_recorder, watchdog=watchdog)
        for i in range(num_actors)
    ]

  def start(self) -> None:
    for actor in self.actors:
      actor.start()

  def request_stop(self) -> None:
    for actor in self.actors:
      actor.request_stop()

  def stop(self, timeout: float = 30.0) -> None:
    """Signals every actor before joining any (one dead actor must not
    leave its siblings running); raises the first recorded error."""
    self.request_stop()
    errors: List[BaseException] = []
    for actor in self.actors:
      if not actor.join(timeout):
        errors.append(RuntimeError(f"an actor did not stop within "
                                   f"{timeout} s"))
      errors.extend(actor.errors)
    if errors:
      raise RuntimeError(
          f"{len(errors)} actor error(s); first shown") from errors[0]

  # --- the fleet's accounts -------------------------------------------------

  @property
  def env_steps(self) -> int:
    return sum(actor.env_steps for actor in self.actors)

  @property
  def episodes(self) -> int:
    return sum(actor.episodes for actor in self.actors)

  @property
  def successes(self) -> int:
    return sum(actor.successes for actor in self.actors)

  def busy_seconds(self) -> float:
    """Seconds the actor threads spent inside control steps (policy call,
    env step, enqueue), summed over the actors."""
    return sum(actor.busy_seconds for actor in self.actors)
