"""The closed QT-Opt loop: collect -> replay -> Bellman-label -> train.

Counterpart of ``tensor2robot_tpu/replay/loop.py``'s host path. Threaded
collectors act through a ``CEMFleetPolicy`` over a ``_HotReloadPredictor``
while the learner thread drains their episodes into the ring, samples,
labels with CEM-maximized Bellman targets against the lagged target net,
trains (with the health reductions), writes TD errors back as priorities,
and every ``refresh_every`` steps hands the collectors and the target net
a snapshot of the EMA variables:

- ``transition_spec``: the loop's transition schema (uint8 wire images);
- ``ReplayLoopConfig``: the loop's knobs, field for field with the JAX
  defaults;
- ``CollectorWorker``: a fleet of ``GraspRetryEnv``s stepped in lockstep
  through one batched policy call, with the JAX exploration mix and
  scene-seed formula (numpy only: the same bits on the same seeds);
- ``eval_transitions`` / ``evaluate_td``: the held-out eval set with its
  analytic targets, and |Q - Q*| over it;
- ``_HotReloadPredictor``: the in-memory predictor the learner swaps;
- ``ReplayTrainLoop``: owns every piece; ``run(num_steps)`` drives the
  host path (the learner's step is ``learner_bench.host_learner_step``)
  or, with ``device_resident``, the device-resident ring and the megastep
  learner (``device_buffer.MegastepLearner``: K steps a dispatch as CUDA
  graphs on the card), or, with ``anakin``, the fused loop
  (``anakin.AnakinLoop``: the env, acting, the extend and the learner all
  on the card, no collector threads), and returns the JAX result's keys;
  its ``obs`` block carries the executable ledger's ``attribution`` and
  the spans' ``trace_stage_counts``.
  With ``vector_actors`` one ``actor.VectorActor`` steps every env through
  one bucket pinned to the fleet; with ``checkpoint_every`` it saves the
  train state with a sidecar (target net, ring, counters, eval history,
  health baselines) and with ``resume`` continues from the newest valid
  one at its exact step; ``profile_window`` traces a range of steps.

**The executable ledger.** Each loop owns one ``obs_ledger``
(``obs/ledger.py``) and hands it to every program it builds: the host
train step (``train_step``, its seconds the train stage of
``learner_bench.host_learner_step``) and the parameters' health
reductions (``health_summary``), the Bellman updater's closures, the
device ring's functions, the megastep, the Anakin period and the acting
buckets. Each registers once a build with its FLOPs and records its
dispatches; the result's ``compile_counts`` (the JAX keys) and
``obs.attribution`` (each program's dispatches, seconds, share of the
run's window from the start of ``run``, FLOPs, estimated MFU, and the
shares by scoring tier) both read it. The ledger is per run and is not
checkpointed.

**The obs spine.** Each loop owns a flight recorder dumping into its
logdir (attached to the process tracer for the run) and takes the process
metric registry and watchdog unless given its own: the learner and feeder
beat heartbeats (``replay/learner``, ``replay/feeder``), each collector
beats ``act/collector``, metric records go through registry gauges and the
one ``flush_to`` bridge (the JSONL records keep their schema), and the
stages open spans (``act/cem_policy``, ``extend/drain``,
``learn/train_step``, ``learn/megastep``, ``learn/anakin_step``,
``replay/eval``, ``replay/checkpoint``, ``replay/fused_checkpoint``) that
show as ``record_function`` ranges in a ``profile_window``'s trace. A
thread's or the loop's exception is a flight-recorder trigger.

**Threads and the card.** The collectors and the learner share one
device and its default stream, so work is ordered as it is submitted:
the learner's clone of the EMA variables precedes the hot-reload copy
that reads it. The policy's lock covers each call's copy-in, replay and
copy-out. The collectors' bucket is captured before their threads start,
so no capture ever runs beside another thread's launches.

**Over a mesh of ranks** (``mesh_dp``, ``mesh_tp``, ``zero1``; one
process a rank, ``parallel/``): the trainer trains over
``{"data": mesh_dp, "model": mesh_tp}`` (ZeRO-1 by default when
``mesh_dp > 1``, the model's own partition rules when ``mesh_tp > 1``),
the device ring splits its capacity over the data axis, and the Anakin
path splits its env fleet too (``anakin.AnakinLoop``). Collectors and
actors run on the primary rank alone: what their threads produce depends
on thread timing, so the primary drains the queue and hands each drained
batch to every rank (one broadcast), and every rank extends its ring
with the same rows. Each rank then samples the same batch, trains on its
block of it, and writes the same priorities; the result's
``param_sharding`` says how the final parameters lie. Checkpoints gather
to the one-rank layout, the primary writes them, and the sidecar carries
the mesh's geometry: a resume on another mesh refuses and names both.
The primary alone writes the metric files; every other rank writes under
``<logdir>/rank<k>``.

Not ported, and named where asked for: the fault seam (``fault_plan=``;
item 15c).
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import threading
import time
import types
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from tensor2robot_tpu_torch import Device, modes
from tensor2robot_tpu_torch.obs import flight_recorder as flight_lib
from tensor2robot_tpu_torch.obs import health as health_lib
from tensor2robot_tpu_torch.obs import ledger as ledger_lib
from tensor2robot_tpu_torch.obs import registry as registry_lib
from tensor2robot_tpu_torch.obs import trace as trace_lib
from tensor2robot_tpu_torch.obs import watchdog as watchdog_lib
from tensor2robot_tpu_torch.parallel import collectives, distributed
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.predictors.abstract_predictor import (
    AbstractPredictor,
    checked_swap,
)
from tensor2robot_tpu_torch.replay.bellman import BellmanUpdater
from tensor2robot_tpu_torch.replay.ingest import ReplayFeeder, TransitionQueue
from tensor2robot_tpu_torch.replay.ring_buffer import (
    ReplayBuffer,
    ShardedReplayBuffer,
)
from tensor2robot_tpu_torch.research.qtopt import cem
from tensor2robot_tpu_torch.research.qtopt import synthetic_grasping as sg
from tensor2robot_tpu_torch.serving.bucketing import BucketLadder
from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
from tensor2robot_tpu_torch.train import checkpoints as checkpoints_lib
from tensor2robot_tpu_torch.train.trainer import Trainer
from tensor2robot_tpu_torch.utils import backoff, optimizers
from tensor2robot_tpu_torch.utils.metric_writer import MetricWriter
from tensor2robot_tpu_torch.utils.profiling import ProfilerHook

_log = logging.getLogger(__name__)


def _loop_mesh(config) -> Optional[mesh_lib.Mesh]:
  """The loop's ``{"data": mesh_dp, "model": mesh_tp}`` mesh over the
  ranks of the process group (None for ``mesh_dp == 0``). Refuses a mesh
  the ranks present do not fill exactly: it neither shrinks nor leaves a
  rank idle."""
  if not config.mesh_dp:
    return None
  if config.mesh_dp < 0 or config.mesh_tp < 1:
    raise ValueError(f"mesh {config.mesh_dp}x{config.mesh_tp}: mesh_dp must "
                     "be >= 0 and mesh_tp >= 1")
  needed = config.mesh_dp * config.mesh_tp
  ranks = distributed.process_count()
  if ranks != needed:
    raise ValueError(
        f"mesh {config.mesh_dp}x{config.mesh_tp} needs {needed} rank(s), "
        f"have {ranks}. Start {needed} ranks (python -m "
        f"torch.distributed.run --nproc-per-node {needed}, or "
        "parallel.launch) or change the mesh.")
  return mesh_lib.create_mesh({"data": config.mesh_dp,
                               "model": config.mesh_tp})


def param_sharding_summary(state) -> Dict:
  """How the final parameters lie (the JAX loop's ``param_sharding``):
  the leaves, those the model axis splits, and the parameter bytes whole
  against this rank's resident blocks (the memory tensor parallelism
  exists to shrink)."""
  layout = state.layout
  whole = (dict(layout.model.module.named_parameters())
           if layout is not None else state.params)
  sharded = 0
  total = per_rank = 0
  for key, value in state.params.items():
    size = value.element_size()
    total += whole[key].numel() * size
    per_rank += value.numel() * size
    if layout is not None and "model" in layout.specs[key].axes():
      sharded += 1
  return {"total_leaves": len(state.params),
          "model_sharded_leaves": sharded,
          "param_bytes_total": int(total),
          "param_bytes_per_replica": int(per_rank)}


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
  ``start`` runs it on a thread of its own until ``stop``, beating an
  ``act/collector`` heartbeat once a control step; its death triggers the
  flight recorder. ``flight_recorder=`` and ``watchdog=`` default to the
  process singletons; the replay loop passes its own.
  """

  def __init__(self, policy, queue: TransitionQueue, image_size: int,
               num_envs: int = 4, max_attempts: int = 4,
               seed: int = 0, grasp_radius: float = 0.35,
               exploration_epsilon: float = 0.2,
               scripted_fraction: float = 0.25,
               flight_recorder=None, watchdog=None):
    self._policy = policy
    self._queue = queue
    self._recorder = flight_recorder or flight_lib.get_recorder()
    self._watchdog = watchdog or watchdog_lib.get_watchdog()
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

  def join(self, timeout: float = 30.0) -> bool:
    """Waits up to `timeout` s for the thread; True once it has ended."""
    self._thread.join(timeout)
    return not self._thread.is_alive()

  def stop(self, timeout: float = 30.0) -> None:
    """Signal + join + surface any recorded error. A multi-collector
    owner should request_stop() on EVERY worker first, then join."""
    self.request_stop()
    if not self.join(timeout):
      raise RuntimeError(f"collector did not stop within {timeout} s")
    if self.errors:
      raise RuntimeError("collector died") from self.errors[0]

  def _scene_seed(self) -> int:
    seed = self._seed * 1_000_003 + self._next_scene
    self._next_scene += 1
    return seed

  def _run(self) -> None:
    # One beat a control step; unregistered on exit, so a stopped
    # collector never reads as stalled.
    heartbeat = self._watchdog.register("act/collector")
    try:
      while not self._stop.is_set():
        self.step_once()
        heartbeat.beat()
    except Exception as e:  # noqa: BLE001 — surfaced through stop()
      self.errors.append(e)
      self._recorder.trigger("collector_thread_exception",
                             error=f"{type(e).__name__}: {e}")
    finally:
      self._watchdog.unregister(heartbeat)

  def step_once(self) -> None:
    """One lockstep control step across the whole env fleet."""
    images = [env.image for env in self._envs]
    with trace_lib.span("act/cem_policy", envs=len(self._envs)):
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


# The config that resumes each path's checkpoints.
_PATH_FLAGS = {"host": "device_resident=False and anakin=False",
               "device-resident": "device_resident=True",
               "anakin": "anakin=True"}


@dataclass
class ReplayLoopConfig:
  """Knobs of the replay loop, field for field with the JAX defaults (the
  chipless smoke scale). The host loop reads the first block,
  ``vector_actors``, the checkpoint, health and profile fields;
  ``device_resident`` adds ``megastep_inner`` and ``ingest_chunk``;
  ``anakin`` adds ``anakin_inner``, ``anakin_train_every`` and
  ``anakin_bank_scenes`` (its fleet is ``num_collectors *
  envs_per_collector`` envs, which is also its ring's chunk). Every path
  reads ``mesh_dp`` (0: one rank, no mesh), ``mesh_tp`` and ``zero1``
  (None: ZeRO-1 when ``mesh_dp > 1``): the loop then spans ``mesh_dp *
  mesh_tp`` ranks (see the module's docstring)."""
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
  # The CEM scoring tier ("f32", "bf16", "int8") of acting and labels on
  # every path: the host BellmanUpdater, the collectors' and the vector
  # actor's CEMFleetPolicy, the megastep and the Anakin loop. Gradients,
  # TD errors and the eval metric stay float32.
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


def _raise_first(errors: List[BaseException]) -> None:
  if errors:
    raise RuntimeError(
        f"{len(errors)} collector error(s); first shown") from errors[0]


class _HotReloadPredictor(AbstractPredictor):
  """In-memory predictor whose variables the learner swaps.

  ``device_fn()`` returns a stable fn (the model's ``predict_fn``) and the
  current variables, on their device; ``update()`` swaps the variables
  and their version in one assignment and bumps ``model_version``, as a
  new export landing would. The caller must not update the tensors it
  hands over in place: the learner hands over a clone.
  """

  def __init__(self, model, variables):
    self._model = model
    self._device = next(iter(variables.values())).device
    self._served = (self._place(variables), 0)

  def _place(self, variables) -> Dict[str, torch.Tensor]:
    return {key: torch.as_tensor(value).to(self._device)
            for key, value in variables.items()}

  def update(self, variables) -> None:
    self._served = (self._place(variables), self._served[1] + 1)

  def set_variables(self, variables, version: Optional[int] = None,
                    cast: bool = False) -> None:
    """``update()`` carrying the candidate's export version, so
    ``model_version`` names the promoted learner step, through the
    predictors' guard (``checked_swap``): the served keys, shapes and
    dtypes, a floating dtype drift cast onto the served dtypes only with
    ``cast=True``."""
    self._served = (checked_swap(self._served[0], variables, cast),
                    self._served[1] + 1 if version is None else int(version))

  def restore(self, timeout_s: float = 0.0,
              raise_on_timeout: bool = False) -> bool:
    return True

  def init_randomly(self) -> None:
    pass

  def predict(self, features) -> Dict[str, np.ndarray]:
    inputs = {key: torch.as_tensor(np.asarray(value)).to(self._device)
              for key, value in dict(features).items()}
    outputs = self._model.predict_fn(self._served[0], inputs)
    return {key: value.float().cpu().numpy()
            for key, value in outputs.items()}

  def device_fn(self):
    return self._model.predict_fn, self._served[0]

  def get_feature_specification(self) -> ts.TensorSpecStruct:
    return ts.flatten_spec_structure(
        self._model.get_feature_specification(modes.PREDICT))

  @property
  def model_version(self) -> int:
    return self._served[1]


class ReplayTrainLoop:
  """Owns every piece of the loop; ``run(num_steps)`` drives it.

  Args:
    config: the loop's knobs.
    logdir: where the metric files go.
    model: any CriticModel with uint8 image + action features (matching
      ``config.image_size`` / ``action_size``). Default: the flagship
      QTOptGraspingModel on the uint8 wire, the production loop. The smoke
      passes ``replay/smoke.TinyQCriticModel``.
    flight_recorder: the loop's recorder (default: one of its own,
      dumping into `logdir`).
    watchdog: where the loop's threads beat (default: the process
      watchdog, whose monitor runs only once its owner starts it).
    fault_plan: the fault seam; it waits for ``ROADMAP.md``'s flagship
      item 15c and raises when given.
    device: where the learner and the policy run; the GPU unless 'cpu'
      is asked for.
  """

  def __init__(self, config: ReplayLoopConfig, logdir: str, model=None,
               flight_recorder: Optional[flight_lib.FlightRecorder] = None,
               watchdog: Optional[watchdog_lib.Watchdog] = None,
               fault_plan=None, device: Device = None):
    if fault_plan is not None:
      raise NotImplementedError(
          "ReplayTrainLoop(fault_plan=) injects faults through "
          "obs/faults.py, which waits for ROADMAP.md's flagship item 15c "
          "(the obs tier).")
    self.config = config
    self.logdir = logdir
    self.model = model if model is not None else self._default_model()
    # Every program the loop builds registers here (see the docstring).
    self.obs_ledger = ledger_lib.ExecutableLedger()
    self._run_started = None
    self._health_registered = False
    self.registry = registry_lib.get_registry()
    self.recorder = flight_recorder or flight_lib.FlightRecorder(
        dump_dir=logdir)
    self.watchdog = watchdog or watchdog_lib.get_watchdog()
    self._learner_hb = self._feeder_hb = None
    self.health_monitor = None
    if config.health:
      self.health_monitor = health_lib.HealthMonitor(
          rules=health_lib.default_rules(capacity=config.capacity),
          registry=self.registry, recorder=self.recorder,
          halt_on_breach=config.health_halt)
    self.mesh = _loop_mesh(config)
    self._mesh_feed = mesh_lib.is_distributed(self.mesh)
    self._primary = distributed.is_primary()
    self.zero1 = bool(config.zero1 if config.zero1 is not None
                      else config.mesh_dp > 1)
    param_specs = None
    if self.mesh is not None and config.mesh_tp > 1:
      from tensor2robot_tpu_torch.parallel import tp_rules
      param_specs = tp_rules.partition_specs_for_model(
          self.model, self.mesh, axis="model")
    self.trainer = Trainer(self.model, seed=config.seed, device=device,
                           mesh=self.mesh, param_specs=param_specs,
                           shard_optimizer_state=self.zero1)
    self.writer = MetricWriter(
        logdir if self._primary
        else os.path.join(logdir, f"rank{distributed.process_index()}"))
    spec = transition_spec(config.image_size, config.action_size)
    if config.device_resident or config.anakin:
      # The device ring is the whole ring on these paths: the host shards
      # exist to relieve a host lock it does not have. The Anakin loop
      # extends it at one chunk, the env fleet's width.
      from tensor2robot_tpu_torch.replay.device_buffer import (
          DeviceReplayBuffer,
      )
      chunk = (config.num_collectors * config.envs_per_collector
               if config.anakin else config.ingest_chunk)
      if config.anakin and config.capacity < chunk:
        # The ring would clamp its chunk below the fleet, and the loop
        # would then refuse a chunk that names the wrong knob.
        raise ValueError(
            f"anakin=True needs capacity >= the env fleet width "
            f"(num_collectors {config.num_collectors} x "
            f"envs_per_collector {config.envs_per_collector} = {chunk}): "
            f"capacity {config.capacity} would clamp the extend chunk "
            "below the fleet")
      self.buffer = DeviceReplayBuffer(
          spec, config.capacity, config.batch_size, seed=config.seed,
          prioritized=config.prioritized, ingest_chunk=chunk,
          mesh=self.trainer.mesh, ledger=self.obs_ledger,
          device=self.trainer.device)
    elif config.num_buffer_shards > 1:
      self.buffer = ShardedReplayBuffer(
          spec, config.capacity, config.batch_size,
          num_shards=config.num_buffer_shards, seed=config.seed,
          prioritized=config.prioritized)
    else:
      self.buffer = ReplayBuffer(
          spec, config.capacity, config.batch_size, seed=config.seed,
          prioritized=config.prioritized)
    self.queue = TransitionQueue(config.queue_capacity,
                                 registry=self.registry,
                                 flight_recorder=self.recorder)
    self.feeder = ReplayFeeder(self.queue, self.buffer, config.min_fill)
    self._collectors: List = []
    self._ckpt_manager = None
    self._saved_step = None
    if config.checkpoint_every or config.resume:
      self.checkpoint_root = (config.checkpoint_dir
                              or os.path.join(logdir, "checkpoints"))
      # Synchronous saves: the sidecar lands after the step, so a present
      # sidecar means a usable checkpoint.
      self._ckpt_manager = checkpoints_lib.CheckpointManager(
          self.checkpoint_root, max_to_keep=config.checkpoint_keep)

  # --- helpers -------------------------------------------------------------

  def _default_model(self):
    """The production model: flagship Q-fn, uint8 wire, GroupNorm (the
    loop serves PREDICT-mode variables from step 0, where BatchNorm's
    cold running statistics would poison the early targets)."""
    from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
        QTOptGraspingModel,
    )
    c = self.config
    return QTOptGraspingModel(
        image_size=c.image_size, action_size=c.action_size,
        uint8_images=True, norm="group",
        optimizer_fn=optimizers.create_adam_optimizer(c.learning_rate),
        **c.model_kwargs)

  @staticmethod
  def _host_variables(state) -> Dict[str, torch.Tensor]:
    """A detached clone of the whole EMA variables on their device (over a
    mesh every rank gathers its blocks): the learner updates its tensors
    in place, so collectors never serve those."""
    return {key: value.detach().clone()
            for key, value in state.full_variables(use_ema=True).items()}

  def _drain(self) -> int:
    """Moves the queue's transitions into the ring; returns the rows.
    Over a mesh the primary drains its collectors' queue and broadcasts
    the batch, and every rank extends its ring with the same rows (a
    collective: every rank calls it at the same points)."""
    if not self._mesh_feed:
      return self.feeder.drain()
    taken = self.feeder.take() if self._primary else None
    return self.feeder.put(*collectives.broadcast_object(taken))

  def _acting_batch(self) -> int:
    """The envs one acting call covers: the whole fleet for the vector
    actor, one collector's otherwise."""
    c = self.config
    return (c.num_collectors * c.envs_per_collector if c.vector_actors
            else c.envs_per_collector)

  def _make_policy(self, predictor) -> CEMFleetPolicy:
    c = self.config
    # The vector actor pins the ladder to its batch: acting builds exactly
    # one bucket (cem_bucket_<N> == 1), and the fleet batch never pads.
    ladder = BucketLadder((self._acting_batch(),)) if c.vector_actors else None
    return CEMFleetPolicy(
        predictor, action_size=c.action_size,
        num_samples=c.cem_num_samples, num_elites=c.cem_num_elites,
        iterations=c.cem_iterations, seed=c.seed + 7, ladder=ladder,
        ledger=self.obs_ledger, precision=c.precision)

  def _eval(self, updater: BellmanUpdater, variables, eval_batches,
            eval_q_stars) -> Dict[str, float]:
    return evaluate_td(updater, variables, eval_batches, eval_q_stars)

  def _eval_baseline(self, updater: BellmanUpdater, state, eval_batches,
                     eval_q_stars, resume_meta) -> Tuple[Dict, List]:
    """(initial_eval, eval_history): the step-0 eval, or on a resume the
    interrupted run's series, so the reduction keeps its original step-0
    baseline."""
    if resume_meta is not None:
      return (dict(resume_meta["initial_eval"]),
              [dict(entry) for entry in resume_meta["eval_history"]])
    initial_eval = self._eval(updater, state.full_variables(use_ema=True),
                              eval_batches, eval_q_stars)
    self._emit(0, {"replay/" + k: v for k, v in initial_eval.items()})
    return initial_eval, [dict(step=0, **initial_eval)]

  def _start_collectors(self, policy) -> None:
    """Starts the collector threads (or the vector actor): over a mesh on
    the primary rank alone, which hands what they collect to the others
    (``_drain``)."""
    c = self.config
    if self._mesh_feed and not self._primary:
      return
    if c.vector_actors:
      # One VectorActor over every env the threaded path spreads across
      # num_collectors threads; the actor list takes the collectors'
      # place in the shared shutdown and accounting paths.
      from tensor2robot_tpu_torch.replay.actor import ActorFleet
      fleet = ActorFleet(
          policy, self.queue, c.image_size,
          total_envs=self._acting_batch(), max_attempts=c.max_attempts,
          seed=c.seed, grasp_radius=c.grasp_radius,
          exploration_epsilon=c.exploration_epsilon,
          scripted_fraction=c.scripted_fraction,
          flight_recorder=self.recorder, watchdog=self.watchdog)
      self._collectors = fleet.actors
      fleet.start()
      return
    self._collectors = [
        CollectorWorker(policy, self.queue, c.image_size,
                        num_envs=c.envs_per_collector,
                        max_attempts=c.max_attempts,
                        seed=c.seed + i, grasp_radius=c.grasp_radius,
                        exploration_epsilon=c.exploration_epsilon,
                        scripted_fraction=c.scripted_fraction,
                        flight_recorder=self.recorder,
                        watchdog=self.watchdog)
        for i in range(c.num_collectors)
    ]
    for collector in self._collectors:
      collector.start()

  def _shutdown_collectors(self) -> List[BaseException]:
    """Signals every collector before joining any, so one that hangs
    leaves none of its siblings running; returns the errors rather than
    raising them, so an exception already in flight is not masked. Closes
    the writer."""
    for collector in self._collectors:
      collector.request_stop()
    errors: List[BaseException] = []
    for collector in self._collectors:
      if not collector.join(30.0):
        errors.append(RuntimeError("a collector did not stop within 30 s"))
      errors.extend(collector.errors)
    self.writer.close()
    return errors

  def _stop(self, profile_hook, final_step: int) -> List[BaseException]:
    """Closes the profile window and stops the collectors (even when the
    window raises); returns their errors, for the caller to raise once no
    exception is in flight."""
    try:
      self._profile_step(profile_hook, final_step, final=True)
    finally:
      errors = self._shutdown_collectors()
    return errors

  def _compile_counts(self) -> Dict[str, int]:
    """The result's ``compile_counts``: every program's builds, read from
    the one ledger under the JAX loop's keys (the TD closure as
    ``bellman_td_error``, an acting bucket as ``cem_bucket_<b>`` at every
    tier)."""
    counts = {}
    for name, builds in self.obs_ledger.compile_counts.items():
      if name == "td_error":
        name = "bellman_td_error"
      elif name.startswith("cem_bucket_"):
        name = "cem_bucket_" + name.split("_")[2]
      counts[name] = builds
    return counts

  def _train_clock(self):
    """``host_learner_step``'s clock: its train stage is the ledger's
    ``train_step``, registered at the run's first (whose FLOPs it counts)
    and recorded at each. On the card the stage returns once the step is
    launched, so its seconds are a lower bound."""
    ledger, batch = self.obs_ledger, self.config.batch_size
    device = self.trainer.device
    registered = False

    @contextlib.contextmanager
    def clock(stage: str):
      nonlocal registered
      if stage != "train":
        yield
        return
      start = time.perf_counter()
      if registered:
        yield
      else:
        with FlopCounterMode(display=False) as flops:
          yield
        registered = True
        ledger.register("train_step", device=device,
                        shapes={"batch": batch},
                        flops=flops.get_total_flops())
      ledger.record_dispatch("train_step", time.perf_counter() - start)

    return clock

  def _emit(self, step: int, scalars: Dict[str, float]) -> None:
    """One metric record through the registry: the block's gauges are
    set, then the bridge flushes exactly that block, so the JSONL records
    keep the JAX loop's keys while the registry holds the same series."""
    self.registry.set_gauges(scalars)
    self.registry.flush_to(self.writer, step, names=scalars.keys())

  def _profile_hook(self) -> Optional[ProfilerHook]:
    """The ``profile_window`` capture: ProfilerHook's window over the
    loop's steps, into ``<logdir>/profile``. The guarded start_trace makes
    a second open window skip rather than raise."""
    if not self.config.profile_window:
      return None
    start, end = self.config.profile_window
    return ProfilerHook(start_step=start, end_step=end,
                        log_dir=os.path.join(self.logdir, "profile"),
                        device=self.trainer.device)

  @staticmethod
  def _profile_step(hook, step: int, final: bool = False) -> None:
    if hook is None:
      return
    shim = types.SimpleNamespace(step=step)
    if final:
      hook.end(shim)
    else:
      hook.after_step(shim, {})

  def _host_param_health(self, state) -> Dict[str, float]:
    """The parameters' non-finite count and global norm
    (``health_summary`` in the ledger, its seconds through the readback
    of the two floats)."""
    if not self._health_registered:
      self._health_registered = True
      self.obs_ledger.register("health_summary", device=self.trainer.device)
    start = time.perf_counter()
    from tensor2robot_tpu_torch.replay.device_buffer import (
        parameter_health,
    )
    with torch.no_grad():
      norm, nonfinite = parameter_health(state)
      summary = {"health/nonfinite_params": float(nonfinite),
                 "health/param_norm": float(norm)}
    self.obs_ledger.record_dispatch("health_summary",
                                    time.perf_counter() - start)
    return summary

  def _collector_error(self) -> Optional[BaseException]:
    for collector in self._collectors:
      if collector.errors:
        return collector.errors[0]
    return None

  def _wait_for_min_fill(self) -> None:
    """Gates the first optimizer step on the ring's min_fill, polling
    with the jittered backoff; a timeout names the gate and the fill it
    reached. Over a mesh the primary decides for every rank: each poll
    broadcasts its drained batch, a collector's death and whether its
    deadline passed, so all ranks leave the poll, or raise, at the same
    attempt."""
    c = self.config
    description = (f"replay buffer min_fill={c.min_fill} under "
                   f"{self.logdir}")

    def ready():
      self._drain()
      self._feeder_hb.beat()
      error = self._collector_error()
      if error is not None:
        raise RuntimeError("collector died during warm-up") from error
      return self.feeder.ready()

    started, attempts = time.monotonic(), 0

    def mesh_ready():
      nonlocal attempts
      attempts += 1
      self._feeder_hb.beat()
      verdict = None
      if self._primary:
        error = self._collector_error()
        verdict = (self.feeder.take(),
                   None if error is None else repr(error),
                   time.monotonic() - started >= c.min_fill_timeout_s)
      taken, error, expired = collectives.broadcast_object(verdict)
      self.feeder.put(*taken)
      if error is not None:
        raise RuntimeError(
            f"collector died during warm-up (on the primary rank): {error}"
        ) from self._collector_error()
      if self.feeder.ready():
        return True
      if expired:
        raise backoff.PollTimeout(description, time.monotonic() - started,
                                  attempts)
      return False

    try:
      backoff.poll_with_backoff(
          mesh_ready if self._mesh_feed else ready,
          float("inf") if self._mesh_feed else c.min_fill_timeout_s,
          initial_s=0.02, max_s=0.25, seed=c.seed, description=description,
          raise_on_timeout=True)
    except backoff.PollTimeout as e:
      raise backoff.PollTimeout(
          f"{e.description} (reached size={self.buffer.size})",
          e.waited_s, e.attempts) from None

  def _obs_block(self) -> Dict:
    """Each program's share of the run's window, from the start of
    ``run``, and the spans' stage counts."""
    device = self.trainer.device
    return {
        "attribution": self.obs_ledger.attribution(
            wall_seconds=time.perf_counter() - self._run_started,
            device_kind=(torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")),
        "trace_stage_counts": trace_lib.get_tracer().stage_counts(),
    }

  def _assemble_result(self, steps: int, initial_eval, eval_history,
                       param_refreshes: int, **extra) -> Dict:
    """The JAX loop's result schema, every path's."""
    final_eval = eval_history[-1]
    reduction = 1.0 - (final_eval["eval_td_error"]
                       / max(initial_eval["eval_td_error"], 1e-9))
    episodes = sum(c_.episodes for c_ in self._collectors)
    return {
        "obs": self._obs_block(),
        "health": (self.health_monitor.snapshot()
                   if self.health_monitor is not None else None),
        "steps": steps,
        "initial_eval": initial_eval,
        "final_eval": {key: v for key, v in final_eval.items()
                       if key != "step"},
        "eval_history": eval_history,
        "eval_td_reduction": round(reduction, 4),
        "compile_counts": self._compile_counts(),
        "queue": self.queue.stats(),
        "buffer": self.buffer.metrics(),
        "episodes_collected": episodes,
        "env_steps_collected": sum(c_.env_steps
                                   for c_ in self._collectors),
        "vector_actors": self.config.vector_actors,
        "precision": self.config.precision,
        "collector_success_rate": (
            sum(c_.successes for c_ in self._collectors) / max(1, episodes)),
        "param_refreshes": param_refreshes,
        "logdir": self.logdir,
        **extra,
    }

  def _mesh_result(self, state) -> Dict:
    """The JAX Anakin result's mesh keys: the mesh's shape, whether ZeRO-1
    ran, and how the final parameters lie (``param_sharding``)."""
    shape = ({"data": 1} if self.mesh is None
             else {str(k): int(v) for k, v in self.mesh.shape.items()})
    return {"mesh_shape": shape, "zero1": self.zero1,
            "param_sharding": param_sharding_summary(state)}

  # --- crash-resume checkpoints --------------------------------------------

  def _path(self) -> str:
    """The loop path this config runs, as a checkpoint records it."""
    c = self.config
    return ("anakin" if c.anakin
            else "device-resident" if c.device_resident else "host")

  def _checkpoint_fingerprint(self) -> Dict:
    """The shape-critical slice of the config a resume must match: a
    drifted batch or capacity would change every fixed shape, so it
    refuses."""
    c = self.config
    return {"image_size": c.image_size, "action_size": c.action_size,
            "batch_size": c.batch_size, "capacity": c.capacity,
            "num_buffer_shards": c.num_buffer_shards,
            "prioritized": c.prioritized, "gamma": c.gamma,
            "seed": c.seed, "precision": c.precision}

  def _write_checkpoint(self, step: int, state, trees: Dict, flats: Dict,
                        path_meta: Dict, initial_eval: Dict,
                        eval_history: List) -> None:
    """One loop checkpoint of either path: the train state first, then the
    sidecar (the path's carried `trees` and `flats` and its `path_meta`,
    the ingest counters, the eval history and the health baselines), so a
    save cut between the two leaves a step that validation rejects.

    A step this loop saved already is the health snapshot of this same
    step (the state has not moved since): its state stays, and the sidecar
    is written again with the eval history as it stands now. A step left
    by an earlier run past the point this one resumed from is replaced."""
    fused = {} if self._path() == "host" else {"fused": True}
    with trace_lib.span("replay/fused_checkpoint" if fused
                        else "replay/checkpoint", step=step):
      if step != self._saved_step:
        stale = os.path.join(self.checkpoint_root, str(step))
        if self._primary and os.path.isdir(stale):
          shutil.rmtree(stale)
        distributed.sync_global_devices(f"loop checkpoint {step}")
        self._ckpt_manager.save(step, state)
        self._saved_step = step
      meta = {
          "fingerprint": self._checkpoint_fingerprint(),
          "mesh": checkpoints_lib.mesh_geometry(self.trainer.mesh),
          "path": self._path(),
          **path_meta,
          "queue_counters": {key: value
                             for key, value in self.queue.stats().items()
                             if key != "pending"},
          "initial_eval": initial_eval,
          "eval_history": eval_history,
      }
      # The drift baselines ride the sidecar: without them a resumed loop
      # would re-warm its EWMA state, blind to drift right after a restart.
      if self.health_monitor is not None:
        meta["health"] = self.health_monitor.state_dict()
      if self._primary:
        checkpoints_lib.save_sidecar(self.checkpoint_root, step,
                                     trees=trees, flats=flats, meta=meta)
        checkpoints_lib.prune_sidecars(self.checkpoint_root,
                                       self._ckpt_manager.all_steps())
      distributed.sync_global_devices(f"loop sidecar {step}")
    self.recorder.record("event", "loop_checkpoint", step=step, **fused)

  def _read_checkpoint(self, state):
    """Restores the newest valid checkpoint of this loop's path into
    `state`, the health monitor and the ingest counters: returns (state,
    step, trees, flats, meta) for the path to restore what it carries, or
    None when none is valid (then the loop starts fresh). Newer steps it
    rejects are logged by ``latest_resumable_step``."""
    step = checkpoints_lib.latest_resumable_step(self.checkpoint_root,
                                                 recorder=self.recorder)
    if step is None:
      return None
    trees, flats, meta = checkpoints_lib.load_sidecar(
        self.checkpoint_root, step)
    fingerprint = self._checkpoint_fingerprint()
    if meta.get("fingerprint") != fingerprint:
      raise ValueError(
          "resume fingerprint mismatch: checkpoint was written by "
          f"{meta.get('fingerprint')}, this loop is {fingerprint}; resume "
          "needs an identically configured loop (shapes would drift "
          "otherwise)")
    # Checkpoints that predate the "path" key: "fused" marks the megastep.
    saved = meta.get("path", "device-resident" if "fused" in meta else "host")
    if saved != self._path():
      raise ValueError(
          f"checkpoint step {step} under {self.checkpoint_root} was saved "
          f"by the {saved} path; resume it with {_PATH_FLAGS[saved]}")
    # A stamp of another mesh refuses before any state is read (sidecars
    # that predate the stamp pass).
    checkpoints_lib.validate_restore_mesh(meta.get("mesh"), self.trainer.mesh)
    state = self._ckpt_manager.restore(state, step=step)
    if int(state.step) != int(step):
      raise ValueError(f"restored TrainState.step {int(state.step)} != "
                       f"checkpoint step {step}")
    if self.health_monitor is not None and meta.get("health"):
      # The drift rules are armed from the first resumed step.
      self.health_monitor.load_state_dict(meta["health"])
    counters = meta.get("queue_counters", {})
    if counters:
      self.queue.restore_counters(**counters)
    _log.info("replay loop resumed at step %d from %s", step,
              self.checkpoint_root)
    self.recorder.record("event", "loop_resumed", step=int(step),
                         **({} if self._path() == "host" else {"fused": True}))
    return state, int(step), trees, flats, meta

  def _save_checkpoint(self, step: int, state, updater,
                       initial_eval: Dict, eval_history: List) -> None:
    """A host-path checkpoint: the lagged target, the ring's whole state
    and the label-seed counter ride the sidecar."""
    target_vars, target_meta = updater.target_state()
    buffer_arrays, buffer_meta = self.buffer.state_dict()
    self._write_checkpoint(
        step, state,
        trees={} if target_vars is None else {"target": target_vars},
        flats={"buffer": buffer_arrays},
        path_meta={"target": target_meta,
                   "next_label_seed": updater.next_label_seed,
                   "buffer_meta": buffer_meta},
        initial_eval=initial_eval, eval_history=eval_history)

  def _restore_checkpoint(self, state):
    """Restores the host path's newest valid checkpoint, the ring
    included: returns (state, trees, meta), or None."""
    loaded = self._read_checkpoint(state)
    if loaded is None:
      return None
    state, _, trees, flats, meta = loaded
    self.buffer.load_state_dict(flats["buffer"], meta["buffer_meta"])
    return state, trees, meta

  def _save_fused_checkpoint(self, step: int, state, learner,
                             initial_eval: Dict, eval_history: List) -> None:
    """A checkpoint between dispatches of the device-resident or the
    Anakin path: what `learner` (the megastep or the Anakin loop) carries
    (the ring's tensors, the lagged target and the Anakin fleet's env
    state) and its draw counters ride the sidecar."""
    flats = learner.checkpoint_arrays()  # whole, on every rank
    self._write_checkpoint(
        step, state, trees={"target": learner.target_state()[0]},
        flats=flats, path_meta={"fused": learner.checkpoint_meta()},
        initial_eval=initial_eval, eval_history=eval_history)

  def _restore_fused_checkpoint(self, state, learner):
    """Restores the device-resident or the Anakin path's newest valid
    checkpoint into `state` and what `learner` carries (all copied into
    their own tensors); returns (state, step, meta), or None."""
    from tensor2robot_tpu_torch.replay.device_buffer import (
        DeviceReplayBuffer,
    )
    loaded = self._read_checkpoint(state)
    if loaded is None:
      return None
    state, step, trees, flats, meta = loaded
    composite = {
        "buffer": DeviceReplayBuffer.state_from_arrays(flats["buffer"]),
        "target": trees["target"]}
    if "env" in flats:
      composite["env"] = flats["env"]
    learner.restore_checkpoint_state(composite, meta["fused"])
    return state, step, meta

  # --- the loop ------------------------------------------------------------

  def run(self, num_steps: int) -> Dict:
    """Runs the closed loop for `num_steps` optimizer steps.

    For the run, the loop's recorder rides the process tracer, and the
    learner and the feeder beat heartbeats (once an optimizer step on the
    host path, once a dispatch on the fused paths); all are taken off on
    the way out, so a finished loop never reads as stalled. An exception
    triggers the recorder, then propagates."""
    self._run_started = time.perf_counter()
    tracer = trace_lib.get_tracer()
    self.recorder.attach(tracer)
    self._learner_hb = self.watchdog.register("replay/learner")
    self._feeder_hb = self.watchdog.register("replay/feeder")
    try:
      if self.config.anakin:
        return self._run_anakin(num_steps)
      if self.config.device_resident:
        return self._run_device_resident(num_steps)
      return self._run_host(num_steps)
    except Exception as e:
      self.recorder.trigger("replay_loop_exception",
                            error=f"{type(e).__name__}: {e}")
      raise
    finally:
      self.watchdog.unregister(self._learner_hb)
      self.watchdog.unregister(self._feeder_hb)
      self.recorder.detach(tracer)

  def _run_host(self, num_steps: int) -> Dict:
    """Threaded collectors and the learner's host step."""
    from tensor2robot_tpu_torch.replay.learner_bench import (
        host_learner_step,
    )
    c = self.config
    state = self.trainer.create_train_state()
    # Crash-resume: the newest valid checkpoint (train state, lagged
    # target, ring, counters, eval history) and its exact step; nothing
    # valid on disk means a fresh start.
    start_step = 0
    resume_trees = resume_meta = None
    if c.resume and self._ckpt_manager is not None:
      loaded = self._restore_checkpoint(state)
      if loaded is not None:
        state, resume_trees, resume_meta = loaded
        start_step = int(resume_meta["step"])
    # The snapshot feeds the collectors' predictor and the target net
    # (refreshed every refresh_every steps); the per-step TD and eval
    # read the live EMA variables.
    host_variables = self._host_variables(state)
    predictor = _HotReloadPredictor(self.model, host_variables)
    policy = self._make_policy(predictor)
    updater = BellmanUpdater(
        self.model, host_variables, action_size=c.action_size,
        gamma=c.gamma, num_samples=c.cem_num_samples,
        num_elites=c.cem_num_elites, iterations=c.cem_iterations,
        seed=c.seed + 13, polyak_tau=c.polyak_tau, precision=c.precision,
        ledger=self.obs_ledger, device=self.trainer.device)
    if resume_meta is not None:
      # The constructor seeded the target with the restored online
      # variables: re-seat the lagged target and the label-seed counter,
      # so post-resume labels continue the interrupted streams.
      updater.restore_target_state(resume_trees.get("target"),
                                   resume_meta["target"])
      updater.restore_label_seed(resume_meta["next_label_seed"])
    checkpointing = self._ckpt_manager is not None and c.checkpoint_every
    profile_hook = self._profile_hook()
    blank = np.zeros((c.image_size, c.image_size, 3), np.uint8)
    try:
      # The acting bucket is built here, on this thread: on the GPU no
      # capture then runs beside another thread's launches.
      if self._primary or not self._mesh_feed:  # the ranks that act
        policy.warm(lambda i: blank,
                    sizes=(policy.ladder.bucket_for(self._acting_batch()),))
      self._start_collectors(policy)
      self._wait_for_min_fill()
      eval_batches, eval_q_stars = eval_transitions(c)
      initial_eval, eval_history = self._eval_baseline(
          updater, state, eval_batches, eval_q_stars, resume_meta)
      with_health = self.health_monitor is not None
      clock = self._train_clock()
      for step in range(start_step + 1, num_steps + 1):
        with trace_lib.span("extend/drain"):
          self._drain()
        self._feeder_hb.beat()
        state, metrics, td, targets, q_next, info = host_learner_step(
            self.trainer, updater, self.buffer, state, clock=clock,
            with_health=with_health)
        self._learner_hb.beat()
        self._profile_step(profile_hook, step)
        if with_health:
          snapshot_fn = None
          if checkpointing:
            # The auto-action: freeze the breaching state as a checkpoint
            # before any halt, so the post-mortem has the exact params.
            snapshot_fn = lambda: self._save_checkpoint(  # noqa: E731
                step, state, updater, initial_eval, eval_history)
          # The JAX host loop's summary: grad stats from the step's
          # metrics, param stats from their reductions, the rest from
          # this step's host data; q is the Bellman bootstrap Q.
          self.health_monitor.observe_with_snapshot(step, {
              "health/nonfinite_grads": float(metrics["grads_nonfinite"]),
              "health/grad_norm": float(metrics["grad_norm"]),
              "health/nonfinite_targets": float(
                  np.sum(~np.isfinite(targets))),
              "health/td_mean": float(np.mean(td)),
              "health/td_max": float(np.max(td)),
              "health/q_mean": float(np.mean(q_next)),
              "health/q_max": float(np.max(q_next)),
              "health/priority_entropy": float(
                  self.buffer.priority_entropy()),
              "health/sample_age": float(np.mean(info.staleness)),
              **self._host_param_health(state),
          }, snapshot_fn=snapshot_fn)
        if step % c.refresh_every == 0:
          # The hot reload: collectors and the target net take the
          # freshest EMA variables; no bucket is rebuilt.
          host_variables = self._host_variables(state)
          predictor.update(host_variables)
          updater.refresh(host_variables, step)
        if step % c.log_every == 0 or step == num_steps:
          self._emit(step, {
              "replay/train_loss": float(metrics["loss"]),
              "replay/train_td_error": float(np.mean(td)),
              "replay/train_q_next": float(np.mean(q_next)),
              "replay/sample_staleness": float(np.mean(info.staleness)),
              "replay/target_lag": float(updater.target_lag(step)),
              "replay/episodes": float(
                  sum(col.episodes for col in self._collectors)),
              **self.buffer.metrics(),
              **self.feeder.metrics(),
          })
          if with_health:
            # Its own record: the replay/ records keep their schema.
            self._emit(step, dict(self.health_monitor.last_summary))
        if step % c.eval_every == 0 or step == num_steps:
          with trace_lib.span("replay/eval"):
            evals = self._eval(updater,
                               state.full_variables(use_ema=True),
                               eval_batches, eval_q_stars)
          eval_history.append(dict(step=step, **evals))
          self._emit(step, {"replay/" + k: v for k, v in evals.items()})
        if checkpointing and step % c.checkpoint_every == 0:
          self._save_checkpoint(step, state, updater, initial_eval,
                                eval_history)
    finally:
      collector_errors = self._stop(profile_hook, num_steps)
    _raise_first(collector_errors)
    return self._assemble_result(num_steps, initial_eval, eval_history,
                                 param_refreshes=updater.refresh_count,
                                 **(self._mesh_result(state)
                                    if c.mesh_dp else {}))

  def _megastep_learner(self):
    """The device-resident path's learner over the loop's ring, with a
    cold target."""
    from tensor2robot_tpu_torch.replay.device_buffer import MegastepLearner
    c = self.config
    return MegastepLearner(
        self.model, self.trainer, self.buffer, action_size=c.action_size,
        gamma=c.gamma, num_samples=c.cem_num_samples,
        num_elites=c.cem_num_elites, iterations=c.cem_iterations,
        inner_steps=c.megastep_inner, seed=c.seed + 13,
        polyak_tau=c.polyak_tau, ledger=self.obs_ledger,
        precision=c.precision, health=self.health_monitor is not None)

  @staticmethod
  def _fused_health_summary(metrics: Dict[str, float]) -> Dict[str, float]:
    """The health keys of a megastep dispatch's metrics."""
    return {key: value for key, value in metrics.items()
            if key.startswith("health/")}

  def _run_device_resident(self, num_steps: int) -> Dict:
    """The device-resident path: the host feeds the ring and reads
    metrics; the megastep runs the learner.

    Each dispatch: the feeder drains the queue into the device ring (in
    fixed chunks), one ``MegastepLearner.step`` runs ``megastep_inner``
    sample -> label -> train -> reprioritize iterations on the device, and
    the host reads their metrics back once. The refresh, log, eval and
    checkpoint cadences count optimizer steps and fire after the dispatch
    whose steps hold a multiple. `num_steps` rounds up to whole dispatches,
    so K never changes."""
    c = self.config
    k = c.megastep_inner
    num_outer = max(1, -(-num_steps // k))
    state = self.trainer.create_train_state()
    host_variables = self._host_variables(state)
    predictor = _HotReloadPredictor(self.model, host_variables)
    policy = self._make_policy(predictor)
    # Eval only: the megastep labels and computes TD on the hot path; the
    # eval against Q* takes the updater's TD closure, whose target net it
    # never reads (so it stays cold) and whose label closure is never built.
    updater = BellmanUpdater(
        self.model, None, action_size=c.action_size, gamma=c.gamma,
        num_samples=c.cem_num_samples, num_elites=c.cem_num_elites,
        iterations=c.cem_iterations, seed=c.seed + 13,
        precision=c.precision, ledger=self.obs_ledger,
        device=self.trainer.device)
    learner = self._megastep_learner()
    # The cold start's target is the initial online copy: refresh 0, not a
    # loop refresh.
    learner.refresh(host_variables, step=0)
    resume_step, resume_meta = 0, None
    if c.resume and self._ckpt_manager is not None:
      restored = self._restore_fused_checkpoint(state, learner)
      if restored is not None:
        state, resume_step, resume_meta = restored
        host_variables = self._host_variables(state)
        predictor.update(host_variables)
    checkpointing = self._ckpt_manager is not None and c.checkpoint_every
    profile_hook = self._profile_hook()
    blank = np.zeros((c.image_size, c.image_size, 3), np.uint8)
    try:
      if self._primary or not self._mesh_feed:  # the ranks that act
        policy.warm(lambda i: blank,
                    sizes=(policy.ladder.bucket_for(self._acting_batch()),))
      self._start_collectors(policy)
      self._wait_for_min_fill()
      eval_batches, eval_q_stars = eval_transitions(c)
      initial_eval, eval_history = self._eval_baseline(
          updater, state, eval_batches, eval_q_stars, resume_meta)
      prev_step = resume_step
      for outer in range(resume_step // k + 1, num_outer + 1):
        with trace_lib.span("extend/drain"):
          self._drain()
        self._feeder_hb.beat()
        state, metrics = learner.step(state)
        self._learner_hb.beat()
        step = outer * k
        self._profile_step(profile_hook, step)
        if self.health_monitor is not None:
          # One summary a dispatch; its spike keys are the max over the K
          # iterations.
          self.health_monitor.observe(step,
                                      self._fused_health_summary(metrics))

        def crossed(every: int) -> bool:
          return step // every > prev_step // every

        if crossed(c.refresh_every):
          host_variables = self._host_variables(state)
          predictor.update(host_variables)
          learner.refresh(host_variables, step)
        if crossed(c.log_every) or outer == num_outer:
          self._emit(step, {
              "replay/train_loss": metrics["loss"],
              "replay/train_td_error": metrics["td_error"],
              "replay/train_q_next": metrics["q_next"],
              "replay/sample_staleness": metrics["staleness"],
              "replay/target_lag": float(learner.target_lag(step)),
              "replay/episodes": float(
                  sum(col.episodes for col in self._collectors)),
              **self.buffer.metrics(),
              **self.feeder.metrics(),
          })
          if self.health_monitor is not None:
            self._emit(step, dict(self.health_monitor.last_summary))
        if crossed(c.eval_every) or outer == num_outer:
          with trace_lib.span("replay/eval"):
            evals = self._eval(updater,
                               state.full_variables(use_ema=True),
                               eval_batches, eval_q_stars)
          eval_history.append(dict(step=step, **evals))
          self._emit(step, {"replay/" + k_: v for k_, v in evals.items()})
        if checkpointing and crossed(c.checkpoint_every):
          self._save_fused_checkpoint(step, state, learner, initial_eval,
                                      eval_history)
        prev_step = step
    finally:
      collector_errors = self._stop(profile_hook, num_outer * k)
    _raise_first(collector_errors)
    return self._assemble_result(
        num_outer * k, initial_eval, eval_history,
        param_refreshes=learner.refresh_count - 1,  # less the cold start
        device_resident=True, megastep_inner=k,
        **(self._mesh_result(state) if c.mesh_dp else {}))

  def _anakin_loop(self):
    """The Anakin path's loop over the loop's ring and a fleet of
    ``num_collectors * envs_per_collector`` envs on a bank of
    ``anakin_bank_scenes`` oracle scenes, with a cold target."""
    from tensor2robot_tpu_torch.replay.anakin import AnakinLoop
    from tensor2robot_tpu_torch.research.qtopt.device_grasping import (
        DeviceGraspEnv,
        make_scene_bank,
    )
    c = self.config
    device = self.trainer.device
    # The one host render of the run: the oracle's own scenes, copied to
    # the card once.
    bank = make_scene_bank(c.anakin_bank_scenes, image_size=c.image_size,
                           base_seed=c.seed, device=device)
    env = DeviceGraspEnv(c.num_collectors * c.envs_per_collector,
                         image_size=c.image_size,
                         max_attempts=c.max_attempts, radius=c.grasp_radius,
                         bank=bank, device=device)
    return AnakinLoop(
        self.model, self.trainer, self.buffer, env,
        action_size=c.action_size, gamma=c.gamma,
        num_samples=c.cem_num_samples, num_elites=c.cem_num_elites,
        iterations=c.cem_iterations, inner_steps=c.anakin_inner,
        train_every=c.anakin_train_every, min_fill=c.min_fill,
        exploration_epsilon=c.exploration_epsilon,
        scripted_fraction=c.scripted_fraction, seed=c.seed + 13,
        polyak_tau=c.polyak_tau, ledger=self.obs_ledger,
        precision=c.precision, health=self.health_monitor is not None)

  def _run_anakin(self, num_steps: int) -> Dict:
    """The Anakin path: the env, acting, the extend and the learner on the
    card (``anakin.AnakinLoop``), no collector threads and no queue. The
    host dispatches, reads one metrics vector a dispatch, and runs the
    refresh, log, eval and checkpoint cadences between dispatches; they
    count optimizer steps and fire after the dispatch that crosses a
    multiple. It stops once `num_steps` optimizer steps have run: the
    dispatches before ``min_fill`` collect without training, so their
    number adapts. The result carries the JAX keys ``mesh_shape``,
    ``zero1`` and ``param_sharding``."""
    c = self.config
    total_envs = c.num_collectors * c.envs_per_collector
    state = self.trainer.create_train_state()
    host_variables = self._host_variables(state)
    # Eval only, as on the device-resident path: the loop labels and
    # computes TD on the card.
    updater = BellmanUpdater(
        self.model, None, action_size=c.action_size, gamma=c.gamma,
        num_samples=c.cem_num_samples, num_elites=c.cem_num_elites,
        iterations=c.cem_iterations, seed=c.seed + 13,
        precision=c.precision, ledger=self.obs_ledger,
        device=self.trainer.device)
    loop = self._anakin_loop()
    loop.refresh(host_variables, step=0)  # the cold start, not a refresh
    resume_step, resume_meta = 0, None
    if c.resume and self._ckpt_manager is not None:
      restored = self._restore_fused_checkpoint(state, loop)
      if restored is not None:
        state, resume_step, resume_meta = restored
    checkpointing = self._ckpt_manager is not None and c.checkpoint_every
    profile_hook = self._profile_hook()
    eval_batches, eval_q_stars = eval_transitions(c)
    initial_eval, eval_history = self._eval_baseline(
        updater, state, eval_batches, eval_q_stars, resume_meta)
    # The warm-up (min_fill at total_envs rows a control step) and the
    # training budget, doubled: a loop that stops training raises instead
    # of spinning.
    learns_per_dispatch = c.anakin_inner // c.anakin_train_every
    max_dispatches = 2 * (-(-c.min_fill // (total_envs * c.anakin_inner))
                          + -(-num_steps // learns_per_dispatch)) + 2
    dispatches = 0
    prev_step = resume_step
    try:
      while loop.trained_steps < num_steps:
        if dispatches >= max_dispatches:
          raise RuntimeError(
              f"anakin loop stalled: {loop.trained_steps} optimizer steps "
              f"after {dispatches} dispatches (min_fill={c.min_fill}, "
              f"buffer size={self.buffer.size})")
        state, metrics = loop.step(state)
        self._learner_hb.beat()
        dispatches += 1
        step = loop.trained_steps
        self._profile_step(profile_hook, step)
        # A dispatch that did not train reports the zero carry, not a
        # summary.
        if self.health_monitor is not None and metrics["trained_steps"]:
          self.health_monitor.observe(step,
                                      self._fused_health_summary(metrics))

        def crossed(every: int) -> bool:
          return step // every > prev_step // every

        done = step >= num_steps
        if crossed(c.refresh_every):
          loop.refresh(self._host_variables(state), step)
        if (crossed(c.log_every) or done) and metrics["trained_steps"]:
          self._emit(step, {
              "replay/train_loss": metrics["loss"],
              "replay/train_td_error": metrics["td_error"],
              "replay/train_q_next": metrics["q_next"],
              "replay/sample_staleness": metrics["staleness"],
              "replay/target_lag": float(loop.target_lag(step)),
              "replay/episodes": float(loop.episodes),
              "replay/env_steps": float(loop.env_steps),
              **self.buffer.metrics(),
          })
          if self.health_monitor is not None:
            self._emit(step, dict(self.health_monitor.last_summary))
        if crossed(c.eval_every) or done:
          with trace_lib.span("replay/eval"):
            evals = self._eval(updater,
                               state.full_variables(use_ema=True),
                               eval_batches, eval_q_stars)
          eval_history.append(dict(step=step, **evals))
          self._emit(step, {"replay/" + k_: v for k_, v in evals.items()})
        if checkpointing and crossed(c.checkpoint_every):
          self._save_fused_checkpoint(step, state, loop, initial_eval,
                                      eval_history)
        prev_step = step
    finally:
      self._profile_step(profile_hook, loop.trained_steps, final=True)
      self.writer.close()
    return self._assemble_result(
        loop.trained_steps, initial_eval, eval_history,
        param_refreshes=loop.refresh_count - 1,  # less the cold start
        device_resident=True, anakin=True, anakin_inner=c.anakin_inner,
        anakin_train_every=c.anakin_train_every, **self._mesh_result(state),
        episodes_collected=loop.episodes,
        env_steps_collected=loop.env_steps,
        collector_success_rate=loop.successes / max(1, loop.episodes))
