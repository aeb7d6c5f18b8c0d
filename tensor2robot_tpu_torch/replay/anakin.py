"""AnakinLoop: act -> env step -> extend -> learn with the host out of the loop.

Counterpart of ``tensor2robot_tpu/replay/anakin.py``. The megastep
(``device_buffer.MegastepLearner``) put the learner on the card and the
vector actor (``actor.VectorActor``) batched acting, but the two still
meet on the host: the actor replays a CEM bucket a control step, steps
numpy, enqueues, and the feeder copies the same bytes back to the card.
Here the environment (``research/qtopt/device_grasping.DeviceGraspEnv``),
acting, the replay extend and the optimizer step all run on the card, the
Anakin architecture of Podracer (arXiv:2104.06272). Each control step:

  obs      = env_state.images           (uint8, the pre-step snapshot)
  act      : fleet CEM (``cem.fleet_cem_optimize`` over
             ``bellman.make_cem_states_and_score``, factored where the
             model has the form) on the live EMA variables, then the
             collectors' epsilon-uniform and scripted-near-object mix;
  env step : ``DeviceGraspEnv.step_fn`` (auto-reset in place);
  extend   : ``DeviceReplayBuffer.extend_fn`` at the fleet's chunk, with
             next_image = obs (the scene is static within an episode);
  learn    : on every ``train_every``-th control step once the ring holds
             ``min_fill`` rows, ``device_buffer.make_learn_iteration_fn``
             (sample -> CEM-Bellman label against the target net ->
             train -> TD -> reprioritize), its metrics merged into the
             dispatch's carry by ``health.merge_scan_metrics``.

A dispatch is ``inner_steps`` control steps, ``inner_steps /
train_every`` periods of ``train_every`` control steps and one learn. The
host reads back one metrics vector a dispatch.

**No data-dependent branch on the card.** JAX gates the learn with a
``lax.cond`` on the ring's size inside its program. Here the host knows
the size (it counts every extend: ``num_envs`` rows a control step), so
before a dispatch it knows which learns pass the gate. On the card, a
dispatch whose learns all pass replays one CUDA graph of a period once a
period, the period's draws copied into the graph's input row first; any
other dispatch (warm-up, or the one that crosses ``min_fill``) runs the
same body eagerly on a side stream, as the megastep's first dispatch
does. The first graphed dispatch captures the period, once for the
loop's life: ``compile_counts == {"anakin_step": 1}``. On the CPU, or
with ``graphs=False``, every dispatch runs the body eagerly (it is built
once, and counted once).

**The draws.** JAX keys each draw by ``fold_in(key(seed + c), tick)``
with threefry inside its program, tick = outer * inner_steps + inner;
threefry and Philox cannot agree. The port draws them on the host with
numpy, ``np.random.default_rng((seed + c, tick))``, the offsets c those
of the JAX keys: per control step the acting CEM noise (c = 7, (n,
iterations, N, A) standard normals), the exploration draws (c = 555: an
epsilon uniform (n,), uniform actions (n, A) in [-1, 1), scripted noise
(n, 2) standard normals, scaled by 0.12 on the card) and, with no bank,
the reset targets (c = 31, ``device_grasping.procedural_draws``); per
learn, at its control step's tick, the ring's slot draws
(``device_buffer.sample_draws(seed, tick, ...)`` at the size the host
counts) and the label noise (c = 1, (B, iterations, N, A)). A dispatch's
draws reach the card in one copy from pinned memory; the next dispatch's
are drawn while the card runs. ``step(draws=)`` takes the JAX package's
own draws in the parity tests.

**Scoring tiers.** ``precision`` sets the tier of acting's CEM and of the
label's max (``research/qtopt/cem.py``), the casts inside the period's
graph; the env step, the extend, the gradients and the TD errors stay
float32, and the loop still captures once. ``dtype`` names the scoring
dtype.

**Over a mesh of ranks** (the trainer's mesh, ``Trainer(mesh=)``), the
JAX loop's sharded layout: the env fleet splits over the data axis
(``DeviceGraspEnv.state_shardings``; each rank acts for and steps its
block of envs with its block of the global draws), the ring splits its
capacity (``DeviceReplayBuffer(mesh=)``; each control step gathers the
fleet's chunk and each rank writes the slots it holds), and the learn
keeps each rank's block of the sampled batch and trains data parallel
(``make_learn_iteration_fn(constrain_batch=)``, ZeRO-1 when the trainer
shards its optimizer state). Acting scores with the whole EMA variables
and labels with the whole target, on every rank. Every draw is the
global stream's, so before the first learn the ring, the fleet and the
episode counts equal one rank's bit for bit; once learns run, the
gradient all-reduce sums in another order. Over more than one rank every
dispatch runs eagerly (gloo's collectives run on the host, outside any
CUDA graph).

**The ledger.** With ``ledger=`` (``obs/ledger.py``) the period's
program registers as ``anakin_step`` (shapes ``{inner_steps, fleet,
batch}``, the scoring tier) with the FLOPs of a dispatch whose periods all
learn: the periods times what ``FlopCounterMode`` counted over the first
eager period that learned. The card's graph is built after such a period
(the capture needs one), so it registers at its build; the eager path
builds at its first dispatch and registers once a period has learned.
Each dispatch records its host seconds from its launch through the
metrics readback, its one wait.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from tensor2robot_tpu_torch.obs import health as health_lib
from tensor2robot_tpu_torch.obs import trace as trace_lib
from tensor2robot_tpu_torch.ops import graph_launches
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.replay.bellman import (
    TargetNetwork,
    make_bellman_targets_fn,
    make_cem_states_and_score,
)
from tensor2robot_tpu_torch.replay.device_buffer import (
    DeviceReplayBuffer,
    check_ring_mesh,
    make_learn_iteration_fn,
    mesh_hooks,
    sample_draws,
)
from tensor2robot_tpu_torch.research.qtopt import cem
from tensor2robot_tpu_torch.research.qtopt.device_grasping import (
    DeviceGraspEnv,
    procedural_draws,
)
from tensor2robot_tpu_torch.train import trainer as trainer_lib

# The draw streams' seed offsets: the JAX loop's key offsets.
_LABEL, _ACT, _ENV_INIT, _ENV, _EXPLORE = 1, 7, 21, 31, 555
_LOSS_KEYS = ("loss", "td_error", "q_next", "staleness")
# Draw fields with one row an env of the fleet (a rank reads its block).
_FLEET_FIELDS = ("act_noise", "draw", "uniform", "normal", "reset_targets")


class DrawLayout:
  """Named fields of one period's flat float32 row of draws."""

  def __init__(self, fields: Sequence[Tuple[str, Tuple[int, ...]]]):
    self.fields: Dict[str, Tuple[int, int, Tuple[int, ...]]] = {}
    offset = 0
    for name, shape in fields:
      size = math.prod(shape)
      self.fields[name] = (offset, size, tuple(shape))
      offset += size
    self.width = offset

  def views(self, row):
    """{name: view} of one (width,) tensor or array."""
    return {name: row[offset:offset + size].reshape(shape)
            for name, (offset, size, shape) in self.fields.items()}


class _AnakinGraph:
  """One period (``train_every`` control steps and a learn) captured in a
  CUDA graph over the loop's input row. ``holds`` says whether a train
  state still has the tensors the graph was captured on."""

  def __init__(self, loop: "AnakinLoop", state, stream: torch.cuda.Stream):
    self.graph = torch.cuda.CUDAGraph()
    state.opt_state.zero_grad(set_to_none=True)
    current = torch.cuda.current_stream(loop.device)
    stream.wait_stream(current)
    try:
      with graph_launches.capture(self.graph, stream) as self.tally:
        loop._period(state, loop._row, learn=True)
    except RuntimeError as e:
      raise NotImplementedError(
          f"AnakinLoop cannot capture {type(loop._model).__name__}'s period "
          f"in a CUDA graph: {e}") from e
    current.wait_stream(stream)
    self._tensors = [t.data_ptr() for t in trainer_lib._state_tensors(state)]
    self._hyperparameters = trainer_lib._hyperparameters(state.opt_state)

  def holds(self, state) -> bool:
    return ([t.data_ptr() for t in trainer_lib._state_tensors(state)]
            == self._tensors
            and trainer_lib._hyperparameters(state.opt_state)
            == self._hyperparameters)

  def replay(self) -> None:
    self.graph.replay()
    graph_launches.replayed(self.tally)


class AnakinLoop(TargetNetwork):
  """The act -> step -> extend -> learn loop around a ``DeviceGraspEnv``.

  Args:
    model / trainer / buffer: the megastep's trio, on one device; the
      buffer's ``ingest_chunk`` must equal the fleet width (one extend
      shape). Over the trainer's mesh the buffer lies on that mesh, and
      the fleet and the sample batch must divide its data axis.
    env: a ``DeviceGraspEnv`` (bank or procedural scenes).
    action_size / gamma / num_samples / num_elites / iterations: acting's
      and labelling's CEM and the discount.
    inner_steps: control steps a dispatch, a multiple of `train_every`.
    train_every: one optimizer step every `train_every` control steps.
    min_fill: the ring size a learn waits for (``ReplayFeeder.ready``'s
      gate).
    exploration_epsilon / scripted_fraction: the collectors' mix.
    seed: keys every draw (see the module's docstring).
    polyak_tau: None copies the online variables on ``refresh``.
    precision: the scoring tier of acting and labels.
    ledger: an ``obs.ledger.ExecutableLedger``: ``anakin_step``'s build,
      FLOPs and dispatch seconds (see the module's docstring).
    health: the learn adds ``health.SUMMARY_KEYS`` to the metrics, the
      spike keys reduced by their running max over the dispatch.
    graphs: on the card, replay the period's graph (False runs every
      dispatch eagerly: the bit-parity control).
  """

  def __init__(
      self,
      model,
      trainer,
      buffer: DeviceReplayBuffer,
      env: DeviceGraspEnv,
      action_size: int = 4,
      gamma: float = 0.9,
      num_samples: int = 32,
      num_elites: int = 4,
      iterations: int = 2,
      inner_steps: int = 40,
      train_every: int = 8,
      min_fill: int = 0,
      exploration_epsilon: float = 0.2,
      scripted_fraction: float = 0.25,
      seed: int = 0,
      polyak_tau: Optional[float] = None,
      ledger=None,
      precision: str = "f32",
      health: bool = False,
      graphs: bool = True,
  ):
    if inner_steps < 1 or train_every < 1 or inner_steps % train_every:
      raise ValueError(
          f"inner_steps {inner_steps} must be a positive multiple of "
          f"train_every {train_every}")
    if buffer.ingest_chunk != env.num_envs:
      raise ValueError(
          f"buffer ingest_chunk {buffer.ingest_chunk} must equal the env "
          f"fleet width {env.num_envs}: the loop extends the ring at one "
          "chunk shape, the fleet's")
    if not trainer.device == buffer.device == env.device:
      raise ValueError(
          f"the trainer runs on {trainer.device}, the ring lives on "
          f"{buffer.device} and the env on {env.device}")
    if buffer.capacity >= 2 ** 24:
      raise ValueError(
          f"capacity {buffer.capacity} >= 2^24: slot draws ride the float32 "
          "draw buffer and must be exact")
    # The trainer's mesh is the loop's: the fleet and the learn batch
    # split over its data axis, so both must divide it.
    self.mesh = trainer.mesh
    self._data_axis = trainer.data_axis
    axis_size = (self.mesh.shape.get(self._data_axis, 1)
                 if self.mesh is not None else 1)
    if env.num_envs % axis_size:
      raise ValueError(
          f"env fleet width {env.num_envs} is not divisible by the "
          f"{self._data_axis!r} mesh axis size ({axis_size} devices), so "
          f"the per-shard env fleets cannot form. Use a fleet of "
          f"{mesh_lib.nearest_multiples(env.num_envs, axis_size)} envs, or a "
          f"data axis that divides {env.num_envs}.")
    if buffer.sample_batch_size % axis_size:
      raise ValueError(
          f"sample batch {buffer.sample_batch_size} is not divisible by "
          f"the {self._data_axis!r} mesh axis size ({axis_size} devices), "
          f"so the fused learn body cannot run data-parallel. Use a batch "
          f"of "
          f"{mesh_lib.nearest_multiples(buffer.sample_batch_size, axis_size)}.")
    check_ring_mesh(trainer, buffer)
    # Placement follows the whole mesh, not its data axis: a dp=1, tp>1
    # mesh still runs every rank's collectives and holds the target whole.
    self._sharded = mesh_lib.is_distributed(self.mesh)
    super().__init__(polyak_tau=polyak_tau, device=trainer.device)
    self.precision = cem.validate_precision(precision)
    self.dtype = str(cem.scoring_dtype(precision)).replace("torch.", "")
    self._model = model
    self._trainer = trainer
    self._buffer = buffer
    self._env = env
    self._action_size = action_size
    self._gamma = gamma
    self._num_samples = num_samples
    self._num_elites = num_elites
    self._iterations = iterations
    self.inner_steps = inner_steps
    self.train_every = train_every
    self.min_fill = min_fill
    self._epsilon = exploration_epsilon
    self._scripted = scripted_fraction
    self._seed = seed
    self._clip_targets = getattr(model, "loss_type",
                                 "cross_entropy") == "cross_entropy"
    self.health = bool(health)
    self._graphs = (graphs and self.device.type == "cuda"
                    and not self._sharded)
    self._factored = getattr(model, "factored_cem_fns", lambda: None)()
    mesh = self.mesh if self._sharded else None
    self._env_step = env.step_fn(mesh, self._data_axis)
    self._extend = buffer.extend_fn(local_rows=self._sharded)
    # This rank's block of the fleet: [first, first + local).
    local = env.num_envs // axis_size
    first = (self.mesh.axis_index(self._data_axis) * local
             if self._sharded else 0)
    self._fleet = slice(first, first + local)
    self._env_shardings = (env.state_shardings(self.mesh, self._data_axis)
                           if self._sharded else None)
    self._learn = None
    self._graph: Optional[_AnakinGraph] = None
    self._built = False
    self._warmed = False
    self._side_stream = None
    self.compile_counts: Dict[str, int] = {}
    self._ledger = ledger
    self._period_flops: Optional[float] = None  # a learning period's
    self._unregistered = False  # a build the ledger has not seen yet

    n, steps, batch = env.num_envs, train_every, buffer.sample_batch_size
    self._noise_shape = (iterations, num_samples, action_size)
    fields = [("act_noise", (steps, n) + self._noise_shape),
              ("draw", (steps, n)), ("uniform", (steps, n, action_size)),
              ("normal", (steps, n, 2))]
    if env.bank is None:
      fields.append(("reset_targets", (steps, n, 2)))
    fields += [("slots", (batch,)), ("uniforms", (batch,)),
               ("label_noise", (batch,) + self._noise_shape)]
    self.layout = DrawLayout(fields)
    self.periods = inner_steps // train_every
    shape = (self.periods, self.layout.width)
    pin = self.device.type == "cuda"
    # Two host buffers: the next dispatch's draws are made into one while
    # the card runs the dispatch copied from the other.
    self._host = [torch.empty(shape, dtype=torch.float32, pin_memory=pin)
                  for _ in range(2)]
    self._prefetched = None  # (host buffer, outer, ring size) it holds
    self._draws = torch.empty(shape, dtype=torch.float32, device=self.device)
    self._row = torch.empty(self.layout.width, dtype=torch.float32,
                            device=self.device)  # the graph's input
    self._keys = _LOSS_KEYS + (health_lib.SUMMARY_KEYS if health else ())
    self._carry = {key: torch.zeros((), dtype=torch.float32,
                                    device=self.device)
                   for key in self._keys}
    self._true = torch.ones((), dtype=torch.bool, device=self.device)
    self.env_state = env.init_state(
        None if env.bank is not None
        else procedural_draws(seed + _ENV_INIT, 0, n), mesh=mesh,
        axis=self._data_axis)
    self._outer = 0
    self._episodes = self._successes = 0
    self.env_steps = 0
    self.trained_steps = 0
    # Wall seconds from a dispatch's launch to its metrics on the host:
    # the bench's host_blocked_fraction denominator.
    self.exec_seconds = 0.0

  # --- fleet bookkeeping -----------------------------------------------------

  @property
  def mesh_shape(self) -> Dict[str, int]:
    """{axis: size} of the mesh the loop spans ({"data": 1} on one
    rank)."""
    if self.mesh is None:
      return {"data": 1}
    return {str(axis): int(size) for axis, size in self.mesh.shape.items()}

  @property
  def episodes(self) -> int:
    """Episodes the fleet ended, as of the last dispatch's readback."""
    return self._episodes

  @property
  def successes(self) -> int:
    return self._successes

  # --- crash-resume ------------------------------------------------------------

  def checkpoint_state(self):
    """The carried device state: the env fleet, the ring and the target
    net (the train state stays with the caller); over a mesh, this rank's
    parts of the fleet and the ring."""
    return {"env": self.env_state, "buffer": self._buffer.state,
            "target": self._target_variables}

  def checkpoint_arrays(self) -> Dict[str, Dict[str, np.ndarray]]:
    """Host copies of the whole env fleet and ring, as a checkpoint holds
    them (over a mesh every rank gathers: a collective)."""
    env = self.env_state.arrays()
    if self._sharded:
      group = self.mesh.group(self._data_axis)
      for name in ("images", "targets", "attempts"):
        env[name] = collectives.all_gather(
            getattr(self.env_state, name), group, 0).cpu().numpy()
    return {"env": env, "buffer": self._buffer.checkpoint_arrays()}

  def checkpoint_meta(self) -> Dict[str, int]:
    """The host counters the device state does not carry."""
    return {"outer": self._outer, "env_steps": self.env_steps,
            "trained_steps": self.trained_steps,
            "refresh_count": self._refresh_count,
            "last_refresh_step": self.last_refresh_step}

  def restore_checkpoint_state(self, composite, meta) -> None:
    """Copies a restored composite into the env's, the ring's and the
    target's own tensors (a captured graph keeps reading them) and
    restores the counters, so the next dispatch continues the draws where
    the save cut them."""
    self.env_state.load(composite["env"], self._env_shardings)
    self._buffer.load_state(composite["buffer"])
    self._assign(composite["target"], polyak=False)
    self._outer = int(meta["outer"])
    self.env_steps = int(meta["env_steps"])
    self.trained_steps = int(meta["trained_steps"])
    self._refresh_count = int(meta["refresh_count"])
    self.last_refresh_step = int(meta["last_refresh_step"])
    self._episodes = int(self.env_state.episodes)
    self._successes = int(self.env_state.successes)
    self._prefetched = None

  # --- the body ------------------------------------------------------------------

  def _build_learn(self):
    trainer, buffer, health = self._trainer, self._buffer, self.health
    targets_fn = make_bellman_targets_fn(
        self._model, self._action_size, self._gamma, self._num_samples,
        self._num_elites, self._iterations, self._clip_targets,
        factored=self._factored is not None, precision=self.precision)

    def step_fn(state, features, labels):
      return trainer.train_step(state, features, labels, with_health=health)

    return make_learn_iteration_fn(
        self._model, step_fn, buffer.sample_fn(),
        buffer.update_priorities_fn(), targets_fn,
        getattr(self._model, "target_key", "target_q"), self._clip_targets,
        health_entropy_fn=buffer.priority_entropy_fn() if health else None,
        **mesh_hooks(trainer))

  def _act(self, variables, obs: torch.Tensor, targets: torch.Tensor,
           draws: Mapping[str, torch.Tensor], t: int) -> torch.Tensor:
    """The fleet's actions at control step `t` of a period: CEM's best,
    then the collectors' exploration mix (``CollectorWorker.step_once``'s
    fractions and order)."""
    states, score = make_cem_states_and_score(
        self._model, self._factored, variables, obs,
        precision=self.precision)
    best, _ = cem.fleet_cem_optimize(
        score, states, draws["act_noise"][t], self._action_size,
        num_samples=self._num_samples, num_elites=self._num_elites,
        iterations=self._iterations, precision=self.precision)
    draw, uniform = draws["draw"][t], draws["uniform"][t]
    scripted = torch.cat(
        [torch.clamp(targets + draws["normal"][t] * 0.12, -1.0, 1.0),
         uniform[:, 2:]], dim=1)
    actions = torch.where((draw < self._epsilon)[:, None], uniform, best)
    return torch.where((draw >= 1.0 - self._scripted)[:, None], scripted,
                       actions)

  def _period(self, state, row: torch.Tensor, learn: bool) -> None:
    """`train_every` control steps, then (with `learn`) one learn whose
    metrics merge into the carry; every tensor changes in place and
    nothing waits on the card, so a CUDA graph can hold it."""
    if self._learn is None:
      self._learn = self._build_learn()
    draws = self.layout.views(row)
    if self._sharded:
      draws.update({name: value[:, self._fleet]
                    for name, value in draws.items()
                    if name in _FLEET_FIELDS})
    env, ring = self.env_state, self._buffer.state
    # Acting scores with the whole EMA variables (gathered over a mesh
    # whose model axis splits them).
    variables = state.full_variables(use_ema=True)
    with torch.no_grad():
      for t in range(self.train_every):
        obs = env.images.clone()
        actions = self._act(variables, obs, env.targets, draws, t)
        _, (rewards, dones, _) = self._env_step(
            env, actions,
            draws["reset_targets"][t] if "reset_targets" in draws else None)
        self._extend(ring, {"image": obs, "action": actions,
                            "reward": rewards, "done": dones,
                            "next_image": obs})
    if not learn:
      return
    _, _, metrics = self._learn(
        state, ring, self._target_variables,
        (draws["slots"].long(), draws["uniforms"]), draws["label_noise"])
    with torch.no_grad():
      merged = health_lib.merge_scan_metrics(metrics, self._carry, self._true)
      for key, value in merged.items():
        self._carry[key].copy_(value)

  # --- the draws ---------------------------------------------------------------

  def _fill(self, slot: int, outer: int, size: int) -> None:
    """Dispatch `outer`'s draws into host buffer `slot`, for a ring that
    holds `size` rows when it starts."""
    host = self._host[slot].numpy()
    k, steps = self.inner_steps, self.train_every
    n, batch = self._env.num_envs, self._buffer.sample_batch_size
    for p in range(self.periods):
      views = self.layout.views(host[p])
      for t in range(steps):
        tick = outer * k + p * steps + t
        views["act_noise"][t] = np.random.default_rng(
            (self._seed + _ACT, tick)).standard_normal(
                (n,) + self._noise_shape, dtype=np.float32)
        explore = np.random.default_rng((self._seed + _EXPLORE, tick))
        views["draw"][t] = explore.random(n, dtype=np.float32)
        views["uniform"][t] = explore.uniform(-1.0, 1.0,
                                              (n, self._action_size))
        views["normal"][t] = explore.standard_normal((n, 2),
                                                     dtype=np.float32)
        if "reset_targets" in views:
          views["reset_targets"][t] = procedural_draws(self._seed + _ENV,
                                                       tick, n)
      tick = outer * k + (p + 1) * steps - 1
      filled = min(self._buffer.capacity, size + n * steps * (p + 1))
      views["slots"][:], views["uniforms"][:] = sample_draws(
          self._seed, tick, batch, filled)
      views["label_noise"][:] = np.random.default_rng(
          (self._seed + _LABEL, tick)).standard_normal(
              (batch,) + self._noise_shape, dtype=np.float32)
    self._prefetched = (slot, outer, size)

  def _stage_draws(self, slot: int, draws) -> None:
    """This dispatch's draws (prefetched, or made now), `draws`' fields
    written over them, then one copy to the card."""
    if self._prefetched != (slot, self._outer, self._buffer.size):
      self._fill(slot, self._outer, self._buffer.size)
    if draws is not None:
      host = self._host[slot].numpy()
      for p in range(self.periods):
        views = self.layout.views(host[p])
        for name, value in draws.items():
          views[name][...] = np.asarray(value)[p]
      self._prefetched = None
    self._draws.copy_(self._host[slot], non_blocking=True)

  # --- dispatch ------------------------------------------------------------------

  def _count_build(self) -> None:
    self.compile_counts["anakin_step"] = (
        self.compile_counts.get("anakin_step", 0) + 1)
    self._unregistered = True
    self._register()

  def _register(self) -> None:
    """Enters a build in the ledger once a learning period's FLOPs are
    known."""
    if (self._ledger is None or not self._unregistered
        or self._period_flops is None):
      return
    self._unregistered = False
    self._ledger.register(
        "anakin_step", device=self.device, dtype=self.precision,
        shapes={"inner_steps": self.inner_steps,
                "fleet": self._env.num_envs,
                "batch": self._buffer.sample_batch_size},
        flops=self.periods * self._period_flops)

  def _eager_period(self, state, row: torch.Tensor, learn: bool) -> None:
    """One period run eagerly; with a ledger, the first that learns
    counts its FLOPs (outside any capture)."""
    if not learn or self._ledger is None or self._period_flops is not None:
      self._period(state, row, learn)
      return
    with FlopCounterMode(display=False) as flops:
      self._period(state, row, learn)
    self._period_flops = flops.get_total_flops()
    self._register()

  def compiled(self, train_state):
    """Builds the dispatch program once and returns it: on the card the
    period's CUDA graph over `train_state`'s tensors (an eager dispatch
    that trained must have warmed them), elsewhere the period's body.
    ``compile_counts["anakin_step"]`` counts the builds."""
    if not self._graphs:
      if not self._built:
        self._built = True
        self._count_build()
      return self._period
    if not self._warmed:
      raise RuntimeError("the Anakin period's graph is captured after an "
                         "eager dispatch that trained: call step() first")
    trainer_lib.check_graphable(train_state.opt_state)
    if self._graph is None or not self._graph.holds(train_state):
      self._graph = _AnakinGraph(self, train_state, self._side_stream)
      self._count_build()
    return self._graph

  def _dispatch(self, state, gates: List[bool]) -> None:
    """The dispatch's periods on the staged draws, each learning where
    its gate passed."""
    for value in self._carry.values():
      value.zero_()
    if self._graphs and self._warmed and all(gates):
      graph = self.compiled(state)
      for p in range(self.periods):
        self._row.copy_(self._draws[p])
        graph.replay()
      return
    if not self._graphs:
      self.compiled(state)
      for p, gate in enumerate(gates):
        self._eager_period(state, self._draws[p], gate)
      return
    # The card's eager dispatches run on a side stream, as the megastep's
    # first: the capture then finds cuDNN, cuBLAS and Adam's state warm.
    trainer_lib.check_graphable(state.opt_state)
    if self._side_stream is None:
      self._side_stream = torch.cuda.Stream(self.device)
    current = torch.cuda.current_stream(self.device)
    self._side_stream.wait_stream(current)
    with torch.cuda.stream(self._side_stream):
      for p, gate in enumerate(gates):
        self._eager_period(state, self._draws[p], gate)
    current.wait_stream(self._side_stream)
    self._warmed |= any(gates)

  def step(self, train_state, draws: Optional[Mapping[str, np.ndarray]]
           = None):
    """One dispatch: `inner_steps` control steps and one optimizer step a
    period whose learn passes the min-fill gate. Returns (state, metrics)
    with the metrics as host floats (the dispatch's one readback) and
    ``trained_steps``.

    `draws`: {field: (periods, *field shape)} draws to use in place of
    the loop's own (``layout``'s fields), as the parity tests pass the
    JAX package's."""
    if self._target_variables is None:
      raise ValueError("call refresh(variables, step=0) before step()")
    k, n = self.inner_steps, self._env.num_envs
    size = self._buffer.size
    capacity = self._buffer.capacity
    gates = [min(capacity, size + n * self.train_every * (p + 1))
             >= self.min_fill for p in range(self.periods)]
    slot = self._outer % 2
    self._stage_draws(slot, draws)
    start = time.perf_counter()
    with trace_lib.span("learn/anakin_step", inner=self.inner_steps,
                        fused="act,step,extend,learn"):
      self._dispatch(train_state, gates)
    # While the card works: the next dispatch's draws.
    self._fill(1 - slot, self._outer + 1, min(capacity, size + n * k))
    with torch.no_grad():
      values = torch.cat([
          torch.stack([self._carry[key] for key in self._keys]).double(),
          torch.stack([self.env_state.episodes,
                       self.env_state.successes]).double()]).cpu().tolist()
    seconds = time.perf_counter() - start
    self.exec_seconds += seconds
    if self._ledger is not None:
      self._ledger.record_dispatch("anakin_step", seconds)
    self._buffer.advance_host_counts(n * k)
    trained = sum(gates)
    self._outer += 1
    self.env_steps += k * n
    self.trained_steps += trained
    self._episodes, self._successes = int(values[-2]), int(values[-1])
    metrics = dict(zip(self._keys, values[:-2]))
    metrics["trained_steps"] = trained
    return dataclasses.replace(train_state,
                               step=train_state.step + trained), metrics
