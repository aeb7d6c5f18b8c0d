"""BellmanUpdater: CEM-maximized Q-targets against a lagged target net.

Counterpart of ``tensor2robot_tpu/replay/bellman.py``. The QT-Opt updater
turns sampled transitions into training targets

    target(s, a) = r + gamma * (1 - done) * max_a' Q_target(s', a')

where the max is the cross-entropy-method search serving uses, run over
every next state of the batch at once (``cem.fleet_cem_optimize``: one
forward of B*N tiled images per CEM iteration).

**The draws.** A state's CEM draws are a pure function of (seed, label
seed), never of the batch it was labelled in or its position there, as in
the JAX package. The port draws each state's (iterations, N, A) block on
the host with ``cem.seeded_noise`` (``np.random.default_rng((seed,
label_seed))``, float32 standard normals; the fleet policy draws a
request's block the same way), stacks the batch's blocks and copies them
to the device once a label: the same draws on the CPU and the card. threefry and
Philox cannot agree, so a parity test passes the JAX package's own draws
through ``compute_targets(noise=)``.

The target network is an argument of the label closure, never a constant
captured in it: a refresh (hard lag or polyak) copies the online values
into the target's own tensors and rebuilds nothing, so a CUDA graph that
reads them (the megastep's, ``replay/device_buffer.py``) sees each one.
``compile_counts`` counts the builds of the label and TD closures under
the JAX package's names; each stays 1 for the updater's life.

**Scoring tiers.** ``precision`` ("f32", "bf16", "int8";
``research/qtopt/cem.py``) sets the tier of the target net's scoring in
the CEM max. Targets, TD errors (priorities and the eval metric against
Q*) and everything after the max stay float32 under every tier.

**The ledger.** With ``ledger=`` (``obs/ledger.py``) the label closure
registers as ``bellman_targets`` at the scoring tier and the TD closure
as ``td_error`` at "f32", each with the FLOPs its first call counted
(``FlopCounterMode``), and every call records its host seconds through its
numpy readback, the wait the call already has.

Over a mesh of ranks the fused learners keep the whole target on every
rank, so every rank labels with it; a refresh takes the whole online
variables (the loop gathers a tensor-parallel state's blocks first,
``full_variables``). ``TargetNetwork(sharding=)`` instead keeps each
rank's block of the target where a sharding's spec says.
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.research.qtopt import cem


def q_value_from_logits(logits: torch.Tensor,
                        clip_targets: bool) -> torch.Tensor:
  """Logit -> value space (``CriticModel.q_value`` on tensors)."""
  logits = logits.float()
  return torch.sigmoid(logits) if clip_targets else logits


def make_cem_states_and_score(model, fns, variables, images,
                              precision: str = "f32"):
  """The one CEM scoring recipe: (states, batched score_fn) for
  ``fleet_cem_optimize``, tiled or factored.

  `fns` is the model's ``factored_cem_fns()`` result: None scores full
  images through ``predict_fn`` (tiled); (encode_fn, q_from_code_fn)
  encodes each image once and scores the codes, the same Q function with
  the image tower out of the sample loop.

  `precision` is the scoring tier (``cem.SCORING_PRECISIONS``); "f32" is
  the pre-tier recipe. Under "bf16" and "int8" the factored encode runs
  once at the tier, over ``cem.scoring_weights_view`` (dense: int8's is
  the quantize -> dequantize round trip, the weights the fleet policy
  scores with) and a floating image cast to the scoring dtype (the model
  scales a uint8 one, as at f32), and the codes are scored at the
  tier."""
  if fns is None:
    return images, cem.make_batched_tiled_q_score_fn(
        model.predict_fn, variables, precision)
  encode_fn, q_from_code_fn = fns
  if cem.validate_precision(precision) != "f32":
    if images.is_floating_point():
      images = images.to(cem.scoring_dtype(precision))
    states = encode_fn(cem.scoring_weights_view(variables, precision),
                       {"image": images})
    return states, cem.make_batched_tiled_q_score_fn(
        q_from_code_fn, variables, precision)
  return (encode_fn(variables, {"image": images}),
          cem.make_batched_tiled_q_score_fn(q_from_code_fn, variables))


def make_bellman_targets_fn(model, action_size: int, gamma: float,
                            num_samples: int, num_elites: int,
                            iterations: int, clip_targets: bool,
                            factored: bool = False,
                            precision: str = "f32"):
  """The Bellman target body as one closure:

  (target_variables, next_images, rewards, dones, noise) -> (targets,
  q_next), with noise (B, iterations, N, A). The cross-entropy critic's
  targets are clipped to [0, 1]. factored=True needs
  ``model.factored_cem_fns()``. `precision` is the tier of the target
  net's scoring inside the search; the best logits return to float32, so
  the arithmetic after the max (reward, discount, done mask, clip) is
  float32 under every tier.
  """
  cem.validate_precision(precision)
  fns = model.factored_cem_fns() if factored else None
  if factored and fns is None:
    raise ValueError(
        f"{type(model).__name__} has no factored CEM form "
        "(factored_cem_fns() returned None); use factored=False")

  def targets_fn(target_variables, next_images, rewards, dones, noise):
    states, score = make_cem_states_and_score(model, fns, target_variables,
                                              next_images, precision)
    _, best_logits = cem.fleet_cem_optimize(
        score, states, noise, action_size, num_samples=num_samples,
        num_elites=num_elites, iterations=iterations, precision=precision)
    q_next = q_value_from_logits(best_logits, clip_targets)
    targets = (rewards.float()
               + gamma * (1.0 - dones.float()) * q_next)
    if clip_targets:
      targets = torch.clamp(targets, 0.0, 1.0)
    return targets, q_next

  return targets_fn


def _host_tree(variables) -> Dict[str, np.ndarray]:
  return {key: value.detach().cpu().numpy()
          for key, value in variables.items()}


class TargetNetwork:
  """The target net's lifecycle: hard-lag or polyak refresh (copied into
  the target's tensors; the consumers take the target as an argument, so
  a refresh rebuilds nothing), plus the lag and refresh-count health
  metrics.

  Args:
    variables: the initial target (a state_dict of tensors or arrays),
      copied onto `device`; None leaves the target cold.
    polyak_tau: None copies on refresh; else target <- tau * online +
      (1 - tau) * target per refresh.
    sharding: a ``parallel.mesh.NamedSharding``: each rank keeps the
      part of every target tensor its spec gives it (the whole tensor
      under a replicated sharding). The variables handed in are whole on
      every rank. None keeps them whole.
    device: where the target lives; the GPU unless 'cpu' is asked for.
  """

  def __init__(self, variables=None, polyak_tau: Optional[float] = None,
               sharding=None, device: Device = None):
    self.device = resolve_device(device)
    self._sharding = sharding
    self._polyak_tau = polyak_tau
    self._target_variables = (None if variables is None
                              else self._copy(variables))
    self._refresh_count = 0
    self.last_refresh_step = 0

  def _local(self, value) -> torch.Tensor:
    """This rank's part of one whole variable (a view, no copy)."""
    value = torch.as_tensor(value).detach()
    if self._sharding is None:
      return value
    return mesh_lib.local_block(value, self._sharding.mesh,
                                self._sharding.spec)

  def _copy(self, variables) -> Dict[str, torch.Tensor]:
    """Copies of `variables` (this rank's parts of them under a sharding)
    on the target's device."""
    return {key: self._local(value).to(self.device, copy=True)
            for key, value in variables.items()}

  def _assign(self, variables, polyak: bool) -> None:
    """Writes `variables` into the target's own tensors (a cold target
    gets copies): a captured graph that reads them sees every refresh."""
    if self._target_variables is None:
      self._target_variables = self._copy(variables)
      return
    tau = self._polyak_tau
    with torch.no_grad():
      for key, target in self._target_variables.items():
        value = self._local(variables[key]).to(self.device)
        if polyak and tau is not None and value.is_floating_point():
          value = tau * value + (1.0 - tau) * target
        target.copy_(value)

  def refresh(self, variables, step: int) -> None:
    """Pulls the online variables into the target net (lag or polyak; the
    first refresh of a cold target is always a hard copy). The target
    keeps its tensors: the values are copied into them."""
    self._assign(variables, polyak=True)
    self._refresh_count += 1
    self.last_refresh_step = int(step)

  def target_lag(self, step: int) -> int:
    """Optimizer steps since the target net last saw online params."""
    return int(step) - self.last_refresh_step

  @property
  def refresh_count(self) -> int:
    return self._refresh_count

  def target_state(self):
    """(host target variables, bookkeeping meta) for a loop checkpoint:
    the target lags the online params, so a resume must carry it."""
    variables = (None if self._target_variables is None
                 else _host_tree(self._target_variables))
    return variables, {"refresh_count": self._refresh_count,
                       "last_refresh_step": self.last_refresh_step}

  def restore_target_state(self, variables, meta) -> None:
    """Inverse of target_state (into the target's own tensors)."""
    if variables is None:
      self._target_variables = None
    else:
      self._assign(variables, polyak=False)
    self._refresh_count = int(meta["refresh_count"])
    self.last_refresh_step = int(meta["last_refresh_step"])


class BellmanUpdater(TargetNetwork):
  """Q-target labeller over a critic model with a ``q_predicted`` head.

  Args:
    model: a CriticModel; its loss_type decides the targets' value space
      (cross-entropy targets are probabilities, clipped to [0, 1]).
    variables: the initial online variables; the target net starts as a
      copy of them.
    action_size / num_samples / num_elites / iterations: the CEM search
      of the max.
    seed: with the label seed, fixes each state's CEM draws.
    polyak_tau: None = hard copy on refresh().
    ledger: an ``obs.ledger.ExecutableLedger`` the label and TD closures
      register into and record their calls in.
    precision: the CEM scoring tier of the labels (TD errors stay
      float32).
    device: where labels and TD errors are computed; the GPU unless
      'cpu' is asked for.
  """

  def __init__(self, model, variables, action_size: int = 4,
               gamma: float = 0.9, num_samples: int = 32,
               num_elites: int = 4, iterations: int = 2, seed: int = 0,
               polyak_tau: Optional[float] = None, ledger=None,
               precision: str = "f32", device: Device = None):
    super().__init__(variables, polyak_tau=polyak_tau, device=device)
    self.precision = cem.validate_precision(precision)
    self._model = model
    self._action_size = action_size
    self._gamma = gamma
    self._num_samples = num_samples
    self._num_elites = num_elites
    self._iterations = iterations
    self._seed = seed
    self._clip_targets = getattr(model, "loss_type",
                                 "cross_entropy") == "cross_entropy"
    # closure name -> builds; every value stays 1 for the updater's life.
    self.compile_counts: Dict[str, int] = {}
    self._ledger = ledger
    self._registered = set()  # the closures the ledger holds
    self._targets_fn = None
    self._td_fn = None
    self._next_label_seed = 0

  def _build(self, name: str, fn):
    self.compile_counts[name] = self.compile_counts.get(name, 0) + 1
    return fn

  def _call(self, name: str, dtype: str, fn, *args) -> Tuple[np.ndarray,
                                                             ...]:
    """Runs closure `name` on `args` and reads its outputs back as numpy.
    With a ledger, its first call counts its FLOPs and registers it (the
    closure's one build), and every call records its seconds through the
    readback."""
    ledger = self._ledger
    first = ledger is not None and name not in self._registered
    start = time.perf_counter()
    with torch.inference_mode():
      if first:
        with FlopCounterMode(display=False) as flops:
          outputs = fn(*args)
      else:
        outputs = fn(*args)
      outputs = tuple(t.cpu().numpy() for t in outputs)
    if ledger is not None:
      if first:
        self._registered.add(name)
        ledger.register(name, device=self.device, dtype=dtype,
                        flops=flops.get_total_flops())
      ledger.record_dispatch(name, time.perf_counter() - start)
    return outputs

  def _tensor(self, array, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    tensor = torch.as_tensor(np.asarray(array))
    return tensor.to(self.device, dtype)

  def label_noise(self, seeds) -> np.ndarray:
    """(B, iterations, N, A) float32 draws: state i's block from
    ``np.random.default_rng((seed, seeds[i]))`` (``cem.seeded_noise``)."""
    return cem.seeded_noise(self._seed, seeds, self._iterations,
                            self._num_samples, self._action_size)

  def compute_targets(self, batch: Mapping, seeds=None, noise=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Labels one transition batch.

    Args:
      batch: mapping with next_image / reward / done leaves (the replay
        ring's sampled batch).
      seeds: (B,) label seeds; default: the next B of a monotonic counter,
        so every label draw in a run is distinct but replayable.
      noise: (B, iterations, N, A) draws to use in place of the seeds'.

    Returns:
      (targets (B,), q_next (B,)) as host numpy float32.
    """
    next_images = self._tensor(batch["next_image"])
    rewards = self._tensor(batch["reward"])
    dones = self._tensor(batch["done"])
    n = next_images.shape[0]
    if seeds is None:
      seeds = np.arange(self._next_label_seed, self._next_label_seed + n,
                        dtype=np.uint32)
      self._next_label_seed += n
    if noise is None:
      noise = self.label_noise(seeds)
    noise = self._tensor(noise, torch.float32)
    if self._targets_fn is None:
      self._targets_fn = self._build("bellman_targets",
                                     make_bellman_targets_fn(
                                         self._model, self._action_size,
                                         self._gamma, self._num_samples,
                                         self._num_elites, self._iterations,
                                         self._clip_targets,
                                         precision=self.precision))
    return self._call("bellman_targets", self.precision, self._targets_fn,
                      self._target_variables, next_images, rewards, dones,
                      noise)

  @property
  def next_label_seed(self) -> int:
    """The label-seed counter (checkpointed so a resumed loop's draws
    continue the interrupted stream)."""
    return self._next_label_seed

  def restore_label_seed(self, next_label_seed: int) -> None:
    self._next_label_seed = int(next_label_seed)

  def _build_td_fn(self):
    model = self._model

    def td_fn(variables, images, actions, targets):
      outputs = model.predict_fn(variables, {"image": images,
                                             "action": actions.float()})
      q = q_value_from_logits(outputs["q_predicted"].reshape(-1),
                              self._clip_targets)
      return (torch.abs(q - targets.float()),)

    return td_fn

  def td_errors(self, variables, batch: Mapping, targets) -> np.ndarray:
    """|Q(s, a) - target| per transition, in value space, float32.

    Drives the priority updates (sampled batch, online variables) and the
    eval metric (held-out batch)."""
    if self._td_fn is None:
      self._td_fn = self._build("td_error", self._build_td_fn())
    td, = self._call("td_error", "f32", self._td_fn, variables,
                     self._tensor(batch["image"]),
                     self._tensor(batch["action"]), self._tensor(targets))
    return td
