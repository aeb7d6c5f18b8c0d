"""Trainer: the train, eval and predict steps for one model on one device.

Counterpart of ``tensor2robot_tpu/train/trainer.py`` for a single device:
one step is the model's TRAIN-mode forward pass, its loss, the backward
pass, the optimizer's step, the new batch statistics and the EMA update
(``optax.incremental_update``'s rule, as ``lerp_``). Every state tensor
(parameters, optimizer moments, batch statistics, EMA) is updated in
place, so a state keeps its tensors from step to step.

``train_steps`` runs K steps over a K-stacked batch, the JAX trainer's
scanned multi-step (``iterations_per_loop``). On the GPU they are one
CUDA graph of the fixed-shape step, captured once per (K, shapes, dtypes)
and replayed: one dispatch for K steps. ``train_step_accum`` takes one
optimizer step over m microbatches; ``train_step(with_health=True)``
also reduces the gradients for the health sentinel.

A model that draws dropout (``takes_generator``) gets a ``torch.Generator``
a step, seeded from the trainer's seed and the step (``step_seed``), the
counterpart of the JAX step's ``fold_in(base_rng, step)``: masks differ
from step to step and repeat after a resume. A CUDA graph of K steps
registers K generators of its own with the graph
(``register_generator_state``) and seeds each for its step before a
replay, so a replay draws the masks the eager steps would.

``Trainer(mesh=, param_specs=, shard_optimizer_state=)`` trains over a
mesh of ranks (``parallel/``) with the JAX trainer's semantics: pure data
parallelism replicates the parameters and averages the gradients over the
global batch; ``param_specs`` holds parameters sharded as their specs say
(tensor parallelism over a model axis, FSDP over the data axis);
``shard_optimizer_state`` is ZeRO-1. ``train/mesh_layout.py`` keeps the
layout and writes the collectives. Every rank passes its block of the
batch (``shard_batch``). A mesh of more than one rank runs ``train_steps``
as K eager steps: gloo's collectives run on the host, outside any stream a
CUDA graph captures (``check_graphable`` says so). The JAX trainer's AOT
executables come with the train step's extras (``ROADMAP.md`` item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch import Device, bridge, resolve_device
from tensor2robot_tpu_torch.obs import health
from tensor2robot_tpu_torch.ops import graph_launches
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.train.mesh_layout import MeshLayout
from tensor2robot_tpu_torch.train.train_state import TrainState
from tensor2robot_tpu_torch.utils import optimizers
from tensor2robot_tpu_torch.utils.tree import tree_leaves, tree_map

Metrics = Dict[str, torch.Tensor]


def _index(tree: Any, i: int) -> Any:
  """Entry `i` along the leading axis of every leaf."""
  return tree_map(lambda t: t[i], tree)


def _leading(tree: Any) -> int:
  return next(tree_leaves(tree)).shape[0]


def _signature(tree: Any) -> Tuple:
  return tuple((tuple(t.shape), t.dtype) for t in tree_leaves(tree))


def step_seed(seed: int, step: int) -> int:
  """The seed of step `step`'s dropout generator: a function of the
  trainer's seed and the step alone."""
  return int(np.random.SeedSequence((seed, step)).generate_state(
      1, np.uint64)[0] >> np.uint64(1))


def check_graphable(optimizer: torch.optim.Optimizer, mesh=None) -> None:
  """Raises NotImplementedError, by name, for an optimizer whose update a
  CUDA graph cannot replay: a replay runs no Python, so it runs no
  learning-rate schedule (a host-side hook), and Adam must keep its step
  count on the device (``capturable=True``). A `mesh` of more than one
  rank raises too: its collectives run through gloo on the host, which no
  capture holds, so its stacks run as K eager steps."""
  if mesh_lib.is_distributed(mesh):
    raise NotImplementedError(
        f"A mesh of {mesh.size} ranks cannot be captured in a CUDA graph: "
        "gloo's collectives run on the host, outside any stream a capture "
        "holds. Trainer.train_steps runs its stacks as K eager steps.")
  name = type(optimizer).__name__
  if getattr(optimizer, "lr_schedule", None) is not None:
    raise NotImplementedError(
        f"train_steps cannot graph {name} with a learning-rate schedule: "
        "the schedule steps on the host after each update, which a CUDA "
        "graph replay does not run. Train it with train_step.")
  if isinstance(optimizer, torch.optim.Adam):
    if not all(group.get("capturable") for group in optimizer.param_groups):
      raise NotImplementedError(
          f"train_steps cannot graph {name} built without capturable=True "
          "(utils/optimizers.create_adam_optimizer builds it so on the GPU).")
  elif not isinstance(optimizer, (torch.optim.SGD, optimizers.RMSprop)):
    raise NotImplementedError(
        f"train_steps cannot graph {name}: only Adam (capturable), SGD and "
        "RMSprop are known to update by device ops alone.")


def _state_tensors(state: TrainState) -> Tuple[torch.Tensor, ...]:
  """Every tensor a captured step reads or writes in place."""
  tensors = [*state.params.values(), *state.model_state.values(),
             *(state.ema_params or {}).values()]
  for moments in state.opt_state.state.values():
    tensors += [v for v in moments.values() if torch.is_tensor(v)]
  return tuple(tensors)


def _hyperparameters(optimizer: torch.optim.Optimizer) -> str:
  """The optimizer's settings, which a capture bakes in."""
  return repr([{k: v for k, v in group.items() if k != "params"}
               for group in optimizer.param_groups])


class _GraphedSteps:
  """K train steps captured in one CUDA graph, over static input buffers.

  The graph holds the addresses of the state's tensors and of the
  buffers the stacked batch is copied into; ``holds`` says whether a
  state still has those tensors (a checkpoint restore, for one, gives the
  optimizer new moments).
  """

  def __init__(self, trainer: "Trainer", state: TrainState, features,
               labels, stream: torch.cuda.Stream):
    self.steps = _leading(features)
    self.seed = trainer.seed
    self.features = tree_map(torch.empty_like, features)
    self.labels = tree_map(torch.empty_like, labels)
    self.graph = torch.cuda.CUDAGraph()
    # One generator a captured step, registered before the capture: a
    # replay reads each one's seed and offset, which replay() sets.
    self.generators: List[Optional[torch.Generator]] = [None] * self.steps
    if trainer.model.takes_generator():
      self.generators = [torch.Generator(trainer.device)
                         for _ in range(self.steps)]
      for generator in self.generators:
        self.graph.register_generator_state(generator)
    self._seed_generators(state.step)
    state.opt_state.zero_grad(set_to_none=True)
    stream.wait_stream(torch.cuda.current_stream(trainer.device))
    try:
      with graph_launches.capture(self.graph, stream) as self.tally:
        for i in range(self.steps):
          _, metrics = trainer.train_step(
              state, _index(self.features, i), _index(self.labels, i),
              generator=self.generators[i])
    except RuntimeError as e:
      raise NotImplementedError(
          f"train_steps cannot capture {type(trainer.model).__name__}'s "
          f"train step in a CUDA graph: {e}") from e
    torch.cuda.current_stream(trainer.device).wait_stream(stream)
    self.metrics = metrics
    self._tensors = [t.data_ptr() for t in _state_tensors(state)]
    self._hyperparameters = _hyperparameters(state.opt_state)

  def holds(self, state: TrainState) -> bool:
    return ([t.data_ptr() for t in _state_tensors(state)] == self._tensors
            and _hyperparameters(state.opt_state) == self._hyperparameters)

  def _seed_generators(self, step: int) -> None:
    for i, generator in enumerate(self.generators):
      if generator is not None:
        generator.manual_seed(step_seed(self.seed, step + i))

  def replay(self, features, labels, step: int) -> Metrics:
    """Replays the K steps from global step `step`."""
    for static, value in zip(tree_leaves((self.features, self.labels)),
                             tree_leaves((features, labels))):
      static.copy_(value, non_blocking=True)
    self._seed_generators(step)
    self.graph.replay()
    graph_launches.replayed(self.tally)
    return {key: value.clone() for key, value in self.metrics.items()}


class Trainer:
  """Owns the device and the steps for one model."""

  def __init__(self, model, seed: int = 0, device: Device = None,
               mesh: Optional[mesh_lib.Mesh] = None, param_specs=None,
               shard_optimizer_state: bool = False, data_axis: str = "data"):
    """Args:
      model: an ``AbstractT2RModel``.
      seed: seeds the ``torch.Generator`` that draws fresh variables, and
        with the step each step's dropout generator.
      device: where to train; the GPU unless 'cpu' is asked for.
      mesh: a ``parallel.mesh.Mesh`` of ranks; None (or one rank) trains
        on this process alone.
      param_specs: a flax tree of ``PartitionSpec``s for the parameters
        (``parallel.tp_rules``): tensor parallelism over a model axis, FSDP
        over the data axis. None replicates them: pure data parallelism.
      shard_optimizer_state: ZeRO-1: each optimizer tensor additionally
        splits over the data axis on its largest divisible dim its
        parameter's spec leaves unclaimed.
      data_axis: the mesh axis the batch splits over.
    """
    self.model = model
    self.seed = seed
    self.device = resolve_device(device)
    self.mesh = mesh
    self.data_axis = data_axis
    self.layout: Optional[MeshLayout] = None
    if mesh_lib.is_distributed(mesh):
      self.layout = MeshLayout(model, mesh, param_specs,
                               shard_optimizer_state, data_axis)
    self._graphs: Dict[Tuple, _GraphedSteps] = {}
    self._warmed = set()  # per-step signatures run eagerly on the side
    self._side_stream = None
    self._generator: Optional[torch.Generator] = None

  def step_generator(self, step: int) -> Optional[torch.Generator]:
    """The dropout generator of global step `step` on the trainer's
    device (``step_seed``), or None for a model that draws none."""
    if not self.model.takes_generator():
      return None
    if self._generator is None:
      self._generator = torch.Generator(self.device)
    return self._generator.manual_seed(step_seed(self.seed, step))

  # --- state ---------------------------------------------------------------

  def create_train_state(
      self, variables: Optional[Mapping[str, Any]] = None) -> TrainState:
    """A fresh TrainState on the trainer's device.

    Args:
      variables: None draws flax's initialisers from
        ``torch.Generator().manual_seed(seed)``. Else the variables to start
        from: a flax tree (``{"params": ..., "batch_stats": ...}``, as the
        JAX ``TrainState.variables()`` gives it), which the weight bridge
        maps, or the model's own state_dict. They are copied.
    """
    module = self.model.module
    if variables is None:
      state_dict = self.model.init_variables(
          torch.Generator().manual_seed(self.seed), device=self.device)
    elif "params" in variables:
      state_dict = bridge.variables_to_state_dict(variables, module)
    else:
      state_dict = dict(variables)
      expected = set(module.state_dict())
      if set(state_dict) != expected:
        raise KeyError(
            f"variables have keys {sorted(state_dict)}; the model has "
            f"{sorted(expected)}.")
    names = [name for name, _ in module.named_parameters()]
    params = {
        name: state_dict[name].detach().to(self.device, copy=True)
        .requires_grad_() for name in names}
    model_state = {
        key: value.detach().to(self.device, copy=True)
        for key, value in state_dict.items() if key not in params}
    ema = ({name: p.detach().clone() for name, p in params.items()}
           if self.model.use_avg_model_params else None)
    state = TrainState(
        step=0, params=params, model_state=model_state,
        opt_state=self.model.create_optimizer(list(params.values())),
        ema_params=ema)
    if self.model.init_from_checkpoint:
      state = self._warm_start(state, self.model.init_from_checkpoint)
    if self.layout is not None:
      state = self.layout.shard(state, self.model.create_optimizer)
    return state

  def _warm_start(self, state: TrainState, checkpoint_path: str
                  ) -> TrainState:
    """Loads the parameters that match by (mapped) flax path and shape
    from `checkpoint_path` into `state`, in place; the EMA re-seeds from
    them (at decay ~0.9999 an EMA left on the random init would poison
    eval and export for tens of thousands of steps)."""
    from tensor2robot_tpu_torch.train import checkpoints
    restored = checkpoints.restore_params(checkpoint_path)
    merged = checkpoints.merge_params(
        bridge.state_dict_to_variables(state.params)["params"], restored,
        assignment_map=self.model.init_from_checkpoint_assignment_map)
    params = bridge.params_to_state_dict(merged, self.model.module)
    with torch.no_grad():
      for name, tensor in state.params.items():
        tensor.copy_(params[name])
        if state.ema_params is not None:
          state.ema_params[name].copy_(params[name])
    return state

  # --- steps ---------------------------------------------------------------

  def _finish_step(self, state: TrainState, new_model_state) -> None:
    """The optimizer's step, then the statistics and the EMA, in place."""
    state.opt_state.step()
    if state.layout is not None:
      state.layout.after_step(state)
    with torch.no_grad():
      for key, value in new_model_state.items():
        state.model_state[key].copy_(value)
      if state.ema_params is not None:
        names = list(state.params)
        torch._foreach_lerp_([state.ema_params[n] for n in names],
                             [state.params[n] for n in names],
                             1.0 - self.model.avg_model_params_decay)

  def train_step(self, state: TrainState, features, labels=None,
                 with_health: bool = False,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[TrainState, Metrics]:
    """One optimizer step; the state's tensors update in place. Go on with
    the state returned (its step is one more).

    ``with_health`` adds ``grad_norm`` (global L2, float32) and
    ``grads_nonfinite`` (non-finite elements) of the raw gradients, taken
    before the optimizer's step, to the metrics: the two reductions the
    health sentinel cannot rebuild from the parameters afterwards.
    `generator` feeds dropout; by default the step's
    (``step_generator``)."""
    if generator is None:
      generator = self.step_generator(state.step)
    if self.layout is not None:
      return self._mesh_step(state, [(features, labels)], generator,
                             with_health)
    state.opt_state.zero_grad(set_to_none=True)
    loss, (metrics, new_model_state) = self.model.model_train_fn(
        state.variables(), features, labels, generator=generator)
    loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    if with_health:
      grads = [p.grad for p in state.params.values() if p.grad is not None]
      metrics["grad_norm"] = health.tree_global_norm(grads)
      metrics["grads_nonfinite"] = health.tree_nonfinite_count(grads)
    self._finish_step(state, new_model_state)
    return dataclasses.replace(state, step=state.step + 1), metrics

  def train_steps(self, state: TrainState, features, labels=None
                  ) -> Tuple[TrainState, Metrics]:
    """K optimizer steps over a K-stacked batch (the leading axis of every
    leaf); returns the last step's metrics.

    On the CPU, and over a mesh of ranks, K ``train_step`` calls. On the
    GPU, a CUDA graph of the K steps: the first stack of a per-step shape
    runs eagerly on a side stream (it warms up cuDNN, cuBLAS, the kernels'
    builds and the optimizer's state), and each later (K, shapes, dtypes)
    is captured once, then replayed with the stack copied into the graph's
    input buffers. A final stack of another K gets a graph of its own. An
    optimizer or a model the graph cannot hold raises NotImplementedError
    (``check_graphable``); nothing falls back to eager steps.
    """
    steps = _leading(features)
    if self.device.type != "cuda" or self.layout is not None:
      for i in range(steps):
        state, metrics = self.train_step(state, _index(features, i),
                                         _index(labels, i))
      return state, metrics
    check_graphable(state.opt_state)
    if self._side_stream is None:
      self._side_stream = torch.cuda.Stream(self.device)
    per_step = (_signature(_index(features, 0)),
                _signature(_index(labels, 0)))
    if per_step not in self._warmed:
      stream, current = self._side_stream, torch.cuda.current_stream(
          self.device)
      stream.wait_stream(current)
      with torch.cuda.stream(stream):
        for i in range(steps):
          state, metrics = self.train_step(state, _index(features, i),
                                           _index(labels, i))
      current.wait_stream(stream)
      self._warmed.add(per_step)
      return state, metrics
    key = (steps,) + per_step
    graph = self._graphs.get(key)
    if graph is None or not graph.holds(state):
      graph = self._graphs[key] = _GraphedSteps(
          self, state, features, labels, self._side_stream)
    metrics = graph.replay(features, labels, state.step)
    return dataclasses.replace(state, step=state.step + steps), metrics

  def train_step_accum(self, state: TrainState, features, labels=None
                       ) -> Tuple[TrainState, Metrics]:
    """One optimizer step over m microbatches (the leading axis of every
    leaf): their gradients summed in order and divided by m, the batch
    statistics threaded through them in order, the metrics their means.
    The microbatches draw dropout from the step's generator in turn."""
    micro = _leading(features)
    generator = self.step_generator(state.step)
    if self.layout is not None:
      return self._mesh_step(
          state, [(_index(features, i), _index(labels, i))
                  for i in range(micro)], generator, False)
    state.opt_state.zero_grad(set_to_none=True)
    model_state = dict(state.model_state)
    per_micro = []
    for i in range(micro):
      loss, (metrics, new_model_state) = self.model.model_train_fn(
          {**state.params, **model_state}, _index(features, i),
          _index(labels, i), generator=generator)
      loss.backward()  # adds into .grad
      model_state.update(new_model_state)
      per_micro.append({k: v.detach() for k, v in metrics.items()})
    with torch.no_grad():
      for param in state.params.values():
        if param.grad is not None:
          param.grad.div_(micro)
    self._finish_step(state, {key: model_state[key]
                              for key in state.model_state})
    return (dataclasses.replace(state, step=state.step + 1),
            {key: torch.stack([m[key] for m in per_micro]).mean(dim=0)
             for key in per_micro[0]})

  def _mesh_step(self, state: TrainState, batches, generator,
                 with_health: bool) -> Tuple[TrainState, Metrics]:
    """One optimizer step over a mesh (``mesh_layout``): each of `batches`
    (this rank's blocks; more than one are microbatches whose gradients
    average) forward and backward, the data axis's reductions, the
    update, the statistics and the EMA; metrics averaged over the data
    axis."""
    layout = self.layout
    state.opt_state.zero_grad(set_to_none=True)
    for param in state.params.values():
      param.grad = None
    scale = 1.0 / (layout.data_size * len(batches))
    model_state = dict(state.model_state)
    per_batch = []
    for features, labels in batches:
      with layout.forward_context(train=True):
        variables = layout.forward_variables(state)
        variables.update(model_state)
        loss, (metrics, new_model_state) = self.model.model_train_fn(
            variables, features, labels, generator=generator)
      (loss * scale).backward()
      model_state.update(new_model_state)
      per_batch.append({k: v.detach() for k, v in metrics.items()})
    layout.reduce_gradients(state)
    metrics = {key: torch.stack([m[key] for m in per_batch]).mean(dim=0)
               for key in per_batch[0]}
    if with_health:
      metrics["grad_norm"], metrics["grads_nonfinite"] = (
          layout.gradient_health(state))
    self._finish_step(state, {key: model_state[key]
                              for key in state.model_state})
    return (dataclasses.replace(state, step=state.step + 1),
            layout.average(metrics))

  def eval_step(self, state: TrainState, features, labels=None) -> Metrics:
    """Eval metrics of one batch (EMA parameters when kept); over a mesh,
    of the global batch whose block this rank holds."""
    if self.layout is not None:
      with torch.no_grad(), self.layout.forward_context(train=False):
        metrics = self.model.model_eval_fn(
            self.layout.forward_variables(state, use_ema=True), features,
            labels)
      return self.layout.average(metrics)
    with torch.no_grad():
      return self.model.model_eval_fn(state.variables(use_ema=True),
                                      features, labels)

  def shard_batch(self, batch: Any) -> Any:
    """This rank's block of a global batch (the whole batch without a
    mesh)."""
    if self.layout is None:
      return batch
    return mesh_lib.shard_batch(self.mesh, batch, self.data_axis)

  def gather_batch(self, tensor: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's block of `tensor` (its leading
    dim), the inverse of ``shard_batch``: a collective over the data axis
    (`tensor` itself without a mesh)."""
    if self.layout is None:
      return tensor
    return collectives.all_gather(tensor, self.layout.data_group, 0)

  @property
  def graphs_steps(self) -> bool:
    """Whether ``train_steps`` replays CUDA graphs (the GPU, no mesh)."""
    return self.device.type == "cuda" and self.layout is None

  def predict_fn(self, state: TrainState) -> Callable[[Any], Any]:
    """PREDICT-mode closure over a snapshot of the current (EMA) variables:
    later steps update the state's tensors in place, not the snapshot.
    Over a mesh every rank gathers the whole variables."""
    variables = {key: value.detach().clone()
                 for key, value in state.full_variables(use_ema=True).items()}
    model = self.model

    def predict(features):
      return model.predict_fn(variables, features)

    return predict
