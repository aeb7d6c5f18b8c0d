"""Rank bodies for the replay loop's mesh tests (no JAX here).

``tensor2robot_tpu_torch.parallel.launch`` spawns processes that import
this module by name, so it imports torch and the port only. ``cases`` runs
every case of ``tests/test_torch_mesh_loop.py`` that needs two ranks in
one spawn; the test process runs the same functions on one rank (``mesh``
None) for the oracle. Each case returns numpy.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.parallel import create_mesh, distributed
from tensor2robot_tpu_torch.replay import anakin, device_buffer, loop, smoke
from tensor2robot_tpu_torch.research.qtopt import device_grasping as dg
from tensor2robot_tpu_torch.train.trainer import Trainer
from tensor2robot_tpu_torch.utils import backoff, optimizers

IMG = 12
N_ENVS, BATCH, CAPACITY = 4, 8, 64
CEM = dict(num_samples=4, num_elites=2, iterations=2)
K = 8  # one period a dispatch
LR = 1e-3
LOSS_KEYS = ("loss", "td_error", "q_next", "staleness")
# TinyQ's dense kernels column-split over the model axis, the q head
# whole (the JAX tests' TPTinyQCriticModel rules).
_TP_RULES = (
    (r"(img_fc1|img_code|act_fc1|joint_fc1|joint_fc2)/kernel", (None, "m")),
    (r"(img_fc1|img_code|act_fc1|joint_fc1|joint_fc2)/bias", ("m",)),
    (r".*", ()),
)


class TPTinyQCriticModel(smoke.TinyQCriticModel):
  """TinyQ with partition rules: its dense layers split over `axis`."""

  def partition_rules(self, axis: str = "model"):
    from tensor2robot_tpu_torch.parallel.mesh import PartitionSpec as P
    return tuple((pattern, P(*[axis if e == "m" else e for e in spec]))
                 for pattern, spec in _TP_RULES)


def tinyq(tp_rules: bool = False):
  cls = TPTinyQCriticModel if tp_rules else smoke.TinyQCriticModel
  return cls(image_size=IMG, optimizer_fn=optimizers.create_adam_optimizer(LR))


def _whole(tree):
  return {key: value.detach().cpu().numpy() for key, value in tree.items()}


def build_anakin(mesh=None, zero1=False, min_fill=10 ** 6, variables=None,
                 target=None, tp=False, dtype="float32"):
  """The Anakin loop over `mesh` (None: one rank) at the test's sizes,
  from flax `variables` and `target` (the JAX init through the bridge) or
  TinyQ's own init."""
  model = tinyq(tp_rules=tp)
  specs = None
  if tp:
    from tensor2robot_tpu_torch.parallel import tp_rules
    specs = tp_rules.partition_specs_for_model(model, mesh, axis="model")
  trainer = Trainer(model, seed=0, device="cpu", mesh=mesh,
                    param_specs=specs, shard_optimizer_state=zero1)
  if dtype == "float64":
    init = model.init_variables(torch.Generator().manual_seed(0),
                                device="cpu")
    variables = {key: value.double() for key, value in init.items()}
  state = trainer.create_train_state(variables)
  ring = device_buffer.DeviceReplayBuffer(
      loop.transition_spec(IMG, 4), CAPACITY, BATCH, seed=13,
      prioritized=True, ingest_chunk=N_ENVS, device="cpu",
      mesh=trainer.mesh)
  env = dg.DeviceGraspEnv(
      N_ENVS, image_size=IMG, max_attempts=3, radius=0.4,
      bank=dg.make_scene_bank(64, image_size=IMG, base_seed=0,
                              device="cpu"), device="cpu")
  fused = anakin.AnakinLoop(
      model, trainer, ring, env, action_size=4, gamma=0.8, inner_steps=K,
      train_every=K, min_fill=min_fill, seed=13, health=True, **CEM)
  if target is not None:
    fused.refresh(bridge.variables_to_state_dict(target, model.module), 0)
  else:
    fused.refresh(state.full_variables(use_ema=True), 0)
  return state, fused, ring


def run_anakin(mesh=None, dispatches=1, draws=None, grads=False, **kwargs):
  """`dispatches` Anakin dispatches (each with `draws[i]` when given):
  their metrics, the whole ring and fleet after them, and with `grads`
  the first dispatch's gradients whole."""
  state, fused, ring = build_anakin(mesh, **kwargs)
  metrics, first_grads = [], None
  for i in range(dispatches):
    state, got = fused.step(state, draws=None if draws is None else draws[i])
    metrics.append(got)
    if grads and i == 0:
      if state.layout is not None:
        first_grads = _whole(state.layout.full_gradients(state))
      else:
        first_grads = {key: p.grad.numpy().copy()
                       for key, p in state.params.items()}
  arrays = fused.checkpoint_arrays()
  return {"metrics": metrics, "env": arrays["env"], "ring": arrays["buffer"],
          "grads": first_grads, "compile_counts": fused.compile_counts,
          "mesh_shape": fused.mesh_shape,
          "params": _whole(state.full_variables())}


def synthetic_transitions(n, seed):
  """`n` random transitions of the test's spec from `seed`."""
  rng = np.random.default_rng(seed)
  return {
      "image": rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8),
      "action": rng.uniform(-1, 1, (n, 4)).astype(np.float32),
      "reward": (rng.random(n) < 0.3).astype(np.float32),
      "done": (rng.random(n) < 0.3).astype(np.float32),
      "next_image": rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8),
  }


def run_megastep(mesh=None, zero1=False, dispatches=3, inner_steps=4,
                 shard_capacity=True):
  """The megastep over a ring every rank fills with the same rows (whole
  on every rank without `shard_capacity`)."""
  model = tinyq()
  trainer = Trainer(model, seed=0, device="cpu", mesh=mesh,
                    shard_optimizer_state=zero1)
  state = trainer.create_train_state()
  ring = device_buffer.DeviceReplayBuffer(
      loop.transition_spec(IMG, 4), CAPACITY, BATCH, seed=3,
      prioritized=True, ingest_chunk=16, device="cpu", mesh=trainer.mesh,
      shard_capacity=shard_capacity)
  ring.extend(synthetic_transitions(48, 17))
  learner = device_buffer.MegastepLearner(
      model, trainer, ring, action_size=4, gamma=0.8,
      inner_steps=inner_steps, seed=13, health=True, **CEM)
  learner.refresh(state.full_variables(use_ema=True), step=0)
  metrics = []
  for _ in range(dispatches):
    state, got = learner.step(state)
    metrics.append(got)
  return {"metrics": metrics, "ring": ring.checkpoint_arrays(),
          "compile_counts": learner.compile_counts,
          "rows": ring.state.storage["image"].shape[0]}


def placements(mesh) -> dict:
  """Where the dp=2 ZeRO-1 Anakin run keeps what it holds, on this rank."""
  state, fused, ring = build_anakin(mesh, zero1=True, min_fill=8)
  state, _ = fused.step(state)
  whole = dict(state.layout.model.module.named_parameters())
  moments = [tensor for slot in state.opt_state.state.values()
             for tensor in slot.values()
             if torch.is_tensor(tensor) and tensor.dim() > 0]
  return {
      "ring_rows": {key: value.shape[0]
                    for key, value in ring.state.storage.items()},
      "written_at_rows": ring.state.written_at.shape[0],
      "fleet_rows": {name: getattr(fused.env_state, name).shape[0]
                     for name in ("images", "targets", "attempts")},
      "params_whole": all(tuple(value.shape) == tuple(whole[key].shape)
                          for key, value in state.params.items()),
      "opt_split": any(
          tuple(state.opt_params[key].shape) != tuple(whole[key].shape)
          for key in state.opt_params),
      "moment_numel": sum(m.numel() for m in moments),
      "block_numel": sum(p.numel() for p in state.opt_params.values()),
      "param_numel": sum(p.numel() for p in whole.values()),
      "tree_len": ring.state.tree.shape[0],
  }


def refusals(mesh) -> dict:
  """The mesh's refusals of indivisible sizes, as messages."""
  out = {}
  model = tinyq()
  trainer = Trainer(model, seed=0, device="cpu", mesh=mesh,
                    shard_optimizer_state=True)
  spec = loop.transition_spec(IMG, 4)
  try:
    device_buffer.DeviceReplayBuffer(spec, 65, BATCH, ingest_chunk=4,
                                     device="cpu", mesh=mesh)
  except ValueError as e:
    out["capacity"] = str(e)
  for name, fleet, batch in (("fleet", 3, BATCH), ("batch", N_ENVS, 7)):
    ring = device_buffer.DeviceReplayBuffer(
        spec, CAPACITY, batch, ingest_chunk=fleet, device="cpu", mesh=mesh)
    env = dg.DeviceGraspEnv(fleet, image_size=IMG, max_attempts=3,
                            radius=0.4, device="cpu",
                            bank=dg.make_scene_bank(8, image_size=IMG,
                                                    device="cpu"))
    try:
      anakin.AnakinLoop(model, trainer, ring, env, inner_steps=K,
                        train_every=K, **CEM)
    except ValueError as e:
      out[name] = str(e)
  return out


def run_loop(path, logdir, steps, mesh_dp=2, resume=False,
             checkpoint_every=0) -> dict:
  """`steps` optimizer steps of the replay loop's `path` at the test's
  sizes over a {"data": mesh_dp} mesh (0: one rank)."""
  paths = {"anakin": dict(anakin=True, anakin_inner=K, anakin_train_every=K,
                          min_fill=16, anakin_bank_scenes=64),
           "device_resident": dict(device_resident=True, megastep_inner=4,
                                   ingest_chunk=16, min_fill=32),
           "host": dict(min_fill=32)}
  config = loop.ReplayLoopConfig(
      seed=0, image_size=IMG, batch_size=BATCH, capacity=CAPACITY,
      envs_per_collector=N_ENVS, mesh_dp=mesh_dp, num_buffer_shards=1,
      eval_every=4, eval_batches=1, log_every=4, refresh_every=4,
      checkpoint_every=checkpoint_every, resume=resume,
      checkpoint_dir=os.path.join(logdir, "checkpoints"), **CEM_CONFIG,
      **paths[path])
  replay = loop.ReplayTrainLoop(config, logdir, model=tinyq(), device="cpu")
  result = replay.run(steps)
  rows = None
  if hasattr(replay.buffer, "rows"):
    rows = replay.buffer.state.storage["image"].shape[0]
  return {key: result[key] for key in (
      "steps", "eval_history", "final_eval", "mesh_shape", "zero1",
      "param_sharding", "buffer", "compile_counts") if key in result} | {
          "ring_rows": rows}


CEM_CONFIG = dict(cem_num_samples=CEM["num_samples"],
                  cem_num_elites=CEM["num_elites"],
                  cem_iterations=CEM["iterations"])


def min_fill_gate(logdir) -> dict:
  """The host path over the mesh with a gate that cannot open in time (the
  whole ring to fill, no time to wait): the primary's deadline decides
  for both ranks. Returns the timeout's message and attempts."""
  config = loop.ReplayLoopConfig(
      seed=0, image_size=IMG, batch_size=BATCH, capacity=CAPACITY,
      min_fill=CAPACITY, min_fill_timeout_s=0.0, envs_per_collector=N_ENVS,
      mesh_dp=2, num_buffer_shards=1, **CEM_CONFIG)
  replay = loop.ReplayTrainLoop(config, logdir, model=tinyq(), device="cpu")
  try:
    replay.run(4)
  except backoff.PollTimeout as e:
    return {"message": str(e), "attempts": e.attempts}
  return {"message": None, "attempts": None}


def cases(rank: int, jax_draws, jax_initial, jax_target, tmp: str) -> dict:
  """Every two-rank case of the mesh tests, in one spawn."""
  del rank
  dp = create_mesh({"data": 2})
  tp = create_mesh({"data": 1, "model": 2})
  out = {
      "pretrain_jax_draws": run_anakin(
          dp, zero1=True, draws=jax_draws, variables=jax_initial,
          target=jax_target),
      "pretrain_own_draws": run_anakin(dp, zero1=True),
      "trained": run_anakin(dp, zero1=True, min_fill=8, dispatches=3),
      "grads64": run_anakin(dp, zero1=True, min_fill=8, grads=True,
                            dtype="float64"),
      "megastep": run_megastep(dp, zero1=True),
      "megastep_whole_ring": run_megastep(dp, zero1=True,
                                          shard_capacity=False),
      "placements": placements(dp),
      "refusals": refusals(dp),
      "tp2": run_anakin(tp, min_fill=8, dispatches=2, tp=True),
      "is_primary": distributed.is_primary(),
  }
  # The loop through its checkpoints: 8 steps straight, and 4 then a
  # resume to 8, on the same mesh.
  straight, cut = os.path.join(tmp, "straight"), os.path.join(tmp, "cut")
  out["loop_straight"] = run_loop("anakin", straight, 8, checkpoint_every=4)
  out["loop_first_half"] = run_loop("anakin", cut, 4, checkpoint_every=4)
  out["loop_resumed"] = run_loop("anakin", cut, 8, resume=True,
                                 checkpoint_every=4)
  out["device_resident"] = run_loop("device_resident",
                                    os.path.join(tmp, "dr"), 8)
  out["host"] = run_loop("host", os.path.join(tmp, "host"), 4)
  out["gate"] = min_fill_gate(os.path.join(tmp, "gate"))
  return out
