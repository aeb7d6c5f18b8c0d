"""Rank bodies for the parallel tier's CPU tests (no JAX here).

``tensor2robot_tpu_torch.parallel.launch`` spawns fresh processes that
import this module by name (the tests' directory is on the path they
inherit), so it imports torch and the port only. Each function takes the
rank and the numpy inputs the test drew, runs many cases in one spawn, and
returns numpy results for the test to hold against the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.parallel import (
    collectives,
    create_mesh,
    distributed,
    mesh as mesh_lib,
    ring_attention,
    tp_rules,
    ulysses_attention,
)


def _as(x: np.ndarray, dtype: str):
  return torch.from_numpy(x).to(getattr(torch, dtype))


def attention_cases(rank: int, cases: list) -> dict:
  """Each case: {"name", "axes", "op": "ring"|"ulysses"|"snail", ...}."""
  from tensor2robot_tpu_torch.layers import snail
  meshes = {}
  out = {}
  for case in cases:
    key = tuple(case["axes"].items())
    if key not in meshes:
      meshes[key] = create_mesh(case["axes"])
    mesh = meshes[key]
    try:
      if case["op"] == "snail":
        block = snail.AttentionBlock(
            case["x"].shape[-1], case["key_size"], case["key_size"],
            torch.float32, seq_mesh=mesh, batch_axis=case.get("batch_axis"))
        block.load_state_dict({k: torch.from_numpy(v)
                               for k, v in case["state_dict"].items()})
        x = torch.from_numpy(case["x"]).requires_grad_()
        y = block(x)
        (y ** 2).sum().backward()
        out[case["name"]] = {
            "out": y.detach().numpy(), "dx": x.grad.numpy(),
            "grads": {k: p.grad.numpy() for k, p in
                      block.named_parameters()}}
        continue
      fn = ring_attention if case["op"] == "ring" else ulysses_attention
      kwargs = dict(axis=case.get("axis", "seq"), causal=case["causal"],
                    batch_axis=case.get("batch_axis"))
      if case["op"] == "ulysses":
        kwargs["attn_impl"] = case.get("impl", "xla")
      inputs = [_as(x, case["dtype"]) for x in case["qkv"]]
      leaves = [x.requires_grad_() for x in inputs]
      y = fn(*leaves, mesh, **kwargs)
      (y.float() ** 2).sum().backward()
      out[case["name"]] = {
          "out": y.detach().float().numpy(), "dtype": str(y.dtype),
          "grads": [x.grad.float().numpy() for x in leaves]}
    except (ValueError, NotImplementedError) as e:
      out[case["name"]] = {"error": f"{type(e).__name__}: {e}"}
  # shard_batch over a real mesh: batched leaves split, scalars riding.
  mesh = create_mesh({"data": distributed.process_count()})
  batch = {"features": {"x": np.arange(32, dtype=np.float32).reshape(16, 2)},
           "aux": {"mask_weight": np.float32(0.5), "step": np.int32(7)}}
  local = mesh_lib.shard_batch(mesh, batch)
  out["shard_batch"] = {"x": local["features"]["x"],
                        "aux": {k: float(v) for k, v in local["aux"].items()},
                        "is_primary": distributed.is_primary()}
  out["collectives"] = {op: collectives.route(
      mesh.group("data"), op, torch.device("cuda"))
      for op in ("all_reduce", "send_recv")}
  return out


def train_modes(rank: int, cfg: dict) -> dict:
  """``chip_smoke``'s training run in each of cfg["modes"] (the critic
  warm-started from the JAX init), and the checkpoint's geometry refused
  on another mesh."""
  import chip_smoke as smoke
  from tensor2robot_tpu_torch.train.checkpoints import CheckpointManager
  from tensor2robot_tpu_torch.train.trainer import Trainer
  results = smoke.train_rank(rank, cfg)
  # A data-parallel checkpoint restored on a tensor-parallel mesh.
  model = smoke.parallel_flagship_model(cfg)
  other = create_mesh({"data": 1, "model": 2})
  trainer = Trainer(model, seed=cfg["seed"], device="cpu", mesh=other,
                    param_specs=tp_rules.partition_specs_for_model(model,
                                                                   other))
  manager = CheckpointManager(os.path.join(cfg["model_dir"], "dp",
                                           "checkpoints"))
  try:
    manager.restore(trainer.create_train_state())
    results["refusal"] = None
  except ValueError as e:
    results["refusal"] = str(e)
  # The same geometry restores, every rank its blocks of the whole.
  same = create_mesh({"data": 2})
  trainer = Trainer(model, seed=cfg["seed"], device="cpu", mesh=same,
                    shard_optimizer_state=True)
  state = manager.restore(trainer.create_train_state())
  results["restored"] = {key: value.detach().numpy().copy() for key, value in
                         state.full_variables().items()}
  results["restored_step"] = state.step
  results["is_primary"] = distributed.is_primary()
  return results


def continuous_eval(rank: int, cfg: dict) -> dict:
  """``continuous_eval_model`` over a data mesh on a finished run."""
  from tensor2robot_tpu_torch.data.default_input_generator import (
      DefaultRandomInputGenerator,
  )
  import chip_smoke as smoke
  from tensor2robot_tpu_torch.train.train_eval import continuous_eval_model
  return continuous_eval_model(
      smoke.parallel_flagship_model(cfg), DefaultRandomInputGenerator(
          batch_size=cfg["batch"], seed=cfg["seed"] + 1),
      os.path.join(cfg["model_dir"], "dp"), eval_steps=2,
      poll_interval_s=0.05, timeout_s=1.0, stop_after_step=cfg["steps"],
      device="cpu", mesh=create_mesh({"data": 2}))


def mock_composition(rank: int, cfg: dict) -> dict:
  """The mock (dropout on; no BatchNorm, whose fed bias Adam steps on
  float noise) over {"data": 2, "model": 2}: tensor parallelism by shape
  with ZeRO-1 composed on, and FSDP over {"data": 4}; each step's loss,
  the health reductions and an eval, for the caller to hold against the
  one-rank run."""
  from tensor2robot_tpu_torch.train.trainer import Trainer
  from tensor2robot_tpu_torch.utils import optimizers
  from tensor2robot_tpu_torch.utils.mocks import MockT2RModel
  out = {}
  for name in cfg["modes"]:
    model = MockT2RModel(hidden_size=128, compute_dtype=torch.float32,
                         optimizer_fn=optimizers.create_adam_optimizer(1e-2))
    if name == "tp_zero1":
      mesh = create_mesh({"data": 2, "model": 2})
      specs = tp_rules.infer_dense_tp_specs_from_model(model, mesh)
      trainer = Trainer(model, seed=5, device="cpu", mesh=mesh,
                        param_specs=specs, shard_optimizer_state=True)
    else:
      mesh = create_mesh({"data": 4})
      specs = tp_rules.infer_fsdp_specs_from_model(model, mesh, min_size=128)
      trainer = Trainer(model, seed=5, device="cpu", mesh=mesh,
                        param_specs=specs)
    state = trainer.create_train_state(
        {k: torch.from_numpy(v) for k, v in cfg["variables"].items()})
    features, labels = trainer.shard_batch(
        ({"x": torch.from_numpy(cfg["x"])},
         {"target": torch.from_numpy(cfg["target"])}))
    losses, norms = [], []
    for _ in range(cfg["steps"]):
      state, metrics = trainer.train_step(state, features, labels,
                                          with_health=True)
      losses.append(float(metrics["loss"]))
      norms.append(float(metrics["grad_norm"]))
    out[name] = {
        "losses": losses, "grad_norms": norms,
        "params": {k: v.detach().numpy().copy() for k, v in
                   state.full_variables().items()},
        "local": {k: list(v.shape) for k, v in state.params.items()},
        "opt_local": {k: list(v.shape) for k, v in
                      (state.opt_params or state.params).items()},
        "eval": {k: float(v) for k, v in trainer.eval_step(
            state, features, labels).items()}}
  return out


def bridge_keys(module) -> dict:
  """{state_dict key: flax path} of a module's parameters."""
  return {key: "/".join(bridge._to_flax(key, p)[1])  # noqa: SLF001
          for key, p in module.named_parameters()}
