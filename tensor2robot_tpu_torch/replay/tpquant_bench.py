"""The int8 served-weights tier's bench.

Counterpart of the int8 half of ``tensor2robot_tpu/replay/
tpquant_bench.py``: per-output-channel symmetric quantization of the
SERVED weights (``cem.cast_scoring_variables(variables, "int8")``, done
when the fleet policy places them; the activations and the CEM search
keep the bf16 tier's rule, the scores return to float32 before the elite
selection). Two claims:

- **Agreement.** Paired f32 and int8 ``CEMFleetPolicy`` requests over a
  bank of oracle scenes on a trained TinyQ critic
  (``precision_bench._pretrain_critic``): the int8 action's value under
  the f32 oracle within ``q_tol`` of the f32 action's, at a rate of at
  least 0.99.
- **Bytes.** The flagship critic's stored (served) tree at least 3x
  smaller in int8 than in float32 (TinyQ reported beside it). These are
  the bytes the policy holds, not the traffic of a score: the graph
  expands every int8 weight to a bf16 copy on each replay.

- **Tier ledger.** The paired policies share one executable ledger:
  every bucket built exactly once at f32 and at int8
  (``cem_bucket_<b>_int8``), and the attribution's ``tier_shares``.

- **Rollout.** ``_measure_rollout_int8``, run on its own: the int8 tier
  through the routed fleet's promotion gate (``precision_bench.
  _measure_tier_rollout``): a jittered tree scored at int8 rolled back in
  shadow, then int8 promoted, one build a bucket a replica a tier.

- **Tensor-parallel ladder.** ``_measure_tp_ladder``: the flagship
  critic (the uint8 GroupNorm QTOptGraspingModel) through the Anakin loop
  on a ``{"data": 1, "model": tp}`` mesh of `tp` ranks for each rung
  (``parallel.launch``; the tp=1 rung in this process), its parameters
  split by the model's own partition rules. Structural, as JAX's: one
  ``anakin_step`` build a rung, a tp > 1 rung's parameters really split
  (``param_sharding.model_sharded_leaves`` > 0, fewer bytes a rank), and
  the tp=1 rung run twice, bit for bit equal, with no leaf split. The
  ranks share one machine (and, on the card, one device through gloo), so
  the rates measure the collectives' overhead and claim no scaling:
  ``colocated_ranks`` is true and ``tp_scaling_efficiency`` null.
"""

from __future__ import annotations

import tempfile
import time
from typing import Dict, Sequence

import torch

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.replay import precision_bench
from tensor2robot_tpu_torch.research.qtopt import cem

R17_TP_LADDER = (1, 2)
R17_BUCKETS = (1, 4, 8)
R17_Q_TOL = 0.05             # value-space q-delta bar (the rollout gate's)
R17_INT8_AGREEMENT_BAR = 0.99
R17_INT8_BYTES_REDUCTION_BAR = 3.0


def _tree_bytes(variables) -> int:
  return sum(sum(t.nbytes for t in value.values())
             if isinstance(value, dict) else value.nbytes
             for value in variables.values())


def _int8_bytes_reduction(variables) -> float:
  """Dense-f32 against int8 stored bytes of one variables dict."""
  return _tree_bytes(variables) / max(
      _tree_bytes(cem.cast_scoring_variables(variables, "int8")), 1)


def _flagship_bytes_reduction(image_size: int, seed: int) -> Dict:
  """The int8 stored-bytes reduction of the flagship's tree (the uint8
  GroupNorm critic the loop trains), TinyQ beside it."""
  from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      QTOptGraspingModel,
  )

  flagship = QTOptGraspingModel(image_size=image_size, action_size=4,
                                uint8_images=True, norm="group")
  out = {}
  for name, model in (("flagship", flagship), ("tinyq", TinyQCriticModel())):
    variables = model.init_variables(torch.Generator().manual_seed(seed),
                                     device="cpu")
    out[name] = _int8_bytes_reduction(variables)
  return out


def _measure_int8_agreement(model, variables, buckets: Sequence[int],
                            corpus_scenes: int, q_tolerance: float,
                            cem_num_samples: int, cem_num_elites: int,
                            cem_iterations: int, action_size: int,
                            image_size: int, seed: int,
                            ledger=None) -> Dict:
  """f32 against int8 paired policies over the scene bank: the precision
  bench's agreement protocol with int8 in the candidate's seat, the pairs
  registered into `ledger`."""
  return precision_bench._paired_agreement(
      model, variables, "int8", buckets, corpus_scenes, q_tolerance,
      cem_num_samples, cem_num_elites, cem_iterations, action_size,
      image_size, seed, ledger=ledger)


def _run_flagship_anakin(tp: int, steps: int, seed: int, image_size: int,
                         logdir: str, device: Device = None) -> Dict:
  """One ladder rung in this rank: the default (flagship) model through
  the Anakin loop on a {"data": 1, "model": tp} mesh (the JAX rung's
  config). Returns the loop's result with its wall seconds and rate."""
  from tensor2robot_tpu_torch.replay.loop import (
      ReplayLoopConfig,
      ReplayTrainLoop,
  )
  config = ReplayLoopConfig(
      anakin=True, mesh_dp=1, mesh_tp=tp, image_size=image_size,
      seed=seed, batch_size=8, capacity=128, min_fill=32,
      anakin_bank_scenes=32, anakin_inner=16, anakin_train_every=8,
      cem_num_samples=8, cem_num_elites=2, cem_iterations=1,
      eval_every=max(steps, 1), eval_batches=1, num_buffer_shards=1)
  loop = ReplayTrainLoop(config, logdir, device=device)
  start = time.perf_counter()
  result = loop.run(steps)
  elapsed = time.perf_counter() - start
  result["wall_seconds"] = elapsed
  result["steps_per_sec"] = result["steps"] / max(elapsed, 1e-9)
  return result


def _tp_rung_rank(rank: int, tp: int, steps: int, seed: int,
                  image_size: int, logdir: str, device: str) -> Dict:
  """``parallel.launch``'s body of a tp > 1 rung."""
  del rank
  return _run_flagship_anakin(tp, steps, seed, image_size, logdir, device)


def _rung_summary(tp: int, result: Dict) -> Dict:
  sharding = result["param_sharding"]
  return {
      "tp": tp,
      "mesh_shape": dict(result["mesh_shape"]),
      "anakin_step_compiles": result["compile_counts"].get("anakin_step"),
      "ledger_all_one": all(
          v == 1 for v in result["compile_counts"].values()),
      "param_sharding": sharding,
      "replica_bytes_factor": round(
          sharding["param_bytes_total"]
          / max(sharding["param_bytes_per_replica"], 1), 3),
      "steps": result["steps"],
      "steps_per_sec": round(result["steps_per_sec"], 4),
      "final_eval_td": result["final_eval"]["eval_td_error"],
  }


def _measure_tp_ladder(ladder: Sequence[int] = R17_TP_LADDER, steps: int = 8,
                       seed: int = 0, image_size: int = 64,
                       device: Device = None) -> Dict:
  """The flagship's tensor-parallel ladder and the tp=1 bitwise oracle
  pair (see the module's docstring). A tp > 1 rung runs in `tp` spawned
  ranks (co-located on the card under ``device`` cuda)."""
  from tensor2robot_tpu_torch.parallel import launch
  if 1 not in ladder or min(ladder) < 1:
    raise ValueError(
        f"ladder {tuple(ladder)} needs its tp=1 rung (the bitwise oracle) "
        "and no tp below 1")
  device = resolve_device(device)
  rungs, oracle = {}, None
  for tp in ladder:
    logdir = tempfile.mkdtemp(prefix=f"tpq{tp}_")
    if tp == 1:
      result = _run_flagship_anakin(1, steps, seed, image_size, logdir,
                                    device)
      # The oracle pair: the same tp=1 config again, bit for bit (eval
      # history and final eval), with no leaf on the model axis.
      rerun = _run_flagship_anakin(1, steps, seed, image_size,
                                   tempfile.mkdtemp(prefix="tpq1_"), device)
      oracle = {
          "bitwise_equal": (result["eval_history"] == rerun["eval_history"]
                            and result["final_eval"] == rerun["final_eval"]),
          "model_sharded_leaves": result["param_sharding"][
              "model_sharded_leaves"],
      }
    else:
      result = launch.launch(
          _tp_rung_rank, tp,
          (tp, steps, seed, image_size, logdir, device.type),
          device=device.type)[0]
    rungs[str(tp)] = _rung_summary(tp, result)
  base_rate = rungs["1"]["steps_per_sec"]
  top = str(max(ladder))
  return {
      "ladder": [int(tp) for tp in ladder],
      "steps": steps,
      "rungs": rungs,
      "tp1_oracle": oracle,
      # Ranks on one machine share its cores (and its one card through
      # gloo): the ratio measures the collectives' overhead, not scaling.
      "scaling_efficiency_diagnostic": round(
          rungs[top]["steps_per_sec"] / max(base_rate, 1e-9), 4),
      "colocated_ranks": True,
      "tp_scaling_efficiency": None,
      "device": str(device),
      "note": ("fixed per-rung workload; co-located ranks share one "
               "machine and its card, so rates are collective-overhead "
               "diagnostics and no scaling is claimed (colocated_ranks)."),
  }


def _measure_rollout_int8(**kwargs) -> Dict:
  """The promotion gate with int8 in the candidate seat."""
  return precision_bench._measure_tier_rollout("int8", **kwargs)


def measure_tpquant(
    buckets: Sequence[int] = R17_BUCKETS,
    corpus_scenes: int = 64,
    q_tolerance: float = R17_Q_TOL,
    pretrain_steps: int = 250,
    cem_num_samples: int = 16,
    cem_num_elites: int = 4,
    cem_iterations: int = 2,
    image_size: int = 16,
    flagship_image_size: int = 472,
    action_size: int = 4,
    gamma: float = 0.8,
    grasp_radius: float = 0.4,
    seed: int = 0,
    device: Device = None,
) -> Dict:
  """The JAX protocol's int8 half: the agreement, its tier ledger and
  bytes (the ladder is ``_measure_tp_ladder``). Raises if a bar fails."""
  from tensor2robot_tpu_torch.obs.ledger import ExecutableLedger

  device = resolve_device(device)
  model, variables, pretrain_loss = precision_bench._pretrain_critic(
      image_size, action_size, gamma, grasp_radius, pretrain_steps,
      batch_size=64, seed=seed, device=device)
  agreement_ledger = ExecutableLedger()
  agreement = _measure_int8_agreement(
      model, variables, buckets, corpus_scenes, q_tolerance,
      cem_num_samples, cem_num_elites, cem_iterations, action_size,
      image_size, seed, ledger=agreement_ledger)
  tier_ledger = precision_bench._measure_tier_ledger(agreement_ledger,
                                                     buckets, "int8")
  bytes_reduction = _flagship_bytes_reduction(flagship_image_size, seed)
  result = {
      "metric": "int8 served weights: agreement and bytes",
      "device": str(device),
      "pretrain": {"steps": pretrain_steps, "final_loss": pretrain_loss},
      "int8_agreement": agreement,
      "int8_agreement_bar": R17_INT8_AGREEMENT_BAR,
      "int8_bytes_reduction": bytes_reduction,
      "int8_bytes_reduction_bar": R17_INT8_BYTES_REDUCTION_BAR,
      "tier_ledger": tier_ledger,
      "int8_q_agreement": agreement["overall_rate"],
      "int8_param_bytes_reduction": bytes_reduction["flagship"],
  }
  failures = []
  if agreement["overall_rate"] < R17_INT8_AGREEMENT_BAR:
    failures.append(f"int8 agreement {agreement['overall_rate']} < "
                    f"{R17_INT8_AGREEMENT_BAR}")
  if bytes_reduction["flagship"] < R17_INT8_BYTES_REDUCTION_BAR:
    failures.append(f"flagship bytes reduction "
                    f"{bytes_reduction['flagship']} < "
                    f"{R17_INT8_BYTES_REDUCTION_BAR}")
  if not tier_ledger["per_tier_exactly_once"]:
    failures.append(
        f"tier ledger not exactly-once: {tier_ledger['compile_counts']}")
  if failures:
    raise AssertionError("tpquant bars failed: " + "; ".join(failures))
  return result
