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

The JAX bench's tensor-parallel ladder waits for ``ROADMAP.md``'s flagship
item 15b-ii (the loop over a mesh): ``_measure_tp_ladder`` raises by
name.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.replay import precision_bench
from tensor2robot_tpu_torch.research.qtopt import cem

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


def _measure_tp_ladder(*_args, **_kwargs):
  raise NotImplementedError(
      "tpquant's tensor-parallel ladder waits for ROADMAP.md's flagship "
      "item 15b-ii (the loop over a mesh).")


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
  """The int8 half of the JAX protocol: agreement, its tier ledger and
  bytes. Raises if a bar fails."""
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
      "waiting": {"tp_ladder": "item 15b-ii"},
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
