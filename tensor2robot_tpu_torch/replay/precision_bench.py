"""The precision bench: the bf16 scoring tier against the f32 oracle.

Counterpart of ``tensor2robot_tpu/replay/precision_bench.py``, the
acceptance instrument of the scoring tiers (``research/qtopt/cem.py``).
Its phases:

1. **Selected-action agreement.** A TinyQ critic is first trained to the
   retry env's analytic fixed point (Q* = success ? 1 : gamma), so the
   bar runs on a real Q landscape. Then, at every ladder bucket, the same
   (scene, seed) requests go through an f32 and a bf16 ``CEMFleetPolicy``
   (the same CEM knobs and per-request draws; only the tier differs) over
   a bank of oracle scenes (``device_grasping.make_scene_bank``). A pair
   agrees when the bf16 action's value under the f32 oracle is within
   ``q_tol`` of the f32 action's: in continuous-action QT-Opt the
   action's value, not its identity, is what serving promises. The
   geometric deltas are reported beside a seed-noise control (two f32
   policies that differ only in their sampling seed). Bar: 0.95 overall.
2. **The fused loop's TD bar.** ``run_qtopt_replay --smoke --anakin`` once
   a tier (``eval_every`` 15); each reduction is measured by the f32 eval
   metric against Q*, as the mean over the eval points past steps / 3
   (the converged phase), and the bf16 one must land within 0.05 of the
   f32 one.

3. **The live-traffic rollout** (``_measure_rollout``, run on its own):
   on a ``FleetRouter`` of replicas with TinyQ, a jittered tree scored
   through the candidate tier must roll back in shadow with the fleet
   left on f32, then the healthy tier walks shadow -> canary -> promote
   and the fleet serves it, with one build a bucket a replica a tier in
   the router's ledger. ``tpquant_bench`` runs the same cycle at int8.

**The tier ledger.** Phase 1's paired policies share one executable
ledger (``obs/ledger.py``; the seed-noise control stays off it, or it
would register the f32 bucket twice): ``tier_ledger`` holds its build
counts, whether each bucket was built exactly once at each tier
(``cem_bucket_<b>`` and ``cem_bucket_<b>_<tier>``), and the attribution's
``tier_shares``.

``measure_precision`` runs phases 1 and 2 and the tier ledger.
"""

from __future__ import annotations

import tempfile
import time
from typing import Dict, Sequence

import numpy as np
import torch

from tensor2robot_tpu_torch import Device, resolve_device

R14_BUCKETS = (1, 2, 4, 8, 16)
R14_Q_TOL = 0.05          # per-request q-delta bar, value space [0, 1]
R14_GEO_TOL = 0.1         # max-abs action delta diagnostic, [-1, 1] box
R14_AGREEMENT_BAR = 0.95
R14_TD_DELTA_BAR = 0.05   # |bf16 - f32| eval-TD-reduction ceiling


def _pretrain_critic(image_size: int, action_size: int, gamma: float,
                     grasp_radius: float, steps: int, batch_size: int,
                     seed: int, device: Device = None):
  """A TinyQ critic fitted to the analytic Q*: supervised on (scene,
  action) -> (success ? 1 : gamma), half the actions near the object, as
  the loop's eval set draws them. Returns (model, EMA variables, final
  loss)."""
  from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
  from tensor2robot_tpu_torch.research.qtopt import synthetic_grasping as sg
  from tensor2robot_tpu_torch.train.trainer import Trainer
  from tensor2robot_tpu_torch.utils import optimizers

  device = resolve_device(device)
  model = TinyQCriticModel(
      image_size=image_size, action_size=action_size,
      optimizer_fn=optimizers.create_adam_optimizer(3e-3))
  trainer = Trainer(model, seed=seed, device=device)
  state = trainer.create_train_state()

  n = batch_size * 16
  rng = np.random.default_rng(seed + 77)
  images, targets = sg.sample_scenes(n, image_size=image_size,
                                     seed=seed + 78, num_distractors=0,
                                     occlusion=False)
  actions = rng.uniform(-1.0, 1.0, (n, action_size)).astype(np.float32)
  near = rng.random(n) < 0.5
  noise = rng.normal(0.0, 0.12, (n, 2)).astype(np.float32)
  actions[near, :2] = np.clip(targets[near] + noise[near], -1.0, 1.0)
  success = sg.grasp_success(targets, actions, grasp_radius)
  q_star = np.where(success, 1.0, gamma).astype(np.float32)
  images, actions, q_star = (torch.from_numpy(a).to(device)
                             for a in (images, actions, q_star))

  loss = None
  for step in range(steps):
    part = torch.arange(step * batch_size, (step + 1) * batch_size,
                        device=device) % n
    state, metrics = trainer.train_step(
        state, {"image": images[part], "action": actions[part]},
        {model.target_key: q_star[part]})
    loss = metrics["loss"]
  variables = {k: v.detach().clone()
               for k, v in state.variables(use_ema=True).items()}
  return model, variables, float(loss)


def _paired_agreement(model, variables, candidate: str,
                      buckets: Sequence[int], corpus_scenes: int,
                      q_tolerance: float, cem_num_samples: int,
                      cem_num_elites: int, cem_iterations: int,
                      action_size: int, image_size: int, seed: int,
                      geo_tolerance=None, timed: bool = False,
                      ledger=None) -> Dict:
  """f32 against `candidate` selected actions, bucket by bucket, over a
  bank of oracle scenes; each pair shares the predictor, the CEM budget
  and the request's draws, so every delta is the tier's numerics. With
  `geo_tolerance` the geometric deltas and the seed-noise control (first
  bucket) are reported too; with `timed` each tier's warmed actions/s.
  The paired policies register into `ledger`, the control does not."""
  from tensor2robot_tpu_torch.replay.loop import _HotReloadPredictor
  from tensor2robot_tpu_torch.research.qtopt.device_grasping import (
      make_scene_bank,
  )
  from tensor2robot_tpu_torch.serving.bucketing import BucketLadder
  from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy

  device = next(iter(variables.values())).device
  predictor = _HotReloadPredictor(model, variables)
  scenes = make_scene_bank(corpus_scenes, image_size=image_size,
                           base_seed=seed + 5, device="cpu").images.numpy()

  def oracle_values(frames, actions) -> np.ndarray:
    with torch.inference_mode():
      q = model.q_value(model.predict_fn(variables, {
          "image": torch.from_numpy(np.stack(frames)).to(device),
          "action": torch.from_numpy(
              np.asarray(actions, np.float32)).to(device)}))
    return q.reshape(-1).cpu().numpy()

  def make_policy(precision, policy_seed, bucket, policy_ledger=None):
    return CEMFleetPolicy(
        predictor, action_size=action_size, num_samples=cem_num_samples,
        num_elites=cem_num_elites, iterations=cem_iterations,
        seed=policy_seed, ladder=BucketLadder((bucket,)),
        ledger=policy_ledger, precision=precision)

  tiers = ("f32", candidate)
  per_bucket = {}
  rates = {tier: [] for tier in tiers}
  agree_total = pairs_total = 0
  control_geo, control_qd = [], []
  for bucket in buckets:
    policies = {tier: make_policy(tier, seed + 7, bucket, ledger)
                for tier in tiers}
    control = (make_policy("f32", seed + 8, bucket)
               if geo_tolerance is not None and bucket == buckets[0]
               else None)
    geo_diffs, q_deltas = [], []
    calls = max(1, corpus_scenes // bucket)
    timing = {tier: 0.0 for tier in tiers}
    for call in range(calls):
      idx = (np.arange(bucket) + call * bucket) % corpus_scenes
      frames = [scenes[i] for i in idx]
      seeds = np.arange(call * bucket, (call + 1) * bucket, dtype=np.uint32)
      actions = {}
      for tier, policy in policies.items():
        start = time.perf_counter()
        actions[tier] = np.asarray(policy(frames, seeds))
        if call:  # the first call pays the bucket's build
          timing[tier] += time.perf_counter() - start
      geo_diffs.append(np.max(np.abs(actions["f32"] - actions[candidate]),
                              axis=1))
      q_f32 = oracle_values(frames, actions["f32"])
      q_deltas.append(q_f32 - oracle_values(frames, actions[candidate]))
      if control is not None:
        control_actions = np.asarray(control(frames, seeds))
        control_geo.append(np.max(np.abs(actions["f32"] - control_actions),
                                  axis=1))
        control_qd.append(q_f32 - oracle_values(frames, control_actions))
    geo_diffs = np.concatenate(geo_diffs)
    q_deltas = np.concatenate(q_deltas)
    agree = int(np.sum(q_deltas <= q_tolerance))
    agree_total += agree
    pairs_total += q_deltas.size
    if calls > 1:
      for tier in tiers:
        rates[tier].append((calls - 1) * bucket / max(timing[tier], 1e-9))
    row = {
        "pairs": int(q_deltas.size),
        "agreement_rate": agree / q_deltas.size,
        "q_delta_mean": float(q_deltas.mean()),
        "q_delta_p99": float(np.percentile(q_deltas, 99)),
        "q_delta_max": float(q_deltas.max()),
    }
    if geo_tolerance is not None:
      row.update({
          "action_maxabs_mean": float(geo_diffs.mean()),
          "action_maxabs_p99": float(np.percentile(geo_diffs, 99)),
          "geo_within_tol": float(np.mean(geo_diffs <= geo_tolerance))})
    per_bucket[str(bucket)] = row
  out = {
      "q_tolerance": q_tolerance,
      "corpus_scenes": corpus_scenes,
      "per_bucket": per_bucket,
      "pairs": pairs_total,
      "overall_rate": agree_total / max(pairs_total, 1),
  }
  if geo_tolerance is not None:
    control_geo = np.concatenate(control_geo)
    control_qd = np.concatenate(control_qd)
    out["geo_tolerance"] = geo_tolerance
    out["seed_noise_control"] = {
        "pairs": int(control_geo.size),
        "action_maxabs_mean": float(control_geo.mean()),
        "geo_within_tol": float(np.mean(control_geo <= geo_tolerance)),
        "q_agreement_rate": float(np.mean(control_qd <= q_tolerance)),
    }
  if timed:
    hz = {tier: float(np.mean(r)) if r else None for tier, r in rates.items()}
    out["scoring_rate"] = {
        "f32_actions_per_sec": hz["f32"],
        f"{candidate}_actions_per_sec": hz[candidate],
        f"{candidate}_speedup": (hz[candidate] / hz["f32"]
                                 if hz["f32"] and hz[candidate] else None),
        "note": "warmed calls (the bucket's build excluded), host clock "
                "around each call",
    }
  return out


def _measure_agreement(model, variables, buckets: Sequence[int],
                       corpus_scenes: int, q_tolerance: float,
                       geo_tolerance: float, cem_num_samples: int,
                       cem_num_elites: int, cem_iterations: int,
                       action_size: int, image_size: int, seed: int,
                       ledger=None) -> Dict:
  """Phase 1: f32 against bf16 selected actions at every bucket, with the
  geometric diagnostics, the seed-noise control and each tier's rate; the
  paired policies register into `ledger`."""
  return _paired_agreement(
      model, variables, "bf16", buckets, corpus_scenes, q_tolerance,
      cem_num_samples, cem_num_elites, cem_iterations, action_size,
      image_size, seed, geo_tolerance=geo_tolerance, timed=True,
      ledger=ledger)


def _measure_fused_loop(steps: int, seed: int, device: Device = None,
                        precisions: Sequence[str] = ("f32", "bf16"),
                        eval_every: int = 15) -> Dict:
  """Phase 2: ``run_qtopt_replay --smoke --anakin`` once a tier (the f32
  run is the bar the others are held against); every reduction by the
  f32 eval metric against Q*."""
  from tensor2robot_tpu_torch.bin import run_qtopt_replay

  out = {"steps": steps, "eval_every": eval_every}
  for precision in precisions:
    with tempfile.TemporaryDirectory(prefix="prec_") as logdir:
      result = run_qtopt_replay.run(
          steps, smoke=True, logdir=logdir, seed=seed, device=device,
          anakin=True, anakin_bench=False, precision=precision,
          eval_every=eval_every)
    initial = result["initial_eval"]["eval_td_error"]
    # The converged phase's mean: the converged loop's eval TD oscillates
    # with the replay mixture, so one final point is a lottery no 0.05
    # cross-run bar can ride on; the window (step > steps / 3) is fixed
    # in advance, the same for every tier.
    converged = [entry["eval_td_error"] for entry in result["eval_history"]
                 if entry["step"] > steps // 3]
    counts = dict(result["compile_counts"])
    out[precision] = {
        "eval_td_reduction_converged": 1.0 - float(np.mean(converged))
        / max(initial, 1e-9),
        "converged_eval_points": len(converged),
        "eval_td_reduction_final_point": result["eval_td_reduction"],
        "initial_eval_td": initial,
        "final_eval_td": result["final_eval"]["eval_td_error"],
        "eval_history": [{"step": entry["step"],
                          "eval_td_error": entry["eval_td_error"]}
                         for entry in result["eval_history"]],
        "precision": result["precision"],
        "anakin_step_compiles": counts.get("anakin_step"),
        "ledger_all_one": all(v == 1 for v in counts.values()),
    }
  for precision in precisions[1:]:
    out[f"td_delta_{precision}"] = abs(
        out[precision]["eval_td_reduction_converged"]
        - out["f32"]["eval_td_reduction_converged"])
  if "bf16" in precisions:
    out["td_delta"] = out["td_delta_bf16"]
  return out


def _measure_tier_ledger(ledger, buckets: Sequence[int],
                         candidate: str) -> Dict:
  """The agreement phase's shared ledger: its build counts, whether every
  bucket was built exactly once at f32 (``cem_bucket_<b>``) and at
  `candidate` (``cem_bucket_<b>_<candidate>``), and its time by tier."""
  counts = ledger.compile_counts
  exactly_once = (
      all(v == 1 for v in counts.values())
      and all(f"cem_bucket_{b}" in counts for b in buckets)
      and all(f"cem_bucket_{b}_{candidate}" in counts for b in buckets))
  return {"compile_counts": counts,
          "per_tier_exactly_once": bool(exactly_once),
          "tier_shares": ledger.attribution()["tier_shares"]}


def _measure_tier_rollout(tier: str, n_devices: int = 2,
                          cem_num_samples: int = 16,
                          cem_num_elites: int = 4, cem_iterations: int = 2,
                          min_shadow: int = 6, min_canary: int = 3,
                          cycle_bound_s: float = 60.0, seed: int = 0,
                          device: Device = None) -> Dict:
  """The live-traffic gate of a scoring tier: the breach first (a
  jittered tree scored through the `tier` candidate must auto-roll back,
  the fleet left on f32), then the healthy tier through
  shadow -> canary -> promote, the fleet then serving it. One ledger
  across warm-up, both cycles and the traffic after the promote: one
  build a bucket a replica a tier. Each cycle's traffic stops when the
  controller is back to serving (`cycle_bound_s` bounds a stuck one)."""
  from tensor2robot_tpu_torch.serving.rollout import (
      RolloutConfig,
      RolloutController,
  )
  from tensor2robot_tpu_torch.serving.router import FleetRouter
  from tensor2robot_tpu_torch.serving.smoke import TinyQPredictor

  device = resolve_device(device)
  predictor = TinyQPredictor(seed=seed, device=device)
  router = FleetRouter(
      predictor, devices=[device] * n_devices,
      num_samples=cem_num_samples, num_elites=cem_num_elites,
      iterations=cem_iterations, ladder_sizes=(1, 2, 4), max_queue=32,
      seed=seed)
  router.warmup(predictor.make_image)
  controller = RolloutController(
      router, predictor,
      RolloutConfig(mirror_fraction=1.0, canary_fraction=0.5,
                    min_shadow_samples=min_shadow,
                    min_canary_samples=min_canary, seed=seed))
  frames = [predictor.make_image(seed + i) for i in range(16)]

  def drive_until_serving(i0: int) -> int:
    stop_at = time.monotonic() + cycle_bound_s
    i = i0
    while controller.state != "serving" and time.monotonic() < stop_at:
      controller.submit(frames[i % len(frames)]).result(30.0)
      i += 1
    return i

  with router, controller:
    breach = predictor.make_candidate_variables(jitter=5.0, seed=seed + 7)
    # Raises, not asserts: an offer starts the cycle.
    if not controller.offer_precision_candidate(tier, variables=breach):
      raise RuntimeError("breach candidate not accepted (rollout busy)")
    i = drive_until_serving(0)
    precision_after_breach = router.precision
    breach_events = [e["event"] for e in controller.timeline()]
    if not controller.offer_precision_candidate(tier):
      raise RuntimeError("tier candidate not accepted (rollout busy)")
    i = drive_until_serving(i)
    timeline = controller.timeline()
    precision_served = router.precision
    post_promote_action = np.asarray(controller.act(frames[0],
                                                    timeout=30.0))
    requests = i

  events = [entry["event"] for entry in timeline]
  return {
      "devices": len(router.replicas),
      "timeline": timeline,
      "events": events,
      "requests": requests,
      "promotions": events.count("promote"),
      "auto_rollbacks": events.count("auto_rollback"),
      "breach_rolled_back": ("auto_rollback" in breach_events
                             and precision_after_breach == "f32"),
      "precision_served": precision_served,
      "post_promote_action_ok": bool(
          np.all(np.isfinite(post_promote_action))),
      "cycle_ok": ("promote" in events and "auto_rollback" in events
                   and precision_served == tier),
      "compile_ledger": router.ledger.compile_counts,
      "tier_shares": {
          name: share["executables"]
          for name, share in router.ledger.attribution()
          ["tier_shares"].items()},
  }


def _measure_rollout(**kwargs) -> Dict:
  """Phase 3 at bf16 (the JAX bench's rollout phase)."""
  return _measure_tier_rollout("bf16", **kwargs)


def measure_precision(
    buckets: Sequence[int] = R14_BUCKETS,
    corpus_scenes: int = 64,
    q_tolerance: float = R14_Q_TOL,
    geo_tolerance: float = R14_GEO_TOL,
    pretrain_steps: int = 250,
    loop_steps: int = 300,
    cem_num_samples: int = 16,
    cem_num_elites: int = 4,
    cem_iterations: int = 2,
    image_size: int = 16,
    action_size: int = 4,
    gamma: float = 0.8,
    grasp_radius: float = 0.4,
    seed: int = 0,
    fused_loop: bool = True,
    device: Device = None,
) -> Dict:
  """The precision protocol's ported phases; returns the JAX artifact's
  fields and raises if a bar of the phases run fails. Phase 1's shared
  ledger gives ``tier_ledger``; ``fused_loop=False`` skips phase 2;
  phase 3 runs on its own (``_measure_rollout``)."""
  from tensor2robot_tpu_torch.obs.ledger import ExecutableLedger

  device = resolve_device(device)
  model, variables, pretrain_loss = _pretrain_critic(
      image_size, action_size, gamma, grasp_radius, pretrain_steps,
      batch_size=64, seed=seed, device=device)
  agreement_ledger = ExecutableLedger()
  agreement = _measure_agreement(
      model, variables, buckets, corpus_scenes, q_tolerance, geo_tolerance,
      cem_num_samples, cem_num_elites, cem_iterations, action_size,
      image_size, seed, ledger=agreement_ledger)
  tier_ledger = _measure_tier_ledger(agreement_ledger, buckets, "bf16")
  fused = (_measure_fused_loop(loop_steps, seed, device=device)
           if fused_loop else None)
  result = {
      "metric": "precision-tiered CEM: bf16 Q-scoring vs the f32 oracle",
      "device": str(device),
      "device_kind": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
      "cem": {"num_samples": cem_num_samples, "num_elites": cem_num_elites,
              "iterations": cem_iterations},
      "buckets": [int(b) for b in buckets],
      "pretrain": {"steps": pretrain_steps, "final_loss": pretrain_loss},
      "agreement": agreement,
      "agreement_bar": R14_AGREEMENT_BAR,
      "fused_loop": fused,
      "td_delta_bar": R14_TD_DELTA_BAR,
      "tier_ledger": tier_ledger,
      "cem_bf16_action_agreement": agreement["overall_rate"],
  }
  failures = []
  if agreement["overall_rate"] < R14_AGREEMENT_BAR:
    failures.append(
        f"agreement {agreement['overall_rate']} < {R14_AGREEMENT_BAR}")
  if not tier_ledger["per_tier_exactly_once"]:
    failures.append(
        f"tier ledger not exactly-once: {tier_ledger['compile_counts']}")
  if fused is not None:
    if fused["td_delta"] > R14_TD_DELTA_BAR:
      failures.append(f"td_delta {fused['td_delta']} > {R14_TD_DELTA_BAR}")
    if not (fused["f32"]["ledger_all_one"]
            and fused["bf16"]["ledger_all_one"]):
      failures.append("fused-loop builds not all ones")
  if failures:
    raise AssertionError(
        "precision bench bars failed: " + "; ".join(failures))
  return result


def main(argv=None) -> None:
  """CLI: runs phases 1 and 2 and the tier ledger and prints one JSON
  line."""
  import argparse
  import json

  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--device", default=None)
  parser.add_argument("--seed", type=int, default=0)
  args = parser.parse_args(argv)
  print(json.dumps(measure_precision(seed=args.seed, device=args.device)))


if __name__ == "__main__":
  main()
