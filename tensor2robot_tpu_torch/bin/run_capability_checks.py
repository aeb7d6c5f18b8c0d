"""Runs the per-family capability checks on the port, one JSON line each.

    python -m tensor2robot_tpu_torch.bin.run_capability_checks \
        --checks pose_env,qtopt --scale full

Counterpart of ``tensor2robot_tpu/bin/run_capability_checks.py``: each
check runs the real pipeline (data written as jpeg records, training
through ``train_eval_model`` with ``iterations_per_loop=50`` into a
``model_dir``, the native export, serving) and prints its measured
outcome beside its bar, the JAX package's ``_EXPECT``. The exit code is
non-zero when a check misses its bar. ``--device`` (default ``cuda``;
``cpu`` on a machine without a GPU) is where everything runs. maml
meta-trains the pose_env MAML regressor on two-object reaching tasks
through ``Trainer.train_steps`` (on the GPU one CUDA graph replay for
``MAML_ITERATIONS_PER_LOOP`` meta-steps) and scores adapted predictions on
fresh tasks, as the JAX check does. grasp2vec trains the embedding model
(ResNet-18, GroupNorm) on synthetic triplets and scores held-out 64-way
retrieval; vrgripper trains the FiLM ResNet regressor on pose_env
demonstrations and scores reaches; both train through
``Trainer.train_steps`` (on the GPU one CUDA graph replay for
``ZOO_ITERATIONS_PER_LOOP`` steps) on the JAX checks' data and draws.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

# (fast, full) knobs per check: the JAX package's.
_SCALES = {
    "pose_env": {"fast": dict(episodes=1000, steps=800, image=64),
                 "full": dict(episodes=2000, steps=1500, image=64)},
    "qtopt": {"fast": dict(grasps=3000, steps=1200, image=64),
              "full": dict(grasps=8000, steps=2500, image=128)},
    "grasp2vec": {"fast": dict(triplets=2048, steps=600, image=64),
                  "full": dict(triplets=8192, steps=1500, image=64)},
    "vrgripper": {"fast": dict(demos=2000, steps=800, image=64),
                  "full": dict(demos=4000, steps=1500, image=64)},
    "maml": {"fast": dict(steps=800, image=64),
             "full": dict(steps=2000, image=64)},
}
# The bar of each (check, scale): the JAX package's.
_EXPECT = {
    ("pose_env", "fast"): 0.65, ("pose_env", "full"): 0.80,
    ("qtopt", "fast"): 0.40, ("qtopt", "full"): 0.72,
    ("grasp2vec", "fast"): 0.38, ("grasp2vec", "full"): 0.62,
    ("vrgripper", "fast"): 0.65, ("vrgripper", "full"): 0.80,
    ("maml", "fast"): 0.75, ("maml", "full"): 0.80,
}
ITERATIONS_PER_LOOP = 50
# check_maml's meta-steps a dispatch: a meta-step is ~18,000 kernels, so a
# shorter stack keeps the eager first stack and the capture short.
MAML_ITERATIONS_PER_LOOP = 10
# check_grasp2vec's and check_vrgripper's steps a dispatch.
ZOO_ITERATIONS_PER_LOOP = 10


def _train_and_restore_predictor(model, record_path, steps, run_dir,
                                 device):
  """The record half shared by the checks: train -> native export ->
  predictor. Returns (predictor, the train loop's loop_stats)."""
  from tensor2robot_tpu_torch.data.default_input_generator import (
      DefaultRecordInputGenerator,
  )
  from tensor2robot_tpu_torch.export.native_export_generator import (
      NativeExportGenerator,
  )
  from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
      ExportedModelPredictor,
  )
  from tensor2robot_tpu_torch.train.train_eval import train_eval_model

  result = train_eval_model(
      model,
      input_generator_train=DefaultRecordInputGenerator(
          file_patterns=record_path, batch_size=64, seed=1),
      max_train_steps=steps, iterations_per_loop=ITERATIONS_PER_LOOP,
      model_dir=run_dir, export_generator=NativeExportGenerator(),
      log_every_steps=max(100, steps), device=device)
  predictor = ExportedModelPredictor(
      model, os.path.join(run_dir, "export", "latest"), device=device)
  if not predictor.restore(timeout_s=10.0):
    raise RuntimeError(
        f"No export appeared under {run_dir}/export/latest")
  return predictor, result.loop_stats


def check_pose_env(scale: str, workdir: str, device: str) -> dict:
  from tensor2robot_tpu_torch.research.pose_env import (
      PoseEnvRegressionModel,
      evaluate_policy,
      pose_env,
  )
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer

  knobs = _SCALES["pose_env"][scale]
  rec = os.path.join(workdir, "pose.tfrecord")
  pose_env.write_tfrecords(rec, num_episodes=knobs["episodes"], seed=0,
                           image_size=knobs["image"])
  model = PoseEnvRegressionModel(image_size=knobs["image"],
                                 optimizer_fn=create_adam_optimizer(1e-3))
  predictor, _ = _train_and_restore_predictor(
      model, rec, knobs["steps"], os.path.join(workdir, "pose_run"), device)
  # The tight 0.05 reach bar, and 0.10 from the same 200 rollouts.
  result = evaluate_policy(predictor, num_episodes=200, seed=1234,
                           image_size=knobs["image"],
                           success_threshold=0.05,
                           extra_thresholds=(0.10,))
  return {"success_rate": result["success_rate"],
          "success_rate_at_0p10": result[f"success_rate_at_{0.10:g}"],
          "mean_reward": result["mean_reward"],
          "metric": "reach success within 0.05"}


def check_qtopt(scale: str, workdir: str, device: str) -> dict:
  from tensor2robot_tpu_torch.research.qtopt import (
      synthetic_grasping as sg,
  )
  from tensor2robot_tpu_torch.research.qtopt.cem import CEMPolicy
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      QTOptGraspingModel,
  )
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer

  knobs = _SCALES["qtopt"][scale]
  rec = os.path.join(workdir, "grasps.tfrecord")
  start = time.perf_counter()
  sg.write_tfrecords(rec, num_examples=knobs["grasps"],
                     image_size=knobs["image"], seed=0)
  write_s = time.perf_counter() - start
  model = QTOptGraspingModel(image_size=knobs["image"],
                             in_image_size=knobs["image"],
                             optimizer_fn=create_adam_optimizer(1e-3))
  start = time.perf_counter()
  predictor, loop_stats = _train_and_restore_predictor(
      model, rec, knobs["steps"], os.path.join(workdir, "qtopt_run"),
      device)
  train_s = time.perf_counter() - start
  policy = CEMPolicy(predictor, action_size=4, num_samples=128,
                     num_elites=10, iterations=4, seed=7)
  control_ms = []

  def timed_policy(image):
    begin = time.perf_counter()
    action = policy(image)  # numpy: the step has finished on the device
    control_ms.append((time.perf_counter() - begin) * 1e3)
    return action

  cem = sg.evaluate_grasp_policy(timed_policy, num_scenes=200, seed=5555,
                                 image_size=knobs["image"])
  rng = np.random.default_rng(0)
  rand = sg.evaluate_grasp_policy(
      lambda im: rng.uniform(-1, 1, 4), num_scenes=200, seed=5555,
      image_size=knobs["image"])
  return {"success_rate": cem["success_rate"],
          "random_success_rate": rand["success_rate"],
          "mean_distance": cem["mean_distance"],
          "write_s": write_s, "train_s": train_s,
          "step_ms_median": loop_stats.get("step_ms_median"),
          "steps_per_dispatch": loop_stats.get("steps_per_dispatch"),
          "input_wait_ms_median": loop_stats.get("input_wait_ms_median"),
          "input_wait_share": loop_stats.get("input_wait_share"),
          "cem_step_ms_median": float(np.median(control_ms))}


def _k1_launches() -> int:
  """K1's kernel launches so far (graph replays included)."""
  from tensor2robot_tpu_torch.ops.spatial_softmax import spatial_softmax
  return spatial_softmax.launches


def check_maml(scale: str, workdir: str, device: str) -> dict:
  import torch

  from tensor2robot_tpu_torch.research.pose_env import meta_reaching as mr
  from tensor2robot_tpu_torch.research.pose_env.pose_env_maml_models import (
      pose_env_maml_model,
  )
  from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
  from tensor2robot_tpu_torch.train.trainer import Trainer
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer

  del workdir
  knobs = _SCALES["maml"][scale]
  k_c = k_i = 4
  tasks = 8
  # Noisy demonstrations: condition labels jittered by the object radius
  # at train and eval, so success grades how well the adapted model
  # integrates K noisy examples (the JAX check's regime and seeds).
  noise = 0.22

  def build(num_inner_steps):
    return pose_env_maml_model(
        num_inner_steps=num_inner_steps, inner_lr=0.05,
        num_condition_samples=k_c, num_inference_samples=k_i,
        image_size=knobs["image"],
        optimizer_fn=create_adam_optimizer(1e-3))

  def to_device(array):
    tensor = torch.from_numpy(array)
    if device == "cpu":
      return tensor
    # Pinned and asynchronous: the host draws the next stack while the
    # card replays this one.
    return tensor.pin_memory().to(device, non_blocking=True)

  def meta_batches(seeds):
    metas = [mr.sample_meta_batch(tasks, k_c, k_i, image_size=knobs["image"],
                                  seed=seed, condition_label_noise=noise)[0]
             for seed in seeds]
    return ts.TensorSpecStruct(
        (key, to_device(np.stack([m[key] for m in metas])))
        for key in metas[0])

  model = build(3)
  trainer = Trainer(model, seed=0, device=device)
  state = trainer.create_train_state()
  launches = _k1_launches()
  start = time.perf_counter()
  for first in range(0, knobs["steps"], MAML_ITERATIONS_PER_LOOP):
    seeds = range(100_000 + first, 100_000 + min(
        first + MAML_ITERATIONS_PER_LOOP, knobs["steps"]))
    state, metrics = trainer.train_steps(state, meta_batches(seeds), None)
  outer_loss = float(metrics["outer_loss"])  # waits for the last step
  train_s = time.perf_counter() - start
  train_launches = _k1_launches() - launches

  meta, info = mr.sample_meta_batch(64, k_c, k_i, image_size=knobs["image"],
                                    seed=9999, condition_label_noise=noise)
  features = ts.TensorSpecStruct(
      (key, torch.from_numpy(value).to(device)) for key, value in meta.items())
  variables = state.variables()
  eval_launches = {}

  def predictions(name, m_eval):
    launches = _k1_launches()
    with torch.no_grad():  # adaptation enables grad for itself
      out, _ = m_eval.inference_network_fn(variables, features, "eval")
    eval_launches[name] = _k1_launches() - launches
    return out["inference_output"].float().cpu().numpy()

  # The gate: half the object radius under the condition noise; the full
  # radius from the same predictions, and the adapted-unadapted margin
  # there, as a second check against a total collapse.
  tight = mr.OBJECT_RADIUS / 2
  adapted_preds = predictions("adapted", model)
  adapted = mr.reach_success(adapted_preds, info, radius=tight)
  adapted_full = mr.reach_success(adapted_preds, info,
                                  radius=mr.OBJECT_RADIUS)
  unadapted = mr.reach_success(predictions("unadapted", build(0)), info,
                               radius=mr.OBJECT_RADIUS)
  margin_ok = (adapted_full["success_rate"]
               >= unadapted["success_rate"] + 0.5)
  return {"success_rate": (adapted["success_rate"] if margin_ok
                           else 0.0),
          "success_rate_at_half_radius": adapted["success_rate"],
          "success_rate_at_object_radius": adapted_full["success_rate"],
          "unadapted_success_rate": unadapted["success_rate"],
          "adapted_vs_unadapted_margin_ok": margin_ok,
          "final_outer_loss": outer_loss,
          "train_s": train_s,
          "steps_per_dispatch": MAML_ITERATIONS_PER_LOOP,
          "k1_launches_train": train_launches,
          "k1_launches_eval_adapted": eval_launches["adapted"],
          "k1_launches_eval_unadapted": eval_launches["unadapted"],
          "metric": f"query reach within {tight:g} (half object "
                    "radius), gated on adapted-unadapted margin"}


def _train_stacked(trainer, state, steps: int, batch_fn, device: str):
  """`steps` train steps in stacks of ZOO_ITERATIONS_PER_LOOP; batch_fn()
  draws one step's (features, labels) as numpy dicts (labels may be
  None). Returns (state, the last metrics, train seconds)."""
  import torch

  from tensor2robot_tpu_torch.specs import tensorspec_utils as ts

  def stack(batches):
    if batches[0] is None:
      return None
    return ts.TensorSpecStruct(
        (key, torch.from_numpy(np.stack([b[key] for b in batches])).to(
            device)) for key in batches[0])

  start = time.perf_counter()
  for first in range(0, steps, ZOO_ITERATIONS_PER_LOOP):
    batches = [batch_fn() for _ in range(
        min(ZOO_ITERATIONS_PER_LOOP, steps - first))]
    state, metrics = trainer.train_steps(
        state, stack([f for f, _ in batches]), stack([l for _, l in batches]))
  metrics = {key: float(value) for key, value in metrics.items()}
  return state, metrics, time.perf_counter() - start


def check_grasp2vec(scale: str, workdir: str, device: str) -> dict:
  import torch

  from tensor2robot_tpu_torch.research.grasp2vec import synthetic_scenes as ss
  from tensor2robot_tpu_torch.research.grasp2vec.grasp2vec_model import (
      Grasp2VecModel,
  )
  from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
  from tensor2robot_tpu_torch.train.trainer import Trainer
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer

  del workdir
  knobs = _SCALES["grasp2vec"][scale]
  model = Grasp2VecModel(image_size=knobs["image"], depth=18, norm="group",
                         optimizer_fn=create_adam_optimizer(1e-3))
  trainer = Trainer(model, seed=0, device=device)
  state = trainer.create_train_state()
  batch = 64
  data = ss.sample_triplets(knobs["triplets"], image_size=knobs["image"],
                            seed=0)
  rng = np.random.default_rng(1)

  def draw():
    # Without replacement: a repeated triplet makes two equal positives.
    idx = rng.choice(knobs["triplets"], batch, replace=False)
    return ss.as_model_batch(data, idx), None

  state, metrics, train_s = _train_stacked(trainer, state, knobs["steps"],
                                           draw, device)
  heldout = ss.sample_triplets(64, image_size=knobs["image"], seed=777)
  features = ts.TensorSpecStruct(
      (key, torch.from_numpy(value).to(device)) for key, value in
      ss.as_model_batch(heldout, np.arange(64)).items())
  eval_metrics = trainer.eval_step(state, features, None)
  return {"success_rate": float(eval_metrics["retrieval_accuracy"]),
          "train_retrieval_accuracy": metrics["retrieval_accuracy"],
          "final_npairs": metrics["npairs"], "train_s": train_s,
          "steps_per_dispatch": ZOO_ITERATIONS_PER_LOOP,
          "metric": "held-out 64-way retrieval accuracy"}


def check_vrgripper(scale: str, workdir: str, device: str,
                    seed_offset: int = 0) -> dict:
  import torch

  from tensor2robot_tpu_torch.research.pose_env import (
      evaluate_policy,
      pose_env,
  )
  from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_models import (
      VRGripperRegressionModel,
  )
  from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
  from tensor2robot_tpu_torch.train.trainer import Trainer
  from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer

  del workdir
  knobs = _SCALES["vrgripper"][scale]
  model = VRGripperRegressionModel(image_size=knobs["image"], action_size=2,
                                   gripper_pose_size=4,
                                   optimizer_fn=create_adam_optimizer(1e-3))
  # seed_offset moves the training randomness (init, demos, batch order);
  # the eval episodes stay fixed.
  trainer = Trainer(model, seed=seed_offset, device=device)
  state = trainer.create_train_state()
  batch = 64
  images, targets = pose_env.collect_episodes(
      knobs["demos"], seed=seed_offset, image_size=knobs["image"])
  rng = np.random.default_rng(1 + seed_offset)
  proprio = rng.normal(0, 1, (knobs["demos"], 4)).astype(np.float32)

  def draw():
    idx = rng.choice(knobs["demos"], batch, replace=False)
    return ({"image": images[idx].astype(np.float32) / 255.0,
             "gripper_pose": proprio[idx]}, {"action": targets[idx]})

  state, metrics, train_s = _train_stacked(trainer, state, knobs["steps"],
                                           draw, device)
  predict = trainer.predict_fn(state)
  zero_proprio = torch.zeros((1, 4), device=device)

  def policy(features):
    out = predict(ts.TensorSpecStruct({
        "image": torch.from_numpy(features["image"]).to(device),
        "gripper_pose": zero_proprio}))
    return {"inference_output": out["inference_output"].float().cpu().numpy()}

  result = evaluate_policy(policy, num_episodes=200, seed=4321,
                           image_size=knobs["image"])
  return {"success_rate": result["success_rate"],
          "mean_reward": result["mean_reward"],
          "final_mse": metrics["mse"], "train_s": train_s,
          "steps_per_dispatch": ZOO_ITERATIONS_PER_LOOP,
          "metric": "pose_env reach success within 0.1"}


_CHECKS = {
    "pose_env": check_pose_env,
    "qtopt": check_qtopt,
    "grasp2vec": check_grasp2vec,
    "vrgripper": check_vrgripper,
    "maml": check_maml,
}


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--checks", default="all",
                      help="comma list of %s or 'all'" % sorted(_CHECKS))
  parser.add_argument("--scale", choices=("fast", "full"), default="fast")
  parser.add_argument("--workdir", default=None,
                      help="scratch dir (default: a TemporaryDirectory)")
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu")
  args = parser.parse_args(argv)
  names = (sorted(_CHECKS) if args.checks == "all"
           else [n.strip() for n in args.checks.split(",")])
  unknown = [n for n in names if n not in _CHECKS]
  if unknown:
    parser.error(f"Unknown checks {unknown}; have {sorted(_CHECKS)}")

  failures = 0
  with tempfile.TemporaryDirectory() as default_dir:
    workdir_root = args.workdir or default_dir
    for name in names:
      start = time.time()
      # A fresh directory each check: train_eval_model resumes from what
      # it finds.
      workdir = os.path.join(workdir_root, f"{name}_{args.scale}")
      shutil.rmtree(workdir, ignore_errors=True)
      os.makedirs(workdir)
      record = {"check": name, "scale": args.scale, "device": args.device}
      try:
        result = _CHECKS[name](args.scale, workdir, args.device)
        expect = _EXPECT[(name, args.scale)]
        passed = bool(result["success_rate"] >= expect)
        record.update(
            {k: (round(float(v), 4) if isinstance(v, (int, float))
                 else v)
             for k, v in result.items()})
        record["expected_at_least"] = expect
      except Exception as e:  # one failing check must not hide the rest
        passed = False
        record["error"] = f"{type(e).__name__}: {e}"
      failures += not passed
      record["passed"] = passed
      record["seconds"] = round(time.time() - start, 1)
      print(json.dumps(record), flush=True)
  return 1 if failures else 0


if __name__ == "__main__":
  sys.exit(main())
