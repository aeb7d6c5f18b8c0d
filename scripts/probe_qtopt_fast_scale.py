#!/usr/bin/env python3
"""Probes the port's ``check_qtopt`` at its fast scale, part by part.

    python3 scripts/probe_qtopt_fast_scale.py train cuda bf16
    DATA_SEED=2 python3 scripts/probe_qtopt_fast_scale.py train cuda f32
    python3 scripts/probe_qtopt_fast_scale.py crosseval graphs
    python3 scripts/probe_qtopt_fast_scale.py crosseval eager

``train DEVICE VARIANT`` trains the check's critic on the check's fast
records (3,000 grasps, 1,200 steps at 64x64, batch 64, Adam 1e-3,
``ITERATIONS_PER_LOOP`` steps a dispatch) on DEVICE (cuda or cpu, with
``THREADS`` CPU threads) with VARIANT bf16 (the check's), f32 (the
critic in float32) or tf32off (bf16 with TF32 off), the record order
seeded by ``DATA_SEED`` (the check's is 1), then serves the export
through the check's ``CEMPolicy`` over its 200 scenes; it prints the
loss every 100 steps and the success rate. ``crosseval MODE`` trains on
the card as the check does (MODE graphs) or one eager step a dispatch
(MODE eager), then scores the one export through ``CEMPolicy`` on the
card and on the CPU. One JSON line each.
"""

import json
import logging
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from tensor2robot_tpu_torch.bin import run_capability_checks as checks  # noqa: E402,E501
from tensor2robot_tpu_torch.data.default_input_generator import (  # noqa: E402
    DefaultRecordInputGenerator,
)
from tensor2robot_tpu_torch.export.native_export_generator import (  # noqa: E402,E501
    NativeExportGenerator,
)
from tensor2robot_tpu_torch.predictors.exported_model_predictor import (  # noqa: E402,E501
    ExportedModelPredictor,
)
from tensor2robot_tpu_torch.research.qtopt import synthetic_grasping as sg  # noqa: E402,E501
from tensor2robot_tpu_torch.research.qtopt.cem import CEMPolicy  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (  # noqa: E402
    QTOptGraspingModel,
)
from tensor2robot_tpu_torch.train.train_eval import train_eval_model  # noqa: E402,E501
from tensor2robot_tpu_torch.utils.optimizers import create_adam_optimizer  # noqa: E402,E501

KNOBS = checks._SCALES["qtopt"]["fast"]


def _records(work: str) -> str:
  path = os.path.join(work, "grasps.tfrecord")
  sg.write_tfrecords(path, num_examples=KNOBS["grasps"],
                     image_size=KNOBS["image"], seed=0)
  return path


def _success(predictor) -> float:
  policy = CEMPolicy(predictor, action_size=4, num_samples=128,
                     num_elites=10, iterations=4, seed=7)
  return sg.evaluate_grasp_policy(policy, num_scenes=200, seed=5555,
                                  image_size=KNOBS["image"])


def train(device: str, variant: str) -> dict:
  if device == "cpu":
    torch.set_num_threads(int(os.environ.get("THREADS", "4")))
  if variant == "tf32off":
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
  data_seed = int(os.environ.get("DATA_SEED", "1"))
  work = tempfile.mkdtemp()
  rec = _records(work)
  kwargs = {"compute_dtype": torch.float32} if variant == "f32" else {}
  model = QTOptGraspingModel(image_size=KNOBS["image"],
                             in_image_size=KNOBS["image"],
                             optimizer_fn=create_adam_optimizer(1e-3),
                             **kwargs)
  losses = []

  class Grab(logging.Handler):
    def emit(self, record):
      message = record.getMessage()
      if message.startswith("step "):
        losses.append(message)

  train_log = logging.getLogger("tensor2robot_tpu_torch.train.train_eval")
  train_log.addHandler(Grab())
  train_log.setLevel(logging.INFO)
  start = time.perf_counter()
  result = train_eval_model(
      model, input_generator_train=DefaultRecordInputGenerator(
          file_patterns=rec, batch_size=64, seed=data_seed),
      max_train_steps=KNOBS["steps"],
      iterations_per_loop=checks.ITERATIONS_PER_LOOP,
      model_dir=os.path.join(work, "run"),
      export_generator=NativeExportGenerator(), log_every_steps=100,
      device=device)
  train_s = time.perf_counter() - start
  predictor = ExportedModelPredictor(
      model, os.path.join(work, "run", "export", "latest"), device=device)
  predictor.restore(timeout_s=10.0)
  res = _success(predictor)
  return {"device": device, "variant": variant, "data_seed": data_seed,
          "train_s": train_s, "losses": losses,
          "train_metrics": {k: float(v)
                            for k, v in result.train_metrics.items()},
          "success": res["success_rate"],
          "mean_distance": res["mean_distance"]}


def crosseval(mode: str) -> dict:
  work = tempfile.mkdtemp()
  rec = _records(work)
  if mode == "eager":
    checks.ITERATIONS_PER_LOOP = 1
  model = QTOptGraspingModel(image_size=KNOBS["image"],
                             in_image_size=KNOBS["image"],
                             optimizer_fn=create_adam_optimizer(1e-3))
  start = time.perf_counter()
  predictor, stats = checks._train_and_restore_predictor(
      model, rec, KNOBS["steps"], os.path.join(work, "run"), "cuda")
  out = {"mode": mode, "train_s": time.perf_counter() - start,
         "loop_stats": stats}
  for where in ("cuda", "cpu"):
    if where == "cpu":
      torch.set_num_threads(8)
      predictor = ExportedModelPredictor(
          model, os.path.join(work, "run", "export", "latest"),
          device="cpu")
      predictor.restore(timeout_s=10.0)
    start = time.perf_counter()
    out[f"success_{where}_policy"] = _success(predictor)["success_rate"]
    out[f"eval_s_{where}"] = time.perf_counter() - start
  return out


def main(argv) -> int:
  if argv[0] == "train":
    result = train(argv[1], argv[2])
  elif argv[0] == "crosseval":
    result = crosseval(argv[1])
  else:
    raise SystemExit(__doc__)
  print(json.dumps(result), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
