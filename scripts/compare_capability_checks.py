#!/usr/bin/env python3
"""One capability check of the port or of the JAX package, on the CPU.

    python3 scripts/compare_capability_checks.py --side port --check vrgripper
    python3 scripts/compare_capability_checks.py --side jax --check qtopt \
        --knobs grasps=1500,steps=600,image=64
    python3 scripts/compare_capability_checks.py --side port --check qtopt \
        --knobs grasps=1500,steps=600,image=64 --device cuda

Runs ``check_<check>`` of ``tensor2robot_tpu_torch/bin/
run_capability_checks.py`` (``--side port``) or of
``tensor2robot_tpu/bin/run_capability_checks.py`` (``--side jax``; the JAX
package must be importable, with ``JAX_PLATFORMS=cpu``) at a scale, with
the same data and draws on both sides, and prints one JSON line with the
check's result. ``--knobs`` overrides the scale's knobs (the same
override on both sides); ``--seed-offset`` moves vrgripper's training
randomness as the JAX check's argument of that name does;
``--port-init-from-jax`` starts the port's check from the JAX check's
initial variables (grasp2vec, vrgripper), so that only the training
differs. ``--device cuda`` runs the port's check on the GPU (the same
records and draws as on the CPU; the default is the CPU). It compares the
two packages' checks where a bar is in doubt; it times nothing on a
device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _knobs(text: str) -> dict:
  return {key: int(value) for key, value in
          (item.split("=") for item in text.split(",") if item)}


def _jax_initial_variables(check: str):
  """The JAX check's initial variables, as numpy arrays."""
  import jax
  import numpy as np
  import optax
  from tensor2robot_tpu.bin import run_capability_checks as checks
  from tensor2robot_tpu.train.trainer import Trainer
  knobs = checks._SCALES[check]["fast"]
  if check == "vrgripper":
    from tensor2robot_tpu.research.vrgripper.vrgripper_env_models import (
        VRGripperRegressionModel,
    )
    model = VRGripperRegressionModel(image_size=knobs["image"],
                                     action_size=2, gripper_pose_size=4,
                                     optimizer_fn=lambda: optax.adam(1e-3))
  else:
    from tensor2robot_tpu.research.grasp2vec.grasp2vec_model import (
        Grasp2VecModel,
    )
    model = Grasp2VecModel(image_size=knobs["image"], depth=18,
                           norm="group",
                           optimizer_fn=lambda: optax.adam(1e-3))
  state = Trainer(model, seed=0).create_train_state(batch_size=64)
  return jax.tree_util.tree_map(np.asarray,
                                jax.device_get(state.variables()))


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--side", choices=("port", "jax"), required=True)
  parser.add_argument("--check", required=True,
                      help="qtopt, grasp2vec, vrgripper, pose_env or maml")
  parser.add_argument("--scale", choices=("fast", "full"), default="fast")
  parser.add_argument("--knobs", default="",
                      help="comma list of knob=value overriding the scale")
  parser.add_argument("--seed-offset", type=int, default=0)
  parser.add_argument("--port-init-from-jax", action="store_true")
  parser.add_argument("--threads", type=int, default=4,
                      help="the port's CPU threads")
  parser.add_argument("--device", default="cpu",
                      help="where the port's check runs: cpu or cuda")
  args = parser.parse_args(argv)
  kwargs = {"seed_offset": args.seed_offset} if args.seed_offset else {}
  start = time.perf_counter()
  with tempfile.TemporaryDirectory() as workdir:
    if args.side == "jax":
      from tensor2robot_tpu.bin import run_capability_checks as checks
      checks._SCALES[args.check][args.scale].update(_knobs(args.knobs))
      result = getattr(checks, f"check_{args.check}")(
          args.scale, workdir, **kwargs)
    else:
      import torch
      torch.set_num_threads(args.threads)
      from tensor2robot_tpu_torch.bin import run_capability_checks as checks
      checks._SCALES[args.check][args.scale].update(_knobs(args.knobs))
      if args.port_init_from_jax:
        from tensor2robot_tpu_torch.train.trainer import Trainer
        variables = _jax_initial_variables(args.check)
        create = Trainer.create_train_state
        Trainer.create_train_state = (
            lambda self, v=None: create(self, variables))
      result = checks._CHECKS[args.check](args.scale, workdir,
                                          args.device, **kwargs)
  print(json.dumps({
      "side": args.side, "check": args.check, "scale": args.scale,
      "device": args.device if args.side == "port" else "cpu",
      "knobs": checks._SCALES[args.check][args.scale],
      "seed_offset": args.seed_offset,
      "port_init_from_jax": args.port_init_from_jax,
      "bar": checks._EXPECT[(args.check, args.scale)],
      "seconds": time.perf_counter() - start,
      **{k: v for k, v in result.items()
         if isinstance(v, (int, float, str))}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
