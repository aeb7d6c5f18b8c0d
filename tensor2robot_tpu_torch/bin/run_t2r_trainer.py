"""CLI trainer: config files + binding overrides -> train_eval_model.

    python -m tensor2robot_tpu_torch.bin.run_t2r_trainer \
        --config tensor2robot_tpu_torch/research/pose_env/configs/pose_env_train.cfg \
        --binding 'DefaultRecordInputGenerator.file_patterns = "/tmp/pose_env/train.tfrecord"' \
        --import_module tensor2robot_tpu_torch.research.pose_env.pose_env_models \
        --model_dir /tmp/pose_env/run1

Counterpart of ``tensor2robot_tpu/bin/run_t2r_trainer.py``: the model,
input generators, export, hooks and exporters are injected through the
config system. ``--mode continuous_eval`` runs the evaluator job
(``continuous_eval_model``, configured by ``continuous_eval_model.*``
bindings) over ``--model_dir``'s checkpoints. ``--device`` (default
``cuda``; ``cpu`` on a machine without a GPU) goes to the entry point as a
call-site argument, not a binding, so it never enters the operative
config.

Under ``python -m torch.distributed.run --nproc-per-node N -m
tensor2robot_tpu_torch.bin.run_t2r_trainer ...`` the N processes join one
process group first (``parallel.distributed.initialize``: NCCL when each
rank trains on a card of its own, gloo otherwise, as under ``--device
cpu``) and train over a mesh of all
of them: data parallel by default, FSDP with ``--binding
'train_eval_model.fsdp = True'``, ZeRO-1 with
``train_eval_model.shard_optimizer_state = True``.
"""

from __future__ import annotations

import argparse
import importlib
import logging
import sys

from tensor2robot_tpu_torch import config as t2r_config
from tensor2robot_tpu_torch.parallel import distributed
from tensor2robot_tpu_torch.train.train_eval import (
    continuous_eval_model,
    train_eval_model,
)


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--config", action="append", default=[],
                      help="Config file path (repeatable; applied in order)")
  parser.add_argument("--binding", action="append", default=[],
                      help="Override binding, e.g. 'f.param = 1'"
                           " (repeatable; applied after files)")
  parser.add_argument("--model_dir", default=None,
                      help="Shortcut for train_eval_model.model_dir")
  parser.add_argument("--import_module", action="append", default=[],
                      help="Extra modules to import so their configurables "
                           "register (repeatable)")
  parser.add_argument("--mode", choices=("train_and_eval",
                                         "continuous_eval"),
                      default="train_and_eval",
                      help="train_and_eval runs train_eval_model; "
                           "continuous_eval runs the evaluator job over "
                           "model_dir's checkpoints (continuous_eval_model."
                           "* bindings)")
  parser.add_argument("--device", default="cuda",
                      help="cuda (the default) or cpu")
  args = parser.parse_args(argv)
  # First: the ranks of a torch.distributed.run launch join one group
  # (a single process is left as it is), on gloo for CPU ranks.
  distributed.initialize(device=args.device)

  logging.basicConfig(
      level=logging.INFO,
      format="%(asctime)s %(levelname)s %(name)s: %(message)s")

  # Standard components + research-model modules register on import.
  importlib.import_module("tensor2robot_tpu_torch.config.registrations")
  for module in args.import_module:
    importlib.import_module(module)

  t2r_config.parse_config_files_and_bindings(args.config, args.binding)
  if args.model_dir:
    target = ("continuous_eval_model.model_dir"
              if args.mode == "continuous_eval"
              else "train_eval_model.model_dir")
    t2r_config.bind(target, args.model_dir)

  try:
    if args.mode == "continuous_eval":
      results = continuous_eval_model(device=args.device)
      logging.info("Evaluated %d checkpoints: %s", len(results),
                   sorted(results))
      return 0
    result = train_eval_model(device=args.device)
    logging.info("Final train metrics: %s", result.train_metrics)
    logging.info("Final eval metrics: %s", result.eval_metrics)
    return 0
  finally:
    distributed.shutdown()


if __name__ == "__main__":
  sys.exit(main())
