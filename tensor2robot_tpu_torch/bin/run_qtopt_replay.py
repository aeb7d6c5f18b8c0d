"""Runs the closed QT-Opt loop: collect -> replay -> Bellman-label -> train.

    python -m tensor2robot_tpu_torch.bin.run_qtopt_replay --smoke --device cpu
    python -m tensor2robot_tpu_torch.bin.run_qtopt_replay --smoke
    python -m tensor2robot_tpu_torch.bin.run_qtopt_replay

Counterpart of ``tensor2robot_tpu/bin/run_qtopt_replay.py``'s host path:
``CEMFleetPolicy`` collectors on synthetic grasping, a sharded prioritized
ring, CEM-maximized Bellman targets against a lagged target net and the
Trainer's step with the health reductions (``replay/loop.py``).

Prints ONE JSON line: the initial and final eval TD error against the
retry env's Q*, its reduction, the replay and health blocks, and
``compile_counts`` (every value 1: each program is built once). ``--smoke``
is the JAX smoke's scale and critic (TinyQ; its bar is a reduction of at
least 0.30); the default is the production loop (the 64x64 uint8
GroupNorm flagship critic, a 4-shard ring of 50,000). ``--out`` writes the
same line to a file. ``--device`` is where the loop runs: the GPU unless
``cpu`` is asked for.

``--device-resident``, ``--vector-actors`` and ``--anakin`` (item 10),
``--mesh`` (item 15), a non-f32 ``--precision`` (item 11) and
``--profile`` (item 8b) wait for later ``ROADMAP.md`` items and raise by
name.
"""

from __future__ import annotations

import argparse
import json
import tempfile

from tensor2robot_tpu_torch import Device


def build_config(smoke: bool, seed: int, **waiting):
  """The JAX CLI's smoke and full configs, field for field. `waiting`
  takes the config fields of the paths that wait for later items
  (device_resident, vector_actors, anakin, mesh_dp, profile_window,
  precision); the config refuses each off its default by name."""
  from tensor2robot_tpu_torch.replay.loop import ReplayLoopConfig
  if smoke:
    return ReplayLoopConfig(seed=seed, envs_per_collector=4, batch_size=32,
                            capacity=512, **waiting)
  return ReplayLoopConfig(
      image_size=64, batch_size=32, capacity=50_000, min_fill=2_000,
      num_buffer_shards=4, num_collectors=4, envs_per_collector=8,
      queue_capacity=10_000, cem_num_samples=64, cem_num_elites=6,
      cem_iterations=3, refresh_every=200, eval_every=500,
      eval_batches=8, log_every=50, learning_rate=1e-4, seed=seed,
      megastep_inner=50, ingest_chunk=256, anakin_inner=200,
      anakin_bank_scenes=4096, **waiting)


def run(steps: int, smoke: bool, logdir: str, seed: int,
        device: Device = None, **waiting) -> dict:
  """The loop for `steps` optimizer steps: TinyQ under `smoke`, the
  flagship critic otherwise. Returns the loop's result."""
  from tensor2robot_tpu_torch.replay.loop import ReplayTrainLoop
  config = build_config(smoke, seed, **waiting)
  model = None  # the flagship QTOptGraspingModel
  if smoke:
    # The flagship's conv tower cannot learn to discriminate within a
    # smoke budget: it would prove the plumbing but not the learning.
    from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
    from tensor2robot_tpu_torch.utils import optimizers
    model = TinyQCriticModel(
        image_size=config.image_size, action_size=config.action_size,
        optimizer_fn=optimizers.create_adam_optimizer(config.learning_rate))
  results = ReplayTrainLoop(config, logdir, model=model,
                            device=device).run(steps)
  results["mode"] = "smoke" if smoke else "full"
  results["metric"] = ("QT-Opt off-policy replay loop: eval Bellman "
                       "residual reduction")
  return results


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--steps", type=int, default=0,
                      help="optimizer steps (0 = 300 under --smoke, else "
                           "10,000)")
  parser.add_argument("--smoke", action="store_true",
                      help="the JAX smoke's scale, with TinyQ")
  parser.add_argument("--device", default=None,
                      help="cuda (the default) or cpu")
  parser.add_argument("--device-resident", action="store_true",
                      help="waits for ROADMAP.md item 10")
  parser.add_argument("--vector-actors", action="store_true",
                      help="waits for ROADMAP.md item 10")
  parser.add_argument("--anakin", action="store_true",
                      help="waits for ROADMAP.md item 10")
  parser.add_argument("--mesh", default="0",
                      help="DP[,TP]; any mesh waits for ROADMAP.md item 15")
  parser.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                      help="CEM scoring tier; bf16 waits for item 11")
  parser.add_argument("--profile", default=None,
                      help="START,END; waits for ROADMAP.md item 8b")
  parser.add_argument("--logdir", default=None,
                      help="metric files' directory (default: a tempdir)")
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--out", default=None,
                      help="also write the JSON line to this file")
  args = parser.parse_args(argv)
  waiting = dict(device_resident=args.device_resident,
                 vector_actors=args.vector_actors, anakin=args.anakin,
                 mesh_dp=0 if args.mesh == "0" else args.mesh,
                 profile_window=args.profile, precision=args.precision)
  steps = args.steps or (300 if args.smoke else 10_000)
  logdir = args.logdir or tempfile.mkdtemp(prefix="qtopt_replay_")
  results = run(steps, args.smoke, logdir, args.seed, device=args.device,
                **waiting)
  line = json.dumps(results)
  if args.out:
    with open(args.out, "w") as f:
      f.write(line + "\n")
  print(line)


if __name__ == "__main__":
  main()
