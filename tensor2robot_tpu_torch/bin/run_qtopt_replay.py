"""Runs the closed QT-Opt loop: collect -> replay -> Bellman-label -> train.

    python -m tensor2robot_tpu_torch.bin.run_qtopt_replay --smoke --device cpu
    python -m tensor2robot_tpu_torch.bin.run_qtopt_replay --smoke
    python -m tensor2robot_tpu_torch.bin.run_qtopt_replay --smoke --vector-actors
    python -m tensor2robot_tpu_torch.bin.run_qtopt_replay --smoke --device-resident
    python -m tensor2robot_tpu_torch.bin.run_qtopt_replay --smoke --anakin
    python -m tensor2robot_tpu_torch.bin.run_qtopt_replay
    python -m torch.distributed.run --nproc-per-node 2 \
        -m tensor2robot_tpu_torch.bin.run_qtopt_replay --anakin --mesh 2

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

``--vector-actors`` replaces the threaded collectors with one
``VectorActor`` stepping every env in lockstep through one bucket pinned
to the fleet (``replay/actor.py``); the line then carries an
``actor_throughput`` block (vector against threaded acting at the same
policy and env count, ``replay/actor_bench.py``; skip it with
``--no-actor-bench``). ``--profile START,END`` traces that window of
optimizer steps with ``torch.profiler`` into ``<logdir>/profile``.

``--device-resident`` keeps the ring on the device and runs the learner as
the megastep, ``megastep_inner`` sample -> label -> train -> reprioritize
iterations a dispatch, CUDA graphs on the card
(``replay/device_buffer.py``); the line then carries a
``learner_throughput`` block (the megastep against the host path at the
same batch shape, ``replay/learner_bench.py``; skip it with
``--no-learner-bench``).

``--anakin`` runs the fused loop: the env fleet on the card over a bank of
oracle scenes, acting, the replay extend and the learner all on the card,
``anakin_inner`` control steps a dispatch with an optimizer step every
``anakin_train_every``-th, CUDA graphs of a period on the card
(``replay/anakin.py``); the line then carries an ``anakin_throughput``
block (the fused loop against the vector fleet beside the megastep at the
same env count and policy, ``replay/anakin_bench.py``; skip it with
``--no-anakin-bench``). ``--precision bf16`` scores acting and labels
at bfloat16 (``research/qtopt/cem.py``); the TD metrics stay float32.

``--mesh DP[,TP]`` runs the loop over a ``{"data": DP, "model": TP}``
mesh of ranks (``replay/loop.py``): ZeRO-1 when DP > 1, the critic's own
partition rules when TP > 1; with ``--anakin`` the env fleet and the ring
split over the data axis too. Start DP * TP ranks with ``python -m
torch.distributed.run --nproc-per-node DP*TP``: they join one process
group (``parallel.distributed.initialize``; gloo under ``--device cpu``
and for ranks that share a card), and the primary prints the JSON line,
which then carries ``mesh_shape``, ``zero1`` and ``param_sharding``; the
throughput blocks run on the primary alone. Under ``--smoke`` with
``--anakin`` the fleet, the batch and the capacity round up to multiples
of DP, as the JAX CLI's do. ``--mesh 0`` (the default) is one rank.
"""

from __future__ import annotations

import argparse
import json
import tempfile

from tensor2robot_tpu_torch import Device
from tensor2robot_tpu_torch.parallel import collectives, distributed


def parse_profile(spec):
  """'START,END' -> (start, end) optimizer-step window; None passthrough."""
  if not spec:
    return None
  parts = spec.split(",")
  if len(parts) != 2:
    raise ValueError(f"--profile takes START,END steps, got {spec!r}")
  try:
    start, end = int(parts[0]), int(parts[1])
  except ValueError:
    raise ValueError(f"--profile takes integers, got {spec!r}")
  if start < 0 or end <= start:
    raise ValueError(f"--profile needs 0 <= START < END, got {spec!r}")
  return start, end


def parse_mesh(spec: str):
  """'8' or '4,2' -> (dp, tp). '0' keeps the mode default mesh."""
  parts = spec.split(",")
  if len(parts) > 2:
    raise ValueError(f"--mesh takes DP or DP,TP, got {spec!r}")
  try:
    dp = int(parts[0])
    tp = int(parts[1]) if len(parts) == 2 else 1
  except ValueError:
    raise ValueError(f"--mesh takes integers, got {spec!r}")
  if dp < 0 or tp < 1:
    raise ValueError(
        f"--mesh takes DP >= 1 (or 0 for the mode default) and "
        f"TP >= 1, got {spec!r}")
  if dp == 0 and tp != 1:
    # dp=0 keeps the mode-default mesh, which would silently discard
    # the requested TP degree — refuse instead.
    raise ValueError(
        f"--mesh 0,{tp} mixes the keep-default sentinel with an "
        "explicit TP degree; name DP explicitly (e.g. "
        f"--mesh 1,{tp}).")
  return dp, tp


def build_config(smoke: bool, seed: int, **options):
  """The JAX CLI's smoke and full configs, field for field. `options` are
  further config fields (device_resident, vector_actors, anakin,
  profile_window, precision, the checkpoint fields, mesh_dp and
  mesh_tp)."""
  from tensor2robot_tpu_torch.replay.loop import ReplayLoopConfig
  if smoke:
    dp = options.get("mesh_dp", 0)
    # The fleet, the batch and the capacity all split over the data axis
    # on the Anakin path: round them up to multiples of it.
    up = (lambda v: -(-v // dp) * dp) if (
        options.get("anakin") and dp > 1) else (lambda v: v)
    return ReplayLoopConfig(seed=seed, envs_per_collector=up(4),
                            batch_size=up(32), capacity=up(512), **options)
  return ReplayLoopConfig(
      image_size=64, batch_size=32, capacity=50_000, min_fill=2_000,
      num_buffer_shards=4, num_collectors=4, envs_per_collector=8,
      queue_capacity=10_000, cem_num_samples=64, cem_num_elites=6,
      cem_iterations=3, refresh_every=200, eval_every=500,
      eval_batches=8, log_every=50, learning_rate=1e-4, seed=seed,
      megastep_inner=50, ingest_chunk=256, anakin_inner=200,
      anakin_bank_scenes=4096, **options)


def run(steps: int, smoke: bool, logdir: str, seed: int,
        device: Device = None, actor_bench: bool = True,
        learner_bench: bool = True, anakin_bench: bool = True,
        watchdog=None, **options) -> dict:
  """The loop for `steps` optimizer steps: TinyQ under `smoke`, the
  flagship critic otherwise (`options`: config fields, as
  ``build_config``). With vector actors and `actor_bench` the result
  gains the ``actor_throughput`` block, device-resident with
  `learner_bench` the ``learner_throughput`` block, Anakin with
  `anakin_bench` the ``anakin_throughput`` block. `watchdog` is where the
  loop's threads beat (default: the process watchdog). Returns the loop's
  result."""
  from tensor2robot_tpu_torch.replay.loop import ReplayTrainLoop
  config = build_config(smoke, seed, **options)
  model = None  # the flagship QTOptGraspingModel
  if smoke:
    # The flagship's conv tower cannot learn to discriminate within a
    # smoke budget: it would prove the plumbing but not the learning.
    from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
    from tensor2robot_tpu_torch.utils import optimizers
    model = TinyQCriticModel(
        image_size=config.image_size, action_size=config.action_size,
        optimizer_fn=optimizers.create_adam_optimizer(config.learning_rate))
  results = ReplayTrainLoop(config, logdir, model=model, watchdog=watchdog,
                            device=device).run(steps)
  if not distributed.is_primary():  # the benches run on the primary alone
    learner_bench = actor_bench = anakin_bench = False
  if config.device_resident and learner_bench:
    # The megastep against the host path at the same batch shape
    # (collector-free; replay/learner_bench).
    from tensor2robot_tpu_torch.replay.learner_bench import (
        measure_learner_throughput,
    )
    inner = config.megastep_inner if smoke else 10
    results["learner_throughput"] = measure_learner_throughput(
        batch_size=config.batch_size,
        image_size=config.image_size if smoke else 16,
        action_size=config.action_size, inner_steps=inner,
        steps_per_trial=3 * inner, cem_num_samples=config.cem_num_samples,
        cem_num_elites=config.cem_num_elites,
        cem_iterations=config.cem_iterations, gamma=config.gamma, seed=seed,
        device=device)
  if config.vector_actors and actor_bench:
    # Vector against threaded acting at the same policy and env count
    # (collector-free; replay/actor_bench).
    from tensor2robot_tpu_torch.replay.actor_bench import (
        measure_actor_throughput,
    )
    results["actor_throughput"] = measure_actor_throughput(
        image_size=config.image_size if smoke else 16,
        action_size=config.action_size, max_attempts=config.max_attempts,
        grasp_radius=config.grasp_radius,
        exploration_epsilon=config.exploration_epsilon,
        scripted_fraction=config.scripted_fraction,
        cem_num_samples=config.cem_num_samples,
        cem_num_elites=config.cem_num_elites,
        cem_iterations=config.cem_iterations, batch_size=config.batch_size,
        gamma=config.gamma, seed=seed, device=device)
  if config.anakin and anakin_bench:
    # The fused loop against the vector fleet beside the megastep at the
    # same env count and policy (replay/anakin_bench).
    from tensor2robot_tpu_torch.replay.anakin_bench import (
        measure_anakin_throughput,
    )
    results["anakin_throughput"] = measure_anakin_throughput(
        image_size=config.image_size if smoke else 16,
        action_size=config.action_size, max_attempts=config.max_attempts,
        grasp_radius=config.grasp_radius,
        exploration_epsilon=config.exploration_epsilon,
        scripted_fraction=config.scripted_fraction,
        cem_num_samples=config.cem_num_samples,
        cem_num_elites=config.cem_num_elites,
        cem_iterations=config.cem_iterations,
        train_every=config.anakin_train_every,
        batch_size=config.batch_size, gamma=config.gamma, seed=seed,
        device=device)
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
                      help="the device-resident ring and the megastep "
                           "learner (the host path is the default)")
  parser.add_argument("--no-learner-bench", action="store_true",
                      help="skip the learner_throughput block of a "
                           "--device-resident run")
  parser.add_argument("--vector-actors", action="store_true",
                      help="one VectorActor steps every env through one "
                           "bucket (the threaded collectors are the "
                           "default)")
  parser.add_argument("--no-actor-bench", action="store_true",
                      help="skip the actor_throughput block of a "
                           "--vector-actors run")
  parser.add_argument("--anakin", action="store_true",
                      help="the fused loop: the env, acting, the replay "
                           "extend and the learner on the card "
                           "(replay/anakin.py)")
  parser.add_argument("--no-anakin-bench", action="store_true",
                      help="skip the anakin_throughput block of an "
                           "--anakin run")
  parser.add_argument("--mesh", default="0",
                      help="DP or DP,TP: the loop over a mesh of DP*TP ranks "
                           "(start them with torch.distributed.run); 0, the "
                           "default, is one rank")
  parser.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                      help="CEM scoring tier of acting and labels")
  parser.add_argument("--profile", default=None,
                      help="START,END optimizer-step window traced with "
                           "torch.profiler into <logdir>/profile")
  parser.add_argument("--logdir", default=None,
                      help="metric files' directory (default: a tempdir)")
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--out", default=None,
                      help="also write the JSON line to this file")
  args = parser.parse_args(argv)
  dp, tp = parse_mesh(args.mesh)
  options = dict(device_resident=args.device_resident,
                 vector_actors=args.vector_actors, anakin=args.anakin,
                 mesh_dp=dp, mesh_tp=tp,
                 profile_window=parse_profile(args.profile),
                 precision=args.precision)
  steps = args.steps or (300 if args.smoke else 10_000)
  # The ranks of a torch.distributed.run launch join one group (one
  # process is left as it is), on gloo under --device cpu.
  distributed.initialize(device=args.device or "cuda")
  primary = distributed.is_primary()
  try:
    # One logdir for every rank: the primary's.
    logdir = collectives.broadcast_object(
        args.logdir or (tempfile.mkdtemp(prefix="qtopt_replay_")
                        if primary else None))
    results = run(steps, args.smoke, logdir, args.seed, device=args.device,
                  actor_bench=not args.no_actor_bench,
                  learner_bench=not args.no_learner_bench,
                  anakin_bench=not args.no_anakin_bench, **options)
  finally:
    distributed.shutdown()
  if not primary:
    return
  line = json.dumps(results)
  if args.out:
    with open(args.out, "w") as f:
      f.write(line + "\n")
  print(line)


if __name__ == "__main__":
  main()
