"""Serving benchmark: QT-Opt CEM control, single-robot and fleet modes.

    python -m tensor2robot_tpu_torch.bin.bench_serving
    python -m tensor2robot_tpu_torch.bin.bench_serving --fleet
    python -m tensor2robot_tpu_torch.bin.bench_serving --fleet --smoke
    python -m tensor2robot_tpu_torch.bin.bench_serving --fleet --smoke \\
        --device cpu

Counterpart of ``tensor2robot_tpu/bin/bench_serving.py``. Single-robot
mode (the default): ``CEMPolicy`` runs one control step a camera frame (one
CUDA graph on the GPU) over the 472x472 flagship critic with random
weights (``CheckpointPredictor.init_randomly``; latency does not depend on
the weights), on the float32 and the uint8 wire. The port's policy returns
each action on the host, so its ``pipelined_hz`` (no wait until the last
frame) differs from ``closed_loop_hz`` only by noise.

Fleet mode (``--fleet``): N synthetic clients drive ``FleetServer``
(deadline micro-batcher -> bucket ladder -> one CUDA graph a rung), closed
loop (each client waits for its action) or at ``--target-hz`` offered load
a client, over the ``--clients`` sweep; every rung is built before the
clients start. It reports aggregate images/s, per-request p50/p99 latency,
batch occupancy, padding waste, the built-programs ledger and the
amortization: the most clients' rate over one client's closed loop through
the single-robot ``CEMPolicy``. ``--smoke`` swaps in ``TinyQPredictor`` at
a small CEM, so what it measures is the serving layer.

Both modes run on the GPU unless ``--device cpu`` is given, and print ONE
JSON line; ``device_kind`` names the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time

import numpy as np

from tensor2robot_tpu_torch import Device, resolve_device


def _device_kind(device) -> str:
  import torch
  device = resolve_device(device)
  if device.type == "cuda":
    return torch.cuda.get_device_name(device)
  return "cpu"


def _flagship_predictor(uint8_images: bool, device: Device):
  """(predictor, image size): the 472x472 critic with random weights."""
  from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
      CheckpointPredictor,
  )
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      QTOptGraspingModel,
  )
  model = QTOptGraspingModel(uint8_images=uint8_images)
  predictor = CheckpointPredictor(model, device=device)
  predictor.init_randomly()
  return predictor, model.get_feature_specification("train")["image"].shape[0]


def bench_policy(uint8_images: bool, control_steps: int = 30,
                 device: Device = None) -> dict:
  """The single-robot control rate over the flagship critic."""
  from tensor2robot_tpu_torch.research.qtopt.cem import CEMPolicy

  predictor, size = _flagship_predictor(uint8_images, device)
  policy = CEMPolicy(predictor, action_size=4, num_samples=64,
                     num_elites=6, iterations=3, seed=0)
  rng = np.random.default_rng(0)

  def make_image():
    if uint8_images:
      return rng.integers(0, 255, (size, size, 3), np.uint8)
    return rng.random((size, size, 3)).astype(np.float32)

  # Fresh frames, each paying its host-to-device copy.
  frames = [make_image() for _ in range(control_steps)]
  policy(frames[0])  # builds the control step

  out = {}
  start = time.perf_counter()
  for image in frames:
    policy(image)
  elapsed = time.perf_counter() - start
  out["closed_loop_hz"] = round(control_steps / elapsed, 1)
  out["closed_loop_ms"] = round(1e3 * elapsed / control_steps, 2)

  start = time.perf_counter()
  for image in frames:
    policy(image)
  elapsed = time.perf_counter() - start
  out["pipelined_hz"] = round(control_steps / elapsed, 1)

  out["image_wire_format"] = "uint8" if uint8_images else "float32"
  out["image_size"] = int(size)
  out["image_bytes"] = int(frames[0].nbytes)
  return out


# --- fleet mode ------------------------------------------------------------


def _cem_kwargs(smoke: bool) -> dict:
  """The CEM of the fleet policy AND the single-client baseline (the
  amortization compares like with like); the smoke's is small, so
  dispatch, the cost batching amortizes, dominates."""
  if smoke:
    return dict(action_size=4, num_samples=32, num_elites=4,
                iterations=2, seed=0)
  return dict(action_size=4, num_samples=64, num_elites=6,
              iterations=3, seed=0)


def _make_fleet_policy(smoke: bool, uint8_images: bool, device: Device):
  """(predictor, policy, make_image) for the fleet sweep."""
  from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy

  if smoke:
    from tensor2robot_tpu_torch.serving.smoke import TinyQPredictor
    predictor = TinyQPredictor(device=device)
    make_image = predictor.make_image
  else:
    predictor, size = _flagship_predictor(uint8_images, device)
    rng = np.random.default_rng(0)

    def make_image(seed: int):
      del seed
      if uint8_images:
        return rng.integers(0, 255, (size, size, 3), np.uint8)
      return rng.random((size, size, 3)).astype(np.float32)

  policy = CEMFleetPolicy(predictor, **_cem_kwargs(smoke))
  return predictor, policy, make_image


def _run_clients(server, n_clients: int, frames: int, make_image,
                 target_hz: float) -> float:
  """Drives n closed-loop (or paced open-loop) clients; returns seconds."""
  errors = []

  def closed_loop(client: int):
    image = make_image(client)
    try:
      for _ in range(frames):
        server.act(image)
    except Exception as e:  # noqa: BLE001 — surfaced after the join
      errors.append(e)

  def open_loop(client: int):
    image = make_image(client)
    period = 1.0 / target_hz
    futures = []
    next_at = time.perf_counter()
    try:
      for _ in range(frames):
        delay = next_at - time.perf_counter()
        if delay > 0:
          time.sleep(delay)
        futures.append(server.submit(image))
        next_at += period
      for future in futures:
        future.result()
    except Exception as e:  # noqa: BLE001
      errors.append(e)

  run = open_loop if target_hz > 0 else closed_loop
  threads = [threading.Thread(target=run, args=(i,), daemon=True)
             for i in range(n_clients)]
  start = time.perf_counter()
  for thread in threads:
    thread.start()
  for thread in threads:
    thread.join()
  elapsed = time.perf_counter() - start
  if errors:
    raise errors[0]
  return elapsed


def bench_fleet(smoke: bool, clients: list, frames: int,
                deadline_ms: float, target_hz: float,
                uint8_images: bool = True, repeats: int = 3,
                device: Device = None) -> dict:
  """The fleet sweep over `clients` (see the module docstring)."""
  from tensor2robot_tpu_torch.research.qtopt.cem import CEMPolicy
  from tensor2robot_tpu_torch.serving.server import FleetServer
  from tensor2robot_tpu_torch.serving.stats import ServingStats

  predictor, policy, make_image = _make_fleet_policy(smoke, uint8_images,
                                                     device)
  ladder = policy.ladder
  # Every rung built up front, on this thread: a flush only replays, and
  # no capture runs beside the clients' threads.
  policy.warm(make_image)

  # One client through the single-robot path (one control step a frame, no
  # batching): the amortization baseline, median over `repeats` trials.
  single_policy = CEMPolicy(predictor, **_cem_kwargs(smoke))
  image = make_image(0)
  single_policy(image)
  single_rates = []
  for _ in range(max(1, repeats)):
    start = time.perf_counter()
    for _ in range(frames):
      single_policy(image)
    single_rates.append(frames / (time.perf_counter() - start))
  single_hz = statistics.median(single_rates)

  sweep = []
  for n in clients:
    stats = ServingStats()
    server = FleetServer(policy, max_batch=min(n, ladder.max_batch),
                         deadline_ms=deadline_ms, stats=stats)
    rates = []
    with server:
      # One throwaway round primes the batcher thread.
      [f.result() for f in [server.submit(make_image(i))
                            for i in range(n)]]
      for _ in range(max(1, repeats)):
        elapsed = _run_clients(server, n, frames, make_image, target_hz)
        rates.append(n * frames / elapsed)
    snap = server.snapshot()
    sweep.append({
        "clients": n,
        "offered_hz_per_client": target_hz if target_hz > 0
        else "closed_loop",
        "aggregate_images_per_sec": round(statistics.median(rates), 1),
        "aggregate_trials": [round(r, 1) for r in rates],
        "latency_p50_ms": snap.get("latency_p50_ms"),
        "latency_p99_ms": snap.get("latency_p99_ms"),
        "batch_occupancy": snap.get("batch_occupancy"),
        "padding_waste": snap.get("padding_waste"),
        "mean_batch_size": snap.get("mean_batch_size"),
        "flushes": snap.get("flushes"),
        "deadline_flushes": snap.get("deadline_flushes"),
    })

  top = sweep[-1]
  cem_kwargs = _cem_kwargs(smoke)
  return {
      "mode": "smoke" if smoke else "full",
      "cem": {k: cem_kwargs[k]
              for k in ("num_samples", "num_elites", "iterations")},
      "bucket_ladder": list(ladder.sizes),
      "compile_counts": {str(k): v
                         for k, v in sorted(policy.compile_counts.items())},
      "deadline_ms": deadline_ms,
      "frames_per_client": frames,
      "repeats": max(1, repeats),
      "single_client_closed_loop_hz": round(single_hz, 1),
      "single_client_trials_hz": [round(r, 1) for r in single_rates],
      "fleet_sweep": sweep,
      "amortization_at_max_clients": round(
          top["aggregate_images_per_sec"] / single_hz, 2),
  }


def _parse_args(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--fleet", action="store_true",
                      help="multi-client micro-batching sweep")
  parser.add_argument("--smoke", action="store_true",
                      help="fleet mode over TinyQPredictor (the serving "
                           "layer alone)")
  parser.add_argument("--clients", default="1,2,4,8,16",
                      help="comma-separated concurrent-client sweep")
  parser.add_argument("--frames", type=int, default=0,
                      help="frames per client (0 = mode default)")
  parser.add_argument("--deadline-ms", type=float, default=5.0,
                      help="micro-batcher deadline budget")
  parser.add_argument("--target-hz", type=float, default=0.0,
                      help="offered load per client; 0 = closed loop")
  parser.add_argument("--repeats", type=int, default=3,
                      help="measurement trials per point (median wins)")
  parser.add_argument("--float32", action="store_true",
                      help="fleet full mode: float32 wire instead of "
                           "uint8")
  parser.add_argument("--device", default=None,
                      help="cuda (the default) or cpu")
  args = parser.parse_args(argv)
  if args.smoke and not args.fleet:
    parser.error("--smoke is a fleet-mode lane; pass --fleet --smoke")
  return args


def main(argv=None) -> None:
  args = _parse_args(argv)
  if args.fleet:
    clients = [int(c) for c in args.clients.split(",") if c]
    frames = args.frames or (60 if args.smoke else 30)
    fleet = bench_fleet(args.smoke, clients, frames, args.deadline_ms,
                        args.target_hz, uint8_images=not args.float32,
                        repeats=args.repeats, device=args.device)
    print(json.dumps({
        "metric": "QT-Opt fleet serving: deadline micro-batch + "
                  "bucketed CEM",
        "device_kind": _device_kind(args.device),
        **fleet,
        "reference_note": "the reference ran robot fleets at 10-30 Hz "
                          "through one batched session.run per CEM "
                          "iteration (SURVEY.md §3.3)",
    }))
    return

  results = [bench_policy(uint8_images=False, device=args.device),
             bench_policy(uint8_images=True, device=args.device)]
  print(json.dumps({
      "metric": "QT-Opt fused CEM control rate (64 samples x 3 iters)",
      "device_kind": _device_kind(args.device),
      "results": results,
      "reference_note": "the reference's robot fleets ran 10-30 Hz "
                        "with a batched session.run per CEM iteration "
                        "(SURVEY.md §3.3)",
  }))


if __name__ == "__main__":
  main()
