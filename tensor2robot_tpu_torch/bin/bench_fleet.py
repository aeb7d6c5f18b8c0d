"""Fleet-serving benchmark CLI: the bin/ face of serving/fleet_bench.

    # The full protocol: 128 clients over 2 replicas on the card.
    python -m tensor2robot_tpu_torch.bin.bench_fleet --out fleet.json

    # The reduced lane (the JAX CI scale), on the card or the CPU:
    python -m tensor2robot_tpu_torch.bin.bench_fleet --ci --devices 2
    python -m tensor2robot_tpu_torch.bin.bench_fleet --ci --device cpu

The offered-load sweep across SLO classes, the overload burst, the
shadow/canary rollout cycles and the compile ledger live in
``serving/fleet_bench.py``; this wrapper sits beside ``bench_serving``
(the single replica's bench).
"""

from tensor2robot_tpu_torch.serving.fleet_bench import main

if __name__ == "__main__":
  main()
