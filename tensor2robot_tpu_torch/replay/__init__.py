"""The QT-Opt replay tier: the learner half of the JAX package's
``tensor2robot_tpu/replay``.

- ``smoke.TinyQCriticModel``: the CPU-scale critic;
- ``sum_tree.SumTree``, ``ring_buffer.ReplayBuffer`` /
  ``ShardedReplayBuffer``, ``ingest`` (``TransitionQueue``,
  ``ReplayFeeder``): host numpy, bit-identical to the JAX package's;
- ``bellman``: CEM-maximized Bellman targets against a lagged target net;
- ``loop``: the transition schema, ``ReplayLoopConfig``,
  ``CollectorWorker`` and the eval against the retry env's Q*;
- ``learner_bench``: the learner's host step, its throughput bench and
  the off-policy learning check.

``ReplayTrainLoop``, the fleet policy and ``run_qtopt_replay`` come with
``ROADMAP.md``'s flagship items 8 and 9; the device-resident and fused
loops with item 10.
"""
