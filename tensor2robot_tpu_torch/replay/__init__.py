"""The QT-Opt replay tier: the host path of the JAX package's
``tensor2robot_tpu/replay``.

- ``smoke.TinyQCriticModel``: the CPU-scale critic;
- ``sum_tree.SumTree``, ``ring_buffer.ReplayBuffer`` /
  ``ShardedReplayBuffer``, ``ingest`` (``TransitionQueue``,
  ``ReplayFeeder``): host numpy, bit-identical to the JAX package's;
- ``bellman``: CEM-maximized Bellman targets against a lagged target net;
- ``loop``: the transition schema, ``ReplayLoopConfig``,
  ``CollectorWorker``, the eval against the retry env's Q*, and the
  closed loop, ``ReplayTrainLoop`` (collectors acting through
  ``serving.CEMFleetPolicy`` over a hot-reloaded predictor while the
  learner trains);
- ``learner_bench``: the learner's host step, its throughput bench and
  the off-policy learning check;
- ``actor``: ``VectorActor`` and ``ActorFleet``, every env stepped in
  lockstep through one bucket; ``actor_bench``: vector against threaded
  acting;
- ``device_buffer``: ``DeviceReplayBuffer``, the ring and its sum tree on
  the device, and ``MegastepLearner``, K learner steps a dispatch (CUDA
  graphs on the card), the loop's ``device_resident`` path;
- ``anakin``: ``AnakinLoop``, act -> env step -> extend -> learn on the
  card around ``research.qtopt.device_grasping.DeviceGraspEnv`` (CUDA
  graphs of a period on the card), the loop's ``anakin`` path;
  ``anakin_bench``: the fused loop against the vector fleet, and its
  resume bar.
"""

from tensor2robot_tpu_torch.replay.anakin import AnakinLoop
from tensor2robot_tpu_torch.replay.bellman import (
    BellmanUpdater,
    TargetNetwork,
)
from tensor2robot_tpu_torch.replay.device_buffer import (
    DeviceReplayBuffer,
    MegastepLearner,
)
from tensor2robot_tpu_torch.replay.ingest import ReplayFeeder, TransitionQueue
from tensor2robot_tpu_torch.replay.loop import (
    CollectorWorker,
    ReplayLoopConfig,
    ReplayTrainLoop,
    transition_spec,
)
from tensor2robot_tpu_torch.replay.ring_buffer import (
    ReplayBuffer,
    ShardedReplayBuffer,
)
from tensor2robot_tpu_torch.replay.smoke import TinyQCriticModel
from tensor2robot_tpu_torch.replay.sum_tree import SumTree

__all__ = [
    "AnakinLoop",
    "BellmanUpdater",
    "CollectorWorker",
    "DeviceReplayBuffer",
    "MegastepLearner",
    "ReplayBuffer",
    "ReplayFeeder",
    "ReplayLoopConfig",
    "ReplayTrainLoop",
    "ShardedReplayBuffer",
    "SumTree",
    "TargetNetwork",
    "TinyQCriticModel",
    "TransitionQueue",
    "transition_spec",
]
