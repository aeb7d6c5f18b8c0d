"""Fleet serving: the QT-Opt control step batched across clients.

Counterpart of ``tensor2robot_tpu/serving``'s single replica:

- ``BucketLadder`` (``bucketing.py``): pads each flush up to a small fixed
  ladder of batch sizes, so the number of built programs is bounded;
- ``SLOClass`` (``slo.py``): deadline and priority classes, EDF admission
  and lowest-priority-first shedding;
- ``MicroBatcher`` (``batcher.py``): clients enqueue frames, a dispatcher
  flushes when a batch fills or the earliest deadline comes due;
- ``CEMFleetPolicy`` (``policy.py``): the CEM control step for a whole
  bucket at once, one CUDA graph a bucket on the GPU;
- ``FleetServer`` (``server.py``): batcher, policy and the latency and
  occupancy stats (``stats.py``): the single-replica semantics oracle;
- ``TinyQPredictor`` (``smoke.py``): the smokes' millisecond Q-function;
- ``FleetRouter`` and ``PolicyReplica`` (``router.py``): several replicas
  (on one card or several) behind a least-loaded router with circuit
  breakers and the Q-drift guard;
- ``ExportWatcher``, ``RolloutConfig`` and ``RolloutController``
  (``rollout.py``): new checkpoints and scoring tiers through shadow,
  canary and promote, with auto-rollback;
- ``FrontDoor`` (``frontdoor.py``): ingress over per-host routers;
- ``measure_fleet`` (``fleet_bench.py``, ``bin/bench_fleet.py``): the
  routed fleet's bench.

``fault_bench.py`` holds the learner's crash-resume parity harness; the
rest of the fault bench waits for ``ROADMAP.md``'s flagship item 15c.
"""

from tensor2robot_tpu_torch.serving.batcher import MicroBatcher
from tensor2robot_tpu_torch.serving.bucketing import (
    DEFAULT_LADDER,
    BucketLadder,
)
from tensor2robot_tpu_torch.serving.fleet_bench import measure_fleet
from tensor2robot_tpu_torch.serving.frontdoor import FrontDoor
from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy
from tensor2robot_tpu_torch.serving.rollout import (
    ExportWatcher,
    RolloutConfig,
    RolloutController,
)
from tensor2robot_tpu_torch.serving.router import FleetRouter, PolicyReplica
from tensor2robot_tpu_torch.serving.server import FleetServer
from tensor2robot_tpu_torch.serving.slo import (
    BATCH,
    DEFAULT_CLASSES,
    INTERACTIVE,
    STANDARD,
    CircuitBreaker,
    DispatcherDead,
    HealthConfig,
    RequestShed,
    RouterNotStarted,
    SLOClass,
)
from tensor2robot_tpu_torch.serving.stats import (
    LatencyHistogram,
    ServingStats,
)

__all__ = [
    "BATCH",
    "BucketLadder",
    "CEMFleetPolicy",
    "CircuitBreaker",
    "DEFAULT_CLASSES",
    "DEFAULT_LADDER",
    "DispatcherDead",
    "ExportWatcher",
    "FleetRouter",
    "FleetServer",
    "FrontDoor",
    "HealthConfig",
    "INTERACTIVE",
    "LatencyHistogram",
    "MicroBatcher",
    "PolicyReplica",
    "RequestShed",
    "RolloutConfig",
    "RolloutController",
    "RouterNotStarted",
    "SLOClass",
    "STANDARD",
    "ServingStats",
    "measure_fleet",
]
