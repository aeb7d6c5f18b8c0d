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
- ``TinyQPredictor`` (``smoke.py``): the smokes' millisecond Q-function.

``fault_bench.py`` holds the learner's crash-resume parity harness. The
router, rollout, front door and the rest of the fault bench wait for
``ROADMAP.md``'s flagship items 9 (the routed fleet) and 15.
"""

from tensor2robot_tpu_torch.serving.batcher import MicroBatcher
from tensor2robot_tpu_torch.serving.bucketing import (
    DEFAULT_LADDER,
    BucketLadder,
)
from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy
from tensor2robot_tpu_torch.serving.server import FleetServer
from tensor2robot_tpu_torch.serving.slo import (
    BATCH,
    DEFAULT_CLASSES,
    INTERACTIVE,
    STANDARD,
    DispatcherDead,
    RequestShed,
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
    "DEFAULT_CLASSES",
    "DEFAULT_LADDER",
    "DispatcherDead",
    "FleetServer",
    "INTERACTIVE",
    "LatencyHistogram",
    "MicroBatcher",
    "RequestShed",
    "SLOClass",
    "STANDARD",
    "ServingStats",
]
