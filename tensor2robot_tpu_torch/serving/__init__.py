"""Fleet serving: the QT-Opt control step batched across clients.

Counterpart of ``tensor2robot_tpu/serving``'s core: ``BucketLadder``
(``bucketing.py``) pads each flush up to a small fixed ladder of batch
sizes, and ``CEMFleetPolicy`` (``policy.py``) runs the CEM control step
for a whole bucket at once, one CUDA graph per bucket on the GPU.
``fault_bench.py`` holds the learner's crash-resume parity harness. The
micro-batcher, SLO classes, router, rollout, front door and the rest of
the fault bench wait for ``ROADMAP.md``'s flagship items 9 and 15.
"""

from tensor2robot_tpu_torch.serving.bucketing import (
    DEFAULT_LADDER,
    BucketLadder,
)
from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy

__all__ = ["BucketLadder", "CEMFleetPolicy", "DEFAULT_LADDER"]
