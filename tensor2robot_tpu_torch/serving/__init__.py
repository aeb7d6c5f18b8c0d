"""Fleet serving: the QT-Opt control step batched across clients.

Counterpart of ``tensor2robot_tpu/serving``'s core: ``BucketLadder``
(``bucketing.py``) pads each flush up to a small fixed ladder of batch
sizes, and ``CEMFleetPolicy`` (``policy.py``) runs the CEM control step
for a whole bucket at once, one CUDA graph per bucket on the GPU. The
micro-batcher, SLO classes, router, rollout and front door wait for
``ROADMAP.md``'s flagship items 9 and 15.
"""

from tensor2robot_tpu_torch.serving.bucketing import (
    DEFAULT_LADDER,
    BucketLadder,
)
from tensor2robot_tpu_torch.serving.policy import CEMFleetPolicy

__all__ = ["BucketLadder", "CEMFleetPolicy", "DEFAULT_LADDER"]
